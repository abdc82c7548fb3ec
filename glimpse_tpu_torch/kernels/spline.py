"""The cubic B-spline read kernel (``csrc/spline.cu``) and its wrapper.

Replaces no TPU kernel: the reference reads the spline by XLA ops
(``glimpse_tpu/track/batch.py:_sample_sse_surface``). The tracker reads each
point's SSE surface at its particles through :func:`bspline_sample`
(``track/batch.py:_read_spline``, mode ``'einsum'``). The wrapper picks by
device alone: a CPU tensor runs the plain version,
:func:`glimpse_tpu_torch.ops.sampling.bspline_sample`; a CUDA tensor
launches the kernel, or raises. Coefficients are float32, float64, float16
or bfloat16; the coordinates (rows and cols) are float32 or float64, as the
tracker's projections through its float32 cameras give them (16-bit
surfaces are read at float32 coordinates); the output is float64 where
either is float64, else float32, as the plain version's promotions make
it. A surface whose
folded table one block's shared memory holds (about 238 x 238 cells in
float32) is staged there; a larger one is read from device memory with the
same arithmetic (:func:`route`). Both are bit-equal to the plain version on
the card. ``bspline_sample.launches`` and ``.captured`` count the kernel's
launches as :mod:`._build` says.
"""
import ctypes

import torch

from ..ops.sampling import bspline_sample as bspline_sample_plain
from . import _build
from ._build import DTYPE_CODES

#: The coordinate types it takes.
COORD_DTYPES = (torch.float32, torch.float64)
#: The most particles a surface may have: the kernel's grid splits a
#: surface's particles into at most 65,535 chunks of 2,048.
MAX_PARTICLES = 65535 * 2048


def route(shape, dtype: torch.dtype) -> str:
    """``'staged'`` or ``'global'``: the route a CUDA call on surfaces of
    this (h, w) shape and coefficient type takes (builds the library on
    first use)."""
    return _build.entry("spline", "glimpse_spline_route")(*shape, DTYPE_CODES[dtype]).decode()


@_build.kernel(
    "spline", "glimpse_spline_sample",
    [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    entries={"glimpse_spline_route": (ctypes.c_char_p, [ctypes.c_int] * 3)},
)
def bspline_sample(coeffs: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """The cubic B-spline of coefficients (B, H, W) at fractional indices
    rows and cols (B, P): (B, P), equal to
    :func:`glimpse_tpu_torch.ops.sampling.bspline_sample` bit for bit.

    Coefficients have a type of ``DTYPE_CODES``, rows and cols one type of
    ``COORD_DTYPES``, and all lie on one device; the output is float64
    where either type is float64, else float32.
    """
    if coeffs.ndim != 3 or rows.ndim != 2 or rows.shape != cols.shape or rows.shape[0] != coeffs.shape[0]:
        raise ValueError(
            f"bspline_sample takes coefficients (B, H, W) and rows and cols (B, P), got"
            f" {tuple(coeffs.shape)}, {tuple(rows.shape)}, {tuple(cols.shape)}"
        )
    B, H, W = coeffs.shape
    P = rows.shape[1]
    if H < 1 or W < 1:
        raise ValueError(f"bspline_sample takes surfaces of at least one cell, got {H} x {W}")
    if P > MAX_PARTICLES:
        raise ValueError(f"bspline_sample takes at most {MAX_PARTICLES} particles a surface, got {P}")
    if coeffs.dtype not in DTYPE_CODES or rows.dtype not in COORD_DTYPES or cols.dtype != rows.dtype:
        raise ValueError(
            f"bspline_sample takes coefficients of a type of {tuple(DTYPE_CODES)} and rows and cols of one"
            f" type of {COORD_DTYPES}, got {coeffs.dtype}, {rows.dtype} and {cols.dtype}"
        )
    if len({coeffs.device, rows.device, cols.device}) != 1:
        raise ValueError("bspline_sample takes tensors on one device")
    if not _build.runs_kernel("spline", coeffs.device):
        return bspline_sample_plain(coeffs, rows, cols)
    coeffs, rows, cols = coeffs.contiguous(), rows.contiguous(), cols.contiguous()
    wide = torch.float64 in (coeffs.dtype, rows.dtype)
    out = torch.empty(rows.shape, dtype=torch.float64 if wide else torch.float32, device=rows.device)
    if out.numel() == 0:
        return out
    _build.launch("spline", coeffs.device, coeffs, rows, cols, out, B, H, W, P, DTYPE_CODES[coeffs.dtype],
                  DTYPE_CODES[rows.dtype])
    return out
