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
the card.

``bspline_sample.launches`` counts the kernel's launches. A call made while
its stream is being captured into a CUDA graph launches nothing: it adds to
``bspline_sample.captured`` instead, and whoever replays the graph adds its
captured launches to ``launches`` at each replay
(:class:`glimpse_tpu_torch.track.batch.StepProgram`).
"""
import ctypes
import functools

import torch

from ..ops.sampling import bspline_sample as bspline_sample_plain
from . import _build

#: The coefficient types the kernel takes, by the code csrc/spline.cu's
#: Dtype gives each.
DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.float16: 2, torch.bfloat16: 3}
#: The coordinate types it takes.
COORD_DTYPES = (torch.float32, torch.float64)
#: The most particles a surface may have: the kernel's grid splits a
#: surface's particles into at most 65,535 chunks of 2,048.
MAX_PARTICLES = 65535 * 2048


@functools.cache
def _entry():
    lib = _build.load("spline")
    fn = lib.glimpse_spline_sample
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.glimpse_spline_route.argtypes = [ctypes.c_int] * 3
    lib.glimpse_spline_route.restype = ctypes.c_char_p
    return lib, fn


def route(shape, dtype: torch.dtype) -> str:
    """``'staged'`` or ``'global'``: the route a CUDA call on surfaces of
    this (h, w) shape and coefficient type takes (builds the library on
    first use)."""
    lib, _ = _entry()
    return lib.glimpse_spline_route(*shape, DTYPE_CODES[dtype]).decode()


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
    if coeffs.device.type == "cpu":
        return bspline_sample_plain(coeffs, rows, cols)
    if coeffs.device.type != "cuda":
        raise ValueError(f"bspline_sample runs on cpu or cuda, got {coeffs.device}")
    coeffs, rows, cols = coeffs.contiguous(), rows.contiguous(), cols.contiguous()
    wide = torch.float64 in (coeffs.dtype, rows.dtype)
    out = torch.empty(rows.shape, dtype=torch.float64 if wide else torch.float32, device=rows.device)
    if out.numel() == 0:
        return out
    lib, fn = _entry()
    with torch.cuda.device(coeffs.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(coeffs.data_ptr(), rows.data_ptr(), cols.data_ptr(), out.data_ptr(), B, H, W, P,
                  DTYPE_CODES[coeffs.dtype], DTYPE_CODES[rows.dtype], stream)
        capturing = torch.cuda.is_current_stream_capturing()
    _build.check(lib, code, "bspline_sample")
    if capturing:
        bspline_sample.captured += 1
    else:
        bspline_sample.launches += 1
    return out


bspline_sample.launches = 0
bspline_sample.captured = 0
