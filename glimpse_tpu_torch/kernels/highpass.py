"""The median high-pass kernel (``csrc/highpass.cu``) and its wrapper.

Replaces the TPU kernel ``glimpse_tpu/kernels/highpass_pallas.py``
(``median_highpass``). The wrapper picks by device alone: a CPU tensor runs
the plain version, :func:`glimpse_tpu_torch.ops.imageproc.highpass`; a CUDA
tensor launches the kernel, or raises. The kernel's domain is odd taps, at
most 49, on tiles of any size: :func:`covers` says whether a window lies
inside it, and :func:`highpass` asks it before any launch and sends the
other windows to the plain version, which takes every size. A tile thinner
than half the window reflects more than once at its edges, as numpy's
symmetric padding does, and takes a route of its own on the card. For the
other tiles the library picks one of two routes on the host, from the
stack's shape, the window and the element size: a tile that one block's
shared memory holds (in float32 about 170 x 170 pixels for the separable
windows, 240 x 240 for the others; in 16 bits about 240 x 240 and 340 x
340, in float64 120 x 120 and 170 x 170) is staged there, several small
tiles to a block; a larger one is read from
device memory by kernels whose grid spreads it over many SMs, and so is a
stack of fewer tiles than the card has SMs whose tiles each hold more work
than one block's threads, which the staged route would leave to one block
a tile.
:func:`kernel_variant` names the kernel a stack takes. Both routes are
bit-equal to the plain version. The staged route runs a network designed
for each width: 16-bit tiles two to a register by packed min/max
(``separable_packed``), float64 tiles without NaN tests and with NaN carried
in a flag (``separable_nanflag``); the global route widens 16-bit tiles to
float. Tiles are float32, float64, float16 or bfloat16, and the output has
the input's type. ``median_highpass.launches`` and ``.captured`` count
the kernel's launches as :mod:`._build` says.
"""
import ctypes
from typing import Tuple

import torch

from ..ops.imageproc import highpass as median_highpass_plain
from . import _build
from ._build import DTYPE_CODES

MAX_TAPS = 49
# The windows with a kernel of their own (GLIMPSE_SEPARABLE_WINDOWS in
# csrc/highpass.cu); the other windows run the generic kernel with their taps
# padded to 9, 25 or 49.
SEPARABLE = frozenset({(3, 3), (5, 5), (7, 7), (3, 7), (9, 5)})


def kernel_variant(size: Tuple[int, int], dtype: torch.dtype, shape: Tuple[int, int, int]) -> str:
    """The name of the compiled kernel a CUDA call on a stack of this
    (N, h, w) shape, element type and window runs, as
    ``separable<KH,KW,R>[type]`` or ``generic<S>[type]``, with ``_global``
    after the family on the route that reads from device memory, and
    ``_packed`` (16 bits) or ``_nanflag`` (float64) after a staged separable
    kernel's family (builds the library on first use)."""
    variant = _build.entry("highpass", "glimpse_median_highpass_variant_typed")
    return variant(*shape, *size, DTYPE_CODES[dtype]).decode()


def covers(size: Tuple[int, int]) -> bool:
    """Whether this window lies in the kernel's domain: odd taps, at most 49.
    A predicate on the window alone, as the TPU kernel's own domain is: the
    kernel takes a tile of any size."""
    kh, kw = size
    return kh % 2 == 1 and kw % 2 == 1 and kh * kw <= MAX_TAPS


def highpass(tiles: torch.Tensor, size: Tuple[int, int] = (5, 5)) -> torch.Tensor:
    """The median high-pass of a stack (N, h, w) by the route its window
    gives: :func:`median_highpass` where :func:`covers` says so, else the
    plain version. The choice is made from the window alone, before any
    launch; inside the domain a tile with no pixels, a build failure or a
    launch failure raises.
    """
    if covers(size):
        return median_highpass(tiles, size)
    return median_highpass_plain(tiles, size)


@_build.kernel(
    "highpass", "glimpse_median_highpass_typed", [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    entries={
        "glimpse_median_highpass_variant_typed": (ctypes.c_char_p, [ctypes.c_int] * 6),
        "glimpse_median_highpass_route": (ctypes.c_int, [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7 + [ctypes.c_void_p]),
    },
)
def median_highpass(tiles: torch.Tensor, size: Tuple[int, int] = (5, 5)) -> torch.Tensor:
    """``tile - median_{kh x kw}(tile)`` over a stack (N, h, w) of tiles of
    float32, float64, float16 or bfloat16, in the input's type.

    Symmetric padding that repeats the edge pixel, reflected as often as a
    tile thinner than half the window needs (numpy's mode='symmetric'); odd
    ``kh`` and ``kw`` with at most 49 taps, on tiles of any size (on a card,
    one that a block's shared memory cannot hold is read from device
    memory). Bit-equal on both devices for every input: a window
    that holds a NaN gives NaN, as ``torch.median`` does; ties and +-inf
    select the same value. A 16-bit tile's difference is taken in float32 and
    rounded once to its type, as the plain version's is.
    """
    kh, kw = size
    if not covers(size):
        raise ValueError(f"median_highpass takes odd taps, at most {MAX_TAPS}, got {size}")
    if tiles.ndim != 3 or tiles.dtype not in DTYPE_CODES:
        raise ValueError(
            f"median_highpass takes (N, h, w) float32, float64, float16 or bfloat16,"
            f" got {tuple(tiles.shape)} {tiles.dtype}"
        )
    if not tiles.is_contiguous():
        raise ValueError("median_highpass takes a contiguous tensor")
    N, h, w = tiles.shape
    if h == 0 or w == 0:
        raise ValueError(f"median_highpass takes tiles of at least one pixel, got {h}x{w}")
    if not _build.runs_kernel("highpass", tiles.device):
        return median_highpass_plain(tiles, size)
    out = torch.empty_like(tiles)
    _build.launch("highpass", tiles.device, tiles, out, N, h, w, kh, kw, DTYPE_CODES[tiles.dtype])
    return out
