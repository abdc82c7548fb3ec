"""Tile processing on tensors: tile extraction, grayscale, normalization,
histogram matching and the median high-pass.

The counterpart of :mod:`glimpse_tpu.ops.imageproc`. Every function works on
the device of the tensor it is given and returns its dtype (float32,
float64, float16 or bfloat16). Quantiles are counts over n, which 16 bits
cannot hold: as the reference's, they are float32 for a 16-bit tensor. :func:`highpass` here
is also the plain version of the median high-pass kernel
(:mod:`glimpse_tpu_torch.kernels.highpass`), and takes every window size,
also those outside the kernel's domain.
"""
from typing import Tuple

import torch


def extract_tiles(image, corners, size: Tuple[int, int]):
    """Tiles (N, th, tw) of an image (H, W) at integer upper-left corners (N, 2)."""
    th, tw = size
    rows = corners[:, 0, None] + torch.arange(th, device=image.device)
    cols = corners[:, 1, None] + torch.arange(tw, device=image.device)
    return image[rows[:, :, None], cols[:, None, :]]


def grayscale(tile):
    """Mean-reduce a trailing channel axis if present."""
    if tile.ndim > 2:
        return tile.mean(dim=-1)
    return tile


def normalize(tile, dim=None, eps: float = 0.0):
    """Normalize to mean 0, variance 1 over ``dim`` (or the whole tensor)."""
    if dim is None:
        dim = tuple(range(tile.ndim))
    mean = tile.mean(dim=dim, keepdim=True)
    centered = tile - mean
    std = torch.sqrt((centered * centered).mean(dim=dim, keepdim=True))
    return centered / (std + eps)


def _quantile_dtype(dtype: torch.dtype) -> torch.dtype:
    """The type of a quantile of a ``dtype`` tensor: float32 or wider."""
    return torch.promote_types(dtype, torch.float32)


def sorted_cdf(a):
    """CDF of a tensor as (sorted values, P(x <= value)).

    Ties all receive the quantile of their last occurrence, so interpolating
    against the result reproduces the CDF of the unique values. The values
    keep ``a``'s dtype; the quantiles are float32 for a 16-bit ``a``.
    """
    flat = a.reshape(-1)
    values = torch.sort(flat).values
    quantiles = torch.searchsorted(values, values, right=True).to(_quantile_dtype(a.dtype)) / flat.shape[0]
    return values, quantiles


def interp(x, xp, fp):
    """Piecewise-linear interpolation of the table (``xp`` ascending, ``fp``)
    at ``x``, as ``numpy.interp``: queries outside the table take the end
    values, and among repeated ``xp`` the last one is the interval's start.
    """
    n = xp.shape[0]
    if n == 1:
        return fp[0].expand(x.shape).clone()
    j = (torch.searchsorted(xp, x.contiguous(), right=True) - 1).clamp(0, n - 2)
    x0, x1 = xp[j], xp[j + 1]
    f0, f1 = fp[j], fp[j + 1]
    slope = (f1 - f0) / (x1 - x0)
    out = slope * (x - x0) + f0
    out = torch.where(x >= xp[-1], fp[-1], out)
    return torch.where(x < xp[0], fp[0], out)


def match_cdf(a, cdf):
    """Transform ``a`` so its CDF matches ``cdf`` (values, quantiles).

    Each element's own quantile is looked up by binary search in the
    tensor's sort, then inverse-interpolated through the target CDF. A
    16-bit ``a`` is interpolated in float32, as the reference's promotes,
    and the result rounded once to ``a``'s dtype.
    """
    values, quantiles = cdf
    flat = a.reshape(-1)
    own_sorted = torch.sort(flat).values
    wide = _quantile_dtype(a.dtype)
    own_q = torch.searchsorted(own_sorted, flat, right=True).to(wide) / flat.shape[0]
    return interp(own_q, quantiles.to(wide), values.to(wide)).reshape(a.shape).to(a.dtype)


def _symmetric_index(n: int, before: int, after: int, device) -> torch.Tensor:
    """Indices of a length-``n`` axis padded by reflection that repeats the
    edge element (numpy's mode='symmetric'): period 2n, the second half
    mirrored, so a pad longer than the axis reflects again."""
    i = torch.remainder(torch.arange(-before, n + after, device=device), 2 * n)
    return torch.where(i >= n, 2 * n - 1 - i, i)


def median_filter(tile, size: Tuple[int, int] = (5, 5)):
    """Median filter of (..., H, W) over ``size`` windows, symmetric padding
    of ``(k // 2, k - 1 - k // 2)`` as scipy.ndimage.median_filter's default.

    ``torch.nn.functional.pad`` has no symmetric mode (its 'reflect' drops
    the edge pixel), so the padding is built by index. An odd tap count takes
    ``torch.median``; an even one the mean of the two middle values of a sort
    (``torch.median`` would return the lower). A window that holds a NaN
    gives NaN either way.
    """
    ky, kx = size
    H, W = tile.shape[-2], tile.shape[-1]
    py, px = ky // 2, kx // 2
    padded = tile.index_select(-2, _symmetric_index(H, py, ky - 1 - py, tile.device))
    padded = padded.index_select(-1, _symmetric_index(W, px, kx - 1 - px, tile.device))
    windows = padded.unfold(-2, ky, 1).unfold(-2, kx, 1)  # (..., H, W, ky, kx)
    taps = windows.reshape(*windows.shape[:-2], ky * kx)
    if (ky * kx) % 2:
        return taps.median(dim=-1).values
    ordered = torch.sort(taps, dim=-1).values  # NaN sorts last
    middle = 0.5 * (ordered[..., ky * kx // 2 - 1] + ordered[..., ky * kx // 2])
    return torch.where(torch.isnan(ordered[..., -1]), ordered[..., -1], middle)


def median_network(values):
    """Median of a sequence of equal-shape tensors by odd-even transposition:
    k passes of min/max compare-exchanges, no sort. An even count gives the
    mean of the two middle values. ``torch.minimum``/``maximum`` propagate
    NaN, so an element with a NaN among its values gives NaN."""
    vals = list(values)
    k = len(vals)
    for pass_ in range(k):
        for i in range(pass_ % 2, k - 1, 2):
            vals[i], vals[i + 1] = torch.minimum(vals[i], vals[i + 1]), torch.maximum(vals[i], vals[i + 1])
    if k % 2:
        return vals[k // 2]
    return 0.5 * (vals[k // 2 - 1] + vals[k // 2])


def highpass(tile, size: Tuple[int, int] = (5, 5)):
    """Median high-pass: tile minus its median-filtered low-pass, in the
    tile's dtype. A float16 or bfloat16 difference is taken in float32 and
    rounded once, which is also what torch's own 16-bit subtraction does."""
    low = median_filter(tile, size=size)
    if tile.dtype in (torch.float16, torch.bfloat16):
        return (tile.float() - low.float()).to(tile.dtype)
    return tile - low


def prepare_tile(tile, cdf=None, highpass_size: Tuple[int, int] = (5, 5), highpass=highpass):
    """The tracker's tile pipeline: grayscale -> normalize -> optional
    histogram match -> median high-pass.

    ``highpass(tile, size=...)`` is the high-pass stage; a caller with a
    kernel for it passes its own. Returns (processed tile, CDF of the tile
    before the high-pass).
    """
    t = normalize(grayscale(tile))
    if cdf is not None:
        t = match_cdf(t, cdf)
    own_cdf = sorted_cdf(t)
    return highpass(t, size=highpass_size), own_cdf
