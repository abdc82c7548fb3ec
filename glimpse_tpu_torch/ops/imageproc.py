"""Tile processing on tensors: normalization and the median high-pass.

The counterpart of :mod:`glimpse_tpu.ops.imageproc` for the tracker's path.
:func:`highpass` here is also the plain version of the median high-pass
kernel (:mod:`glimpse_tpu_torch.kernels.highpass`).
"""
from typing import Tuple

import torch


def normalize(tile, dim=None, eps: float = 0.0):
    """Normalize to mean 0, variance 1 over ``dim`` (or the whole tensor)."""
    if dim is None:
        dim = tuple(range(tile.ndim))
    mean = tile.mean(dim=dim, keepdim=True)
    centered = tile - mean
    std = torch.sqrt((centered * centered).mean(dim=dim, keepdim=True))
    return centered / (std + eps)


def _symmetric_index(n: int, before: int, after: int, device) -> torch.Tensor:
    """Indices of a length-``n`` axis padded by reflection that repeats the
    edge element (numpy's mode='symmetric'); ``before``/``after`` <= n."""
    i = torch.arange(-before, n + after, device=device)
    return torch.where(i < 0, -i - 1, torch.where(i >= n, 2 * n - i - 1, i))


def median_filter(tile, size: Tuple[int, int] = (5, 5)):
    """Median filter of (..., H, W) over odd ``size`` windows, symmetric padding.

    ``torch.nn.functional.pad`` has no symmetric mode (its 'reflect' drops
    the edge pixel), so the padding is built by index.
    """
    ky, kx = size
    if ky % 2 == 0 or kx % 2 == 0:
        raise ValueError(f"median_filter takes odd window sizes, got {size}")
    H, W = tile.shape[-2], tile.shape[-1]
    py, px = ky // 2, kx // 2
    padded = tile.index_select(-2, _symmetric_index(H, py, py, tile.device))
    padded = padded.index_select(-1, _symmetric_index(W, px, px, tile.device))
    windows = padded.unfold(-2, ky, 1).unfold(-2, kx, 1)  # (..., H, W, ky, kx)
    return windows.reshape(*windows.shape[:-2], ky * kx).median(dim=-1).values


def highpass(tile, size: Tuple[int, int] = (5, 5)):
    """Median high-pass: tile minus its median-filtered low-pass."""
    return tile - median_filter(tile, size=size)
