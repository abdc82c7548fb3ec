"""Sum-of-squared-error (SSE) template matching on tensors.

The counterpart of :mod:`glimpse_tpu.ops.ncc`: :func:`sse_map_batched` is its
'conv' form, SSE(u, v) = sum_patch S^2 - 2 (S * T)(u, v) + sum T^2, for the
batched tracker; :func:`sse_map` the direct sliding sum for one pair, for
the host tracker; :func:`sse_map_numpy` that sum on NumPy arrays.
"""
import numpy as np
import torch
import torch.nn.functional as F


def sse_map_batched(search, templates):
    """SSE maps of search tiles (N, sh, sw) against templates (N, th, tw).

    Returns (N, sh - th + 1, sw - tw + 1). Both window sums are grouped
    convolutions, one group per point. A float32 convolution on the card
    goes through cuDNN in TF32 by default, which keeps about three decimal
    digits; they run here with TF32 off.
    """
    N = search.shape[0]
    th, tw = templates.shape[-2:]
    ones = torch.ones((N, 1, th, tw), dtype=search.dtype, device=search.device)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        s2 = F.conv2d((search * search)[None], ones, groups=N)[0]
        corr = F.conv2d(search[None], templates[:, None], groups=N)[0]
    t2 = torch.sum(templates * templates, dim=(-2, -1))
    return s2 - 2 * corr + t2[:, None, None]


def sse_map(search, template):
    """SSE map of one search tile (sh, sw) against one template (th, tw), by
    the direct sliding-window sum of squared differences in the input's
    dtype. Returns (sh - th + 1, sw - tw + 1)."""
    th, tw = template.shape
    windows = search.unfold(0, th, 1).unfold(1, tw, 1)  # (oh, ow, th, tw)
    diff = windows - template
    return torch.einsum("uvij,uvij->uv", diff, diff)


def sse_map_numpy(search: np.ndarray, template: np.ndarray) -> np.ndarray:
    """SSE map of one search tile (sh, sw) against one template (th, tw) on
    NumPy arrays, by the direct sliding-window sum (a reference value for
    tests). Returns (sh - th + 1, sw - tw + 1)."""
    windows = np.lib.stride_tricks.sliding_window_view(search, template.shape)
    diff = windows - template
    return np.einsum("uvij,uvij->uv", diff, diff)
