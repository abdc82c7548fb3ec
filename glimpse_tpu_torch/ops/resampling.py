"""Systematic particle resampling on tensors.

The counterpart of :func:`glimpse_tpu.ops.resampling.systematic_jax`, in the
threshold form the resample kernel takes: with ``t = P * cumsum(w / sum(w))
- u``, particle slot j draws source ``min(#{i : t[i] < j}, P - 1)``. The
count is ``torch.searchsorted(t, j, side='left')``: a threshold equal to j
does not count (left tie rule, as the TPU kernel's), where the reference's
merge-rank search resolves such ties to the right.
"""
import torch


def systematic_thresholds(weights, u):
    """Threshold table t (N, P) in float32 from weights (N, P) and offsets u (N,).

    Float32 always: the table must hold particle counts exactly.
    """
    P = weights.shape[-1]
    w = weights.to(torch.float32)
    w = w / torch.sum(w, dim=-1, keepdim=True)
    return P * torch.cumsum(w, dim=-1) - u.to(torch.float32).reshape(-1, 1)


def systematic_indices(t):
    """Source particle of every slot, (N, P) int64, from a threshold table."""
    P = t.shape[-1]
    slots = torch.arange(P, dtype=t.dtype, device=t.device).expand_as(t).contiguous()
    return torch.clamp(torch.searchsorted(t, slots, side="left"), max=P - 1)


def systematic(weights, u):
    """Systematic resampling indices (N, P) for comb offsets u (N,) in [0, 1)."""
    return systematic_indices(systematic_thresholds(weights, u))
