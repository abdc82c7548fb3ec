"""Particle resampling on tensors: systematic, stratified, residual, choice.

The counterparts of :mod:`glimpse_tpu.ops.resampling`'s JAX versions, batched
over the points axis: weights (N, P) give source indices (N, P).

Systematic resampling is in the threshold form the resample kernel takes:
with ``t = P * cumsum(w / sum(w)) - u``, particle slot j draws source
``min(#{i : t[i] < j}, P - 1)``. The count is ``torch.searchsorted(t, j,
side='left')``: a threshold equal to j does not count (left tie rule, as the
TPU kernel's), where the reference's merge-rank search resolves such ties to
the right.

The other three take their uniform draws ``u`` (N, P) explicitly, or draw
them from a ``torch.Generator``, and search as the reference's merge rank
does: ties to the right, clamped to P - 1.

The ``*_np`` functions are the host tracker's resamplers: NumPy on a
``numpy.random.Generator``, one particle set at a time, drawing as the
reference's do, so both packages give the same indices from one seed.
"""
import numpy as np
import torch

# ---- NumPy host versions ---- #


def systematic_np(weights: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    n = len(weights)
    w = weights / weights.sum()
    positions = (np.arange(n) + rng.random()) / n
    return np.searchsorted(np.cumsum(w), positions)


def stratified_np(weights: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    n = len(weights)
    w = weights / weights.sum()
    positions = (np.arange(n) + rng.random(n)) / n
    return np.searchsorted(np.cumsum(w), positions)


def residual_np(weights: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    n = len(weights)
    w = weights / weights.sum()
    counts = (n * w).astype(int)
    deterministic = np.repeat(np.arange(n), counts)
    residuals = w * n - counts
    residuals = residuals / residuals.sum()
    extra = np.searchsorted(np.cumsum(residuals), rng.random(n - len(deterministic)))
    return np.concatenate((deterministic, extra))


def choice_np(weights: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    n = len(weights)
    w = weights / weights.sum()
    return rng.choice(np.arange(n), size=n, replace=True, p=w)


def resample_np(
    weights: np.ndarray, method: str = "systematic", rng: np.random.Generator = None
) -> np.ndarray:
    if rng is None:
        rng = np.random.default_rng()
    fn = {
        "systematic": systematic_np,
        "stratified": stratified_np,
        "residual": residual_np,
        "choice": choice_np,
    }[method]
    return fn(weights, rng)


# ---- Tensor versions ---- #


def systematic_thresholds(weights, u):
    """Threshold table t (N, P) in float32 from weights (N, P) and offsets u (N,).

    Float32 always: the table must hold particle counts exactly. The
    cumulative sum accumulates in float64 and is rounded to float32, as the
    CPU's float32 ``cumsum`` does: a card's float32 scan takes its order
    from the number of rows (at 1,024 x 1,024 the first 512 rows of a batch
    scan otherwise than 512 rows alone), so a run cut into slices would
    resample other rows than the whole; in float64 the order is lost in the
    rounding. On the CPU the table is what a float32 ``cumsum`` gives.
    """
    P = weights.shape[-1]
    w = weights.to(torch.float32)
    w = w / torch.sum(w, dim=-1, keepdim=True)
    cumulative = torch.cumsum(w, dim=-1, dtype=torch.float64).to(torch.float32)
    return P * cumulative - u.to(torch.float32).reshape(-1, 1)


def systematic_indices(t):
    """Source particle of every slot, (N, P) int64, from a threshold table."""
    P = t.shape[-1]
    slots = torch.arange(P, dtype=t.dtype, device=t.device).expand_as(t).contiguous()
    return torch.clamp(torch.searchsorted(t, slots, side="left"), max=P - 1)


def systematic(weights, u):
    """Systematic resampling indices (N, P) for comb offsets u (N,) in [0, 1)."""
    return systematic_indices(systematic_thresholds(weights, u))


def _search_right(table, values):
    """Insertion index of each value in its row of table, ties to the
    right, clamped to [0, P - 1]: the reference's ``_batched_searchsorted``."""
    P = table.shape[-1]
    return torch.clamp(torch.searchsorted(table, values.contiguous(), side="right"), max=P - 1)


def _uniforms(weights, u, generator):
    if u is not None:
        return u.to(device=weights.device, dtype=weights.dtype)
    return torch.rand(weights.shape, generator=generator, device=weights.device, dtype=weights.dtype)


def _normalized(weights):
    return weights / torch.sum(weights, dim=-1, keepdim=True)


def stratified(weights, u=None, generator=None):
    """One uniform draw in each of P equal strata: slot j takes position
    (j + u[j]) / P of the weights' cumulative distribution."""
    P = weights.shape[-1]
    u = _uniforms(weights, u, generator)
    positions = (torch.arange(P, dtype=weights.dtype, device=weights.device) + u) / P
    return _search_right(torch.cumsum(_normalized(weights), dim=-1), positions)


def residual(weights, u=None, generator=None):
    """Particle i is copied floor(P w_i) times, in order; the remaining
    slots draw from the normalized residuals with uniforms u (N, P), slot j
    with u[:, j]."""
    P = weights.shape[-1]
    w = _normalized(weights)
    counts = torch.floor(P * w)
    total = torch.sum(counts, dim=-1, keepdim=True)
    slots = torch.arange(P, dtype=weights.dtype, device=weights.device)
    # Slot k belongs to the first particle whose cumulative count exceeds k.
    det_idx = _search_right(torch.cumsum(counts, dim=-1), slots.expand_as(w))
    residuals = w * P - counts
    res_sum = torch.sum(residuals, dim=-1, keepdim=True)
    res = residuals / torch.where(res_sum > 0, res_sum, 1.0)
    extra_idx = _search_right(torch.cumsum(res, dim=-1), _uniforms(weights, u, generator))
    return torch.where(slots < total, det_idx, extra_idx)


def choice(weights, u=None, generator=None):
    """P independent draws from the weights. The draws are sorted first:
    resampled particles are exchangeable, and the reference sorts them too."""
    u = torch.sort(_uniforms(weights, u, generator), dim=-1).values
    return _search_right(torch.cumsum(_normalized(weights), dim=-1), u)


METHODS = {"stratified": stratified, "residual": residual, "choice": choice}
