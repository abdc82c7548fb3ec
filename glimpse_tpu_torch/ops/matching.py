"""Batched keypoint descriptor matching on tensors.

The counterpart of :mod:`glimpse_tpu.ops.matching`: squared L2 distances
between two descriptor stacks as one matmul, ``a^2 + b^2 - 2 ab`` clamped at
0, then the nearest and second-nearest neighbour of every row, the Lowe
ratio ``d1 / d2 < max_ratio`` (strict) and an optional mutual-nearest cross
check. ``torch.cdist`` is not used: it computes the distance another way and
moves ratios near the threshold. Descriptor stacks are padded to a multiple
of ``pad_step`` and batched over image pairs:
:meth:`DescriptorMatcher.match_pairs` runs each batch through a
:class:`BatchProgram`, one a batch shape, as the reference compiles
``_match_batch`` once a shape: on a card a replay of a graph captured from
:func:`match_batch`.
"""
import contextlib
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from .. import graphs


def _ceil_to(n: int, step: int) -> int:
    return -(-n // step) * step


@contextlib.contextmanager
def full_float32():
    """Run float32 matmuls and convolutions in full float32 on the card (no
    TF32), as the reference's ``Precision.HIGHEST``; the flags are restored
    on exit."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def match_batch(da, db, na, nb, max_ratio: float, cross_check: bool):
    """Match padded stacks ``da`` (B, Na, D) against ``db`` (B, Nb, D).

    Rows at or past ``na`` / ``nb`` (B,) are padding. Returns the nearest
    index into ``db`` (B, Na), the ratio (B, Na) and validity (B, Na). Ties
    go to the first index, as ``jnp.argmin`` breaks them.
    """
    with full_float32():
        ip = torch.matmul(da, db.transpose(-1, -2))
    a2 = torch.sum(da * da, dim=-1)
    b2 = torch.sum(db * db, dim=-1)
    d2 = torch.clamp(a2[:, :, None] + b2[:, None, :] - 2.0 * ip, min=0.0)
    n_a, n_b = da.shape[1], db.shape[1]
    rows = torch.arange(n_a, device=da.device)
    cols = torch.arange(n_b, device=da.device)
    col_ok = cols[None, :] < nb[:, None]
    row_ok = rows[None, :] < na[:, None]
    big = torch.full((), np.finfo(np.float32).max, device=da.device)
    d2 = torch.where(col_ok[:, None, :], d2, big)
    d1sq, best = torch.min(d2, dim=2)
    d2nd_sq = torch.min(torch.where(cols[None, None, :] == best[:, :, None], big, d2), dim=2).values
    d1 = torch.sqrt(d1sq)
    d2nd = torch.sqrt(torch.clamp(d2nd_sq, max=1e30))
    ratio = d1 / torch.clamp(d2nd, min=1e-12)
    valid = row_ok & (ratio < max_ratio)
    if cross_check:
        best_for_b = torch.argmin(torch.where(row_ok[:, :, None], d2, big), dim=1)  # (B, Nb)
        valid = valid & (torch.gather(best_for_b, 1, best) == rows[None, :])
    return best, ratio, valid


class BatchProgram:
    """:func:`match_batch` at one shape (B, Na, Nb, D) and ``cross_check``
    as a program over static buffers (:class:`graphs.Program`): the padded
    stacks, their lengths (B,) and ``max_ratio`` as a float32 scalar on
    ``device``, which the reference passes traced. A call copies a batch in
    and returns (best, ratio, valid) as NumPy arrays, bit for bit the eager
    call's."""

    def __init__(self, B: int, Na: int, Nb: int, D: int, cross_check: bool, device) -> None:
        device = torch.device(device)
        self.da = torch.zeros((B, Na, D), dtype=torch.float32, device=device)
        self.db = torch.zeros((B, Nb, D), dtype=torch.float32, device=device)
        self.na, self.nb = (torch.zeros(B, dtype=torch.int64, device=device) for _ in range(2))
        self.max_ratio = torch.zeros((), dtype=torch.float32, device=device)
        self.program = graphs.Program(
            functools.partial(match_batch, self.da, self.db, self.na, self.nb, self.max_ratio, cross_check), device,
            f"descriptor matching of {B} pairs of {Na} x {Nb}")

    def __call__(self, da, db, na, nb, max_ratio: float):
        """``da``/``db``: B padded stacks on the device; ``na``/``nb`` their lengths."""
        torch.stack(da, out=self.da)
        torch.stack(db, out=self.db)
        self.na.copy_(torch.tensor(na))
        self.nb.copy_(torch.tensor(nb))
        self.max_ratio.copy_(torch.tensor(max_ratio, dtype=torch.float32))
        return tuple(t.cpu().numpy() for t in self.program())


class DescriptorMatcher:
    """Pairwise descriptor matcher over padded, batched stacks.

    Stacks are padded to multiples of ``pad_step``; padded stacks are kept
    on ``device`` in a bounded LRU keyed by array identity, so in sequence
    matching each image's descriptors cross to the card once, not once per
    pair.
    """

    def __init__(self, pad_step: int = 1024, cache_entries: int = 192, device="cuda") -> None:
        self.pad_step = pad_step
        self.cache_entries = cache_entries
        self.device = torch.device(device)
        self._device_cache = {}  # (id(array), pad) -> (array, tensor)

    def _pad(self, d: np.ndarray, pad_to: Optional[int] = None) -> np.ndarray:
        n = pad_to or _ceil_to(max(len(d), 1), self.pad_step)
        out = np.zeros((n, d.shape[1]), dtype=np.float32)
        out[: len(d)] = d
        return out

    def _device_stack(self, d: np.ndarray, pad_to: Optional[int] = None) -> torch.Tensor:
        key = (id(d), pad_to)
        hit = self._device_cache.pop(key, None)
        # The host array stays alive inside the entry and must be the same
        # object: an id can be reused after garbage collection.
        if hit is None or hit[0] is not d:
            hit = (d, torch.from_numpy(self._pad(d, pad_to)).to(self.device))
        self._device_cache[key] = hit
        while len(self._device_cache) > self.cache_entries:
            self._device_cache.pop(next(iter(self._device_cache)))
        return hit[1]

    def match_pairs(self, descriptors, pairs, max_ratio: Optional[float] = None, cross_check: bool = False,
                    batch: Optional[int] = None):
        """Match many image pairs in batched chunks.

        ``descriptors``: per-image (n_i, D) arrays; ``pairs``: (M, 2)
        indices into it. Every stack is padded to one common size. Returns a
        list aligned with ``pairs`` of ``(indices (m, 2), ratios (m,))``, the
        contract of :meth:`match` per pair; a pair where either image has
        fewer than 2 descriptors has no matches. Each batch shape has its
        :class:`BatchProgram` for the call.
        """
        pairs = np.asarray(pairs, dtype=int).reshape(-1, 2)
        empty = (np.empty((0, 2), dtype=int), np.empty(0, dtype=np.float32))
        out = [empty] * len(pairs)
        todo = [m for m in range(len(pairs)) if min(len(descriptors[pairs[m, 0]]), len(descriptors[pairs[m, 1]])) >= 2]
        if not todo:
            return out
        used = {int(k) for k in np.unique(pairs[todo])}
        n_pad = _ceil_to(max(len(descriptors[k]) for k in used), self.pad_step)
        if batch is None:
            # Keep the (B, N, N) distance block and its temporaries within
            # about 4 GB.
            batch = max(1, min(32, 4_000_000_000 // (n_pad * n_pad * 12)))
        ratio_limit = np.inf if max_ratio is None else float(np.float32(max_ratio))
        programs = {}
        for start in range(0, len(todo), batch):
            chunk = todo[start : start + batch]
            da = [self._device_stack(descriptors[pairs[m, 0]], n_pad) for m in chunk]
            db = [self._device_stack(descriptors[pairs[m, 1]], n_pad) for m in chunk]
            key = (len(chunk), n_pad, n_pad, da[0].shape[-1], cross_check)
            if key not in programs:
                programs[key] = BatchProgram(*key, self.device)
            best, ratio, valid = programs[key](
                da, db, [len(descriptors[pairs[m, 0]]) for m in chunk], [len(descriptors[pairs[m, 1]]) for m in chunk],
                ratio_limit)
            for row, m in enumerate(chunk):
                keep = np.flatnonzero(valid[row])
                out[m] = (np.column_stack([keep, best[row][keep]]), ratio[row][keep])
        return out

    def match(self, desc_a: np.ndarray, desc_b: np.ndarray, max_ratio: Optional[float] = None,
              cross_check: bool = False) -> Tuple[np.ndarray, np.ndarray]:
        """Matches ``(pairs (m, 2) int, ratios (m,))`` of (a index, b index)."""
        if len(desc_a) < 2 or len(desc_b) < 2:
            return np.empty((0, 2), dtype=int), np.empty(0, dtype=np.float32)
        na = torch.tensor([len(desc_a)], device=self.device)
        nb = torch.tensor([len(desc_b)], device=self.device)
        ratio_limit = np.inf if max_ratio is None else float(np.float32(max_ratio))
        best, ratio, valid = (
            t[0].cpu().numpy()
            for t in match_batch(
                self._device_stack(desc_a)[None], self._device_stack(desc_b)[None], na, nb, ratio_limit, cross_check
            )
        )
        keep = np.flatnonzero(valid)
        return np.column_stack([keep, best[keep]]), ratio[keep]
