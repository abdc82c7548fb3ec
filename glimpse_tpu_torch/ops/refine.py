"""Correlation refinement of keypoint matches on tensors.

The counterpart of :mod:`glimpse_tpu.ops.refine`. Each match's displacement
is measured again on the image pair: the A-side template is anchored on the
integer pixel grid, its SSE map against a search window around the B
keypoint is taken (:func:`ops.ncc.sse_map_batched`), and the SSE minimum is
refined to subpixel by damped Newton steps on the surface's exact bicubic
B-spline (:func:`ops.sampling.bspline_derivatives`). Tiles are cut by
integer gathers, exact on uint8-valued images; the spline and Newton steps
run in full float32. :class:`MatchRefiner` runs each chunk through a
:class:`ChunkProgram`, one a chunk shape, as the reference compiles
``_refine_one_pair`` once a shape: on a card a replay of a graph captured
from :func:`refine_chunk`.
"""
import collections
import functools
from typing import Callable, Dict

import numpy as np
import torch

from .. import graphs
from . import ncc, sampling
from .matching import full_float32


def _extract_tiles(images, corners, size: int):
    """Square tiles (C, N, size, size) of ``images`` (C, H, W) at integer
    (row, col) upper-left ``corners`` (C, N, 2), already inside the images."""
    C, H, W = images.shape
    offsets = torch.arange(size, device=images.device)
    rows = corners[..., 0, None] + offsets  # (C, N, size)
    cols = corners[..., 1, None] + offsets
    index = rows[..., :, None] * W + cols[..., None, :]  # (C, N, size, size)
    return torch.gather(images.reshape(C, H * W), 1, index.reshape(C, -1)).reshape(index.shape)


def _newton_peak_2d(coeff, y, x, iters: int):
    """Damped Newton minimization on bicubic spline surfaces.

    ``coeff`` (N, o, o) B-spline coefficients; (y, x) (N,) start positions.
    Steps are clipped to one cell and positions to the grid; where the 2x2
    Hessian is not positive definite the step is a small gradient step.
    """
    o = coeff.shape[-1]
    for _ in range(iters):
        _, gy, gx, hyy, hxx, hxy = (d[:, 0] for d in sampling.bspline_derivatives(coeff, y[:, None], x[:, None]))
        det = hyy * hxx - hxy * hxy
        pd = (det > 1e-12) & (hyy > 0)
        det_safe = torch.where(pd, det, torch.ones_like(det))
        sy = torch.where(pd, (hxx * gy - hxy * gx) / det_safe, 0.25 * gy)
        sx = torch.where(pd, (hyy * gx - hxy * gy) / det_safe, 0.25 * gx)
        y = torch.clamp(y - torch.clamp(sy, -1.0, 1.0), 0.0, o - 1.0)
        x = torch.clamp(x - torch.clamp(sx, -1.0, 1.0), 0.0, o - 1.0)
    return y, x


def refine_chunk(imgs_a, imgs_b, ca, cb, template: int, search: int, iters: int):
    """Subpixel SSE peaks (y, x), each (C, N), in window coordinates.

    ``imgs_a``/``imgs_b`` (C, H, W) image pairs; ``ca``/``cb`` (C, N, 2)
    integer upper-left corners of the A templates and B windows.
    """
    C, N = ca.shape[:2]
    ta = _extract_tiles(imgs_a, ca, template).reshape(C * N, template, template)
    sb = _extract_tiles(imgs_b, cb, search).reshape(C * N, search, search)
    sse = ncc.sse_map_batched(sb, ta)  # (C*N, o, o)
    o = sse.shape[-1]
    idx = torch.argmin(sse.reshape(C * N, -1), dim=1)
    with full_float32():
        coeff = sampling.bspline_prefilter_2d(sse)
    y, x = _newton_peak_2d(coeff, (idx // o).float(), (idx % o).float(), iters)
    return y.reshape(C, N), x.reshape(C, N)


#: Chunk shapes whose programs a :class:`MatchRefiner` keeps: a sequence
#: gives two (its full chunks and its last one) per image size.
CHUNK_PROGRAMS = 4


class ChunkProgram:
    """:func:`refine_chunk` at one shape as a program over static buffers
    (:class:`graphs.Program`): image pairs (C, H, W) float32 and corners (C,
    N, 2) int64 on ``device``. A call copies a chunk in and returns the
    subpixel peaks (y, x), each (C, N), as NumPy arrays, bit for bit the
    eager call's."""

    def __init__(self, C: int, N: int, H: int, W: int, template: int, search: int, iters: int, device) -> None:
        device = torch.device(device)
        self.imgs_a, self.imgs_b = (torch.zeros((C, H, W), dtype=torch.float32, device=device) for _ in range(2))
        self.ca, self.cb = (torch.zeros((C, N, 2), dtype=torch.int64, device=device) for _ in range(2))
        self.program = graphs.Program(
            functools.partial(refine_chunk, self.imgs_a, self.imgs_b, self.ca, self.cb, template, search, iters),
            device, f"match refinement of {C} x {N} matches")

    def __call__(self, imgs_a, imgs_b, ca: np.ndarray, cb: np.ndarray):
        """``imgs_a``/``imgs_b``: C (H, W) tensors on the device; ``ca``/``cb`` (C, N, 2)."""
        torch.stack(imgs_a, out=self.imgs_a)
        torch.stack(imgs_b, out=self.imgs_b)
        self.ca.copy_(torch.from_numpy(ca))
        self.cb.copy_(torch.from_numpy(cb))
        y, x = self.program()
        return y.cpu().numpy(), x.cpu().numpy()


class MatchRefiner:
    """Correlation refinement over a match sequence, in chunks of
    ``pairs_per_dispatch`` image pairs x ``pad_matches`` matches.

    Images are kept on ``device`` in an LRU keyed by the caller's image
    index, sized to the matching window (``seq=(1, 8, 64)`` revisits an
    image for up to 64 later pairs). Each chunk shape (pairs, padded
    matches, image size) has its :class:`ChunkProgram`; the last
    :data:`CHUNK_PROGRAMS` shapes' are kept.
    """

    def __init__(self, template: int = 11, search: int = 25, iters: int = 4, pad_matches: int = 3072,
                 pairs_per_dispatch: int = 8, cache_images: int = 192, device="cuda"):
        if template % 2 == 0 or search % 2 == 0 or search <= template:
            raise ValueError("template/search must be odd, search > template")
        self.template = int(template)
        self.search = int(search)
        self.iters = int(iters)
        self.pad_matches = int(pad_matches)
        self.pairs_per_dispatch = int(pairs_per_dispatch)
        self.device = torch.device(device)
        self._cache_images = int(cache_images)
        self._images: Dict[int, torch.Tensor] = {}  # insertion-ordered LRU
        self._programs: Dict[tuple, ChunkProgram] = collections.OrderedDict()

    def _device_image(self, key: int, read: Callable[[int], np.ndarray]) -> torch.Tensor:
        img = self._images.pop(key, None)
        if img is None:
            img = torch.from_numpy(np.asarray(read(key), dtype=np.float32)).to(self.device)
        self._images[key] = img
        while len(self._images) > self._cache_images:
            self._images.pop(next(iter(self._images)))
        return img

    def _program(self, C: int, N: int, H: int, W: int) -> ChunkProgram:
        """The chunk program of this shape, built at first use."""
        key = (C, N, H, W)
        if key not in self._programs:
            self._programs[key] = ChunkProgram(C, N, H, W, self.template, self.search, self.iters, self.device)
            while len(self._programs) > CHUNK_PROGRAMS:
                self._programs.popitem(last=False)
        self._programs.move_to_end(key)
        return self._programs[key]

    def refine_pairs(self, pairs, uvs, read_image):
        """Refine matched coordinates for a sequence of image pairs.

        Arguments:
            pairs: (i, j) image-index pairs.
            uvs: parallel (uv_a, uv_b) float (n, 2) arrays (x, y; n varies).
            read_image: image index -> 2D grayscale array (uint8 range).

        Returns:
            A list of (uv_a', uv_b'). Matches whose template or window would
            cross an image border keep their coordinates; refined A
            coordinates are the integer template centres, refined B
            coordinates carry the measured subpixel displacement.
        """
        pairs = [tuple(map(int, p)) for p in pairs]
        uvs = [(np.asarray(a, float), np.asarray(b, float)) for a, b in uvs]
        th = self.template // 2
        sh = self.search // 2
        center = (self.search - self.template) / 2.0
        out = [None] * len(pairs)
        order = sorted(range(len(pairs)), key=lambda k: pairs[k])
        for start in range(0, len(order), self.pairs_per_dispatch):
            chunk = order[start : start + self.pairs_per_dispatch]
            n_pad = max([self.pad_matches] + [len(uvs[k][0]) for k in chunk])
            imgs_a, imgs_b, cas, cbs, metas = [], [], [], [], []
            for k in chunk:
                i, j = pairs[k]
                uv_a, uv_b = uvs[k]
                img_a = self._device_image(i, read_image)
                img_b = self._device_image(j, read_image)
                H, W = img_a.shape
                pa = np.round(uv_a).astype(np.int64)
                pb = np.round(uv_b).astype(np.int64)
                valid = (
                    (pa[:, 0] >= th) & (pa[:, 0] < W - th) & (pa[:, 1] >= th) & (pa[:, 1] < H - th)
                    & (pb[:, 0] >= sh) & (pb[:, 0] < W - sh) & (pb[:, 1] >= sh) & (pb[:, 1] < H - sh)
                )
                n = len(pa)
                ca = np.zeros((n_pad, 2), np.int64)
                cb = np.zeros((n_pad, 2), np.int64)
                # (row, col) corners, clamped so every row (padding too) is legal.
                ca[:n] = np.clip(pa[:, ::-1] - th, 0, [H - self.template, W - self.template])
                cb[:n] = np.clip(pb[:, ::-1] - sh, 0, [H - self.search, W - self.search])
                imgs_a.append(img_a)
                imgs_b.append(img_b)
                cas.append(ca)
                cbs.append(cb)
                metas.append((k, n, pa, pb, valid))
            y, x = self._program(len(chunk), n_pad, H, W)(imgs_a, imgs_b, np.stack(cas), np.stack(cbs))
            for row, (k, n, pa, pb, valid) in enumerate(metas):
                uv_a, uv_b = uvs[k]
                if n == 0:
                    out[k] = (uv_a, uv_b)
                    continue
                duv = np.stack([x[row, :n] - center, y[row, :n] - center], axis=1) + (pb - pa)
                out[k] = (np.where(valid[:, None], pa.astype(float), uv_a), np.where(valid[:, None], pa + duv, uv_b))
        return out


def refine_matches(img_a, img_b, uv_a, uv_b, template: int = 11, search: int = 25, iters: int = 4, device="cuda"):
    """One-pair convenience wrapper around :class:`MatchRefiner`."""
    refiner = MatchRefiner(
        template=template, search=search, iters=iters, pad_matches=max(len(np.atleast_2d(uv_a)), 1),
        pairs_per_dispatch=1, cache_images=2, device=device,
    )
    imgs = {0: img_a, 1: img_b}
    (out,) = refiner.refine_pairs([(0, 1)], [(uv_a, uv_b)], lambda k: imgs[k])
    return out
