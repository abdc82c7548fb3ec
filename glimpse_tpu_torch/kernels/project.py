"""The observer front-end kernel (``csrc/project.cu``) and its wrapper.

Replaces no TPU kernel: the reference computes the front end by XLA ops
(``glimpse_tpu/track/batch.py:_project_and_extract``). The tracker calls
:func:`project_extract` once a step for all its observers
(``track/batch.py:observer_log_likelihoods_multi``): each observer projects
every point's particles, cuts a search tile at their weighted-mean
projection and gives each particle's fractional index into the SSE surface,
stacked observer-major. The wrapper picks by device alone: a CPU tensor runs
:func:`project_extract_plain`, each observer's front end in turn, stacked by
``torch.cat``; a CUDA tensor launches the kernel, one block a point for all
observers, or raises.

Particles (N, P, >= 3) and weights (N, P) share one type D of float32,
float64, float16 or bfloat16; the cameras (O, 20) are float32, as the
tracker holds them; projections, cols and rows are in the type D and the
cameras promote to (float64 for float64 particles, else float32: 16-bit
particles meet the float32 camera in float32, as
:func:`glimpse_tpu_torch.ops.projection.project_planes` widens them); the
template offsets are of type D or of that type; the images (O, H, W) are of
any of the four types, and the tiles take theirs. Numbers: the kernel's
weighted means are block reductions, summed in another order than
``torch.sum``'s, so a point's corner may differ from the plain version's
on the card where the plain mean lies within float rounding of a half-pixel
tie (round half to even); wherever the corners agree, tiles, cols and rows
are bit-equal to it. ``project_extract.launches`` and ``.captured`` count
the kernel's launches as :mod:`._build` says.
"""
import ctypes
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import imageproc, projection
from . import _build
from ._build import DTYPE_CODES

#: The most observers one launch takes (their corrections pass by value).
MAX_OBSERVERS = 64


def projections(camera_vector, correction, particles):
    """One observer's projections (u, v) of the particles (N, P): a particle
    at or behind the camera plane projects to NaN, then far outside (-1e6)."""
    u, v = projection.project_planes(
        camera_vector, particles[..., 0], particles[..., 1], particles[..., 2], correction=correction,
    )
    return torch.nan_to_num(u, nan=-1e6), torch.nan_to_num(v, nan=-1e6)


def _observer_front(image, camera_vector, correction, particles, template_duv, w_norm, template_size, search_size):
    """One observer's front end: (search tiles (N, sh, sw), cols, rows (N, P))."""
    th, tw = template_size
    sh, sw = search_size
    H, W = image.shape
    u, v = projections(camera_vector, correction, particles)
    u_mean = torch.sum(u * w_norm, dim=1)
    v_mean = torch.sum(v * w_norm, dim=1)
    # torch.round rounds half to even, as the reference's jnp.round.
    corner_col = torch.round(u_mean - sw * 0.5).long().clamp(0, W - sw)
    corner_row = torch.round(v_mean - sh * 0.5).long().clamp(0, H - sh)
    search = imageproc.extract_tiles(image, torch.stack([corner_row, corner_col], dim=-1), (sh, sw))
    # SSE surface origin in image coordinates (cell centers at +0.5).
    sse_left = corner_col.to(particles.dtype) + (tw * 0.5 - 0.5) + template_duv[:, 0]
    sse_top = corner_row.to(particles.dtype) + (th * 0.5 - 0.5) + template_duv[:, 1]
    cols = u - sse_left[:, None] - 0.5
    rows = v - sse_top[:, None] - 0.5
    return search, cols, rows


def project_extract_plain(images, camera_vectors, corrections, particles, weights, template_duv,
                          template_size, search_size):
    """Each observer's front end in turn (:func:`_observer_front`), stacked
    observer-major: (search tiles (O N, sh, sw), cols, rows (O N, P))."""
    w_norm = weights / torch.sum(weights, dim=-1, keepdim=True)
    fronts = [
        _observer_front(images[o], camera_vectors[o], corrections[o], particles, template_duv[o], w_norm,
                        template_size, search_size)
        for o in range(images.shape[0])
    ]
    return tuple(torch.cat(parts, dim=0) for parts in zip(*fronts))


def compute_dtype(particles_dtype: torch.dtype) -> torch.dtype:
    """The type projections, cols and rows take: the particles' and the
    float32 cameras' promoted."""
    return torch.promote_types(particles_dtype, torch.float32)


def _correction_constants(corrections: Sequence[Optional[Tuple[float, float]]], dtype: torch.dtype):
    """Three doubles an observer: whether it has an elevation correction,
    (refraction - 1) and 1 / (2 radius), each rounded as PyTorch's CUDA ops
    round host scalars in ``dtype``: the factor to the computing type, the
    divisor to it before its reciprocal is taken there."""
    host = np.float32 if dtype == torch.float32 else np.float64
    values = []
    for correction in corrections:
        if correction is None:
            values += [0.0, 0.0, 0.0]
        else:
            radius, refraction = (float(x) for x in correction)
            values += [1.0, float(host(refraction - 1)), float(host(1.0) / host(2 * radius))]
    return (ctypes.c_double * max(len(values), 1))(*values)


@_build.kernel(
    "project", "glimpse_project_extract",
    [ctypes.c_void_p] * 9 + [ctypes.c_longlong] + [ctypes.c_int] * 12
    + [ctypes.POINTER(ctypes.c_double), ctypes.c_void_p],
)
def project_extract(images: torch.Tensor, camera_vectors: torch.Tensor, corrections, particles: torch.Tensor,
                    weights: torch.Tensor, template_duv: torch.Tensor, template_size: Tuple[int, int],
                    search_size: Tuple[int, int]):
    """Every observer's front end: (search tiles (O N, sh, sw), cols, rows
    (O N, P)), observer-major, equal to :func:`project_extract_plain` as the
    module's docstring says.

    images (O, H, W), camera_vectors (O, 20), corrections O of None or
    (radius, refraction), particles (N, P, >= 3), weights (N, P),
    template_duv (O, N, 2); the types and devices the module's docstring
    gives, else ValueError.
    """
    if (images.ndim != 3 or camera_vectors.ndim != 2 or camera_vectors.shape != (images.shape[0], 20)
            or particles.ndim != 3 or particles.shape[2] < 3 or weights.shape != particles.shape[:2]
            or template_duv.shape != (images.shape[0], particles.shape[0], 2)
            or len(corrections) != images.shape[0]):
        raise ValueError(
            f"project_extract takes images (O, H, W), cameras (O, 20), O corrections, particles (N, P, >= 3),"
            f" weights (N, P) and template offsets (O, N, 2), got {tuple(images.shape)},"
            f" {tuple(camera_vectors.shape)}, {len(corrections)}, {tuple(particles.shape)}, {tuple(weights.shape)}"
            f" and {tuple(template_duv.shape)}"
        )
    O, H, W = images.shape
    N, P = weights.shape
    sh, sw = search_size
    if O > MAX_OBSERVERS:
        raise ValueError(f"project_extract takes at most {MAX_OBSERVERS} observers, got {O}")
    if not (0 < sh <= H and 0 < sw <= W):
        raise ValueError(f"project_extract cuts {sh} x {sw} search tiles from {H} x {W} images: they do not fit")
    if (particles.dtype not in DTYPE_CODES or weights.dtype != particles.dtype
            or camera_vectors.dtype != torch.float32 or images.dtype not in DTYPE_CODES):
        raise ValueError(
            f"project_extract takes particles and weights of one type of {tuple(DTYPE_CODES)}, float32 cameras"
            f" and images of one of {tuple(DTYPE_CODES)}, got {particles.dtype}, {weights.dtype},"
            f" {camera_vectors.dtype} and {images.dtype}"
        )
    dtype = compute_dtype(particles.dtype)
    if template_duv.dtype not in (particles.dtype, dtype):
        raise ValueError(f"project_extract takes template offsets of {particles.dtype} or {dtype},"
                         f" got {template_duv.dtype}")
    if len({t.device for t in (images, camera_vectors, particles, weights, template_duv)}) != 1:
        raise ValueError("project_extract takes tensors on one device")
    if not _build.runs_kernel("project", particles.device):
        return project_extract_plain(images, camera_vectors, corrections, particles, weights, template_duv,
                                     template_size, search_size)
    device = particles.device
    tiles = torch.empty((O * N, sh, sw), dtype=images.dtype, device=device)
    cols = torch.empty((O * N, P), dtype=dtype, device=device)
    rows = torch.empty((O * N, P), dtype=dtype, device=device)
    if O * N == 0:
        return tiles, cols, rows
    _build.launch("project", device, *launch_args((tiles, cols, rows), images, camera_vectors, corrections,
                                                  particles, weights, template_duv, template_size, search_size))
    return tiles, cols, rows


def launch_args(outputs, images, camera_vectors, corrections, particles, weights, template_duv, template_size,
                search_size) -> tuple:
    """The kernel's arguments, the stream aside, as :func:`_build.launch`
    takes them (a tensor for each pointer), for a call of
    :func:`project_extract` that writes ``outputs`` (tiles, cols, rows)."""
    tiles, cols, rows = outputs
    images, camera_vectors, particles, weights, template_duv = (
        t.contiguous() for t in (images, camera_vectors, particles, weights, template_duv))
    # The weights' totals as the plain version sums them: summed in another
    # order, a 16-bit total could round to another value and move every
    # normalized weight.
    totals = torch.sum(weights, dim=-1)
    O, H, W = images.shape
    N, P = weights.shape
    return (particles, weights, totals, camera_vectors, template_duv, images, tiles, cols, rows, N, O, P,
            particles.shape[2], H, W, *template_size, *search_size, DTYPE_CODES[particles.dtype],
            images.element_size(), int(template_duv.dtype != particles.dtype),
            _correction_constants(corrections, cols.dtype))
