"""The systematic resample kernel (``csrc/resample.cu``) and its wrapper.

Replaces the TPU kernel ``glimpse_tpu/kernels/resample_pallas.py``
(``systematic_resample_gather``, all four of its layouts). The wrapper
picks by device alone: a CPU tensor runs :func:`systematic_resample_plain`;
a CUDA tensor launches the kernel, or raises. The thresholds are float32;
particles and weights share one type of float32, float64, float16 or
bfloat16 and are copied bit for bit. ``systematic_resample.launches`` and
``.captured`` count the kernel's launches as :mod:`._build` says.
"""
import ctypes

import torch

from ..ops import resampling
from . import _build

MAX_PARTICLES = 232448 // 4  # one float32 threshold row per block's shared memory
#: The payload types the kernel copies.
PAYLOAD_DTYPES = (torch.float32, torch.float64, torch.float16, torch.bfloat16)


def systematic_resample_plain(t, particles, weights):
    """searchsorted-left on ``t``, clamped to P - 1, then a row gather."""
    idx = resampling.systematic_indices(t)
    new_particles = particles.gather(1, idx[..., None].expand(-1, -1, particles.shape[-1]))
    return new_particles, weights.gather(1, idx)


@_build.kernel("resample", "glimpse_systematic_resample",
               [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
def systematic_resample(t: torch.Tensor, particles: torch.Tensor, weights: torch.Tensor):
    """Resample particles (N, P, 6) and weights (N, P) by a threshold table t (N, P).

    ``t`` is float32; particles and weights are of one type in
    ``PAYLOAD_DTYPES``, and come back in it. ``t`` comes from :func:`glimpse_tpu_torch.ops.resampling.systematic_thresholds`.
    Slot j of point n copies source row ``min(#{i : t[n, i] < j}, P - 1)``:
    exact row copies, left tie rule. Returns (particles, weights).
    """
    if t.ndim != 2 or particles.shape != (*t.shape, 6) or weights.shape != t.shape:
        raise ValueError(
            f"systematic_resample takes t (N, P), particles (N, P, 6) and weights"
            f" (N, P), got {tuple(t.shape)}, {tuple(particles.shape)}, {tuple(weights.shape)}"
        )
    tensors = (t, particles, weights)
    if t.dtype != torch.float32:
        raise ValueError(f"systematic_resample takes float32 thresholds, got {t.dtype}")
    if particles.dtype not in PAYLOAD_DTYPES or weights.dtype != particles.dtype:
        raise ValueError(
            f"systematic_resample takes particles and weights of one type of {PAYLOAD_DTYPES},"
            f" got {particles.dtype} and {weights.dtype}"
        )
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("systematic_resample takes contiguous tensors")
    if len({x.device for x in tensors}) != 1:
        raise ValueError("systematic_resample takes tensors on one device")
    N, P = t.shape
    if P > MAX_PARTICLES:
        raise ValueError(
            f"{P} particles do not fit one block's shared memory (at most {MAX_PARTICLES})"
        )
    if not _build.runs_kernel("resample", t.device):
        return systematic_resample_plain(t, particles, weights)
    out_particles = torch.empty_like(particles)
    out_weights = torch.empty_like(weights)
    _build.launch("resample", t.device, t, particles, weights, out_particles, out_weights, N, P, particles.element_size())
    return out_particles, out_weights
