"""glimpse_tpu_torch: the batched particle-filter tracker on PyTorch and CUDA.

A port of :mod:`glimpse_tpu` (JAX on a TPU) to PyTorch on an NVIDIA H100.
Module paths mirror the JAX package's: ``ops`` holds plain functions on
tensors, ``kernels`` the hand-written CUDA kernels with their plain
versions, ``track`` the batched tracker. The package imports torch and numpy
and never jax; the CUDA kernels build on their first call on the card.
"""
from . import kernels, ops, track
