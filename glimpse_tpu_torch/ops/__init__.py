"""Plain functions on tensors: projection, tile processing, SSE, sampling, resampling."""
from . import imageproc, ncc, projection, resampling, sampling
