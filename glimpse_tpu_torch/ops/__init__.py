"""Plain functions on tensors: projection, tile processing, SSE, sampling, resampling, terrain."""
from . import imageproc, ncc, projection, resampling, sampling, terrain
