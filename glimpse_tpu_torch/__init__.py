"""glimpse_tpu_torch: the batched particle-filter tracker on PyTorch and CUDA.

A port of :mod:`glimpse_tpu` (JAX on a TPU) to PyTorch on an NVIDIA H100.
Module paths mirror the JAX package's: ``ops`` holds plain functions on
tensors, ``kernels`` the hand-written CUDA kernels with their plain
versions, ``track`` the batched tracker, the host ``Tracker``, the host
motion models, ``Observer`` and ``Tracks``; ``optimize`` camera calibration
(``Cameras`` and its control classes), keypoint matching
(``KeypointMatcher``), sequence stabilization and ``project_images``;
``convert`` moves cameras to and from MATLAB, OpenCV, Agisoft and
PhotoModeler; ``profiling`` times phases and traces the card; ``parallel``
cuts the tracker's points over a mesh of devices; ``svg`` reads
hand-digitised control; ``Camera``, ``Raster``, ``Image`` and ``Exif`` are
the host objects, float64 NumPy at their surface. The package imports
torch, numpy and scipy and never jax; Pillow and matplotlib are imported by
the functions that need them; the CUDA kernels build on their first call on
the card.
"""
from . import config, convert, helpers, io, kernels, native, ops, optimize, parallel, profiling, render, svg, track
from .camera import Camera
from .exif import Exif
from .image import Image
from .raster import Grid, Raster, RasterInterpolant
from .track import (
    CartesianMotion,
    CylindricalMotion,
    Motion,
    Observer,
    TangentCartesianMotion,
    TangentCylindricalMotion,
    Tracker,
    Tracks,
)

__all__ = [
    "config",
    "convert",
    "helpers",
    "io",
    "kernels",
    "native",
    "ops",
    "optimize",
    "parallel",
    "profiling",
    "render",
    "svg",
    "track",
    "Camera",
    "Exif",
    "Image",
    "Grid",
    "Raster",
    "RasterInterpolant",
    "Observer",
    "Tracker",
    "Tracks",
    "Motion",
    "CartesianMotion",
    "CylindricalMotion",
    "TangentCartesianMotion",
    "TangentCylindricalMotion",
]

__version__ = "0.1.0"
