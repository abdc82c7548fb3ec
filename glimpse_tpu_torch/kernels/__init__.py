"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain version.

Importing this package registers every kernel's wrapper (:mod:`._build`)
and builds nothing: it needs no ``nvcc``, and a kernel's library is
compiled on the first call that gets a CUDA tensor.
"""
# In the order of the registry, which chip_smoke.py's ``kernels`` line keeps.
from .highpass import median_highpass
from .resample import systematic_resample
from .spline import bspline_sample
from .project import project_extract
from .prior import dem_prior
