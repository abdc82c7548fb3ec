"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain version.

Importing this package builds nothing and needs no ``nvcc``: a kernel's
library is compiled on the first call that gets a CUDA tensor.
"""
from .highpass import median_highpass
from .resample import systematic_resample
