"""The batched particle-filter tracker and conversion of reference state."""
from . import batch, convert
