"""The batched particle-filter tracker, the host tracker, the host motion
models, observers, tracks, the frame feeder, and conversion of reference
state."""
from . import batch, convert, feeder, smooth
from .motion import (
    CartesianMotion,
    CylindricalMotion,
    Motion,
    TangentCartesianMotion,
    TangentCylindricalMotion,
)
from .observer import Observer
from .tracker import Tracker
from .tracks import Tracks

__all__ = [
    "Motion",
    "CartesianMotion",
    "CylindricalMotion",
    "TangentCartesianMotion",
    "TangentCylindricalMotion",
    "Observer",
    "Tracker",
    "Tracks",
]
