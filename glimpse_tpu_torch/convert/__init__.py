"""Convert between external camera models and the port's camera model."""
from . import cameras
from .cameras import Agisoft, Matlab, OpenCV, PhotoModeler
from .converter import Converter

__all__ = ["cameras", "Converter", "Agisoft", "Matlab", "OpenCV", "PhotoModeler"]
