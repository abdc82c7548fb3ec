"""Host-side I/O: GDAL-free raster and image codecs."""
from . import geotiff  # noqa: F401
