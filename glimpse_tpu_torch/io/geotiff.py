"""Minimal GDAL-free GeoTIFF reader/writer built on Pillow.

The counterpart of :mod:`glimpse_tpu.io.geotiff`, in place of upstream's
GDAL raster I/O, for the formats the framework needs: single- and
multi-band TIFF/GeoTIFF (any Pillow-decodable compression) plus any other
Pillow-readable image (JPEG, PNG). Geo-referencing is carried via the
standard GeoTIFF tags:

- 33550 ``ModelPixelScaleTag``  (dx, dy, dz)
- 33922 ``ModelTiepointTag``    (i, j, k, x, y, z)
- 34264 ``ModelTransformationTag`` (4x4 affine)
- 42113 ``GDAL_NODATA``         (no-data value as ASCII)
- 34737 ``GeoAsciiParamsTag``   (CRS text, stored/preserved opaquely)

This is a host-side component: decode happens on the CPU into host arrays
which feed the device pipeline. Pillow is imported at the first call, not
with the module.
"""
import dataclasses
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np

MODEL_PIXEL_SCALE = 33550
MODEL_TIEPOINT = 33922
MODEL_TRANSFORMATION = 34264
GDAL_NODATA = 42113
GEO_ASCII_PARAMS = 34737
GEO_KEY_DIRECTORY = 34735


def pil():
    """Pillow's ``Image`` module, imported on first use."""
    from PIL import Image as PILImage

    # Lift Pillow's decompression-bomb ceiling: gigapixel DEMs are normal here.
    PILImage.MAX_IMAGE_PIXELS = None
    return PILImage


@dataclasses.dataclass
class GeoTiffInfo:
    """Parsed header of a (Geo)TIFF: size, affine transform, nodata, CRS."""

    size: Tuple[int, int]  # (nx, ny)
    # GDAL-style geotransform: (x0, dx, rot, y0, rot, dy)
    transform: Tuple[float, float, float, float, float, float]
    nodata: Optional[float]
    crs: Optional[str]
    n_bands: int
    dtype: np.dtype


def _transform_from_tags(tags, size) -> Tuple[float, ...]:
    if MODEL_TRANSFORMATION in tags:
        m = tags[MODEL_TRANSFORMATION]
        return (m[3], m[0], m[1], m[7], m[4], m[5])
    if MODEL_PIXEL_SCALE in tags and MODEL_TIEPOINT in tags:
        sx, sy = tags[MODEL_PIXEL_SCALE][0:2]
        tie = tags[MODEL_TIEPOINT]
        i, j, _, x, y, _ = tie[0:6]
        # Tie point maps pixel (i, j) to world (x, y); y step is negative
        # (north-up) by GeoTIFF convention.
        return (x - i * sx, sx, 0.0, y + j * sy, 0.0, -sy)
    # No geo tags: pixel coordinates.
    return (0.0, 1.0, 0.0, 0.0, 0.0, -1.0)


def read_info(path: Union[str, Path]) -> GeoTiffInfo:
    """Read size and geo metadata without decoding pixel data."""
    PILImage = pil()
    with PILImage.open(str(path)) as im:
        size = im.size
        tags = getattr(im, "tag_v2", {}) or {}
        nodata = None
        if GDAL_NODATA in tags:
            try:
                nodata = float(str(tags[GDAL_NODATA]).strip().strip("\x00"))
            except ValueError:
                nodata = None
        crs = None
        if GEO_ASCII_PARAMS in tags:
            crs = str(tags[GEO_ASCII_PARAMS]).strip("\x00").strip("|") or None
        transform = _transform_from_tags(tags, size)
        n_bands = len(im.getbands())
        n_frames = getattr(im, "n_frames", 1)
        if n_frames > 1 and n_bands == 1:
            n_bands = n_frames  # one band per page (see read/write)
        a = np.asarray(im.crop((0, 0, 1, 1)))
        return GeoTiffInfo(
            size=size,
            transform=transform,
            nodata=nodata,
            crs=crs,
            n_bands=n_bands,
            dtype=a.dtype,
        )


def read(
    path: Union[str, Path],
    band: Optional[int] = None,
    window: Optional[Tuple[int, int, int, int]] = None,
    out_size: Optional[Tuple[int, int]] = None,
) -> np.ndarray:
    """Decode pixel data.

    Arguments:
        band: 1-based band index, or None for all bands stacked on axis 2.
        window: Crop (left, top, right, bottom) in pixel coordinates.
        out_size: Resample decoded region to (nx, ny) (nearest for masks,
            bilinear otherwise), mirroring GDAL's buf_xsize/buf_ysize reads.
    """
    PILImage = pil()

    def _decode(im):
        if window is not None:
            im = im.crop(tuple(int(v) for v in window))
        if out_size is not None and tuple(out_size) != im.size:
            im = im.resize(
                (int(out_size[0]), int(out_size[1])), PILImage.BILINEAR
            )
        return np.asarray(im)

    with PILImage.open(str(path)) as im:
        n_frames = getattr(im, "n_frames", 1)
        if n_frames > 1:
            # Multi-page TIFF: pages are bands (the writer below emits one
            # float band per page).
            if band is not None:
                im.seek(band - 1)
                return _decode(im)
            pages = []
            for i in range(n_frames):
                im.seek(i)
                pages.append(_decode(im))
            return np.stack(pages, axis=2)
        a = _decode(im)
    if a.ndim == 3 and band is not None:
        a = a[:, :, band - 1]
    return a


def apply_nodata(a: np.ndarray, nodata: Optional[float]) -> np.ndarray:
    """Replace nodata values with NaN (casting to float as needed)."""
    if nodata is None:
        return a
    if not np.issubdtype(a.dtype, np.floating):
        a = a.astype(float)
    else:
        a = a.copy()
    a[a == nodata] = np.nan
    return a


def write(
    path: Union[str, Path],
    a: np.ndarray,
    transform: Optional[Tuple[float, ...]] = None,
    crs: Optional[str] = None,
    nodata: Optional[float] = None,
) -> None:
    """Write an array as a (Geo)TIFF.

    NaN values are replaced by ``nodata`` (default -9999 for float arrays
    containing NaN). Multi-band arrays (H, W, D) write D samples per pixel.
    """
    from PIL import TiffImagePlugin, TiffTags

    PILImage = pil()
    path = str(path)
    a = np.asarray(a)
    if np.issubdtype(a.dtype, np.floating):
        has_nan = np.isnan(a).any()
        if has_nan and nodata is None:
            nodata = -9999.0
        if nodata is not None and has_nan:
            a = np.where(np.isnan(a), nodata, a)
        a = a.astype(np.float32)
        mode = "F"
    elif a.dtype == np.uint8:
        mode = None  # let Pillow infer (L or RGB)
    else:
        a = a.astype(np.int32)
        mode = "I"
    info = TiffImagePlugin.ImageFileDirectory_v2()
    if transform is not None:
        x0, dx, _, y0, _, dy = transform
        info[MODEL_PIXEL_SCALE] = (abs(dx), abs(dy), 0.0)
        info[MODEL_TIEPOINT] = (0.0, 0.0, 0.0, float(x0), float(y0), 0.0)
        info.tagtype[MODEL_PIXEL_SCALE] = TiffTags.DOUBLE
        info.tagtype[MODEL_TIEPOINT] = TiffTags.DOUBLE
    if nodata is not None:
        info[GDAL_NODATA] = str(nodata)
        info.tagtype[GDAL_NODATA] = TiffTags.ASCII
    if crs is not None:
        info[GEO_ASCII_PARAMS] = str(crs)
        info.tagtype[GEO_ASCII_PARAMS] = TiffTags.ASCII
    if a.ndim == 3 and a.shape[2] == 1:
        a = a[:, :, 0]
    if a.ndim == 3:
        # Multi-band float TIFF: write interleaved via raw encoder.
        bands = [PILImage.fromarray(a[:, :, i]) for i in range(a.shape[2])]
        bands[0].save(path, tiffinfo=info, save_all=True, append_images=bands[1:])
    else:
        im = PILImage.fromarray(a, mode=mode) if mode else PILImage.fromarray(a)
        im.save(path, tiffinfo=info)
