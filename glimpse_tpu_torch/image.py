"""Photographic image + camera model + capture time.

The counterpart of :class:`glimpse_tpu.Image`, with Pillow (imported at the
first decode, not with the module) in place of GDAL and the reprojection
(:meth:`project`) running through the sampling ops on tensors. Camera
parameters missing from the constructor are filled from EXIF (imgsz, fmm,
sensorsz) via :class:`glimpse_tpu_torch.Exif`. An image whose ``array`` is
set at the camera's size is read from that array and never decoded.
"""
import datetime as datetime_module
import threading
from pathlib import Path
from typing import Any, Iterable, Optional, Tuple, Union

import numpy as np

from .camera import Camera
from .exif import Exif
from .io import geotiff
from .ops import sampling as sampling_ops


class Image:
    """An image file, its camera model, and its capture time."""

    def __init__(
        self,
        path: Union[str, Path],
        cam: Union[dict, Camera] = None,
        datetime: datetime_module.datetime = None,
        exif: Exif = None,
    ) -> None:
        self.path = str(path)
        self._exif = exif
        if not isinstance(cam, Camera):
            cam = Camera(**self._fill_camera_args(dict(cam or {})))
        self.cam = cam
        self.datetime = datetime if datetime else self._metadata.datetime
        self.exif = self._exif
        self.array: Optional[np.ndarray] = None
        # Guards first-read cache population when Tracker runs per-track
        # worker threads against shared Observers.
        self._cache_lock = threading.Lock()

    def __getstate__(self) -> dict:
        state = self.__dict__.copy()
        state.pop("_cache_lock", None)  # locks don't pickle
        return state

    def __setstate__(self, state: dict) -> None:
        self.__dict__.update(state)
        self._cache_lock = threading.Lock()

    @property
    def _metadata(self) -> Exif:
        """EXIF metadata, parsed from the file on first use."""
        if self._exif is None:
            self._exif = Exif(self.path)
        return self._exif

    def _fill_camera_args(self, args: dict) -> dict:
        """Complete camera constructor kwargs from EXIF where absent.

        imgsz falls back to the file's pixel dimensions; fmm/sensorsz are
        only consulted when no pixel focal length was given.
        """
        focal_known = args.get("f") is not None
        wanted = {
            "imgsz": args.get("imgsz") is None,
            "fmm": not focal_known and args.get("fmm") is None,
            "sensorsz": not focal_known and args.get("sensorsz") is None,
        }
        if not any(wanted.values()):
            return args
        meta = self._metadata
        if wanted["imgsz"]:
            args["imgsz"] = meta.imgsz or self._path_imgsz
        if wanted["fmm"] and meta.fmm:
            args["fmm"] = meta.fmm
        if wanted["sensorsz"] and meta.sensorsz:
            args["sensorsz"] = meta.sensorsz
        return args

    @property
    def size(self) -> np.ndarray:
        """Image size in pixels (nx, ny) per the camera model."""
        return self.cam.imgsz

    @property
    def _path_imgsz(self) -> Tuple[int, int]:
        with geotiff.pil().open(self.path) as im:
            return im.size

    @property
    def _cache_imgsz(self) -> Optional[Tuple[int, int]]:
        if self.array is not None:
            return self.array.shape[1], self.array.shape[0]
        return None

    def read(self, box: Iterable[int] = None, cache: bool = True) -> np.ndarray:
        """Read image data, resized to the camera image size.

        ``box`` crops (left, top, right, bottom) in camera-size pixel
        coordinates. Cached reads slice the cached full image; uncached reads
        decode only the needed window.
        """
        cam_size = tuple(int(v) for v in self.cam.imgsz)
        if box is not None and not cache and self.array is None:
            # Windowed uncached read: decode only the needed region.
            PILImage = geotiff.pil()
            with PILImage.open(self.path) as im:
                xscale = im.size[0] / cam_size[0]
                yscale = im.size[1] / cam_size[1]
                window = (
                    int(round(box[0] * xscale)),
                    int(round(box[1] * yscale)),
                    int(round(box[2] * xscale)),
                    int(round(box[3] * yscale)),
                )
                im = im.crop(window)
                target = (int(box[2] - box[0]), int(box[3] - box[1]))
                if im.size != target:
                    im = im.resize(target, PILImage.BILINEAR)
                return np.asarray(im)
        with self._cache_lock:
            array = self.array
            stale = array is not None and (array.shape[1], array.shape[0]) != cam_size
            if array is None or stale:
                PILImage = geotiff.pil()
                with PILImage.open(self.path) as im:
                    if im.size != cam_size:
                        im = im.resize(cam_size, PILImage.BILINEAR)
                    array = np.asarray(im)
                if cache:
                    self.array = array
        if box is not None:
            array = array[int(box[1]) : int(box[3]), int(box[0]) : int(box[2])]
        return array

    def write(self, path: Union[str, Path], array: np.ndarray = None, **kwargs: Any) -> None:
        """Write image data to a file (TIFF via the GeoTIFF codec, else Pillow)."""
        if array is None:
            array = self.read()
        path = str(path)
        if path.lower().endswith((".tif", ".tiff")):
            geotiff.write(path, array, **kwargs)
        else:
            geotiff.pil().fromarray(np.asarray(array)).save(path)

    def plot(self, **kwargs: Any):
        """Plot with the upper-left pixel corner at (0, 0)."""
        import matplotlib.pyplot

        array = self.read()
        height, width = array.shape[:2]
        kwargs.setdefault("origin", "upper")
        kwargs.setdefault("extent", (0, width, height, 0))
        return matplotlib.pyplot.imshow(array, **kwargs)

    def set_plot_limits(self) -> None:
        """Set plot limits to the image extent."""
        self.cam.set_plot_limits()

    def xyz_to_uv(self, xyz: np.ndarray, **kwargs: Any) -> np.ndarray:
        """Project world coordinates to image coordinates (see Camera)."""
        return self.cam.xyz_to_uv(xyz, **kwargs)

    def uv_to_xyz(self, uv: np.ndarray, directions: bool = False, **kwargs: Any) -> np.ndarray:
        """Project image coordinates to world coordinates (see Camera)."""
        return self.cam.uv_to_xyz(uv, directions=directions, **kwargs)

    def inbounds(self, uv: np.ndarray) -> np.ndarray:
        """Whether image coordinates are in (or on) the frame."""
        return self.cam.inframe(uv)

    def project(self, cam: Camera, method: str = "linear") -> np.ndarray:
        """Project this image into another camera at the same position.

        Inverse-grid warping: each target pixel is cast out through ``cam``
        and sampled in this image, with the resampling done by the
        bilinear and nearest ops.
        """
        if not all(cam.xyz == self.cam.xyz):
            raise ValueError(
                "Source and target cameras have different positions ('xyz')"
            )
        nx, ny = int(cam.imgsz[0]), int(cam.imgsz[1])
        u = np.linspace(0.5, cam.imgsz[0] - 0.5, nx)
        v = np.linspace(0.5, cam.imgsz[1] - 0.5, ny)
        U, V = np.meshgrid(u, v)
        uv = np.column_stack((U.ravel(), V.ravel()))
        dxyz = cam.uv_to_xyz(uv)
        puv = self.cam.xyz_to_uv(dxyz, directions=True)
        # Fractional source indices (pixel centers at half-integers).
        rows = puv[:, 1] - 0.5
        cols = puv[:, 0] - 0.5
        array = self.read()
        if array.ndim < 3:
            array = array[:, :, None]
        H, W = array.shape[0:2]
        oob = (
            np.isnan(rows) | np.isnan(cols)
            | (rows < -0.5) | (rows > H - 0.5) | (cols < -0.5) | (cols > W - 0.5)
        )
        rows_safe = np.where(oob, 0.0, rows)
        cols_safe = np.where(oob, 0.0, cols)
        order = {"linear": 1, "nearest": 0}[method]
        projected = np.full((ny, nx, array.shape[2]), np.nan, dtype=float)
        for i in range(array.shape[2]):
            vals = sampling_ops.sample_grid_host(
                array[:, :, i], rows_safe, cols_safe, order=order
            )
            vals[oob] = np.nan
            projected[:, :, i] = vals.reshape(ny, nx)
        return projected.astype(array.dtype) if np.issubdtype(
            array.dtype, np.floating
        ) else projected
