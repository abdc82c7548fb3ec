"""Distorted camera model: world <-> image coordinate conversion.

The counterpart of :class:`glimpse_tpu.Camera`. All math lives in
:mod:`glimpse_tpu_torch.ops.projection` as functions on tensors: this class
keeps float64 NumPy at its surface and calls them on float64 CPU tensors that
share the arrays' memory (a projection round trip stays under 1e-9 px), while
the device paths (tracking, stabilization) call the same functions with
float32 tensors on the card.
"""
import copy
from pathlib import Path
from typing import Any, Dict, Iterable, Optional, Tuple, Union

import numpy as np
import torch

from . import helpers
from .ops import projection as proj

Number = Union[int, float]
Vector = Union[Number, Iterable[Number], np.ndarray]


def _tensor(a) -> torch.Tensor:
    """A float64 CPU tensor over an array's memory where the array allows it."""
    return torch.as_tensor(np.asarray(a, dtype=float))


class Camera:
    """Distorted camera model over a 20-float parameter vector.

    Parameters: position ``xyz``, view direction ``viewdir`` (yaw, pitch,
    roll in degrees), image size ``imgsz``, focal length ``f`` (px),
    principal point offset ``c`` (px), radial distortion ``k`` (k1..k6,
    rational model), tangential distortion ``p`` (p1, p2). Focal length and
    principal point may instead be given in mm (``fmm``, ``cmm``) together
    with ``sensorsz``.

    ``correction`` enables earth-curvature + atmospheric-refraction
    correction when projecting absolute world coordinates: `False` to skip,
    `True` for defaults, or a dict with ``radius`` and/or ``refraction``.

    Example (projection round trip is exact to float64 precision):

        >>> cam = Camera(imgsz=(100, 80), f=90, k=(-0.1, 0.05, 0, 0, 0, 0))
        >>> uv = [[25.0, 60.0], [50.0, 40.0]]
        >>> cam.xyz_to_uv(cam.uv_to_xyz(uv)).round(9).tolist()
        [[25.0, 60.0], [50.0, 40.0]]
        >>> cam.uv_to_xyz([[50.0, 40.0]]).round(9).tolist()  # optical axis
        [[0.0, 1.0, 0.0]]
    """

    def __init__(
        self,
        imgsz: Vector,
        f: Vector = None,
        c: Vector = None,
        sensorsz: Vector = None,
        fmm: Vector = None,
        cmm: Vector = None,
        k: Vector = (0, 0, 0, 0, 0, 0),
        p: Vector = (0, 0),
        xyz: Vector = (0, 0, 0),
        viewdir: Vector = (0, 0, 0),
        correction: Union[bool, dict] = False,
    ) -> None:
        if imgsz is None:
            raise ValueError("Image size (imgsz) cannot be None")
        self._vector = np.full(20, np.nan, dtype=float)
        self.imgsz = imgsz
        self.sensorsz = sensorsz
        self.xyz = xyz
        self.viewdir = viewdir
        self.f = self._resolve_px_units("f", px=f, mm=fmm, required=True)
        self.c = self._resolve_px_units("c", px=c, mm=cmm, required=False)
        self.k = k
        self.p = p
        self.correction = self._normalize_correction(correction)
        self._original_vector = self._vector.copy()

    def _resolve_px_units(self, name, px, mm, required):
        """Resolve a parameter given in pixels or millimeters (not both)."""
        if mm is None:
            if px is not None:
                return px
            if required:
                raise ValueError(f"Focal length ({name} or {name}mm) is missing")
            return (0, 0)
        if px is not None:
            what = "Focal length" if name == "f" else "Principal point offset"
            raise ValueError(
                f"{what} provided in both pixels and mm ({name}, {name}mm)"
            )
        if self.sensorsz is None:
            raise ValueError("Attributes in mm (fmm, cmm) provided without sensor size")
        pitch = self.imgsz / self.sensorsz  # px per mm, per axis
        return helpers.format_list(mm, length=2) * pitch

    @staticmethod
    def _normalize_correction(correction):
        """Expand a curvature/refraction spec to a full dict (or False)."""
        if correction is True:
            overrides = {}
        elif isinstance(correction, dict):
            overrides = correction
        else:
            return correction
        return {
            "radius": proj.EARTH_RADIUS,
            "refraction": proj.REFRACTION,
            **overrides,
        }

    # ---- Vector-slice properties ---- #

    @property
    def xyz(self) -> np.ndarray:
        """Position in world coordinates (x, y, z)."""
        return self._vector[proj.XYZ]

    @xyz.setter
    def xyz(self, value: Vector) -> None:
        self._vector[proj.XYZ] = helpers.format_list(value, length=3, default=0)

    @property
    def viewdir(self) -> np.ndarray:
        """View direction in degrees (yaw, pitch, roll)."""
        return self._vector[proj.VIEWDIR]

    @viewdir.setter
    def viewdir(self, value: Vector) -> None:
        self._vector[proj.VIEWDIR] = helpers.format_list(value, length=3, default=0)

    @property
    def imgsz(self) -> np.ndarray:
        """Image size in pixels (nx, ny)."""
        return self._vector[proj.IMGSZ].astype(int)

    @imgsz.setter
    def imgsz(self, value: Vector) -> None:
        as_int = helpers.format_list(value, length=2, dtype=int)
        as_float = helpers.format_list(value, length=2)
        if np.any(np.asarray(as_int) != np.asarray(as_float)):
            raise ValueError("Image size is not integer")
        self._vector[proj.IMGSZ] = as_int

    @property
    def f(self) -> np.ndarray:
        """Focal length in pixels (fx, fy)."""
        return self._vector[proj.F]

    @f.setter
    def f(self, value: Vector) -> None:
        self._vector[proj.F] = helpers.format_list(value, length=2)

    @property
    def c(self) -> np.ndarray:
        """Principal point offset from the image center in pixels (dx, dy)."""
        return self._vector[proj.C]

    @c.setter
    def c(self, value: Vector) -> None:
        self._vector[proj.C] = helpers.format_list(value, length=2, default=0)

    @property
    def k(self) -> np.ndarray:
        """Radial distortion coefficients (k1..k6)."""
        return self._vector[proj.K]

    @k.setter
    def k(self, value: Vector) -> None:
        self._vector[proj.K] = helpers.format_list(value, length=6, default=0)

    @property
    def p(self) -> np.ndarray:
        """Tangential distortion coefficients (p1, p2)."""
        return self._vector[proj.P]

    @p.setter
    def p(self, value: Vector) -> None:
        self._vector[proj.P] = helpers.format_list(value, length=2, default=0)

    @property
    def sensorsz(self) -> Optional[np.ndarray]:
        """Sensor size in millimeters (nx, ny)."""
        return self._sensorsz

    @sensorsz.setter
    def sensorsz(self, value: Vector = None) -> None:
        if value is not None:
            value = np.array(helpers.format_list(value, length=2), dtype=float)
        self._sensorsz = value

    @property
    def fmm(self) -> Optional[np.ndarray]:
        """Focal length in millimeters (fx, fy)."""
        if self.sensorsz is None:
            return None
        return self.f * self.sensorsz / self.imgsz

    @fmm.setter
    def fmm(self, value: Vector) -> None:
        if self.sensorsz is None:
            raise ValueError("Sensor size is required")
        self.f = helpers.format_list(value, length=2) * self.imgsz / self.sensorsz

    @property
    def cmm(self) -> Optional[np.ndarray]:
        """Principal point offset from the image center in millimeters (dx, dy)."""
        if self.sensorsz is None:
            return None
        return self.c * self.sensorsz / self.imgsz

    @cmm.setter
    def cmm(self, value: Vector) -> None:
        if self.sensorsz is None:
            raise ValueError("Sensor size is required")
        self.c = (
            helpers.format_list(value, length=2, default=0) * self.imgsz / self.sensorsz
        )

    @property
    def R(self) -> np.ndarray:
        """Rotation matrix equivalent of :attr:`viewdir` (3, 3)."""
        return proj.rotation_matrix(_tensor(self.viewdir)).numpy()

    @property
    def Rprime(self) -> np.ndarray:
        """Derivative of :attr:`R` with respect to :attr:`viewdir` (3, 3, 3)."""
        return proj.rotation_matrix_gradient(_tensor(self.viewdir)).numpy()

    @property
    def _correction_tuple(self) -> Optional[Tuple[float, float]]:
        """Correction constants as a (radius, refraction) tuple, or None."""
        if isinstance(self.correction, dict):
            return (self.correction["radius"], self.correction["refraction"])
        return None

    # ---- Constructors ---- #

    @classmethod
    def from_json(cls, path: Union[str, Path], **kwargs: Any) -> "Camera":
        """Read Camera from a JSON file. See :meth:`to_json` for the reverse."""
        json_args = helpers.read_json(path)
        for key in list(json_args):
            value = json_args[key]
            if isinstance(value, (bool, dict)) or value is None:
                # Non-numeric parameters (e.g. correction) pass through.
                continue
            value = np.array(value, dtype=float)
            if np.isnan(value).all():
                value = None
            json_args[key] = value
        args = {**json_args, **kwargs}
        return cls(**args)

    # ---- State management ---- #

    def copy(self) -> "Camera":
        """Return a copy whose original (reset) state is this camera's current state."""
        cam = copy.deepcopy(self)
        cam._original_vector = cam._vector.copy()
        return cam

    def reset(self) -> None:
        """Reset this camera to its original state."""
        self._vector = self._original_vector.copy()

    def to_array(self) -> np.ndarray:
        """Return the 20-float camera parameter vector."""
        return self._vector.copy()

    def to_dict(
        self,
        attributes: Iterable[str] = (
            "xyz", "viewdir", "imgsz", "f", "c", "k", "p", "correction",
        ),
    ) -> Dict[str, Any]:
        """Return selected attributes as a dictionary of native Python types."""
        return {key: helpers.numpy_to_native(getattr(self, key)) for key in attributes}

    def to_json(
        self,
        path: Union[str, Path] = None,
        attributes: Iterable[str] = (
            "xyz", "viewdir", "imgsz", "f", "c", "k", "p", "correction",
        ),
        **kwargs: Any,
    ) -> Optional[str]:
        """Write or return this camera as JSON. See :meth:`from_json` for the reverse."""
        obj = self.to_dict(attributes=attributes)
        return helpers.write_json(obj, path=path, **kwargs)

    def idealize(self) -> None:
        """Remove all distortions (zero :attr:`c`, :attr:`k`, :attr:`p`)."""
        self.k = np.zeros(6, dtype=float)
        self.p = np.zeros(2, dtype=float)
        self.c = np.zeros(2, dtype=float)

    def resize(self, size: Vector = 1, force: bool = False) -> None:
        """Resize the camera, scaling :attr:`imgsz`, :attr:`f`, and :attr:`c`.

        ``size`` is a scale factor of the *original* image size, or a target
        (nx, ny). Non-aspect-preserving targets are rejected unless ``force``.
        """
        scale1d = np.atleast_1d(size)
        original_size = self._original_vector[proj.IMGSZ]
        if len(scale1d) > 1 and force:
            new_size = scale1d
        else:
            if len(scale1d) > 1:
                scale = helpers.get_scale_from_size(original_size, scale1d)
                if scale is None:
                    raise ValueError(
                        "Target image size does not preserve the original aspect ratio"
                    )
                scale1d = scale
            new_size = np.floor(scale1d * original_size + 0.5)
        scale2d = new_size / self.imgsz
        self.imgsz = np.round(new_size)
        self.f = self.f * scale2d
        self.c = self.c * scale2d

    # ---- Projection ---- #

    def xyz_to_uv(
        self, xyz: np.ndarray, directions: bool = False, return_depth: bool = False
    ) -> Union[np.ndarray, Tuple[np.ndarray, np.ndarray]]:
        """Project world coordinates (n, 3) to image coordinates (n, 2).

        ``directions=True`` treats inputs as ray directions relative to the
        camera (skipping the position offset and elevation correction).
        Points at or behind the camera plane map to NaN.
        """
        out = proj.project(
            _tensor(self._vector),
            _tensor(xyz),
            directions=directions,
            correction=None if directions else self._correction_tuple,
            return_depth=return_depth,
        )
        if return_depth:
            return out[0].numpy(), out[1].numpy()
        return out.numpy()

    def uv_to_xyz(
        self,
        uv: np.ndarray,
        directions: bool = True,
        depth: Vector = 1,
        method: str = None,
        **kwargs: Any,
    ) -> np.ndarray:
        """Project image coordinates (n, 2) to world ray directions or coordinates.

        ``method`` selects the undistortion solver for numerically inverted
        distortion models: "oulu" (default), "lookup", or "regulafalsi"
        ("k1" closed-form and the identity are chosen automatically when the
        coefficients allow).
        Non-reversible multi-coefficient cameras should use "lookup" or
        "regulafalsi", as the Oulu fixed point may not converge there.
        """
        return proj.unproject(
            self._vector, _tensor(uv), directions=directions, depth=depth,
            method=method or self._undistort_method(), **kwargs,
        ).numpy()

    def _undistort_method(self) -> str:
        """Default undistortion solver for this camera's coefficients.

        Closed-form for k1-only (exact under extreme distortion), Oulu fixed
        point otherwise; ``ops.projection.undistort`` makes the same choice
        from concrete coefficients. Callers can override per call via the
        ``method`` argument of :meth:`uv_to_xyz` / :meth:`_uv_to_xy`.
        """
        return "oulu"

    def infront(self, xyz: np.ndarray, directions: bool = False) -> np.ndarray:
        """Test whether world coordinates are in front of the camera."""
        return proj.infront(_tensor(self._vector), _tensor(xyz), directions=directions).numpy()

    def inframe(self, uv: np.ndarray) -> np.ndarray:
        """Test whether image coordinates are in (or on) the image frame."""
        return proj.inframe(_tensor(self._vector), _tensor(uv)).numpy()

    # ---- Image-plane geometry ---- #

    def grid(
        self, step: Vector = 1, snap: Iterable[float] = (0.5, 0.5), mode: str = "points"
    ) -> Union[np.ndarray, Tuple[np.ndarray, np.ndarray]]:
        """Return a grid of image coordinates covering the frame."""
        box = (0, 0, self.imgsz[0], self.imgsz[1])
        return helpers.box_to_grid(box, step=step, snap=snap, mode=mode)

    def edges(self, step: Vector = 1) -> np.ndarray:
        """Return coordinates of image edges, clockwise from the origin.

        The perimeter is generated as four corner-to-corner sides, each
        side dropping its final vertex (which starts the next side).
        """
        if isinstance(step, (int, float)):
            step = (step, step)
        w, h = float(self.imgsz[0]), float(self.imgsz[1])
        nu = int(w / step[0] + 1)
        nv = int(h / step[1] + 1)
        corners = [(0.0, 0.0), (w, 0.0), (w, h), (0.0, h), (0.0, 0.0)]
        counts = [nu, nv, nu, nv]
        sides = []
        for (x0, y0), (x1, y1), n in zip(corners[:-1], corners[1:], counts):
            side = np.column_stack((np.linspace(x0, x1, n), np.linspace(y0, y1, n)))
            sides.append(side[:-1])
        return np.concatenate(sides)

    def viewbox(self, depth: Number) -> np.ndarray:
        """Bounding box of the viewshed built from edge pixels projected to depth."""
        uv = self.edges()
        dxyz = self.uv_to_xyz(uv, depth=depth, directions=False)
        vertices = np.vstack((self.xyz, dxyz))
        return helpers.bounding_box(vertices)

    def viewpoly(self, depth: Number) -> np.ndarray:
        """Bounding polygon of the viewshed through the principal row."""
        principal_row = self.imgsz[1] / 2 + self.c[1]
        corners = self.uv_to_xyz(
            np.column_stack([(0.0, self.imgsz[0]), (principal_row,) * 2]),
            directions=False, depth=depth,
        )
        # Closed triangle: camera -> left edge -> right edge -> camera.
        return np.concatenate([[self.xyz], corners, [self.xyz]], axis=0)

    def set_plot_limits(self) -> None:
        """Set current matplotlib axes limits to the image extent."""
        import matplotlib.pyplot

        matplotlib.pyplot.xlim(0, self.imgsz[0])
        matplotlib.pyplot.ylim(self.imgsz[1], 0)

    def rasterize(self, uv: np.ndarray, values: np.ndarray) -> np.ndarray:
        """Convert image points to a raster of per-pixel mean values (NaN empty)."""
        out = np.full(tuple(self.imgsz[::-1].astype(int)), np.nan)
        keep = self.inframe(uv)
        rows_cols = uv[keep][:, ::-1].astype(int)
        helpers.rasterize_points(
            rows_cols[:, 0], rows_cols[:, 1], values[keep], a=out
        )
        return out

    def spherical_to_xyz(self, angles: np.ndarray) -> np.ndarray:
        """Convert spherical coordinates (azimuth, altitude[, distance]) to world."""
        return proj.spherical_to_xyz(_tensor(self.xyz), _tensor(angles)).numpy()

    def xyz_to_spherical(self, xyz: np.ndarray, directions: bool = False) -> np.ndarray:
        """Convert world coordinates to spherical (azimuth, altitude[, distance])."""
        return proj.xyz_to_spherical(_tensor(self.xyz), _tensor(xyz), directions=directions).numpy()

    # ---- Distortion (private API parity) ---- #

    def _distort(self, xy: np.ndarray) -> np.ndarray:
        return proj.distort(_tensor(xy), _tensor(self.k), _tensor(self.p)).numpy()

    def _undistort(self, xy: np.ndarray, method: str = "oulu", **kwargs: Any):
        return proj.undistort(_tensor(xy), self.k, self.p, method=method, **kwargs).numpy()

    def _xyz_to_xy(
        self, xyz: np.ndarray, directions: bool = False, return_depth: bool = False
    ):
        out = proj.world_to_camera(
            _tensor(xyz),
            _tensor(self.xyz),
            _tensor(self.R),
            directions=directions,
            correction=None if directions else self._correction_tuple,
            return_depth=return_depth,
        )
        if return_depth:
            return out[0].numpy(), out[1].numpy()
        return out.numpy()

    def _xy_to_uv(self, xy: np.ndarray) -> np.ndarray:
        return proj.camera_to_image(
            _tensor(xy), _tensor(self._vector[proj.IMGSZ]), _tensor(self.f),
            _tensor(self.c), _tensor(self.k), _tensor(self.p),
        ).numpy()

    def _uv_to_xy(self, uv: np.ndarray, method: str = None, **kwargs: Any) -> np.ndarray:
        return proj.image_to_camera(
            _tensor(uv), self._vector[proj.IMGSZ], self.f, self.c,
            self.k, self.p, method=method or self._undistort_method(),
            **kwargs,
        ).numpy()

    def _xy_to_xyz(self, xy: np.ndarray, directions: bool = True, depth: Vector = 1):
        return proj.camera_to_world(
            _tensor(xy), _tensor(self.R), cam_xyz=_tensor(self.xyz),
            directions=directions, depth=depth,
        ).numpy()

    def reversible(self) -> bool:
        """Test whether distorted image coordinates increase monotonically.

        Samples each principal axis at pixel resolution and checks that the
        distortion map never reverses direction along it.
        """

        def monotone_along(axis: int) -> bool:
            n = int(self.imgsz[axis])
            half_extent = self.imgsz[axis] / (2 * self.f[axis])
            xy = np.zeros((n, 2))
            xy[:, axis] = np.linspace(-half_extent, half_extent, n)
            distorted = self._distort(xy)[:, axis]
            return not (np.diff(distorted) < 0).any()

        return monotone_along(0) and monotone_along(1)

    def project_dem(
        self,
        dem,
        values: np.ndarray = None,
        mask: np.ndarray = None,
        tile_size: Iterable[int] = (256, 256),
        tile_overlap: Iterable[int] = (1, 1),
        scale: Number = 1,
        scale_limits: Iterable[Number] = (1, 1),
        parallel: Union[bool, int] = False,
        return_depth: bool = False,
    ) -> np.ndarray:
        """Render a simulated image from a DEM.

        Implemented in :func:`glimpse_tpu_torch.render.project_dem`; kept as
        a method under upstream's name.
        """
        from .render import project_dem

        return project_dem(
            self, dem, values=values, mask=mask, tile_size=tile_size,
            tile_overlap=tile_overlap, scale=scale, scale_limits=scale_limits,
            parallel=parallel, return_depth=return_depth,
        )
