"""Camera calibration and sequence stabilization.

The counterpart of :mod:`glimpse_tpu.optimize`:

- the control classes (:class:`Points`, :class:`Lines`, :class:`Matches`,
  :class:`RotationMatches`, :class:`RotationMatchesXY`), :class:`Polynomial`
  and :func:`ransac`, host NumPy on the port's :class:`~.camera.Camera`;
- :class:`Cameras`, the bundle adjustment over masked camera parameters
  driven by :func:`scipy.optimize.least_squares`, whose exact Jacobian is
  ``torch.func.jacfwd`` over :mod:`.ops.projection` in float64 on ``device``;
- :class:`RotationMatchesXYZ`, one image pair's matches as undistorted
  normalized camera coordinates (``xys``), from cameras or camera vectors;
- :class:`ObserverCameras`, the view directions of one observer's images
  that minimize the smoothed L1 norm of unit-ray differences over all
  matches, with anchor frames held fixed: a chained Procrustes start
  (:meth:`ObserverCameras.initialize`) and the fit on an autograd objective
  (:meth:`ObserverCameras.fit`);
- keypoints: :func:`detect_keypoints` and :func:`match_keypoints` (OpenCV
  SIFT and FLANN on the host, imported at first use), their device
  counterparts over :mod:`.ops.features` and :mod:`.ops.matching`, and
  :class:`KeypointMatcher`, which detects, matches, refines and caches
  (pickles) over a whole image sequence;
- :func:`project_images`, a sequence reprojected into one ideal camera,
  sampled in float64 on ``device``.
"""
import collections
import functools
import math
from pathlib import Path
from typing import Any, Dict, Generator, Iterable, List, Optional, Tuple, Type, Union

import numpy as np
import scipy.optimize
import scipy.sparse
import torch

from . import config, graphs, helpers
from .camera import Camera
from .ops import features, projection
from .ops.matching import DescriptorMatcher, full_float32

Index = Union[slice, Iterable[int]]
CamIndex = Union[int, "Camera"]
Number = Union[int, float]


# ---- Control objects ---- #
# Controls support RANSAC via: .size, .observed(index), .predicted(index).


def _float_pair(arrays):
    """Coerce a pair of coordinate arrays to float, passing None through."""
    if arrays is None:
        return None
    return [np.asarray(a, dtype=float) for a in arrays]


class Points:
    """Image-world point correspondences.

    World coordinates project through the camera and compare against their
    observed image coordinates.
    """

    def __init__(self, cam: Camera, uv, xyz, directions: bool = False) -> None:
        uv = np.asarray(uv, dtype=float)
        xyz = np.asarray(xyz, dtype=float)
        if uv.shape[0] != xyz.shape[0]:
            raise ValueError("Image and world coordinates have different length")
        self.cam = cam
        self.uv = uv
        self.xyz = xyz
        self.directions = directions
        self._remember_camera_state()

    def _remember_camera_state(self) -> None:
        """Snapshot camera position/size for later invalidation checks."""
        self._position = self.cam.xyz.copy()
        self._imgsz = self.cam.imgsz.copy()

    @property
    def size(self) -> int:
        """Number of point pairs."""
        return len(self.uv)

    def observed(self, index: Index = slice(None)) -> np.ndarray:
        """Observed image coordinates."""
        return self.uv[index]

    def _test_position(self) -> None:
        if self.directions and any(self.cam.xyz != self._position):
            raise ValueError(
                "Camera position has changed and world coordinates are ray directions"
            )

    def predicted(self, index: Index = slice(None)) -> np.ndarray:
        """Image coordinates predicted by projecting the world coordinates."""
        self._test_position()
        return self.cam.xyz_to_uv(self.xyz[index], directions=self.directions)

    def _scale(self, scale: np.ndarray) -> None:
        if np.any(scale != 1):
            self.uv = self.uv * scale

    def resize(self, size=None, force: bool = False) -> None:
        """Resize the camera and image coordinates together."""
        if size is not None:
            self.cam.resize(size=size, force=force)
        self._scale(self.cam.imgsz / self._imgsz)
        self._imgsz = self.cam.imgsz.copy()

    def plot(self, index: Index = slice(None), selected="red", unselected="gray",
             **kwargs: Any) -> dict:
        """Plot reprojection errors as quivers (observed -> predicted)."""
        return _plot_quivers(
            self.observed(), self.predicted(), self.cam, index, selected,
            unselected, **kwargs,
        )


class Lines(Points):
    """Image-world line correspondences.

    World polylines are projected, clipped to the frame, resampled to a
    pixel density, and each observed image point matches its nearest
    projected point.
    """

    def __init__(self, cam: Camera, uvs, xyzs, directions: bool = False,
                 density: float = 1) -> None:
        self.cam = cam
        self.xyzs = xyzs
        self.directions = directions
        self.density = density
        self.uvs = _float_pair(uvs) or []
        self.uv = np.vstack(self.uvs)
        self._remember_camera_state()

    def _frame_window_xy(self) -> np.ndarray:
        """Bounding box, in normalized camera coordinates, spanned by the
        frame edges (computed from densified edge samples so distortion
        wrap-around cannot leak lines outside the view)."""
        edge_xy = self.cam._uv_to_xy(self.cam.edges(step=self.cam.imgsz / 2))
        return np.concatenate([edge_xy.min(axis=0), edge_xy.max(axis=0)])

    def _project_xyzs(self) -> List[np.ndarray]:
        """Project world lines into the image at the target pixel density.

        Two phases: (1) project every
        polyline to normalized coordinates and split out the runs in front
        of the camera; (2) clip those runs to the frame window, densify to
        the target pixel step, and distort into pixels. If clipping leaves
        nothing in frame, the in-front runs are projected raw instead.
        """
        in_front: List[np.ndarray] = []
        for xyz in self.xyzs:
            xy = self.cam._xyz_to_xy(np.asarray(xyz), directions=self.directions)
            in_front += helpers.boolean_split(
                xy, np.isnan(xy[:, 0]), include="false"
            )
        window = self._frame_window_xy()
        step = 1.0 / (self.density * self.cam.f.max())
        visible = [
            helpers.interpolate_line(np.asarray(run), dx=step)
            for segment in in_front
            for run in helpers.clip_polyline_box(segment, window)
        ]
        return [self.cam._xy_to_uv(xy) for xy in (visible or in_front)]

    def predicted(self, index: Index = slice(None)) -> np.ndarray:
        """Nearest projected world-line point for each observed image point."""
        self._test_position()
        candidates = np.concatenate(self._project_xyzs(), axis=0)
        d2 = helpers.pairwise_distance(
            self.observed(index=index), candidates, metric="sqeuclidean"
        )
        return candidates[d2.argmin(axis=1)]

    def _world_candidates(self, budget: int = 4096) -> np.ndarray:
        """Fixed world-space densification for the autodiff Jacobian path.

        The host ``predicted`` pipeline densifies AFTER projection and
        clipping (data-dependent shapes);
        the traceable path fixes the candidate set in WORLD space
        instead: each polyline segment gets points in proportion to its
        projected image length under the current camera (target spacing
        ~1/density px), capped at ``budget`` points total. Projecting
        these fixed points is differentiable; visibility and the
        nearest-candidate assignment are resolved with masks inside the
        traced residual (the assignment is held fixed under
        differentiation — the standard ICP-style semi-smooth Jacobian,
        which is also what finite differences of the host path measure
        away from assignment switches).
        """
        segs: List[Tuple[np.ndarray, np.ndarray]] = []
        want: List[float] = []
        for xyz in self.xyzs:
            xyz = np.asarray(xyz, dtype=float)
            uv = self.cam.xyz_to_uv(xyz, directions=self.directions)
            d = np.linalg.norm(np.diff(uv, axis=0), axis=1)
            # Behind-camera segments keep a nominal count: they are
            # masked while invisible but can swing into view mid-fit.
            d = np.where(np.isfinite(d), d, 32.0)
            for i in range(len(xyz) - 1):
                segs.append((xyz[i], xyz[i + 1]))
                want.append(max(float(d[i]) * self.density, 1.0))
        counts = np.maximum(np.ceil(np.asarray(want)).astype(int), 1)
        total = int(counts.sum()) + len(self.xyzs)
        if total > budget:
            scale = (budget - len(self.xyzs)) / max(counts.sum(), 1)
            counts = np.maximum((counts * scale).astype(int), 1)
        pts = []
        for (a, b), c in zip(segs, counts):
            frac = np.arange(c, dtype=float)[:, None] / c
            pts.append(a[None, :] + (b - a)[None, :] * frac)
        # Closing endpoints (one per polyline).
        for xyz in self.xyzs:
            pts.append(np.asarray(xyz, dtype=float)[-1:])
        return np.concatenate(pts, axis=0)

    def _scale(self, scale: np.ndarray) -> None:
        if np.any(scale != 1):
            self.uvs = [uv * scale for uv in self.uvs]
            self.uv = self.uv * scale

    def plot(self, index: Index = slice(None), selected="red", unselected="gray",
             observed="green", predicted="yellow", **kwargs: Any) -> dict:
        """Plot observed/predicted lines and reprojection-error quivers."""
        import matplotlib.pyplot as plt

        result = {}
        for uvs, args, label in [
            (self.uvs, observed, "observed"),
            (self._project_xyzs(), predicted, "predicted"),
        ]:
            if args is None:
                result[label] = None
                continue
            if not isinstance(args, dict):
                args = {"color": args}
            result[label] = [
                plt.plot(uv[:, 0], uv[:, 1], **args)[0] for uv in uvs
            ]
        result.update(
            _plot_quivers(
                self.observed(), self.predicted(), self.cam, index, selected,
                unselected, **kwargs,
            )
        )
        return result


class Matches:
    """Image-image point correspondences between co-located cameras.

    Points from one camera are cast out as rays and projected into the
    other.
    """

    def __init__(self, cams, uvs, weights=None) -> None:
        self.cams = cams
        self.weights = weights
        self.uvs = _float_pair(uvs) if uvs else uvs
        self._test_matches()
        self._test_position()
        self._imgszs = [cam.imgsz.copy() for cam in cams]

    @property
    def size(self) -> int:
        """Number of point pairs."""
        return len(self.uvs[0]) if self.uvs else len(self.xys[0])

    def _test_matches(self) -> None:
        coords = self.uvs if self.uvs else getattr(self, "xys", None)
        a, b = self.cams[0], self.cams[1]
        if a is b:
            raise ValueError("Both cameras are the same object")
        if not (len(self.cams) == 2 == len(coords)):
            raise ValueError(
                "Cameras and point coordinates do not have two elements each"
            )
        if len(coords[0]) != len(coords[1]):
            raise ValueError("Camera point coordinates do not have the same length")

    def _test_position(self) -> None:
        if any(self.cams[0].xyz != self.cams[1].xyz):
            raise ValueError("Cameras have different positions")

    def _cam_index(self, cam: CamIndex) -> int:
        if isinstance(cam, int):
            if cam >= len(self.cams):
                raise IndexError("Camera index out of range")
            return cam
        return list(self.cams).index(cam)

    def observed(self, cam: CamIndex = 0, index: Index = slice(None)) -> np.ndarray:
        """Observed image coordinates in one camera."""
        return self.uvs[self._cam_index(cam)][index]

    def predicted(self, cam: CamIndex = 0, index: Index = slice(None)) -> np.ndarray:
        """Image coordinates predicted from the other camera's observations."""
        self._test_position()
        into = self._cam_index(cam)
        rays = self.cams[1 - into].uv_to_xyz(self.uvs[1 - into][index])
        return self.cams[into].xyz_to_uv(rays, directions=True)

    def to_type(self, mtype: Type["Matches"]) -> "Matches":
        """Convert to another matches type."""
        if mtype is type(self):
            return self
        return mtype(cams=self.cams, uvs=self.uvs, weights=self.weights)

    def resize(self, size=None, force: bool = False) -> None:
        """Resize the cameras and their image coordinates together."""
        for i, (cam, old_size) in enumerate(zip(self.cams, self._imgszs)):
            if size is not None:
                cam.resize(size=size, force=force)
            if np.array_equal(cam.imgsz, old_size):
                continue
            self.uvs[i] = self.uvs[i] * (cam.imgsz / old_size)
            self._imgszs[i] = cam.imgsz.copy()

    def filter(
        self,
        n_best: int = None,
        min_weight: float = None,
        cam: CamIndex = 0,
        max_error: float = None,
        max_distance: float = None,
        scaled: bool = False,
    ) -> None:
        """Keep matches by weight rank, reprojection error, or pair distance."""
        if (n_best or min_weight) and self.weights is None:
            raise ValueError("Filtering on weights failed since these are missing")
        keep = np.ones(self.size, dtype=bool)
        if self.weights is not None:
            if n_best:
                ranked = np.argsort(-self.weights)
                keep[ranked[min(n_best, self.size):]] = False
            if min_weight:
                keep &= self.weights >= min_weight
        ci = self._cam_index(cam)
        co = 1 - ci
        unit = self.cams[ci].imgsz[0] if scaled else 1.0
        if max_error:
            live = np.flatnonzero(keep)
            residuals = self.predicted(ci, index=live) - self.observed(ci, index=live)
            keep[live] &= np.hypot(residuals[:, 0], residuals[:, 1]) <= max_error * unit
        if max_distance and keep.any():
            live = np.flatnonzero(keep)
            to_ci = self.cams[ci].imgsz / self.cams[co].imgsz
            shifts = self.observed(co, index=live) * to_ci - self.observed(
                ci, index=live
            )
            keep[live] &= (
                np.hypot(shifts[:, 0], shifts[:, 1]) <= max_distance * unit
            )
        self._apply_selection(keep)

    def _apply_selection(self, keep: np.ndarray) -> None:
        """Drop matches outside the boolean selection, in place.

        Both pixel (uvs) and normalized (xys) coordinates are filtered when
        present, keeping RotationMatches' two representations in sync.
        """
        if self.uvs:
            self.uvs = [uv[keep] for uv in self.uvs]
        if getattr(self, "xys", None) is not None:
            self.xys = [xy[keep] for xy in self.xys]
        if self.weights is not None:
            self.weights = self.weights[keep]

    def plot(self, cam: CamIndex = 0, index: Index = slice(None), selected="red",
             unselected="gray", **kwargs: Any) -> dict:
        """Plot reprojection errors as quivers in one camera."""
        c = self._cam_index(cam)
        return _plot_quivers(
            self.observed(cam=cam), self.predicted(cam=cam), self.cams[c], index,
            selected, unselected, **kwargs,
        )


class RotationMatches(Matches):
    """Matches between cameras separated by a pure rotation.

    Normalized camera coordinates are precomputed, so camera internals must
    not change after construction.
    """

    def __init__(self, cams, uvs=None, xys=None, weights=None) -> None:
        if uvs is None and xys is None:
            raise ValueError("Both uvs and xys are missing")
        self.cams = cams
        self.weights = weights
        self.uvs = _float_pair(uvs)
        self.xys = _float_pair(xys)
        if self.xys is None:
            self.xys = [c._uv_to_xy(uv) for c, uv in zip(cams, self.uvs)]
        elif self.uvs is None:
            self.uvs = [c._xy_to_uv(xy) for c, xy in zip(cams, self.xys)]
        self._test_matches()
        self._snapshot_internals()

    def _snapshot_internals(self) -> None:
        """Record imgsz/f/c/k/p, which must not change after construction."""
        self._internals = [cam.to_array()[6:] for cam in self.cams]

    def _test_internals(self) -> None:
        if any(
            (cam._vector[6:] != v).any() for cam, v in zip(self.cams, self._internals)
        ):
            raise ValueError(
                "Camera internal parameters (imgsz, f, c, k, p) have changed"
            )

    def predicted(self, cam: CamIndex = 0, index: Index = slice(None)) -> np.ndarray:
        """Image coordinates predicted via the precomputed camera coordinates."""
        self._test_position()
        self._test_internals()
        into = self._cam_index(cam)
        rays = self.cams[1 - into]._xy_to_xyz(self.xys[1 - into][index])
        return self.cams[into].xyz_to_uv(rays, directions=True)

    def to_type(self, mtype: Type[Matches]) -> Matches:
        """Convert to another matches type."""
        if mtype is type(self):
            return self
        return mtype(cams=self.cams, uvs=self.uvs, weights=self.weights)


class RotationMatchesXY(RotationMatches):
    """RotationMatches whose residuals live in normalized camera coordinates.

    Image coordinates may be dropped to save memory.
    """

    def __init__(self, cams, uvs=None, xys=None, weights=None) -> None:
        if uvs is None and xys is None:
            raise ValueError("Both uvs and xys are missing")
        self.cams = cams
        self.weights = weights
        self.uvs = _float_pair(uvs)  # may stay None (dropped to save memory)
        self.xys = _float_pair(xys)
        if self.xys is None:
            self.xys = [c._uv_to_xy(uv) for c, uv in zip(cams, self.uvs)]
        self._test_matches()
        self._snapshot_internals()

    @property
    def size(self) -> int:
        """Number of point pairs."""
        return len(self.xys[0])

    def observed(self, cam: CamIndex = 0, index: Index = slice(None)) -> np.ndarray:
        """Observed normalized camera coordinates."""
        return self.xys[self._cam_index(cam)][index]

    def predicted(self, cam: CamIndex = 0, index: Index = slice(None)) -> np.ndarray:
        """Camera coordinates predicted from the other camera's observations."""
        self._test_position()
        self._test_internals()
        into = self._cam_index(cam)
        rays = self.cams[1 - into]._xy_to_xyz(self.xys[1 - into][index])
        return self.cams[into]._xyz_to_xy(rays, directions=True)

    def to_type(self, mtype: Type[Matches]) -> Matches:
        """Convert to another matches type."""
        if mtype is type(self):
            return self
        if mtype is Matches:
            uvs = self.uvs
            if uvs is None:
                uvs = [c._xy_to_uv(xy) for c, xy in zip(self.cams, self.xys)]
            return mtype(cams=self.cams, uvs=uvs, weights=self.weights)
        return mtype(cams=self.cams, uvs=self.uvs, xys=self.xys, weights=self.weights)

    def plot(self, *args: Any, **kwargs: Any) -> None:
        """Plotting is not available in normalized coordinates."""
        raise NotImplementedError()


class RotationMatchesXYZ:
    """Matched points of one image pair as camera coordinates, for
    :class:`ObserverCameras`; its predictions are unit world rays.

    ``cams`` are the two images' cameras, as :class:`Camera` objects or as
    20-float camera vectors; ``uvs`` the two (n, 2) pixel arrays or ``xys``
    the two (n, 2) normalized camera coordinate arrays. Without ``xys`` they
    come from ``uvs`` through :func:`ops.projection.image_to_camera` in
    float64 on the host. The reference's objects of the same name pass into
    :class:`ObserverCameras` as they are: it reads only ``xys`` and ``size``.
    """

    def __init__(self, cams, uvs=None, xys=None, weights=None) -> None:
        if uvs is None and xys is None:
            raise ValueError("Both uvs and xys are missing")
        self.cams = [c if isinstance(c, Camera) else np.asarray(c, dtype=float) for c in cams]
        self.weights = weights
        self.uvs = None if uvs is None else [np.asarray(uv, dtype=float) for uv in uvs]
        if xys is None:
            xys = [
                projection.image_to_camera(
                    torch.from_numpy(uv), c[projection.IMGSZ], c[projection.F], c[projection.C],
                    c[projection.K], c[projection.P],
                ).numpy()
                for c, uv in zip(map(_camera_vector, self.cams), self.uvs)
            ]
        self.xys = [np.asarray(xy, dtype=float) for xy in xys]
        if len(self.xys[0]) != len(self.xys[1]):
            raise ValueError("The two images have different numbers of points")
        self._internals = [_camera_vector(c)[6:].copy() for c in self.cams]

    @property
    def size(self) -> int:
        """Number of point pairs."""
        return len(self.xys[0])

    def _cam_index(self, cam: CamIndex) -> int:
        if isinstance(cam, int):
            if cam >= len(self.cams):
                raise IndexError("Camera index out of range")
            return cam
        return [id(c) for c in self.cams].index(id(cam))

    def predicted(self, cam: CamIndex = 0, index: Index = slice(None)) -> np.ndarray:
        """Unit-length world ray directions for one camera's observations."""
        vectors = [_camera_vector(c) for c in self.cams]
        if any(vectors[0][0:3] != vectors[1][0:3]):
            raise ValueError("Cameras have different positions")
        if any((v[6:] != saved).any() for v, saved in zip(vectors, self._internals)):
            raise ValueError("Camera internal parameters (imgsz, f, c, k, p) have changed")
        which = self._cam_index(cam)
        R = projection.rotation_matrix(torch.from_numpy(vectors[which][projection.VIEWDIR].copy()))
        rays = projection.camera_to_world(torch.from_numpy(self.xys[which][index]), R).numpy()
        return rays / np.linalg.norm(rays, axis=1, keepdims=True)

    def observed(self, *args: Any, **kwargs: Any) -> None:
        """Observed coordinates are not available for RotationMatchesXYZ."""
        raise NotImplementedError()

    def to_type(self, mtype: Type[Matches]) -> Matches:
        """Convert to another matches type (the cameras must be
        :class:`Camera` objects)."""
        if mtype is type(self):
            return self
        if mtype is Matches:
            uvs = self.uvs
            if uvs is None:
                uvs = [c._xy_to_uv(xy) for c, xy in zip(self.cams, self.xys)]
            return mtype(cams=self.cams, uvs=uvs, weights=self.weights)
        return mtype(cams=self.cams, uvs=self.uvs, xys=self.xys, weights=self.weights)


def _camera_vector(cam) -> np.ndarray:
    """The 20-float vector of a :class:`Camera` or of a vector."""
    return cam._vector if isinstance(cam, Camera) else cam


def _plot_quivers(uv, puv, cam, index, selected, unselected, **kwargs):
    """Shared quiver plotting for control objects."""
    import matplotlib.pyplot as plt

    new_plot = not plt.get_fignums()
    defaults = {
        "scale": 1, "scale_units": "xy", "angles": "xy", "units": "xy",
        "width": cam.imgsz[0] * 0.005, **kwargs,
    }
    duv = puv - uv
    full = np.arange(len(uv))
    index, unindex = full[index], np.delete(full, index)
    result = {}
    for idx, args, label in [
        (unindex, unselected, "unselected"),
        (index, selected, "selected"),
    ]:
        if not len(idx) or args is None:
            result[label] = None
            continue
        if not isinstance(args, dict):
            args = {"color": args}
        args = {**defaults, **args}
        result[label] = plt.quiver(
            uv[idx, 0], uv[idx, 1], duv[idx, 0], duv[idx, 1], **args
        )
    if new_plot:
        cam.set_plot_limits()
    return result


# ---- Models (RANSAC-compatible: .size, .fit(index), .errors(params, index)) --


class Polynomial:
    """Least-squares polynomial model (RANSAC-compatible)."""

    def __init__(self, xy, deg: int = 1) -> None:
        self.xy = np.asarray(xy)
        self.deg = deg

    @property
    def size(self) -> int:
        """Number of observations."""
        return len(self.xy)

    def predict(self, params, index: Index = slice(None)) -> np.ndarray:
        """Evaluate the polynomial at the x of the indexed points."""
        return np.polyval(params, self.xy[index, 0])

    def errors(self, params, index: Index = slice(None)) -> np.ndarray:
        """Absolute prediction errors."""
        return np.abs(self.predict(params, index) - self.xy[index, 1])

    def fit(self, index: Index = slice(None)) -> np.ndarray:
        """Least-squares polynomial coefficients (highest degree first)."""
        return np.polyfit(self.xy[index, 0], self.xy[index, 1], deg=self.deg)

    def plot(self, params=None, index: Index = slice(None), selected="red",
             unselected="gray", predicted="red", **kwargs: Any) -> dict:
        """Scatter the observations and draw the fitted polynomial."""
        import matplotlib.pyplot as plt

        if params is None:
            params = self.fit(index)
        everything = np.arange(self.size)
        chosen = everything[index]
        rest = np.setdiff1d(everything, chosen)

        def scatter(rows, spec):
            if spec is None or rows.size == 0:
                return None
            style = spec if isinstance(spec, dict) else {"c": spec}
            return plt.scatter(
                self.xy[rows, 0], self.xy[rows, 1], **{**style, **kwargs}
            )

        result = {
            "unselected": scatter(rest, unselected),
            "selected": scatter(chosen, selected),
            "predicted": None,
        }
        if predicted is not None:
            line_style = (
                predicted if isinstance(predicted, dict) else {"color": predicted}
            )
            result["predicted"] = plt.plot(
                self.xy[:, 0], self.predict(params), **line_style
            )
        return result


Control = Union[Points, Lines, Matches, RotationMatches]
Params = Dict[str, Union[bool, int, Iterable[int], tuple]]

_ATTRIBUTES = ("xyz", "viewdir", "imgsz", "f", "c", "k", "p")
_OFFSETS = (0, 3, 6, 8, 10, 12, 18, 20)


class Cameras:
    """Multi-camera bundle adjustment over masked camera parameters.

    Cameras may share groups of parameters (synchronized across a group) and
    have per-camera free parameters; the optimizer is
    ``scipy.optimize.least_squares`` with per-parameter scale factors and a
    control x camera block sparsity structure.
    """

    def __init__(
        self,
        cams,
        controls,
        cam_params=None,
        group_indices=None,
        group_params=None,
        weights=None,
        scales: bool = True,
        sparsity: bool = True,
        device="cuda",
    ) -> None:
        self.device = torch.device(device)
        torch.empty(0, device=self.device)  # raises on a host without the device
        if isinstance(cams, Camera):
            cams = [cams]
        if isinstance(controls, (Points, Lines, Matches)):
            controls = [controls]
        if isinstance(cam_params, dict):
            cam_params = [cam_params]
        if isinstance(group_indices, int):
            group_indices = [group_indices]
        if group_indices is not None and isinstance(group_indices[0], int):
            group_indices = [group_indices]
        if isinstance(group_params, dict):
            group_params = [group_params]
        self.cams = list(cams)
        self.controls = self.prune_controls(controls, cams=self.cams)
        ncams = len(self.cams)
        self.cam_params = cam_params if cam_params is not None else [{}] * ncams
        self.group_indices = (
            group_indices if group_indices is not None else [list(range(ncams))]
        )
        self.group_params = (
            group_params
            if group_params is not None
            else [{}] * len(self.group_indices)
        )
        self.weights = weights
        self.update_params()
        self._test()
        self.vectors = [cam.to_array() for cam in self.cams]
        self.scales = None
        if scales:
            self._build_scales()
        self.sparsity = None
        if sparsity:
            self._build_sparsity()

    # -- weights -- #

    @property
    def weights(self):
        """Per-point weights, normalized to mean 1."""
        return self._weights

    @weights.setter
    def weights(self, value) -> None:
        if value is None:
            self._weights = None
        else:
            value = np.atleast_2d(value).reshape(-1, 1)
            self._weights = value * len(value) / sum(value)

    # -- static helpers -- #

    @staticmethod
    def _get_control_cams(control) -> List[Camera]:
        if isinstance(control, (Points, Lines)):
            return [control.cam]
        return list(control.cams)

    @classmethod
    def prune_controls(cls, controls, cams) -> list:
        """Keep only controls that reference at least one of the cameras."""
        return [
            control
            for control in controls
            if set(cams) & set(cls._get_control_cams(control))
        ]

    @staticmethod
    def camera_scales(cam: Camera, controls=None) -> np.ndarray:
        """Per-parameter scale factors: change producing ~1 px of motion.

        Analytic pixels-per-unit heuristics for each of the 20 parameters, inverted to units per pixel.
        """
        f_mean = float(cam.f.mean())
        # Mean image radius (px), and its normalized-camera-frame twin.
        r_px = (cam.imgsz.mean() / 6) * (np.sqrt(2) + np.log(1 + np.sqrt(2)))
        r_xy = r_px / f_mean

        px_per_unit = np.ones(20, dtype=float)
        world = Cameras._control_world_points(cam, controls)
        if world is not None:
            depth = np.linalg.norm(world - cam.xyz).mean()
            px_per_unit[0:3] = f_mean / depth
        fov_deg = np.degrees(2 * np.arctan(cam.imgsz / (2 * cam.f)))
        px_per_unit[3:5] = cam.imgsz / fov_deg
        px_per_unit[5] = 2 * r_px * np.sin(np.radians(1.0) / 2)
        px_per_unit[6:8] = 0.5
        px_per_unit[8:10] = r_xy
        # Radial terms: r^(2i+1) per coefficient order, rational denominators
        # for k4..k6, with the 2^(i+1/2) spread factor.
        for i in range(3):
            magnitude = r_xy ** (3 + 2 * i) * f_mean * 2 ** (0.5 + i)
            px_per_unit[12 + i] = magnitude
            px_per_unit[15 + i] = magnitude / (1 + cam.k[3 + i] * r_xy ** (2 + 2 * i))
        px_per_unit[18:20] = np.sqrt(5) * r_xy ** 2 * f_mean
        return 1 / px_per_unit

    @staticmethod
    def _control_world_points(cam: Camera, controls) -> Optional[np.ndarray]:
        """World coordinates of absolute (non-direction) controls on ``cam``."""
        gathered = []
        for control in controls or ():
            applies = (
                isinstance(control, (Points, Lines))
                and control.cam is cam
                and not control.directions
            )
            if not applies:
                continue
            if isinstance(control, Lines):
                gathered.extend(control.xyzs)
            else:
                gathered.append(control.xyz)
        return np.vstack(gathered) if gathered else None

    @staticmethod
    def camera_bounds(cam: Camera) -> np.ndarray:
        """Default parameter bounds (distortion limits from undistort stability)."""
        k = cam.f.mean() / 4000
        p = cam.f.mean() / 40000
        bounds = np.full((20, 2), [-np.inf, np.inf], dtype=float)
        bounds[6:10] = [0, np.inf]
        bounds[10] = np.array([-0.5, 0.5]) * cam.imgsz[0]
        bounds[11] = np.array([-0.5, 0.5]) * cam.imgsz[1]
        bounds[12] = [-k, k]
        bounds[13] = [-k / 2, k / 2]
        bounds[14] = [-k / 2, k / 2]
        bounds[15:18] = [-k, k]
        bounds[18:20] = [-p, p]
        return bounds

    @staticmethod
    def parse_params(params: Params = None, default_bounds=None):
        """Parse a parameter selection dict into a (20,) mask and (20, 2) bounds.

        Selections: {'viewdir': True} (all), {'viewdir': 0} (one index),
        {'viewdir': [0, 1]}, or with bounds {'viewdir': (indices, min, max)}.
        """
        if params is None:
            params = {}
        mask = np.zeros(20, dtype=bool)
        bounds = np.full((20, 2), np.nan)
        for key, value in params.items():
            if key not in _ATTRIBUTES:
                continue
            selection = value[0] if isinstance(value, tuple) else value
            i = _ATTRIBUTES.index(key)
            if selection or selection == 0:
                if selection is True:
                    positions = np.arange(_OFFSETS[i], _OFFSETS[i + 1])
                else:
                    positions = _OFFSETS[i] + np.atleast_1d(selection)
                mask[positions] = True
            if isinstance(value, tuple):
                min_bounds = np.atleast_1d(value[1]).astype(float)
                if len(min_bounds) == 1:
                    min_bounds = np.repeat(min_bounds, len(positions))
                max_bounds = np.atleast_1d(value[2]).astype(float)
                if len(max_bounds) == 1:
                    max_bounds = np.repeat(max_bounds, len(positions))
                bounds[positions] = np.column_stack((min_bounds, max_bounds))
        if default_bounds is not None:
            missing = np.isnan(bounds)
            bounds[missing] = default_bounds[missing]
        missing = np.isnan(bounds)
        bounds[missing[:, 0], 0] = -np.inf
        bounds[missing[:, 1], 1] = np.inf
        return mask, bounds

    # -- parameter bookkeeping -- #

    def update_params(self) -> None:
        """Rebuild masks, bounds, values, and index breaks from current state."""
        cam_bounds = [self.camera_bounds(cam) for cam in self.cams]
        parsed = [
            self.parse_params(params, default_bounds=bounds)
            for params, bounds in zip(self.cam_params, cam_bounds)
        ]
        self.cam_masks = [mask for mask, _ in parsed]
        cam_bounds = [bounds for _, bounds in parsed]
        self.group_masks = []
        group_bounds = []
        for group, idx in enumerate(self.group_indices):
            defaults = np.column_stack(
                (
                    np.column_stack([cam_bounds[i][:, 0] for i in idx]).max(axis=1),
                    np.column_stack([cam_bounds[i][:, 1] for i in idx]).min(axis=1),
                )
            )
            mask, bounds = self.parse_params(
                self.group_params[group], default_bounds=defaults
            )
            self.group_masks.append(mask)
            group_bounds.append(bounds)
        # Parameter vector layout: [group0 | group1 | ... | cam0 | cam1 | ...].
        values, lower, upper = [], [], []
        for group, idx in enumerate(self.group_indices):
            mask = self.group_masks[group]
            group_values = np.nanmean(
                np.vstack([self.cams[i]._vector[mask] for i in idx]), axis=0
            )
            values.extend(group_values)
            lower.extend(group_bounds[group][mask, 0])
            upper.extend(group_bounds[group][mask, 1])
        for i, mask in enumerate(self.cam_masks):
            values.extend(self.cams[i]._vector[mask])
            lower.extend(cam_bounds[i][mask, 0])
            upper.extend(cam_bounds[i][mask, 1])
        self.values = np.asarray(values, dtype=float)
        self.bounds = (np.asarray(lower, dtype=float), np.asarray(upper, dtype=float))
        self.group_breaks = np.cumsum(
            [0] + [int(mask.sum()) for mask in self.group_masks]
        )
        self.cam_breaks = np.cumsum(
            [self.group_breaks[-1]] + [int(mask.sum()) for mask in self.cam_masks]
        )

    def _test(self) -> None:
        """Guard against configurations with undefined behavior."""
        if not self.controls:
            raise ValueError("No controls reference the cameras")
        self._check_group_image_sizes()
        self._check_mask_overlaps()
        self._check_controls_cover_params()

    def _check_group_image_sizes(self) -> None:
        """Groups synchronizing f or c need a single shared image size."""
        for g, members in enumerate(self.group_indices):
            if not ({"f", "c"} & set(self.group_params[g])):
                continue
            sizes = {tuple(self.cams[j].imgsz) for j in members}
            if len(sizes) > 1:
                raise ValueError(
                    f"Group {g}: 'f' or 'c' in parameters but image sizes not equal"
                )

    def _check_mask_overlaps(self) -> None:
        """No camera may belong to two groups that free the same parameter."""
        stacked = np.vstack(self.group_masks)
        for param in np.flatnonzero(stacked.sum(axis=0) > 1):
            touching = np.flatnonzero(stacked[:, param])
            members = np.concatenate([self.group_indices[g] for g in touching])
            if np.unique(members).size < members.size:
                raise ValueError(
                    "Some cameras are in multiple groups with overlapping masks"
                )

    def _check_controls_cover_params(self) -> None:
        """Every camera with free parameters needs at least one control."""
        controlled = {
            cam
            for control in self.controls
            for cam in self._get_control_cams(control)
        }
        for i, cam in enumerate(self.cams):
            in_param_group = any(
                self.group_params[g]
                for g, members in enumerate(self.group_indices)
                if i in members
            )
            if (self.cam_params[i] or in_param_group) and cam not in controlled:
                raise ValueError("Not all cameras with params appear in controls")

    def _build_scales(self) -> None:
        scales = [self.camera_scales(cam, self.controls) for cam in self.cams]
        cam_scales = [scale[mask] for scale, mask in zip(scales, self.cam_masks)]
        group_scales = [
            np.nanmean(np.vstack([scales[i][mask] for i in idx]), axis=0)
            for mask, idx in zip(self.group_masks, self.group_indices)
        ]
        parts = group_scales + cam_scales
        self.scales = np.hstack([p for p in parts if len(p)]) if any(
            len(p) for p in parts
        ) else None

    def _build_sparsity(self) -> None:
        """Control x parameter block sparsity for the Jacobian estimate."""
        m_control = [2 * control.size for control in self.controls]
        m = sum(m_control)
        n = int(self.cam_breaks[-1])
        groups = np.zeros((len(self.cams), len(self.group_indices)), dtype=bool)
        for i, idx in enumerate(self.group_indices):
            groups[list(idx), i] = True
        S = scipy.sparse.lil_matrix((m, n), dtype=int)
        control_breaks = np.cumsum([0] + m_control)
        for i, control in enumerate(self.controls):
            ctrl_slice = slice(control_breaks[i], control_breaks[i + 1])
            for cam in self._get_control_cams(control):
                try:
                    j = self.cams.index(cam)
                except ValueError:
                    continue
                S[ctrl_slice, self.cam_breaks[j] : self.cam_breaks[j + 1]] = 1
                for group in np.nonzero(groups[j])[0]:
                    S[
                        ctrl_slice,
                        self.group_breaks[group] : self.group_breaks[group + 1],
                    ] = 1
        self.sparsity = S

    # -- exact Jacobians (forward-mode autodiff) -- #

    def _autodiff_supported(self) -> bool:
        """Whether every control has a residual on tensors.

        All control types of :class:`Cameras` are covered, ``Lines`` through
        the fixed-budget world densification and a nearest-candidate
        assignment held fixed (:meth:`Lines._world_candidates`). Only
        ``RotationMatchesXYZ`` is excluded: it has no ``observed`` (it exists
        only for :class:`ObserverCameras`).
        """
        for control in self.controls:
            if isinstance(control, RotationMatchesXYZ):
                return False
            if not isinstance(control, (Points, Matches)):
                return False
        return True

    def _build_autodiff_residual(self, rows: Optional[np.ndarray] = None):
        """The residual stack on tensors, for ``torch.func.jacfwd``.

        Returns ``(scatter, assign, residual_array, fixed_cams)``:
        ``scatter(params, base)`` writes the free parameters into the camera
        20-vectors ``base`` (rows, 20) exactly like :meth:`set_cameras`
        (groups first, then per-camera blocks), out of place, as a constant
        0/1 matrix applied to ``params``; ``assign(vs)`` resolves what is
        held fixed under differentiation (each ``Lines`` control's nearest
        candidates) from concrete camera vectors; ``residual_array(params,
        base, held)`` is the (n, 2) residual, float64 on ``device``.
        ``rows`` is None for every control point, or the points to evaluate,
        in any order (indices into the stacked controls): each term then
        projects only its own share of them, so a RANSAC sample costs its
        own size. Cameras that controls reference but that are not fit
        ride along as rows the scatter never touches: values, no derivatives.

        The ``Lines`` term's (observations x candidates) distance matrix, the
        largest tensor here (1,200 x 4,096 float64 is 39 MB, and as many
        again for each parameter if it carried tangents), is built only in
        ``assign``, outside the differentiated function; inside it the
        candidates are (M, 2) per parameter, so ``jacfwd`` needs no
        ``chunk_size``.
        """
        device = self.device

        def const(a):
            return torch.as_tensor(np.asarray(a, dtype=float), dtype=torch.float64, device=device)

        # Controls may reference cameras that are NOT being fit (e.g. a
        # Matches pair anchored to a fixed camera): the host residual reads
        # the live camera objects, so such cameras act as constants.
        cam_row = {id(cam): i for i, cam in enumerate(self.cams)}
        fixed_cams: List[Camera] = []

        def row_of(cam):
            key = id(cam)
            if key not in cam_row:
                cam_row[key] = len(self.cams) + len(fixed_cams)
                fixed_cams.append(cam)
            return cam_row[key]

        def pick(a, sel):
            return a if sel is None else a[sel]

        terms = []  # term(vs, held, sel) -> (m, 2); sel: None or the control's rows to take
        assigners = []  # None, or assigner(vs, sel) -> what the term holds fixed
        for control in self.controls:
            assigner = None
            if isinstance(control, RotationMatchesXY):
                j0, j1 = row_of(control.cams[0]), row_of(control.cams[1])
                xy0, xy1 = const(control.xys[0]), const(control.xys[1])

                def term(vs, held, sel, j0=j0, j1=j1, xy0=xy0, xy1=xy1):
                    rays = projection.camera_to_world(pick(xy1, sel), projection.rotation_matrix(vs[j1][3:6]), directions=True)
                    pred = projection.world_to_camera(
                        rays, vs[j0][0:3], projection.rotation_matrix(vs[j0][3:6]), directions=True
                    )
                    return pred - pick(xy0, sel)

            elif isinstance(control, RotationMatches):
                j0, j1 = row_of(control.cams[0]), row_of(control.cams[1])
                uv0, xy1 = const(control.uvs[0]), const(control.xys[1])

                def term(vs, held, sel, j0=j0, j1=j1, uv0=uv0, xy1=xy1):
                    rays = projection.camera_to_world(pick(xy1, sel), projection.rotation_matrix(vs[j1][3:6]), directions=True)
                    return projection.project(vs[j0], rays, directions=True) - pick(uv0, sel)

            elif isinstance(control, Matches):
                j0, j1 = row_of(control.cams[0]), row_of(control.cams[1])
                uv0, uv1 = const(control.uvs[0]), const(control.uvs[1])

                def term(vs, held, sel, j0=j0, j1=j1, uv0=uv0, uv1=uv1):
                    # The coefficients are slices of the traced vector, so the
                    # inverse is always the 20-iteration fixed-point solver.
                    rays = projection.unproject(vs[j1], pick(uv1, sel), directions=True)
                    return projection.project(vs[j0], rays, directions=True) - pick(uv0, sel)

            elif isinstance(control, Lines):
                j = row_of(control.cam)
                world = const(control._world_candidates())
                uv_obs = const(control.uv)
                l_directions = control.directions
                l_corr = None if l_directions else control.cam._correction_tuple

                def candidates(vs, j=j, world=world, directions=l_directions, corr=l_corr):
                    """The fixed world candidates projected: (uv (M, 2) with
                    1e9 where not finite, finite (M,))."""
                    uvc = projection.project(vs[j], world, directions=directions, correction=corr)
                    finite = torch.isfinite(uvc[:, 0]) & torch.isfinite(uvc[:, 1])
                    return torch.where(finite[:, None], uvc, 1e9), finite

                def assigner(vs, sel, j=j, uv_obs=uv_obs, candidates=candidates):
                    # Visibility and the nearest assignment by masks: the
                    # fixed-shape form of project -> clip -> densify -> NN.
                    uvc, finite = candidates(vs)
                    imgsz = vs[j][6:8]
                    inside = (
                        finite
                        & (uvc[:, 0] >= 0) & (uvc[:, 0] <= imgsz[0])
                        & (uvc[:, 1] >= 0) & (uvc[:, 1] <= imgsz[1])
                    )
                    # If clipping leaves nothing in frame, match against the
                    # in-front candidates raw, as the host path does (a
                    # select on the card: nothing is read on the host).
                    use = torch.where(inside.any(), inside, finite)
                    d2 = torch.sum((pick(uv_obs, sel)[:, None, :] - uvc[None, :, :]) ** 2, dim=-1)
                    d2 = torch.where(use[None, :], d2, math.inf)
                    return torch.argmin(d2, dim=1)

                def term(vs, held, sel, uv_obs=uv_obs, candidates=candidates):
                    return candidates(vs)[0][held] - pick(uv_obs, sel)

            else:  # Points (absolute or directions)
                j = row_of(control.cam)
                xyz, uv = const(control.xyz), const(control.uv)
                directions = control.directions
                corr = None if directions else control.cam._correction_tuple

                def term(vs, held, sel, j=j, xyz=xyz, uv=uv, directions=directions, corr=corr):
                    return projection.project(vs[j], pick(xyz, sel), directions=directions, correction=corr) - pick(uv, sel)

            terms.append(term)
            assigners.append(assigner)

        # The scatter of set_cameras as one constant matrix: entry
        # (20 * camera + position, parameter) is 1 where that parameter is
        # written there; a later write (a camera's own block) replaces an
        # earlier one (its group's).
        n_rows = len(self.cams) + len(fixed_cams)
        S = np.zeros((n_rows * 20, int(self.cam_breaks[-1])))
        writes = []
        for g, members in enumerate(self.group_indices):
            span = np.arange(self.group_breaks[g], self.group_breaks[g + 1])
            writes += [(j, np.flatnonzero(self.group_masks[g]), span) for j in members]
        for j, mask in enumerate(self.cam_masks):
            writes.append((j, np.flatnonzero(mask), np.arange(self.cam_breaks[j], self.cam_breaks[j + 1])))
        for j, pos, span in writes:
            S[20 * j + pos, :] = 0
            S[20 * j + pos, span] = 1
        written = const(S.sum(axis=1)).bool()
        S = const(S)
        weight_arr = None if self.weights is None else const(self.weights)

        def scatter(params, base):
            return torch.where(written, S @ params, base.reshape(-1)).reshape(n_rows, 20)

        # The rows as each control's own indices, and the permutation that
        # puts the per-control results back into the rows' order.
        per_control, order, rows_t = [None] * len(terms), None, None
        if rows is not None:
            breaks = np.cumsum([0] + [control.size for control in self.controls])
            found = [np.flatnonzero((rows >= lo) & (rows < hi)) for lo, hi in zip(breaks[:-1], breaks[1:])]
            per_control = [torch.as_tensor(rows[at] - lo, device=device) for at, lo in zip(found, breaks)]
            order = torch.as_tensor(np.argsort(np.concatenate(found), kind="stable"), device=device)
            rows_t = torch.as_tensor(rows, device=device)

        def assign(vs):
            return [None if a is None else a(vs, sel) for a, sel in zip(assigners, per_control)]

        def residual_array(params, base, held):
            vs = scatter(params, base)
            r = torch.cat([t(vs, h, sel) for t, h, sel in zip(terms, held, per_control)], dim=0)
            if order is not None:
                r = r[order]
            if weight_arr is not None:
                r = r * pick(weight_arr, rows_t)
            # Behind-camera NaNs contribute zero residual AND zero derivative
            # (the host fun applies the same nan_to_num).
            return torch.where(torch.isnan(r), 0.0, r)

        return scatter, assign, residual_array, fixed_cams

    def _autodiff_jac(self, index: Index = slice(None)):
        """scipy-compatible callable returning the exact (m, n) Jacobian:
        ``torch.func.jacfwd`` of the residual stack (:func:`_exact_jacobian`),
        float64 on ``device``, over the rows ``index`` selects.

        As the reference caches its compiled ``jacfwd`` in ``_jac_cache``,
        this keeps one :class:`_JacobianProgram` per row selection, rebuilt
        when the number of cameras or the controls' sizes change: on a card
        its first call runs eagerly and later calls replay a captured graph.
        Repeated fits and RANSAC's refits of one sample reuse it."""
        rows = np.arange(self.size)[index]
        if rows.size == self.size and np.array_equal(rows, np.arange(self.size)):
            rows = None
        token = (len(self.cams), tuple(c.size for c in self.controls))
        cache = getattr(self, "_jac_cache", None)
        if cache is None or cache["token"] != token:
            cache = self._jac_cache = {"token": token, "programs": collections.OrderedDict()}
        programs = cache["programs"]
        key = None if rows is None else rows.tobytes()
        if key not in programs:
            programs[key] = _JacobianProgram(self, rows)
            while len(programs) > _JACOBIAN_PROGRAMS:
                programs.popitem(last=False)
        programs.move_to_end(key)
        program = programs[key]

        def jac(x, *args):
            # Residuals restore the live camera vectors after every call, so
            # to_array() here is the fit-start (non-free) state; cameras that
            # are not fit ride along at their live values.
            base = np.stack([cam.to_array() for cam in self.cams] + [cam.to_array() for cam in program.fixed_cams])
            return program(x, base)

        return jac

    # -- camera parameter application -- #

    def set_cameras(self, params, save: bool = False) -> None:
        """Write a parameter vector into the camera 20-vectors.

        Layout: group blocks first (broadcast to every member camera), then
        one block of free parameters per camera.
        """
        values = np.asarray(params, dtype=float)
        for g, members in enumerate(self.group_indices):
            block = values[self.group_breaks[g] : self.group_breaks[g + 1]]
            for j in members:
                self.cams[j]._vector[self.group_masks[g]] = block
        for j, cam in enumerate(self.cams):
            cam._vector[self.cam_masks[j]] = values[
                self.cam_breaks[j] : self.cam_breaks[j + 1]
            ]
        if save:
            self.vectors = [cam.to_array() for cam in self.cams]

    def reset_cameras(self) -> None:
        """Restore cameras to their previously saved state."""
        for cam, vector in zip(self.cams, self.vectors):
            cam._vector = vector.copy()

    # -- residuals -- #

    @property
    def size(self) -> int:
        """Total number of control points."""
        return int(np.sum([control.size for control in self.controls]))

    def _stack_controls(self, method: str, index: Index) -> np.ndarray:
        """Concatenate a per-control accessor over all controls."""
        if len(self.controls) == 1:
            return getattr(self.controls[0], method)(index=index)
        return np.vstack(
            [getattr(control, method)() for control in self.controls]
        )[index]

    def observed(self, index: Index = slice(None)) -> np.ndarray:
        """Observed coordinates over all controls."""
        return self._stack_controls("observed", index)

    def predicted(self, params=None, index: Index = slice(None)) -> np.ndarray:
        """Predicted coordinates over all controls (optionally at params)."""
        if params is None:
            return self._stack_controls("predicted", index)
        saved = [cam.to_array() for cam in self.cams]
        self.set_cameras(params)
        try:
            return self._stack_controls("predicted", index)
        finally:
            for cam, vector in zip(self.cams, saved):
                cam._vector = vector

    def residuals(self, params=None, index: Index = slice(None)) -> np.ndarray:
        """Weighted residuals (predicted - observed), shape (n, 2)."""
        d = self.predicted(params=params, index=index) - self.observed(index=index)
        if self.weights is None:
            return d
        return d * self.weights[index]

    def plot_weights(self, index: Index = slice(None), **kwargs):
        """Scatter the observed points colored and sized by their weights.

        """
        import matplotlib.pyplot as plt

        weights = np.ones(self.size) if self.weights is None else self.weights
        uv = self.observed(index=index)
        return plt.scatter(
            uv[:, 0], uv[:, 1], c=weights[index], s=weights[index], **kwargs
        )

    def errors(self, params=None, index: Index = slice(None)) -> np.ndarray:
        """Euclidean reprojection errors (n,)."""
        return np.linalg.norm(self.residuals(params=params, index=index), axis=1)

    def fit(
        self,
        index: Index = slice(None),
        cam_params=None,
        group_params=None,
        full: bool = False,
        method: str = "least_squares",
        verbose: bool = False,
        jac: str = "auto",
        **kwargs: Any,
    ):
        """Optimal parameter vector minimizing the reprojection residuals.

        Calls ``scipy.optimize.least_squares`` directly (Trust Region
        Reflective with bounds) using the per-parameter scales as ``x_scale``.
        ``jac`` selects the Jacobian source: ``'exact'`` evaluates exact
        derivatives of the full residual stack with ``torch.func.jacfwd``
        over the projection ops, in float64 on ``device``; ``'2-point'`` is
        scipy's finite-difference path with the block sparsity structure;
        ``'auto'`` (default, as the reference's) uses exact whenever every
        control supports tracing (all built-in controls — including
        ``Lines``, whose residual is traced through the budgeted candidate
        densification — do; only custom controls without pure-op residuals
        fall back to finite differences). ``cam_params``/
        ``group_params`` run staged pre-fits.

        The exact Jacobian is forward mode, one launch per op and dual part
        eagerly; on a card its program (:meth:`_autodiff_jac`) replays them
        as one captured graph from its second call. On one NVIDIA H100 (700
        W; ``chip_smoke.py`` phases 17 and 28) a call took 2.1-2.2 ms
        replayed against 45-47 ms eager for 4 cameras x 2,000 points, 28 ms
        against 542-610 ms for 6 cameras x 4,000 ``Matches`` with three
        radial coefficients, and 2.8-3.0 ms against 45 ms for 3 cameras of
        1,200 ``Lines`` points against 4,096 candidates; those fits took
        0.36-0.69 s, 7.0-8.2 s and 3.1 s against 0.28 s, 4.9 s and 15.6 s
        with ``'2-point'``. The ``Matches`` fit then waits on its host
        residual: pass ``jac='2-point'`` where such a term leads.
        """
        iterations = max(
            len(cam_params) if cam_params else 0,
            len(group_params) if group_params else 0,
        )
        if iterations:
            for n in range(iterations):
                model = Cameras(
                    cams=self.cams,
                    controls=self.controls,
                    cam_params=cam_params[n] if cam_params else self.cam_params,
                    group_params=(
                        group_params[n] if group_params else self.group_params
                    ),
                    device=self.device,
                )
                values = model.fit(index=index, method=method, jac=jac, **kwargs)
                if values is not None:
                    model.set_cameras(params=values)
            self.update_params()
        options = dict(kwargs)
        if self.scales is not None and len(self.scales):
            options.setdefault("x_scale", self.scales)
        exact = jac == "exact" or (jac == "auto" and self._autodiff_supported())
        if exact:
            options.setdefault("jac", self._autodiff_jac(index))
        elif self.sparsity is not None:
            if isinstance(index, slice) and index == slice(None):
                options.setdefault("jac_sparsity", self.sparsity)
            else:
                jac_index = (
                    np.arange(self.size)[index]
                    if isinstance(index, slice)
                    else np.asarray(index)
                )
                jac_index = np.dstack((2 * jac_index, 2 * jac_index + 1)).ravel()
                options.setdefault("jac_sparsity", self.sparsity[jac_index])

        def fun(params: np.ndarray) -> np.ndarray:
            r = self.residuals(params=params, index=index).ravel()
            return np.nan_to_num(r, nan=0.0)

        lower, upper = self.bounds
        # TRF requires strictly interior starting points.
        x0 = np.clip(self.values, lower + 1e-12, upper - 1e-12)
        result = scipy.optimize.least_squares(
            fun, x0=x0, bounds=(lower, upper), verbose=1 if verbose else 0, **options
        )
        if iterations:
            self.reset_cameras()
            self.update_params()
        if not result.success:
            print(result.message)
        if full:
            return result
        if result.success:
            return result.x
        return None

    def plot(self, params=None, cam: CamIndex = 0, index: Index = slice(None),
             **kwargs: Any) -> list:
        """Plot reprojection errors for one camera across its controls."""
        if params is not None:
            vectors = [c.to_array() for c in self.cams]
            self.set_cameras(params)
        cam = self.cams[cam] if isinstance(cam, int) else cam
        results = [
            control.plot(index=index, **kwargs)
            if not isinstance(control, Matches)
            else control.plot(cam=cam, index=index, **kwargs)
            for control in self.prune_controls(self.controls, cams=[cam])
        ]
        if params is not None:
            for c, vector in zip(self.cams, vectors):
                c._vector = vector
        return results


#: Row selections whose Jacobian program a :class:`Cameras` keeps (the full
#: stack among them): RANSAC draws a new sample a fit, and each program holds
#: its graph's memory.
_JACOBIAN_PROGRAMS = 8


def _exact_jacobian(scatter, assign, residual_array, params, base):
    """The exact Jacobian of :meth:`Cameras._build_autodiff_residual`'s
    residual stack at ``params`` (n,), the fit-start camera vectors ``base``
    (rows, 20): what each ``Lines`` term holds fixed is assigned first, then
    ``torch.func.jacfwd`` of the flat residual, (m, n) float64. Eager: one
    launch an operation and dual part."""
    with torch.no_grad():
        held = assign(scatter(params, base))

    def flat(p):
        return residual_array(p, base, held).reshape(-1)

    return torch.func.jacfwd(flat)(params)


class _JacobianProgram:
    """:func:`_exact_jacobian` of one :class:`Cameras` over one row
    selection, as a program over static buffers (:class:`graphs.Program`):
    the parameters (n,) and the fit-start camera vectors (rows, 20), float64
    on the model's device. A call copies ``x`` and ``base`` in, runs (on a
    card: replays) and returns the (m, n) Jacobian as a NumPy array, bit for
    bit the eager call's."""

    def __init__(self, model: "Cameras", rows: Optional[np.ndarray]) -> None:
        self.closures = model._build_autodiff_residual(rows)
        self.fixed_cams = self.closures[3]
        n_rows = len(model.cams) + len(self.fixed_cams)
        device = model.device
        self.params = torch.zeros(int(model.cam_breaks[-1]), dtype=torch.float64, device=device)
        self.base = torch.zeros((n_rows, 20), dtype=torch.float64, device=device)
        self.program = graphs.Program(
            functools.partial(_exact_jacobian, *self.closures[:3], self.params, self.base), device,
            "the exact Jacobian")

    def __call__(self, x, base) -> np.ndarray:
        self.params.copy_(torch.from_numpy(np.asarray(x, dtype=float)))
        self.base.copy_(torch.from_numpy(np.asarray(base, dtype=float)))
        return self.program().cpu().numpy()


# ---- Observer stabilization ---- #


def _coo(matches):
    return matches if scipy.sparse.issparse(matches) else scipy.sparse.coo_matrix(matches)


class ObserverCameras:
    """View directions of an observer's image sequence from keypoint matches.

    ``observer`` is anything with ``images[i].cam.viewdir`` (degrees);
    ``matches`` a scipy sparse matrix (COO) whose entry (i, j) is the
    matches of images i and j (``xys`` and ``size``); ``anchors`` the images
    whose view directions stay fixed. The objective and its gradient run on
    ``device``.
    """

    def __init__(self, observer, matches=None, anchors: Iterable[int] = None, device="cuda") -> None:
        self.observer = observer
        self.anchors = [0] if anchors is None else list(anchors)
        self.matches = matches
        self.device = torch.device(device)
        self._matcher = None
        self.viewdirs = np.vstack([np.array(img.cam.viewdir, dtype=float) for img in self.observer.images])

    @property
    def matcher(self) -> "KeypointMatcher":
        """A :class:`KeypointMatcher` over the observer's images on this
        object's ``device`` (built on first use)."""
        if self._matcher is None:
            self._matcher = KeypointMatcher(images=self.observer.images, device=self.device)
        return self._matcher

    def set_cameras(self, viewdirs) -> None:
        """Write view directions into the observer's cameras."""
        for i, img in enumerate(self.observer.images):
            img.cam.viewdir = viewdirs[i]

    def reset_cameras(self) -> None:
        """Restore the original view directions."""
        self.set_cameras(viewdirs=self.viewdirs.copy())

    def build_keypoints(self, **kwargs: Any) -> None:
        """Keypoints of every image (:meth:`KeypointMatcher.build_keypoints`)."""
        self.matcher.build_keypoints(**kwargs)

    def build_matches(self, **kwargs: Any) -> None:
        """Matches between images (:meth:`KeypointMatcher.build_matches`), as
        :class:`RotationMatchesXYZ`."""
        self.matcher.build_matches(**kwargs)
        self.matcher.convert_matches(RotationMatchesXYZ)
        self.matches = self.matcher.matches

    def _flatten_matches(self):
        """The match matrix as (xyA, xyB, imgA, imgB) arrays."""
        matches = _coo(self.matches)
        xa, xb, ia, ib = [], [], [], []
        for m, i, j in zip(matches.data, matches.row, matches.col):
            xa.append(m.xys[0])
            xb.append(m.xys[1])
            ia.append(np.full(m.size, i, dtype=np.int32))
            ib.append(np.full(m.size, j, dtype=np.int32))
        return np.vstack(xa), np.vstack(xb), np.concatenate(ia), np.concatenate(ib)

    def initialize(self, min_matches: int = 8) -> np.ndarray:
        """View directions (n_images, 3) chained from pairwise rotations.

        For each consecutive pair with at least ``min_matches`` matches, the
        relative rotation is the orthogonal-Procrustes optimum over the
        matched unit rays (one 3x3 SVD, float64 on the host); composing them
        outward from the first anchor gives the start. An image with no such
        pair keeps its neighbour's rotation. Does not change the cameras.
        """
        coo = _coo(self.matches)
        pair_map = {(int(i), int(j)): m for m, i, j in zip(coo.data, coo.row, coo.col) if m.size >= min_matches}

        def unit(v):
            v = np.column_stack([v, np.ones(len(v))])
            return v / np.linalg.norm(v, axis=1, keepdims=True)

        def relative(m, R_known, forward: bool):
            """Rotation of the unknown image given the known image's R."""
            va, vb = unit(m.xys[0]), unit(m.xys[1])
            if not forward:  # the unknown is the first image of the pair
                va, vb = vb, va
            U, _, Vt = np.linalg.svd(vb.T @ (va @ R_known))
            d = np.sign(np.linalg.det(U @ Vt))
            return U @ np.diag([1.0, 1.0, d]) @ Vt

        def viewdir(R):
            return projection.viewdir_from_rotation(torch.from_numpy(R)).numpy()

        n = len(self.viewdirs)
        out = self.viewdirs.copy()
        a0 = self.anchors[0] if self.anchors else 0
        known = {a0: projection.rotation_matrix(torch.from_numpy(out[a0])).numpy()}
        for i in range(a0 + 1, n):
            m = pair_map.get((i - 1, i))
            known[i] = known[i - 1] if m is None else relative(m, known[i - 1], forward=True)
            out[i] = viewdir(known[i])
        for i in range(a0 - 1, -1, -1):
            m = pair_map.get((i, i + 1))
            known[i] = known[i + 1] if m is None else relative(m, known[i + 1], forward=False)
            out[i] = viewdir(known[i])
        return out

    def _blocks(self):
        """Matches as per-pair blocks padded to a common width K (a multiple
        of 128): xa, xb (P, K, 3), weights (P, K), image indices ia, ib (P,).

        Every row, padding included, carries the homogeneous 1: a zero row
        would put the ray norm's backward pass at 0 and the gradient at NaN,
        even under a zero weight.
        """
        coo = _coo(self.matches)
        blocks = [(m.xys[0], m.xys[1], int(i), int(j)) for m, i, j in zip(coo.data, coo.row, coo.col) if m.size > 0]
        P = len(blocks)
        K = -(-max(len(b[0]) for b in blocks) // 128) * 128
        xa = np.zeros((P, K, 3), np.float32)
        xb = np.zeros((P, K, 3), np.float32)
        xa[..., 2] = 1.0
        xb[..., 2] = 1.0
        w = np.zeros((P, K), np.float32)
        for p, (a, b, _, _) in enumerate(blocks):
            xa[p, : len(a), :2] = a
            xb[p, : len(a), :2] = b
            w[p, : len(a)] = 1.0
        ia = np.array([b[2] for b in blocks])
        ib = np.array([b[3] for b in blocks])
        return tuple(torch.from_numpy(v).to(self.device) for v in (xa, xb, w, ia, ib))

    def objective(self, free: np.ndarray, smooth: float = 1e-5):
        """The fit's objective as a function of the free images' view
        directions, flat (3 * len(free),) float32 on the device: the sum over
        matches of sqrt(r^2 + smooth^2) (|r| for ``smooth=0``), r each
        component of the difference of the two unit world rays."""
        xa, xb, w, ia, ib = self._blocks()
        viewdirs_0 = torch.from_numpy(self.viewdirs.astype(np.float32)).to(self.device)
        free_t = torch.from_numpy(np.asarray(free)).to(self.device)
        eps2 = float(smooth) ** 2

        def unit_rays(xys, R):
            d = torch.matmul(xys, R)
            return d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True), min=1e-20)

        def value(flat):
            viewdirs = viewdirs_0.index_put((free_t,), flat.reshape(-1, 3))
            R = projection.rotation_matrix(viewdirs)
            with full_float32():
                r = unit_rays(xa, R[ia]) - unit_rays(xb, R[ib])
            term = torch.sqrt(r * r + eps2) if eps2 > 0.0 else torch.abs(r)
            return torch.sum(w[..., None] * term)

        return value

    def fit(self, anchor_weight: float = 1e6, method: str = "lbfgs-device", tol: Optional[float] = None,
            init: str = "chain", smooth: float = 1e-5, **kwargs):
        """View directions that minimize the ray objective.

        ``init="chain"`` starts from :meth:`initialize`, ``"current"`` from
        the images' view directions. Anchors are held exactly fixed
        (``anchor_weight`` is accepted for the reference's signature). The
        objective is a smoothed L1, ``sqrt(r^2 + smooth^2)``. ``method``:
        ``"lbfgs-device"`` (default, see :meth:`_fit_lbfgs_device`), or a
        ``scipy.optimize.minimize`` method driven from the host with the
        device's value and gradient: ``"l-bfgs-b"`` (stopping on the
        gradient, memory 30, 2,000 iterations), ``"bfgs"``, or
        ``"newton-cg"`` with Hessian-vector products from ``torch.func.jvp``
        of the gradient.

        Returns a ``scipy.optimize.OptimizeResult`` whose ``x`` holds every
        image's view direction (anchors included), flat.
        """
        n_imgs = len(self.viewdirs)
        free = np.setdiff1d(np.arange(n_imgs), np.asarray(self.anchors, dtype=int))
        value = self.objective(free, smooth)
        x0 = np.asarray(self.initialize() if init == "chain" else self.viewdirs)[free].ravel()
        if method.lower() == "lbfgs-device":
            return self._fit_lbfgs_device(value, x0, free, kwargs)

        def tensor(x):
            return torch.as_tensor(np.asarray(x, dtype=np.float32), device=self.device)

        def fun(x):
            flat = tensor(x).requires_grad_(True)
            v = value(flat)
            (g,) = torch.autograd.grad(v, flat)
            return v.item(), g.cpu().numpy().astype(float)

        options = dict(kwargs)
        if method.lower() == "l-bfgs-b":
            # The smoothing floor adds about n_matches * smooth to the value,
            # so scipy's relative ftol would stop on the first flat step;
            # stop on the gradient instead.
            defaults = {"ftol": 1e-14, "gtol": 1e-7, "maxcor": 30, "maxiter": 2000}
            options["options"] = {**defaults, **options.get("options", {})}
        if method.lower() in ("newton-cg", "trust-ncg", "trust-krylov"):
            grad = torch.func.grad(value)
            options["hessp"] = lambda x, v: (
                torch.func.jvp(grad, (tensor(x),), (tensor(v),))[1].cpu().numpy().astype(float)
            )
        result = scipy.optimize.minimize(fun=fun, x0=x0, jac=True, method=method, tol=tol, **options)
        full = self.viewdirs.copy()
        full[free] = np.asarray(result.x, dtype=float).reshape(-1, 3)
        result.x = full.ravel()
        self.reset_cameras()
        return result

    def _fit_lbfgs_device(self, value, x0, free, kwargs):
        """L-BFGS with the objective and the iterates on the device: the
        reference's ``optax.lbfgs(memory_size)`` loop (:func:`lbfgs`), memory
        ``memory_size`` (30), at most ``maxiter`` (2,000) iterations,
        stopping once ``|g|_2 < gtol`` (1e-7; in float32 the gradient of a
        sum over millions of matches floors far above it, so the budget is
        the expected stop). As the reference compiles its loop, the device
        side runs as programs (:class:`LBFGSPrograms`): on a card each
        evaluation and each direction is one replay of a captured graph,
        bit for bit the eager :func:`lbfgs`."""
        max_iter = int(kwargs.pop("maxiter", 2000))
        gtol = float(kwargs.pop("gtol", 1e-7))
        memory = int(kwargs.pop("memory_size", 30))

        def value_and_grad(flat):
            flat = flat.detach().requires_grad_(True)
            v = value(flat)
            (g,) = torch.autograd.grad(v, flat)
            return v.detach(), g

        x0 = torch.as_tensor(np.asarray(x0, dtype=np.float32), device=self.device)
        steps = LBFGSPrograms(value_and_grad, x0, memory)
        x, fval, grad, n_iter = _lbfgs_loop(steps, max_iter=max_iter, gtol=gtol, memory=memory)
        gnorm = float(torch.linalg.vector_norm(grad))
        full = self.viewdirs.copy()
        full[free] = x.cpu().numpy().astype(float).reshape(-1, 3)
        result = scipy.optimize.OptimizeResult(
            x=full.ravel(), fun=fval, nit=n_iter, success=bool(np.isfinite(fval)), grad_norm=gnorm,
            message=(
                "device L-BFGS converged (|g| < gtol)" if gnorm < gtol
                else f"device L-BFGS iteration budget spent (|g| = {gnorm:.3e})" if n_iter >= max_iter
                else f"device L-BFGS stopped: line searches fail, the objective is flat to rounding (|g| = {gnorm:.3e})"
            ),
        )
        self.reset_cameras()
        return result


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a; NaN where it has none (optax's and scipy's form)."""
    with np.errstate(all="ignore"):
        db, dc = np.float64(b - a), np.float64(c - a)
        denom = (db * dc) ** 2 * (db - dc)
        u, v = fb - fa - fpa * db, fc - fa - fpa * dc
        A = (dc**2 * u - db**2 * v) / denom
        B = (-(dc**3) * u + db**3 * v) / denom
        return a + (-B + np.sqrt(B * B - 3.0 * A * fpa)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """Critical point of the quadratic through (a, fa), (b, fb) with slope
    fpa at a."""
    with np.errstate(all="ignore"):
        B = (fb - fa - fpa * np.float64(b - a)) / np.float64(b - a) ** 2
        return a - fpa / (2.0 * B)


# optax.lbfgs's line search: scale_by_zoom_linesearch(max_linesearch_steps=
# 20, initial_guess_strategy="one") with its default tolerances.
_LS_STEPS = 20
_SLOPE_RTOL = 1e-4
_CURV_RTOL = 0.9
_APPROX_DEC_RTOL = 1e-6
_INTERVAL_THRESHOLD = 1e-5
# lbfgs stops once this many of the last 2 * _STALL line searches failed.
_STALL = 20


def _zoom_linesearch(steps, value0: float, slope0: float):
    """optax's zoom line search on the line ``x + t u`` of ``steps`` (the
    device side of :func:`lbfgs`: :class:`_TensorSteps` or
    :class:`LBFGSPrograms`): a stepsize meeting the strong Wolfe conditions,
    with Hager and Zhang's approximate sufficient decrease (which a float32
    objective near its optimum needs), found by doubling the step from 1 and
    then zooming by cubic, quadratic or bisection steps. After 20
    evaluations, or once the interval is shorter than 1e-5, it falls back to
    the best step with sufficient decrease, as optax does. Returns
    (stepsize, value, the step's handle for ``steps.accept``, whether the
    conditions were met); ``value0`` and ``slope0`` are the value and
    directional derivative at ``t = 0``.

    Only the objective and its gradient run on the device; the scalars of
    the search are read once an evaluation and kept in float64.
    """

    def errors(t, v, s):
        """Sufficient-decrease and curvature errors, 0 where met; NaN is inf."""
        decrease = v - value0 - _SLOPE_RTOL * t * slope0
        approx = np.maximum(s - (2 * _SLOPE_RTOL - 1.0) * slope0, v - value0 - _APPROX_DEC_RTOL * abs(value0))
        decrease = np.maximum(np.minimum(approx, decrease), 0.0)
        curvature = np.maximum(abs(s) - _CURV_RTOL * abs(slope0), 0.0)
        return tuple(math.inf if math.isnan(e) else float(e) for e in (decrease, curvature))

    t, v, g, s = 0.0, value0, steps.here, slope0
    low, v_low, s_low = 0.0, value0, slope0
    high, v_high = 0.0, value0
    cubic_ref, v_cubic_ref = 0.0, value0
    safe = (0.0, value0, g)
    decrease = math.inf
    found = False
    for count in range(_LS_STEPS):
        if not found:  # grow the step until an interval brackets a minimum
            prev_t, prev_v, prev_s = t, v, s
            t = 1.0 if count == 0 else 2.0 * prev_t
            v, s, g = steps.evaluate(t)
            decrease, curvature = errors(t, v, s)
            if decrease <= 0.0:
                safe = (t, v, steps.keep(g))
            to_high = decrease > 0.0 or (v >= prev_v and count > 0)
            to_low = s >= 0.0 and not to_high
            if to_low:
                low, v_low, s_low, high, v_high = t, v, s, prev_t, prev_v
            else:
                low, v_low, s_low, high, v_high = prev_t, prev_v, prev_s, t, v
            cubic_ref, v_cubic_ref = low, v_low
            if max(decrease, curvature) <= 0.0:
                return t, v, g, True
            found = to_high or to_low
            too_small = False
        else:  # zoom into [low, high]
            delta = abs(high - low)
            left, right = min(high, low), max(high, low)
            too_small = delta <= _INTERVAL_THRESHOLD
            middle = _cubicmin(low, v_low, s_low, high, v_high, cubic_ref, v_cubic_ref)
            if not left + 0.2 * delta < middle < right - 0.2 * delta:
                middle = _quadmin(low, v_low, s_low, high, v_high)
                if not left + 0.1 * delta < middle < right - 0.1 * delta:
                    middle = (low + high) / 2.0
            t = float(middle)
            v, s, g = steps.evaluate(t)
            decrease, curvature = errors(t, v, s)
            if decrease <= 0.0 and v < safe[1]:
                safe = (t, v, steps.keep(g))
            if max(decrease, curvature) <= 0.0:
                return t, v, g, True
            to_high = decrease > 0.0 or v >= v_low
            high_to_low = s * (high - low) >= 0.0 and not to_high
            # The cubic's third point is the end point the new one replaces.
            cubic_ref, v_cubic_ref = (high, v_high) if to_high or high_to_low else (low, v_low)
            if to_high:
                high, v_high = t, v
            elif high_to_low:
                high, v_high = low, v_low
            if not to_high:
                low, v_low, s_low = t, v, s
        if too_small and safe[0] > 0.0:
            break
    if safe[0] > 0.0 or math.isinf(decrease):
        return (*safe, False)
    return t, v, g, False


def _lbfgs_loop(steps, max_iter: int, gtol: float, memory: int):
    """The host side of :func:`lbfgs`, shared by its eager device side
    (:class:`_TensorSteps`) and its programs (:class:`LBFGSPrograms`): the
    stopping rule, the history's scalars (``rho_i = 1 / s_i.y_i``, or 0 where
    ``s_i.y_i`` is 0, and ``gamma``) and the line search, all in float64 on
    the host. Returns (x, value, gradient, iterations)."""
    value = steps.start()
    rho: List[float] = []
    n_iter = 0
    failed = collections.deque(maxlen=2 * _STALL)
    while n_iter == 0 or (n_iter < max_iter and sum(failed) < _STALL and steps.grad_norm() >= gtol):
        if n_iter == 0:
            gamma = min(1.0, 1.0 / steps.grad_norm())
        else:
            sy, yy = steps.push(memory)
            rho.append(0.0 if sy == 0.0 else 1.0 / sy)
            if len(rho) > memory:
                del rho[0]
            gamma = sy / yy if yy > 0.0 else 1.0
        slope0 = steps.direction(gamma, rho)
        t, value, handle, met = _zoom_linesearch(steps, value, slope0)
        failed.append(not met)
        steps.accept(t, handle)
        n_iter += 1
    x, grad = steps.result()
    return x, value, grad, n_iter


class _TensorSteps:
    """The device side of :func:`lbfgs`, eagerly on tensors: the iterate,
    its gradient and the history (lists of tensors, oldest first), one
    launch an operation. It is the reference :class:`LBFGSPrograms` is held
    to bit for bit. A step's handle is its gradient."""

    def __init__(self, value_and_grad, x0) -> None:
        self.value_and_grad = value_and_grad
        self.x = x0.detach().clone()
        self.S: List[torch.Tensor] = []
        self.Y: List[torch.Tensor] = []

    def start(self) -> float:
        """The value at ``x0``; keeps its gradient."""
        value, self.grad = self.value_and_grad(self.x)
        return float(value)

    @property
    def here(self):
        """The handle of the current iterate (its gradient)."""
        return self.grad

    def grad_norm(self) -> float:
        return float(torch.linalg.vector_norm(self.grad))

    def push(self, memory: int) -> Tuple[float, float]:
        """The last step's (s, y) onto the history, the oldest dropped past
        ``memory``; returns (s.y, y.y)."""
        s, y = self.x - self.prev_x, self.grad - self.prev_g
        sy, yy = torch.stack([torch.dot(y, s), torch.dot(y, y)]).tolist()
        self.S.append(s)
        self.Y.append(y)
        if len(self.S) > memory:
            del self.S[0], self.Y[0]
        return sy, yy

    def direction(self, gamma: float, rho: List[float]) -> float:
        """The two-loop recursion: ``q = H g``, the direction ``u = -q``;
        returns ``u.g``."""
        q = self.grad.clone()
        alphas = []
        for s_i, y_i, r_i in zip(reversed(self.S), reversed(self.Y), reversed(rho)):
            alpha = r_i * torch.dot(s_i, q)
            q = q - alpha * y_i
            alphas.append(alpha)
        q = gamma * q
        for s_i, y_i, r_i, alpha in zip(self.S, self.Y, rho, reversed(alphas)):
            q = q + (alpha - r_i * torch.dot(y_i, q)) * s_i
        self.q, self.u = q, -q
        return float(torch.dot(self.u, self.grad))

    def evaluate(self, t: float):
        """(value, ``g.u``, handle) at ``x + t u``."""
        value, grad = self.value_and_grad(self.x + t * self.u)
        v, s = torch.stack([value, torch.dot(grad, self.u)]).tolist()
        return v, s, grad

    def keep(self, handle):
        return handle

    def accept(self, t: float, grad) -> None:
        """Move to ``x - t q``, whose gradient ``grad`` is."""
        self.prev_x, self.prev_g = self.x, self.grad
        self.x = self.x - t * self.q
        self.grad = grad

    def result(self):
        return self.x, self.grad


def _lbfgs_evaluation(value_and_grad, x, t, u, grad) -> dict:
    """:class:`LBFGSPrograms`' evaluation on its buffers: at ``x_t = x + t
    u``, the value and gradient, ``s = x_t - x``, ``y = g_t - g`` and the
    scalars ``[value, g_t.u, s.y, y.y, |g_t|]``."""
    x_t = x + t[0] * u
    value, grad_t = value_and_grad(x_t)
    s, y = x_t - x, grad_t - grad
    scalars = torch.stack([value, torch.dot(grad_t, u), torch.dot(y, s), torch.dot(y, y),
                           torch.linalg.vector_norm(grad_t)])
    return {"x": x_t, "g": grad_t, "s": s, "y": y, "scalars": scalars}


def _lbfgs_direction(level: int, grad, u, S, Y, scalars) -> torch.Tensor:
    """:class:`LBFGSPrograms`' direction on its buffers: the two-loop
    recursion over the first ``level`` rows of the history ``S``, ``Y``
    (``scalars``: gamma, then each row's rho), ``u = -q`` written into
    ``u``; returns ``u.g``. The operations of :meth:`_TensorSteps.direction`."""
    n, gamma, rho = grad.numel(), scalars[0], scalars[1:]
    q = grad.clone()
    alphas = []
    for i in reversed(range(level)):
        alpha = rho[i] * torch.dot(S[i, :n], q)
        q = q - alpha * Y[i, :n]
        alphas.append(alpha)
    q = gamma * q
    for i, alpha in zip(range(level), reversed(alphas)):
        q = q + (alpha - rho[i] * torch.dot(Y[i, :n], q)) * S[i, :n]
    torch.neg(q, out=u)
    return torch.dot(u, grad)


class LBFGSPrograms:
    """The device side of :func:`lbfgs` as programs over static buffers
    (:class:`graphs.Program`): the port's counterpart of the reference's
    L-BFGS loop compiled as one ``lax.while_loop``
    (``ObserverCameras._fit_lbfgs_device``). The host keeps the scalar
    logic of :func:`_lbfgs_loop` and :func:`_zoom_linesearch`; on a card
    each evaluation and each direction is one graph replay:

    - an evaluation: ``x_t = x + t u``, the value and gradient at ``x_t``,
      and, for the step's acceptance, ``s = x_t - x``, ``y = g_t - g``; it
      writes ``[value, g_t.u, s.y, y.y, |g_t|]``, read once;
    - a direction: the two-loop recursion over the history's first L rows,
      one program a fill level L = 0..``memory``, writing ``u = -q`` and
      ``u.g``, read once.

    The iterate, its gradient, the direction and the history ((memory, n)
    rows, oldest first, each row starting on a 512-byte line as a fresh
    tensor does) live in buffers of their own; once the history is full, a
    new pair shifts it by one row by copy. ``t``, ``gamma`` and each
    ``rho_i`` enter as float32 device scalars, copied in before each
    replay: torch rounds a Python float to float32 the same way in the
    eager ``t * u``. Accepting a step copies the evaluation's ``x_t``,
    ``g_t``, ``s`` and ``y`` into the buffers (an earlier evaluation's are
    copied aside before a later one overwrites them). Results are bit for
    bit those of :class:`_TensorSteps`. A step's handle is the number of
    its evaluation, -1 for the current iterate.
    """

    def __init__(self, value_and_grad, x0, memory: int) -> None:
        self.value_and_grad = value_and_grad
        self.device = x0.device
        self.memory = int(memory)
        x0 = x0.detach()
        n = x0.numel()
        stride = -(-n // 128) * 128  # 512-byte rows, as fresh allocations

        def zeros(*shape):
            return torch.zeros(*shape, dtype=x0.dtype, device=self.device)

        self.x = x0.clone()
        self.grad = zeros(n)
        self.u = zeros(n)
        self.S, self.Y = zeros(self.memory, stride), zeros(self.memory, stride)
        self.shifted = zeros(max(self.memory - 1, 0), stride)
        self.saved = {k: zeros(n) for k in ("x", "g", "s", "y")}
        self.t = zeros(1)
        self.scalars = zeros(1 + self.memory)  # gamma, rho_0..rho_{memory-1}
        self.n = n
        self.fill = 0
        self.evaluation = graphs.Program(
            functools.partial(_lbfgs_evaluation, value_and_grad, self.x, self.t, self.u, self.grad), self.device,
            "an L-BFGS evaluation")
        self.directions: Dict[int, graphs.Program] = {}
        self.evaluations = 0  # the handle of the last evaluation is evaluations - 1
        self.latest = None  # its outputs and scalars
        self.kept = None  # the evaluation that keep() marked
        self.saved_at = None  # the evaluation whose outputs ``saved`` holds
        self.saved_scalars = None
        self.pair = None  # (s.y, y.y) of the accepted step
        self.norm = None  # |g| of the current iterate

    def _direction(self, level: int) -> graphs.Program:
        """The direction program over the history's first ``level`` rows, built at first use."""
        if level not in self.directions:
            self.directions[level] = graphs.Program(
                functools.partial(_lbfgs_direction, level, self.grad, self.u, self.S, self.Y, self.scalars),
                self.device, f"an L-BFGS direction over {level} pairs")
        return self.directions[level]

    def _write(self, buffer: torch.Tensor, values) -> None:
        """Host scalars into a device buffer: one copy, rounded to its type on the host."""
        buffer.copy_(torch.tensor(values, dtype=buffer.dtype))

    def start(self) -> float:
        value, grad = self.value_and_grad(self.x)
        self.grad.copy_(grad)
        self.norm = float(torch.linalg.vector_norm(self.grad))
        return float(value)

    here = -1

    def grad_norm(self) -> float:
        return self.norm

    def push(self, memory: int) -> Tuple[float, float]:
        return self.pair

    def direction(self, gamma: float, rho: List[float]) -> float:
        level = len(rho)
        self._write(self.scalars, [gamma] + rho + [0.0] * (self.memory - level))
        return float(self._direction(level)())

    def evaluate(self, t: float):
        if self.kept is not None and self.kept == self.evaluations - 1 and self.saved_at != self.kept:
            for k, buffer in self.saved.items():  # the kept step's outputs, before the replay overwrites them
                buffer.copy_(self.latest[0][k])
            self.saved_scalars, self.saved_at = self.latest[1], self.kept
        self._write(self.t, [t])
        out = self.evaluation()
        self.latest = (out, out["scalars"].tolist())
        self.evaluations += 1
        v, s = self.latest[1][:2]
        return v, s, self.evaluations - 1

    def keep(self, handle: int) -> int:
        self.kept = handle
        return handle

    def accept(self, t: float, handle: int) -> None:
        if handle == self.here:  # no step: x + 0 u, the gradient kept
            self._write(self.t, [t])
            x = self.x + self.t[0] * self.u
            s, y = x - self.x, self.grad - self.grad
            step = {"x": x, "g": self.grad, "s": s, "y": y}
            self.pair = tuple(torch.stack([torch.dot(y, s), torch.dot(y, y)]).tolist())
        else:
            if handle == self.evaluations - 1:
                step, scalars = self.latest[0], self.latest[1]
            elif handle == self.saved_at:
                step, scalars = self.saved, self.saved_scalars
            else:
                raise AssertionError(f"evaluation {handle} was neither the last nor kept")
            self.pair, self.norm = tuple(scalars[2:4]), scalars[4]
        self.x.copy_(step["x"])
        if step["g"] is not self.grad:
            self.grad.copy_(step["g"])
        if self.memory:
            n, row = self.n, min(self.fill, self.memory - 1)
            if self.fill == self.memory:  # drop the oldest pair
                for ring in (self.S, self.Y):
                    self.shifted.copy_(ring[1:])
                    ring[:-1].copy_(self.shifted)
            self.S[row, :n].copy_(step["s"])
            self.Y[row, :n].copy_(step["y"])
            self.fill = min(self.fill + 1, self.memory)
        self.kept = None

    def result(self):
        return self.x.clone(), self.grad.clone()


def lbfgs(value_and_grad, x0, max_iter: int = 2000, gtol: float = 1e-7, memory: int = 30):
    """Minimize with ``optax.lbfgs(memory_size=memory)`` semantics: the
    two-loop recursion over the last ``memory`` (step, gradient change)
    pairs, the identity scaled by ``s.y / y.y`` (by ``min(1, 1 / |g|)`` on the
    first step), and :func:`_zoom_linesearch` from a unit step; iterations
    continue while ``|g|_2 >= gtol``, fewer than ``max_iter`` have run and
    fewer than 20 of the last 40 line searches have failed.

    ``value_and_grad(x) -> (value, gradient)`` as tensors on ``x0``'s device.
    Returns (x, value, gradient, iterations). This is the eager form, one
    launch an operation (:class:`_TensorSteps`); :meth:`ObserverCameras.fit`
    runs the same host logic over :class:`LBFGSPrograms`. Where it differs
    from the reference's jitted loop: it runs on the host, reading the card
    once per line-search evaluation; the search's scalars are float64 on the
    host (float32 on the device in optax); memory slots not yet written are
    skipped, which is exact (they carry zero weight); and the stop on failed
    line searches, which optax lacks: once the float32 objective is flat to its
    rounding, searches keep failing (every other one, say), each spending
    its 20 evaluations on a step of no measurable gain, and optax goes on
    doing so to ``max_iter``.
    """
    return _lbfgs_loop(_TensorSteps(value_and_grad, x0), max_iter, gtol, memory)


# ---- Keypoints ---- #


def _cv2():
    """OpenCV, or None where it does not import (imported at first use)."""
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def detect_keypoints(array, mask=None, method=None, root: bool = False, **kwargs):
    """Keypoints and descriptors on the host by OpenCV (SIFT by default,
    RootSIFT with ``root``). Raises ImportError without OpenCV."""
    cv2 = _cv2()
    if cv2 is None:
        raise ImportError("OpenCV is required for keypoint detection")
    detector = (cv2.SIFT if method is None else method).create(**kwargs)
    img8 = np.asarray(array, dtype=np.uint8)
    mask8 = None if mask is None else np.asarray(mask, dtype=np.uint8)
    keypoints, descriptors = detector.detectAndCompute(img8, mask=mask8)
    if root and descriptors is not None:
        # RootSIFT: L1-normalize, then take the elementwise square root.
        l1 = descriptors.sum(axis=1, keepdims=True) + 1e-7
        descriptors = np.sqrt(descriptors / l1)
    return keypoints, descriptors


# cv2.SIFT_create keyword names the device detector accepts (values are
# translated, not emulated).
_DEVICE_DETECTOR_KWARGS = {
    "contrastThreshold": "contrast_threshold",
    "edgeThreshold": "edge_ratio",
    "sigma": "sigma0",
    "nOctaveLayers": "n_scales",
}


def detect_keypoints_device(arrays, masks=None, **kwargs):
    """Keypoints on the device (:func:`ops.features.detect_and_describe`,
    which takes ``device=``); accepts the common ``cv2.SIFT_create`` keyword
    spellings. Returns ``(pts (n, 2), descriptors (n, 128))`` per image."""
    for cv2_name, ours in _DEVICE_DETECTOR_KWARGS.items():
        if cv2_name in kwargs:
            kwargs[ours] = kwargs.pop(cv2_name)
    return features.detect_and_describe(arrays, masks=masks, **kwargs)


def _empty_match(return_ratios: bool):
    e = np.empty((0, 2), dtype=float)
    return (e, e.copy(), np.empty(0, dtype=float)) if return_ratios else (e, e.copy())


def match_keypoints_device(ka, kb, cross_check: bool = False, max_ratio: float = None, max_distance: float = None,
                           return_ratios: bool = False, matcher=None, device="cuda"):
    """Match two images' ``(keypoints, descriptors)`` on the device.

    ``matcher`` is a :class:`ops.matching.DescriptorMatcher`; None (or a
    string) takes the process's shared matcher on ``device``. Returns
    ``(uva, uvb)``, plus the ratios with ``return_ratios``; ``max_distance``
    drops matches at least that many pixels apart.
    """
    if matcher is None or isinstance(matcher, str):
        matcher = _shared_device_matcher(device)
    pairs, ratios = matcher.match(ka[1], kb[1], max_ratio=max_ratio, cross_check=cross_check)
    if not len(pairs):
        return _empty_match(return_ratios)
    uva = _keypoint_pts(ka[0])[pairs[:, 0]]
    uvb = _keypoint_pts(kb[0])[pairs[:, 1]]
    if max_distance:
        ok = np.linalg.norm(uva - uvb, axis=1) < max_distance
        uva, uvb, ratios = uva[ok], uvb[ok], ratios[ok]
    return (uva, uvb, ratios) if return_ratios else (uva, uvb)


_KEYPOINT_PTS_CACHE: Dict[int, tuple] = {}


def _keypoint_pts(keypoints) -> np.ndarray:
    """(n, 2) coordinates of a ``cv2.KeyPoint`` list, cached by identity
    (an image's keypoints serve all its pairs); device keypoints are
    coordinate arrays already."""
    if isinstance(keypoints, np.ndarray):
        return keypoints
    key = id(keypoints)
    hit = _KEYPOINT_PTS_CACHE.get(key)
    if hit is not None and hit[0] is keypoints:
        return hit[1]
    if len(_KEYPOINT_PTS_CACHE) > 256:
        _KEYPOINT_PTS_CACHE.clear()
    pts = np.array([k.pt for k in keypoints], dtype=float).reshape(-1, 2)
    _KEYPOINT_PTS_CACHE[key] = (keypoints, pts)
    return pts


_DEVICE_MATCHERS: Dict[torch.device, DescriptorMatcher] = {}


def _shared_device_matcher(device="cuda") -> DescriptorMatcher:
    """One :class:`DescriptorMatcher` per device for the process, so its
    cache of descriptor stacks on the device serves every call."""
    device = torch.device(device)
    if device not in _DEVICE_MATCHERS:
        _DEVICE_MATCHERS[device] = DescriptorMatcher(device=device)
    return _DEVICE_MATCHERS[device]


def match_keypoints(ka, kb, mask=None, cross_check: bool = False, max_ratio: float = None,
                    max_distance: float = None, return_ratios: bool = False, matcher=None, device="cuda"):
    """Match keypoint descriptors (FLANN kNN with Lowe's ratio and a cross check).

    ``matcher='device'``, or any matcher without ``knnMatch``, routes to
    :func:`match_keypoints_device` on ``device``; a cv2 matcher is used as
    given; None builds a FLANN matcher (ImportError without OpenCV).
    """
    if matcher == "device" or (matcher is not None and not hasattr(matcher, "knnMatch")):
        return match_keypoints_device(
            ka, kb, cross_check=cross_check, max_ratio=max_ratio, max_distance=max_distance,
            return_ratios=return_ratios, matcher=None if isinstance(matcher, str) else matcher, device=device,
        )
    cv2 = _cv2()
    if cv2 is None:
        raise ImportError("OpenCV is required for keypoint matching")
    if matcher is None:
        matcher = cv2.FlannBasedMatcher()
    if mask is not None:
        mask = np.asarray(mask, dtype=np.uint8)
    k = 2 if (max_ratio or return_ratios) else 1
    if len(ka[0]) < k or len(kb[0]) < k:
        return _empty_match(return_ratios)
    matches = matcher.knnMatch(ka[1], kb[1], k=k, mask=mask)
    if cross_check:
        matches_ba = matcher.knnMatch(kb[1], ka[1], k=k, mask=mask)
        ba = {(m[0].trainIdx, m[0].queryIdx) for m in matches_ba}
        matches = [m for m in matches if (m[0].queryIdx, m[0].trainIdx) in ba]
    if max_ratio:
        # A zero second-nearest distance (duplicate descriptors) makes the
        # ratio test degenerate: such matches are ambiguous, so they go.
        matches = [m for m in matches if m[1].distance > 0 and m[0].distance / m[1].distance < max_ratio]
    if not matches:
        return _empty_match(return_ratios)
    uva = _keypoint_pts(ka[0])[[m[0].queryIdx for m in matches]]
    uvb = _keypoint_pts(kb[0])[[m[0].trainIdx for m in matches]]
    if return_ratios:
        ratios = np.array([m.distance / max(n_.distance, 1e-12) for m, n_ in matches])
    if max_distance:
        valid = np.linalg.norm(uva - uvb, axis=1) < max_distance
        uva, uvb = uva[valid], uvb[valid]
        if return_ratios:
            ratios = ratios[valid]
    return (uva, uvb, ratios) if return_ratios else (uva, uvb)


class _NumpyCLAHE:
    """A ``cv2.CLAHE``-like object over :func:`helpers.clahe` (``apply``)."""

    def __init__(self, clip_limit: float, tile_grid_size) -> None:
        self.clip_limit = float(clip_limit)
        self.tile_grid_size = tuple(tile_grid_size)

    def apply(self, array: np.ndarray) -> np.ndarray:
        return helpers.clahe(array, self.clip_limit, self.tile_grid_size)


class KeypointMatcher:
    """Keypoints of an image sequence and matches between time-windowed pairs.

    Keypoints and each pair's matches are cached as pickle files; the
    matches are an upper-triangular COO matrix of :class:`Matches`. The
    device detector, matcher and match refiner run on ``device``.
    """

    def __init__(self, images: Iterable, clahe=False, device="cuda") -> None:
        ordered = list(images)
        times = [img.datetime for img in ordered]
        if any(b < a for a, b in zip(times, times[1:])):
            raise ValueError("Images are not in ascending temporal order")
        self.images = np.asarray(ordered, dtype=object)
        self.clahe = self._make_clahe(clahe)
        self.device = torch.device(device)
        self.keypoints = None
        self.matches = None

    @staticmethod
    def _make_clahe(spec):
        if spec is False:
            return None
        cv2 = _cv2()
        if cv2 is not None:
            return cv2.createCLAHE(**({} if spec is True else spec))
        # Without OpenCV: NumPy CLAHE under cv2's keyword names.
        kwargs = {} if spec is True else dict(spec)
        clip_limit = kwargs.pop("clipLimit", 40.0)
        tile_grid_size = kwargs.pop("tileGridSize", (8, 8))
        if kwargs:
            raise TypeError(f"Unknown CLAHE options: {sorted(kwargs)}")
        return _NumpyCLAHE(clip_limit, tile_grid_size)

    def _basenames(self) -> List[str]:
        basenames = [helpers.strip_path(img.path) for img in self.images]
        if len(basenames) != len(set(basenames)):
            raise ValueError("Image basenames are not unique")
        return basenames

    def _prepare_image(self, array: np.ndarray) -> np.ndarray:
        if array.ndim > 2:
            array = array.mean(axis=2)
        array = array.astype(np.uint8, copy=False)
        if self.clahe is not None:
            array = self.clahe.apply(array)
        return array

    def build_keypoints(self, masks=None, path=None, overwrite: bool = False, clear_images: bool = True,
                        clear_keypoints: bool = False, parallel=False, detector=None, **kwargs: Any) -> None:
        """Detect (or load cached) keypoints for every image.

        ``detector='device'`` detects in batches of one image shape on
        ``device`` (:func:`detect_keypoints_device`); otherwise OpenCV on the
        host, one image a task. Both keep one pickle an image under ``path``
        and compute only what is neither in memory nor on disk (all of it
        with ``overwrite``); ``clear_keypoints`` keeps nothing in memory.
        """
        if path:
            path = Path(path)
        if clear_keypoints and not path:
            raise ValueError("path is required when clear_keypoints is True")
        if path and path.is_file():
            raise ValueError("path must be a directory")
        basenames = self._basenames()
        if masks is None or isinstance(masks, np.ndarray):
            masks = [masks] * len(self.images)
        parallel = helpers._parse_parallel(parallel)
        if not self.keypoints:
            self.keypoints = [None] * len(self.images)
        if detector == "device":
            self._build_keypoints_device(masks, path, basenames, overwrite=overwrite, clear_images=clear_images,
                                         clear_keypoints=clear_keypoints, **kwargs)
            return

        def detect(i: int, img):
            array = self._prepare_image(img.read())
            found = detect_keypoints(array, mask=masks[i], **kwargs)
            if clear_images:
                img.array = None
            return found

        def job(i: int, img):
            cache_file = path / f"{basenames[i]}.pkl" if path else None
            on_disk = cache_file is not None and cache_file.exists()
            known = self.keypoints[i]
            if overwrite or (known is None and not on_disk):
                known = detect(i, img)
                if cache_file:
                    helpers.write_pickle(known, path=cache_file)
            elif known is not None:
                if cache_file and not on_disk:
                    helpers.write_pickle(known, path=cache_file)
            elif not clear_keypoints:
                known = helpers.read_pickle(cache_file)
            return None if clear_keypoints else known

        with config.backend(np=parallel) as pool:
            self.keypoints = pool.map(func=job, sequence=tuple(enumerate(self.images)), star=True)

    def _build_keypoints_device(self, masks, path, basenames, overwrite: bool, clear_images: bool,
                                clear_keypoints: bool, **kwargs: Any) -> None:
        """The device detector under the host path's cache contract."""
        cache_files = [path / f"{basenames[i]}.pkl" if path else None for i in range(len(self.images))]
        todo = []
        for i in range(len(self.images)):
            on_disk = cache_files[i] is not None and cache_files[i].exists()
            if overwrite or (self.keypoints[i] is None and not on_disk):
                todo.append(i)
            elif self.keypoints[i] is not None:
                if cache_files[i] and not on_disk:
                    helpers.write_pickle(self.keypoints[i], path=cache_files[i])
            elif not clear_keypoints:
                self.keypoints[i] = helpers.read_pickle(cache_files[i])
        arrays = {}
        for i in todo:
            arrays[i] = self._prepare_image(self.images[i].read())
            if clear_images:
                self.images[i].array = None
        # One batch stream per image shape.
        by_shape: Dict[tuple, list] = {}
        for i in todo:
            by_shape.setdefault(arrays[i].shape, []).append(i)
        kwargs.setdefault("device", self.device)
        for idxs in by_shape.values():
            found = detect_keypoints_device([arrays[i] for i in idxs], masks=[masks[i] for i in idxs], **kwargs)
            for i, kp in zip(idxs, found):
                if cache_files[i]:
                    helpers.write_pickle(kp, path=cache_files[i])
                self.keypoints[i] = None if clear_keypoints else kp

    def _matching_images(self, maxdt, seq, imgs) -> List[np.ndarray]:
        """For each image, the later images it is matched to."""
        n = len(self.images)
        if maxdt is None and seq is None:
            matching_images = [np.arange(i + 1, n) for i in range(n)]
        elif maxdt is not None:
            datetimes = np.array([img.datetime for img in self.images])
            ends = np.searchsorted(datetimes, datetimes + maxdt, side="right")
            matching_images = [np.arange(i + 1, end) for i, end in enumerate(ends)]
        else:
            matching_images = [np.array([], dtype=int) for _ in range(n)]
        if seq is not None:
            seq = np.asarray(seq)
            seq = np.unique(seq[seq > 0])
            for i, m in enumerate(matching_images):
                iseq = seq + i
                iseq = iseq[: np.searchsorted(iseq, n)]
                matching_images[i] = np.unique(np.concatenate((m, iseq)))
        if imgs is not None:
            for i, m in enumerate(matching_images):
                matching_images[i] = m if i in imgs else m[np.isin(m, imgs)]
        return matching_images

    def build_matches(self, maxdt=None, seq: Iterable[int] = None, imgs: Iterable[int] = None,
                      keypoints_path=None, path=None, overwrite: bool = False, clear_keypoints: bool = True,
                      clear_matches: bool = False, parallel=False, weights: bool = False, mtype=None,
                      filter: dict = None, refine=False, **kwargs: Any) -> None:
        """Match each image to its neighbours in time (``maxdt`` window,
        ``seq`` offsets, restricted to ``imgs``).

        With ``matcher='device'`` every pair not yet cached is matched up
        front in batches on ``device`` (``DescriptorMatcher.match_pairs``);
        ``refine`` (device matcher only; True or a dict of
        :class:`ops.refine.MatchRefiner` options) then re-measures each
        matched displacement by template correlation on images re-read
        through the same grayscale and CLAHE preparation. Each pair is
        cached as a pickle under ``path``. ``weights`` makes each match's
        weight its inverse Lowe ratio; ``mtype`` converts, ``filter`` filters.
        """
        if path:
            path = Path(path)
        if keypoints_path:
            keypoints_path = Path(keypoints_path)
        if clear_matches and not path:
            raise ValueError("path is required when clear_matches is True")
        if path and path.is_file():
            raise ValueError("path must be a directory")
        parallel = helpers._parse_parallel(parallel)
        kwargs = {**kwargs, "return_ratios": weights}
        basenames = self._basenames()
        if self.keypoints is None:
            self.keypoints = [None] * len(self.images)
        if any(k is None for k in self.keypoints) and not keypoints_path:
            raise ValueError("Missing keypoints so keypoints_path is required")
        n = len(self.images)
        matching_images = self._matching_images(maxdt, seq, imgs)

        def ensure_keypoints(k: int):
            if self.keypoints[k] is None:
                self.keypoints[k] = helpers.read_pickle(keypoints_path / f"{basenames[k]}.pkl")
            return self.keypoints[k]

        def pair_file(i, j):
            return path / f"{basenames[i]}-{basenames[j]}.pkl" if path else None

        # Device path: every pair not yet cached, matched up front in batches.
        precomputed = None
        if kwargs.get("matcher") == "device":
            need = [
                (int(i), int(j)) for i, js in enumerate(matching_images) for j in js
                if overwrite or pair_file(i, j) is None or not pair_file(i, j).exists()
            ]
            precomputed = {}
            if need:
                involved = {k for ij in need for k in ij}
                for k in involved:
                    ensure_keypoints(k)
                no_desc = np.empty((0, 1), dtype=np.float32)
                descs = [
                    self.keypoints[k][1]
                    if k in involved and self.keypoints[k] is not None and self.keypoints[k][1] is not None
                    else no_desc
                    for k in range(n)
                ]
                found_all = _shared_device_matcher(self.device).match_pairs(
                    descs, np.asarray(need, dtype=int), max_ratio=kwargs.get("max_ratio"),
                    cross_check=kwargs.get("cross_check", False),
                )
                max_distance = kwargs.get("max_distance")
                no_uv = np.empty((0, 2), dtype=float)
                for (i, j), (idx, ratios) in zip(need, found_all):
                    if len(idx):
                        uva = _keypoint_pts(self.keypoints[i][0])[idx[:, 0]]
                        uvb = _keypoint_pts(self.keypoints[j][0])[idx[:, 1]]
                    else:
                        uva, uvb = no_uv, no_uv.copy()
                    if max_distance:
                        ok = np.linalg.norm(uva - uvb, axis=1) < max_distance
                        uva, uvb, ratios = uva[ok], uvb[ok], ratios[ok]
                    precomputed[(i, j)] = (uva, uvb, ratios) if weights else (uva, uvb)
                if refine and precomputed:
                    from .ops.refine import MatchRefiner

                    options = {"device": self.device, **(refine if isinstance(refine, dict) else {})}
                    keys = list(precomputed)
                    refined = MatchRefiner(**options).refine_pairs(
                        keys, [precomputed[key][:2] for key in keys],
                        lambda k: self._prepare_image(self.images[k].read()),
                    )
                    for key, ruv in zip(keys, refined):
                        precomputed[key] = tuple(ruv) + precomputed[key][2:]

        def match_pair(i: int, j: int):
            """The pair's cached match, or a new one (cached); None when it
            is not kept in memory."""
            cams = (self.images[i].cam, self.images[j].cam)
            cache_file = pair_file(i, j)
            if cache_file and cache_file.exists() and not overwrite:
                if clear_matches:
                    return None
                match = helpers.read_pickle(cache_file)
                match.cams = cams
            else:
                found = precomputed.pop((int(i), int(j)), None) if precomputed is not None else None
                if found is None:
                    found = match_keypoints(ensure_keypoints(i), ensure_keypoints(j), device=self.device, **kwargs)
                match = Matches(cams=cams, uvs=list(found[0:2]), weights=(1 / found[2]) if weights else None)
                if cache_file:
                    helpers.write_pickle(match, cache_file)
                if clear_matches:
                    return None
            return match.to_type(mtype) if mtype is not None else match

        def process(i: int, js: np.ndarray):
            found = [match_pair(i, j) for j in js]
            if clear_keypoints:
                self.keypoints[i] = None
            return None if clear_matches else found

        def reduce(matches=None):
            # A task that keeps nothing in memory returns None, and the pool
            # then calls reduce() with no argument.
            if filter and matches:
                for match in matches:
                    if match:
                        match.filter(**filter)
            return matches

        with config.backend(np=parallel) as pool:
            results = pool.map(func=process, reduce=reduce, star=True, sequence=tuple(enumerate(matching_images)))
        if clear_matches:
            self.matches = None
            return
        data = np.concatenate([np.asarray(r, dtype=object) for r in results])
        rows = np.concatenate([np.full(len(row), i, dtype=int) for i, row in enumerate(matching_images)])
        cols = np.concatenate(matching_images) if len(matching_images) else np.array([])
        matches = scipy.sparse.coo_matrix((np.ones(len(data)), (rows, cols)))
        matches.data = data
        self.matches = matches
        self._assign_cameras()

    def _test_matches(self) -> None:
        if self.matches is None:
            raise ValueError("Matches have not been initialized. Run build_matches()")

    def _assign_cameras(self) -> None:
        for m, i, j in zip(self.matches.data, self.matches.row, self.matches.col):
            m.cams = (self.images[i].cam, self.images[j].cam)

    def convert_matches(self, mtype, clear_uvs: bool = False, parallel=False) -> None:
        """Convert every match to another type (optionally dropping uvs)."""
        self._test_matches()
        for i, m in enumerate(self.matches.data):
            m = m.to_type(mtype)
            if clear_uvs and mtype in (RotationMatchesXY, RotationMatchesXYZ):
                m.uvs = None
            self.matches.data[i] = m

    def filter_matches(self, clear_weights: bool = False, **kwargs: Any) -> None:
        """Filter every match in place."""
        self._test_matches()
        for m in self.matches.data:
            if kwargs:
                m.filter(**kwargs)
            if clear_weights:
                m.weights = None

    def _images_mask(self, imgs) -> np.ndarray:
        if np.iterable(imgs):
            return np.isin(self.matches.row, imgs) | np.isin(self.matches.col, imgs)
        return (self.matches.row == imgs) | (self.matches.col == imgs)

    def matches_per_image(self) -> np.ndarray:
        """Matched points per image, over all its pairs."""
        self._test_matches()
        return np.array(
            [np.sum([m.size for m in self.matches.data[self._images_mask(i)]]) for i in range(len(self.images))]
        )

    def images_per_image(self) -> np.ndarray:
        """How many images each image has matches with."""
        self._test_matches()
        return np.array(
            [np.sum([m.size > 0 for m in self.matches.data[self._images_mask(i)]]) for i in range(len(self.images))]
        )

    def drop_images(self, imgs) -> None:
        """Drop images and all their matches, renumbering the rest densely."""
        self._test_matches()
        hit = self._images_mask(imgs)
        self.matches.data[hit] = False
        self.matches.eliminate_zeros()
        survivors = np.union1d(self.matches.row, self.matches.col)
        remap = np.full(len(self.images), -1, dtype=int)
        remap[survivors] = np.arange(survivors.size)
        self.matches.row = remap[self.matches.row]
        self.matches.col = remap[self.matches.col]
        self.matches._shape = (survivors.size, survivors.size)
        self.images = self.images[survivors]

    def match_breaks(self, min_matches: int = 0) -> np.ndarray:
        """Images where the chain of matched pairs breaks: fewer than
        ``max(1, min_matches)`` pairs start there (capped by how many later
        images exist)."""
        self._test_matches()
        n = len(self.images)
        pairs_from = np.zeros(n - 1, dtype=int)
        starts, counts = np.unique(self.matches.row, return_counts=True)
        pairs_from[starts] = counts
        available = (n - 1) - np.arange(n - 1)
        required = np.maximum(1, np.minimum(min_matches, available))
        return np.flatnonzero(pairs_from < required)


# ---- Batch reprojection ---- #


def project_images(cam: Camera, images: Iterable, paths: Iterable, u: np.ndarray = None, v: np.ndarray = None,
                   overwrite: bool = False, method: str = "linear", grayscale: bool = False, parallel=False,
                   device="cuda") -> None:
    """Reproject an image sequence into one ideal camera (a stabilized sequence).

    The target grid (pixel centres, or the ``u`` x ``v`` grid) is cast out
    once through ``cam`` in float64 on the host; each image projects it
    through its own camera, and each band is sampled there in float64 on
    ``device`` (:func:`ops.sampling.sample_grid`, bilinear or nearest;
    outside the image 0), so the written arrays equal a float64 NumPy
    evaluation. Each result is written as a GeoTIFF to its path; existing
    files are kept unless ``overwrite``.
    """
    from .io import geotiff
    from .ops import sampling

    paths = [str(path) for path in paths]
    if len(paths) != len(set(paths)):
        raise ValueError("Image output paths are not unique")
    if u is None:
        u = np.linspace(0.5, cam.imgsz[0] - 0.5, int(cam.imgsz[0]))
    if v is None:
        v = np.linspace(0.5, cam.imgsz[1] - 0.5, int(cam.imgsz[1]))
    U, V = np.meshgrid(u, v)
    uv = np.column_stack((U.ravel(), V.ravel()))
    dxyz = cam.uv_to_xyz(uv)
    parallel = helpers._parse_parallel(parallel)
    order = {"linear": 1, "nearest": 0}[method]
    device = torch.device(device)

    def process(image, path: str) -> None:
        path = Path(path)
        if path.exists() and not overwrite:
            return None
        puv = image.cam.xyz_to_uv(dxyz, directions=True)
        finite = np.isfinite(puv).all(axis=1)
        seen = puv[finite]
        box_min = np.maximum(np.floor(seen.min(axis=0)).astype(int), 0)
        box_max = np.minimum(np.ceil(seen.max(axis=0)).astype(int), image.cam.imgsz)
        local = puv - box_min
        array = image.read(box=[*box_min, *box_max])
        if array.ndim < 3:
            array = array[:, :, None]
        if grayscale:
            array = array.mean(axis=2, keepdims=True)
        H, W = array.shape[0:2]
        rows = local[:, 1] - 0.5
        cols = local[:, 0] - 0.5
        oob = ~finite | (rows < -0.5) | (rows > H - 0.5) | (cols < -0.5) | (cols > W - 0.5)
        rows_t = torch.from_numpy(np.where(oob, 0.0, rows)).to(device)
        cols_t = torch.from_numpy(np.where(oob, 0.0, cols)).to(device)
        bands = []
        for i in range(array.shape[2]):
            band = torch.from_numpy(np.ascontiguousarray(array[:, :, i], dtype=float)).to(device)
            vals = sampling.sample_grid(band, rows_t, cols_t, order=order).cpu().numpy()
            vals[oob] = 0
            bands.append(vals.reshape(len(v), len(u)).astype(array.dtype))
        path.parent.mkdir(parents=True, exist_ok=True)
        geotiff.write(str(path), np.dstack(bands))
        return None

    with config.backend(np=parallel) as pool:
        pool.map(func=process, sequence=tuple(zip(images, paths)), star=True)


# ---- RANSAC ---- #


def ransac(
    model,
    n: int,
    max_error: float,
    min_inliers: int,
    iterations: int = 100,
    rng: np.random.Generator = None,
    **kwargs: Any,
) -> Tuple[np.ndarray, np.ndarray]:
    """Random Sample Consensus over any model with .size/.fit/.errors.

    Samples are drawn without replacement and never repeat.
    """
    rng = np.random.default_rng() if rng is None else rng
    everything = np.arange(model.size)

    def evaluate(sample: np.ndarray):
        """Fit on the sample, grow a consensus set, refit, score."""
        seed_params = model.fit(sample, **kwargs)
        if seed_params is None:
            return None
        rest = np.setdiff1d(everything, sample)
        close = rest[model.errors(seed_params, rest) < max_error]
        if close.size <= min_inliers:
            return None
        consensus = np.concatenate((sample, close))
        refined = model.fit(consensus, **kwargs)
        if refined is None:
            return None
        return float(np.mean(model.errors(refined, consensus))), refined

    best_err, best_params = np.inf, None
    for sample in _ransac_samples(
        n=n, size=model.size, iterations=iterations, rng=rng
    ):
        scored = evaluate(np.asarray(sample))
        if scored is not None and scored[0] < best_err:
            best_err, best_params = scored
    if best_params is None:
        raise ValueError("Best fit does not meet acceptance criteria")
    inliers = np.flatnonzero(model.errors(best_params) <= max_error)
    return best_params, inliers


def _ransac_samples(
    n: int, size: int, iterations: int = 100, rng: np.random.Generator = None
) -> Generator[List[int], None, None]:
    """Yield non-repeating random index samples of size n."""
    if rng is None:
        rng = np.random.default_rng()
    if n >= size:
        raise ValueError("Sample size is larger or equal to total size")
    log = math.lgamma(size + 1) - math.lgamma(n + 1) - math.lgamma(size - n + 1)
    if log < 700:  # avoid float overflow in exp
        iterations = min(iterations, int(np.floor(np.exp(log))))
    seen = set()
    indices = np.arange(size)
    while len(seen) < iterations:
        rng.shuffle(indices)
        sample = frozenset(indices[:n])
        if sample not in seen:
            yield list(sample)
            seen.add(sample)
