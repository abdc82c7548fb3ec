"""Regular grids, rasters (DEMs, orthoimages), and raster time series.

The counterpart of :mod:`glimpse_tpu.raster` (``Grid``, ``Raster``,
``RasterInterpolant``): GDAL-free (Pillow-backed GeoTIFF codec in
:mod:`glimpse_tpu_torch.io.geotiff`), float64 NumPy at its surface, with the
compute-heavy algorithms delegated to functions on tensors in
:mod:`glimpse_tpu_torch.ops`: sampling on float64 CPU tensors over the
arrays' memory, viewshed and horizon on the card unless the caller asks for
the CPU.
"""
import copy as copy_module
import datetime as datetime_module
import numbers
import warnings
from pathlib import Path
from typing import Any, Callable, Iterable, List, Optional, Tuple, Union

import numpy as np

from . import helpers
from .io import geotiff
from .ops import sampling as sampling_ops
from .ops import terrain as terrain_ops

Number = Union[int, float]


class Grid:
    """Regular rectangular 2-D grid defined by size and outer limits.

    ``x``/``y`` accept outer limits (2,), cell-center vectors (n,), or
    cell-center matrices matching the array shape; cell size and direction
    are inferred.
    """

    def __init__(
        self,
        size: Union[int, Iterable[int]],
        x: Iterable = None,
        y: Iterable = None,
        crs: Union[int, str] = None,
    ) -> None:
        self.size = size
        self._xlim, self._x, self._X = self._parse_axis(x, dim=0)
        self._ylim, self._y, self._Y = self._parse_axis(y, dim=1)
        self.crs = crs

    # ---- Axis parsing ---- #

    def _parse_axis(self, value, dim: int):
        """Parse an axis spec into (limits, centers-or-None, matrix-or-None)."""
        if value is None:
            value = (0, self.size[dim])
        value = np.asarray(value)
        if value.ndim >= 2 and value.shape[0:2] == tuple(self.shape[0:2]):
            X = value
            vec = value[:, 0] if dim else value[0]
        else:
            X = None
            vec = np.atleast_1d(value.squeeze() if value.ndim > 1 else value)
        if vec.shape[0] > 2:
            centers = vec
            dx = np.diff(vec[0:2])
            lim = np.append(vec[0] - dx / 2, vec[-1] + dx / 2)
        else:
            centers = None
            lim = vec
        if len(lim) != 2:
            raise ValueError("Could not parse limits from x, y inputs")
        return np.asarray(lim, dtype=float), centers, X

    # ---- Core properties ---- #

    @property
    def size(self) -> np.ndarray:
        """Grid dimensions (nx, ny)."""
        return self._size

    @size.setter
    def size(self, value) -> None:
        flat = np.ravel(value)
        if flat.dtype.kind not in "iu":
            raise ValueError("Grid dimensions must be integer")
        n = flat.size
        if n not in (1, 2):
            raise ValueError("Grid dimensions must be scalar or (2,)")
        if flat.min() < 1:
            raise ValueError("Grid dimensions must be positive")
        self._size = np.resize(flat, 2)

    @property
    def shape(self) -> Tuple[int, int]:
        """Array shape (ny, nx)."""
        return int(self.size[1]), int(self.size[0])

    @property
    def xlim(self) -> np.ndarray:
        """Outer x limits (left, right)."""
        return self._xlim

    @xlim.setter
    def xlim(self, value) -> None:
        value = self._check_limits(value)
        if not np.array_equal(self._xlim if hasattr(self, "_xlim") else None, value):
            self._xlim = value
            self._x = None
            self._X = None

    @property
    def ylim(self) -> np.ndarray:
        """Outer y limits (top, bottom)."""
        return self._ylim

    @ylim.setter
    def ylim(self, value) -> None:
        value = self._check_limits(value)
        if not np.array_equal(self._ylim if hasattr(self, "_ylim") else None, value):
            self._ylim = value
            self._y = None
            self._Y = None

    def _check_limits(self, value) -> np.ndarray:
        value = np.atleast_1d(value).astype(float)
        if value.shape != (2,):
            raise ValueError("Grid limits must be (2,)")
        if value[0] == value[1]:
            raise ValueError("Grid limits cannot be equal")
        return value

    @property
    def d(self) -> np.ndarray:
        """Signed cell size (dx, dy)."""
        return np.hstack((np.diff(self.xlim), np.diff(self.ylim))) / self.size

    @property
    def min(self) -> np.ndarray:
        """Minimum bounding coordinates (xmin, ymin)."""
        return np.array((min(self.xlim), min(self.ylim)))

    @property
    def max(self) -> np.ndarray:
        """Maximum bounding coordinates (xmax, ymax)."""
        return np.array((max(self.xlim), max(self.ylim)))

    @property
    def box2d(self) -> np.ndarray:
        """Bounding box (xmin, ymin, xmax, ymax)."""
        return np.hstack((self.min, self.max))

    @property
    def x(self) -> np.ndarray:
        """Cell-center x coordinates, left to right (nx,)."""
        if self._x is None:
            self._x = self._centers(0)
        return self._x

    @property
    def y(self) -> np.ndarray:
        """Cell-center y coordinates, top to bottom (ny,)."""
        if self._y is None:
            self._y = self._centers(1)
        return self._y

    def _centers(self, dim: int) -> np.ndarray:
        lim = self.xlim if dim == 0 else self.ylim
        n = int(self.size[dim])
        d = (lim[1] - lim[0]) / n
        return lim[0] + d * (np.arange(n) + 0.5)

    @property
    def X(self) -> np.ndarray:
        """Cell-center x coordinates for each cell (ny, nx)."""
        if self._X is None:
            self._X = np.tile(self.x, (int(self.size[1]), 1))
        return self._X

    @property
    def Y(self) -> np.ndarray:
        """Cell-center y coordinates for each cell (ny, nx)."""
        if self._Y is None:
            self._Y = np.tile(self.y, (int(self.size[0]), 1)).T
        return self._Y

    def __eq__(self, other) -> bool:
        return (
            self.shape == other.shape
            and (self.xlim == other.xlim).all()
            and (self.ylim == other.ylim).all()
        )

    # ---- Constructors ---- #

    @classmethod
    def read(
        cls,
        path: Union[str, Path],
        d: Number = None,
        xlim: Iterable[Number] = None,
        ylim: Iterable[Number] = None,
    ) -> "Grid":
        """Read grid geometry from a raster file header."""
        info = geotiff.read_info(path)
        x0, dx, _, y0, _, dy = info.transform
        nx, ny = info.size
        grid = cls(
            (nx, ny),
            x=x0 + dx * np.array([0, nx]),
            y=y0 + dy * np.array([0, ny]),
            crs=info.crs,
        )
        new_xlim, new_ylim, rows, cols = grid.crop_extent(xlim=xlim, ylim=ylim)
        win_nx = (cols[1] - cols[0]) + 1
        win_ny = (rows[1] - rows[0]) + 1
        if d:
            buf_nx = int(np.ceil(abs(win_nx * grid.d[0] / d)))
            buf_ny = int(np.ceil(abs(win_ny * grid.d[1] / d)))
        else:
            buf_nx, buf_ny = int(win_nx), int(win_ny)
        grid.xlim, grid.ylim = new_xlim, new_ylim
        grid.size = np.array([buf_nx, buf_ny])
        return grid

    # ---- Geometry ops ---- #

    def copy(self) -> "Grid":
        """Copy the grid."""
        return Grid(self.size.copy(), x=self.xlim.copy(), y=self.ylim.copy())

    def resize(self, scale: Number) -> None:
        """Resize by a scale factor (limits fixed, integer-rounded size)."""
        self.size = np.floor(self.size * scale + 0.5).astype(int)
        self._x = self._y = self._X = self._Y = None

    def shift(self, dx: Number = None, dy: Number = None) -> None:
        """Shift grid position in x and/or y.

        All cached coordinate products (limits, vectors, meshes) move
        together so no lazy cache needs invalidating.
        """
        for name, delta in (("x", dx), ("y", dy)):
            if delta is None:
                continue
            for attr in (f"_{name}lim", f"_{name}", f"_{name.upper()}"):
                held = getattr(self, attr)
                if held is not None:
                    setattr(self, attr, held + delta)

    def inbounds_xy(self, xy, grid: bool = False):
        """Test whether world points (n, 2) — or grid vectors — are in bounds."""
        lo, hi = self.min[0:2], self.max[0:2]
        if grid:
            return tuple(
                (np.asarray(v) >= lo[i]) & (np.asarray(v) <= hi[i])
                for i, v in enumerate(xy[:2])
            )
        ok = (np.asarray(xy) >= lo) & (np.asarray(xy) <= hi)
        return ok.all(axis=1)

    def inbounds(self, uv) -> np.ndarray:
        """Test whether image coordinates (n, 2) are in (or on) bounds."""
        uv = np.asarray(uv)
        return ((uv >= 0) & (uv <= self.size)).all(axis=1)

    def snap_xy(
        self, xy, centers: bool = False, edges: bool = False, inbounds: bool = True
    ) -> np.ndarray:
        """Snap points to nearest cell centers and/or edges.

        Upstream's snapping rules: points on
        edges snap to higher indices; with ``inbounds`` points on the
        right/bottom outer edge snap to interior centers.
        """
        if not centers and not edges:
            raise ValueError("Arguments centers and edges cannot both be False")
        xy = np.asarray(xy, dtype=float)
        origin = np.array([self.xlim[0], self.ylim[0]])
        # The snap target is a lattice {anchor + k*spacing}: cell centers
        # (anchor offset d/2), cell edges (anchor 0), or both (spacing d/2).
        spacing = self.d / 2 if (centers and edges) else self.d
        anchor = origin + self.d / 2 if (centers and not edges) else origin
        steps = np.floor((xy - anchor) / spacing + 0.5)
        if not edges and inbounds:
            far = np.array([self.xlim[1], self.ylim[1]])
            steps = np.where(xy == far, steps - 1, steps)
        return anchor + steps * spacing

    def snap_box(
        self,
        xy,
        size,
        centers: bool = False,
        edges: bool = True,
        inbounds: bool = True,
    ) -> np.ndarray:
        """Snap a centered box to the grid; box must be inside the bounds."""
        halfsize = np.multiply(size, 0.5)
        xy_box = np.vstack((np.asarray(xy) - halfsize, np.asarray(xy) + halfsize))
        if any(~self.inbounds_xy(xy_box)):
            raise IndexError("Box extends beyond grid bounds")
        return self.snap_xy(
            xy_box, centers=centers, edges=edges, inbounds=inbounds
        ).flatten()

    # ---- Coordinate converters ---- #

    def xyz_to_uv(self, xyz) -> np.ndarray:
        """World (n, 2+) -> image coordinates (n, 2)."""
        xyz = np.asarray(xyz)
        return (xyz[:, 0:2] - (self.xlim[0], self.ylim[0])) / self.d

    def uv_to_xyz(self, uv) -> np.ndarray:
        """Image (n, 2) -> world coordinates (n, 3) with NaN z."""
        uv = np.asarray(uv)
        xy = uv * self.d + (self.xlim[0], self.ylim[0])
        return np.column_stack((xy, np.full(len(xy), np.nan)))

    def rowcol_to_xy(self, rowcol) -> np.ndarray:
        """Array indices (n, 2) -> cell-center world coordinates (n, 2)."""
        origin = np.array((self.xlim[0], self.ylim[0]))
        return (np.asarray(rowcol) + 0.5)[:, ::-1] * self.d + origin

    def xy_to_rowcol(self, xy, snap: bool = False, inbounds: bool = True) -> np.ndarray:
        """World coordinates (n, 2) -> (fractional or snapped) array indices."""
        pts = np.asarray(xy, dtype=float)
        if snap:
            pts = self.snap_xy(pts, centers=True, edges=False, inbounds=inbounds)
        cols = (pts[:, 0] - self.xlim[0]) / self.d[0] - 0.5
        rows = (pts[:, 1] - self.ylim[0]) / self.d[1] - 0.5
        out = np.column_stack((rows, cols))
        return out.round().astype(int) if snap else out

    def rowcol_to_idx(self, rowcol) -> np.ndarray:
        """Array indices (n, 2) -> flat indices (n,)."""
        rowcol = np.asarray(rowcol)
        return np.ravel_multi_index((rowcol[:, 0], rowcol[:, 1]), self.shape)

    def idx_to_rowcol(self, idx) -> np.ndarray:
        """Flat indices (n,) -> array indices (n, 2)."""
        return np.column_stack(np.unravel_index(idx, self.shape))

    def crop_extent(
        self, xlim: Iterable[Number] = None, ylim: Iterable[Number] = None
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Compute the grid-aligned extent covering the requested crop.

        Returns new (xlim, ylim) and the inclusive (row, col) index bounds.
        Upstream's edge and overshoot semantics:
        interior cell-edge maxima snap down; overshoot clamps to the grid.
        """
        if xlim is None:
            xlim = self.xlim
        if ylim is None:
            ylim = self.ylim
        box = helpers.intersect_boxes(
            np.vstack(
                (
                    np.hstack((min(xlim), min(ylim), max(xlim), max(ylim))),
                    np.hstack((self.min, self.max)),
                )
            )
        )
        xlim = box[0::2] if self.xlim[0] <= self.xlim[1] else box[0::2][::-1]
        ylim = box[1::2] if self.ylim[0] <= self.ylim[1] else box[1::2][::-1]

        def axis_indices(lo, hi, origin, d, n, far_edge):
            # Fractional index of each bound along the (signed) axis.
            u_lo = (lo - origin) / d
            u_hi = (hi - origin) / d
            i_lo = int(np.floor(u_lo))
            i_hi = int(np.floor(u_hi))
            if lo == far_edge:
                i_lo -= 1
            if hi == far_edge:
                i_hi -= 1
            elif (far_edge - hi) % d == 0:
                # Interior cell edge at the max bound snaps down.
                i_hi -= 1
            return max(i_lo, 0), min(i_hi, n - 1)

        c0, c1 = axis_indices(
            xlim[0], xlim[1], self.xlim[0], self.d[0], int(self.size[0]), self.xlim[1]
        )
        r0, r1 = axis_indices(
            ylim[0], ylim[1], self.ylim[0], self.d[1], int(self.size[1]), self.ylim[1]
        )
        new_xlim = self.xlim[0] + np.array([c0, c1 + 1]) * self.d[0]
        new_ylim = self.ylim[0] + np.array([r0, r1 + 1]) * self.d[1]
        return new_xlim, new_ylim, np.array([r0, r1]), np.array([c0, c1])

    def set_plot_limits(self) -> None:
        """Set the current matplotlib axis limits to the grid limits
        (y inverted, image convention)."""
        import matplotlib.pyplot as plt

        plt.xlim(self.xlim[0], self.xlim[1])
        plt.ylim(self.ylim[1], self.ylim[0])

    def tile_indices(
        self, size: Iterable[int], overlap: Iterable[int] = (0, 0)
    ) -> Tuple[Tuple[slice, slice], ...]:
        """Slices chopping the grid into roughly `size`-sized overlapping tiles."""

        def axis_cuts(length: int, want: int, pad: int):
            # Near-equal chunks; interior chunks reach `pad` back into their
            # left neighbor.
            parts = max(int(np.round(length / want)), 1)
            chunk = int(np.ceil(length / parts))
            ends = list(range(chunk, length, chunk)) + [length]
            starts = [0] + [e - pad for e in ends[:-1]]
            return list(zip(starts, ends))

        nx, ny = int(self.size[0]), int(self.size[1])
        col_spans = axis_cuts(nx, size[0], overlap[0])
        row_spans = axis_cuts(ny, size[1], overlap[1])
        return tuple(
            (slice(*rows), slice(*cols))
            for rows in row_spans
            for cols in col_spans
        )


class Raster(Grid):
    """Values on a regular 2-D grid, with lazy file-backed reads.

    Adds to :class:`Grid`: the value array, point/grid sampling via
    :mod:`glimpse_tpu_torch.ops.sampling`, crop/resize/shift, terrain analysis
    (viewshed/horizon via :mod:`glimpse_tpu_torch.ops.terrain`, hillshade),
    GDAL-free file I/O, and a capture ``datetime`` for time series.

    Example (cell centers sample exactly; y descends row-wise by default):

        >>> import numpy as np
        >>> r = Raster(np.array([[0.0, 1.0], [2.0, 3.0]]), x=(0, 2), y=(2, 0))
        >>> r.sample(np.array([[0.5, 1.5], [1.5, 0.5]])).tolist()
        [0.0, 3.0]
        >>> r.sample(np.array([[1.0, 1.0]])).tolist()  # bilinear midpoint
        [1.5]
    """

    def __init__(
        self,
        array,
        x: Iterable = None,
        y: Iterable = None,
        datetime: datetime_module.datetime = None,
        crs: Union[int, str] = None,
    ) -> None:
        if array is None:
            # File-backed lazy initialization (see Raster.open).
            self._array = None
            self._xlim, self._x, self._X = np.asarray(x, dtype=float), None, None
            self._ylim, self._y, self._Y = np.asarray(y, dtype=float), None, None
            self._lazy_size = None
        else:
            self._array = np.atleast_2d(array)
            self._xlim, self._x, self._X = self._parse_axis(x, dim=0)
            self._ylim, self._y, self._Y = self._parse_axis(y, dim=1)
            self._lazy_size = None
        self.datetime = datetime
        self.crs = crs
        self.path = None
        self._band = None
        self._nan = None
        self._read_spec = None
        self._coeffs = None

    def _parse_axis(self, value, dim: int):
        # Raster shape comes from the array, so the Grid parser can use it.
        return Grid._parse_axis(self, value, dim)

    # ---- File I/O ---- #

    @classmethod
    def open(
        cls,
        path: Union[str, Path],
        band: int = 1,
        d: float = None,
        xlim: Iterable[Number] = None,
        ylim: Iterable[Number] = None,
        datetime: datetime_module.datetime = None,
        nan: Any = None,
    ) -> "Raster":
        """Open a raster lazily: geometry now, pixels on first read.

        Float rasters with a file-defined no-data value get NaN substitution;
        an explicit ``nan`` overrides and forces float.
        """
        path = str(path)
        info = geotiff.read_info(path)
        x0, dx, _, y0, _, dy = info.transform
        nx, ny = info.size
        grid = Grid(
            (nx, ny),
            x=x0 + dx * np.array([0, nx]),
            y=y0 + dy * np.array([0, ny]),
        )
        new_xlim, new_ylim, rows, cols = grid.crop_extent(xlim=xlim, ylim=ylim)
        win_nx = int(cols[1] - cols[0] + 1)
        win_ny = int(rows[1] - rows[0] + 1)
        if d:
            buf_nx = int(np.ceil(abs(win_nx * grid.d[0] / d)))
            buf_ny = int(np.ceil(abs(win_ny * grid.d[1] / d)))
        else:
            buf_nx, buf_ny = win_nx, win_ny
        is_float = np.issubdtype(info.dtype, np.floating)
        if nan is None and is_float and info.nodata:
            nan = info.nodata
        obj = cls(None, x=new_xlim, y=new_ylim, datetime=datetime,
                  crs=info.crs if info.crs else None)
        obj.path = path
        obj._band = band
        obj._nan = nan
        obj._read_spec = dict(
            window=(int(cols[0]), int(rows[0]), int(cols[1]) + 1, int(rows[1]) + 1),
            out_size=(buf_nx, buf_ny),
        )
        obj._lazy_size = (buf_nx, buf_ny)
        return obj

    def read(self, box: Iterable[int] = None, cache: bool = True) -> np.ndarray:
        """Read raster data, optionally a crop ``box`` (left, top, right, bottom).

        Cached reads subset the in-memory array; uncached reads decode only
        the needed window from the file.
        """
        if box is not None:
            box = np.asarray(box).reshape(-1, 2)
            if not np.issubdtype(box.dtype, np.integer):
                raise ValueError("Box must be integers")
            if not np.all(self.inbounds(box)):
                raise ValueError("Box is out of bounds")
        array = self._array
        new_array = False
        if array is None:
            new_array = True
            spec = self._read_spec
            window, out_size = spec["window"], spec["out_size"]
            if box is not None and not cache:
                # Map box (buffer coords) to source pixel coords.
                sx = (window[2] - window[0]) / out_size[0]
                sy = (window[3] - window[1]) / out_size[1]
                sub_window = (
                    int(window[0] + box[0][0] * sx),
                    int(window[1] + box[0][1] * sy),
                    int(window[0] + box[1][0] * sx),
                    int(window[1] + box[1][1] * sy),
                )
                sub_size = (int(box[1][0] - box[0][0]), int(box[1][1] - box[0][1]))
                array = geotiff.read(
                    self.path, band=self._band, window=sub_window, out_size=sub_size
                )
                array = geotiff.apply_nodata(array, self._nan)
                return array
            array = geotiff.read(
                self.path, band=self._band, window=window, out_size=out_size
            )
            array = geotiff.apply_nodata(array, self._nan)
            if cache:
                self.array = array
        if box is not None and (cache or not new_array):
            array = array[box[0][1] : box[1][1], box[0][0] : box[1][0]]
        return array

    def write(self, path: Union[str, Path], **kwargs: Any) -> None:
        """Write to a GeoTIFF with this raster's transform and CRS."""
        # GDAL-style affine: top-left corner + per-axis spacing, no rotation.
        affine = (self.xlim[0], self.d[0], 0.0, self.ylim[0], 0.0, self.d[1])
        kwargs.setdefault("transform", affine)
        kwargs.setdefault("crs", self.crs)
        geotiff.write(path, self.array, **kwargs)

    # ---- Array properties ---- #

    @property
    def array(self) -> np.ndarray:
        """Raster values (ny, nx); triggers a cached file read if lazy."""
        if self._array is None:
            self._array = self.read()
        return self._array

    @array.setter
    def array(self, value) -> None:
        if value is not None:
            value = np.atleast_2d(value)
        old = getattr(self, "_array", None)
        self._coeffs = None
        if value is not None and old is not None and value.shape != old.shape:
            self._x = self._X = self._y = self._Y = None
        self._array = value

    @property
    def size(self) -> np.ndarray:
        """Grid dimensions (nx, ny)."""
        if self._array is None and self._lazy_size is not None:
            return np.asarray(self._lazy_size)
        return np.array(self.array.shape[0:2][::-1]).astype(int)

    @size.setter
    def size(self, value) -> None:
        raise AttributeError("Raster size is determined by its array")

    @property
    def zlim(self) -> np.ndarray:
        """Value limits (nanmin, nanmax)."""
        return np.array([np.nanmin(self.array), np.nanmax(self.array)])

    @property
    def box3d(self) -> np.ndarray:
        """Bounding box (xmin, ymin, zmin, xmax, ymax, zmax)."""
        zlim = self.zlim
        return np.hstack((self.min, zlim.min(), self.max, zlim.max()))

    @property
    def grid(self) -> Grid:
        """This raster's grid."""
        return Grid(self.size, x=self.xlim, y=self.ylim)

    def __eq__(self, other) -> bool:
        return (
            np.array_equiv(self.array, other.array)
            and (self.xlim == other.xlim).all()
            and (self.ylim == other.ylim).all()
        )

    def __getitem__(self, indices) -> "Raster":
        """Extract a subset raster with array indices."""
        if not isinstance(indices, tuple):
            indices = (indices, slice(None))

        def as_slice(idx):
            if isinstance(idx, slice):
                return idx
            if isinstance(idx, int):
                return slice(idx, idx + 1)
            raise IndexError("Only integers and slices are valid indices")

        rows, cols = (as_slice(idx) for idx in indices)

        def axis_limits(centers, cell, sl):
            kept = centers[sl]
            stride = sl.step if (sl.step and sl.step > 1) else 1
            half = cell * stride / 2
            return (kept[0] - half, kept[-1] + half)

        return self.__class__(
            self.array[rows, cols],
            x=axis_limits(self.x, self.d[0], cols),
            y=axis_limits(self.y, self.d[1], rows),
            datetime=self.datetime,
        )

    def copy(self) -> "Raster":
        """Copy the raster (values, limits, datetime)."""
        return self.__class__(
            self.array.copy(),
            x=self.xlim.copy(),
            y=self.ylim.copy(),
            datetime=copy_module.copy(self.datetime),
        )

    @property
    def Zf(self):
        """Cached scipy RegularGridInterpolator over (x, y) (API parity)."""
        if getattr(self, "_Zf", None) is None:
            import scipy.interpolate

            # RegularGridInterpolator wants ascending axes: flip any
            # descending axis (and the matching value axis) first.
            xs, ys = self.x, self.y
            values = self.array.T
            if self.d[0] < 0:
                xs, values = xs[::-1], values[::-1]
            if self.d[1] < 0:
                ys, values = ys[::-1], values[:, ::-1]
            self._Zf = scipy.interpolate.RegularGridInterpolator((xs, ys), values)
        return self._Zf

    # ---- Sampling ---- #

    def _xy_to_fractional_rowcol(self, xy) -> Tuple[np.ndarray, np.ndarray]:
        xy = np.asarray(xy, dtype=float)
        cols = (xy[:, 0] - self.xlim[0]) / self.d[0] - 0.5
        rows = (xy[:, 1] - self.ylim[0]) / self.d[1] - 0.5
        return rows, cols

    def sample(
        self,
        xy,
        grid: bool = False,
        order: int = 1,
        bounds_error: bool = True,
        fill_value: float = np.nan,
    ) -> np.ndarray:
        """Sample values at points (n, 2) or on a grid (x-vector, y-vector).

        ``order``: 0 nearest, 1 bilinear, 3 cubic spline (2/4/5 fall back to
        SciPy splines). ``fill_value=None`` extrapolates.
        """
        keep = None
        if bounds_error or fill_value is not None:
            keep = self.inbounds_xy(xy, grid=grid)
            all_in = (
                keep[0].all() and keep[1].all() if grid else keep.all()
            )
            if bounds_error:
                if not all_in:
                    raise ValueError(
                        "Some of the sampling coordinates are out of bounds"
                    )
                keep = None  # nothing to mask
        if grid:
            return self._sample_on_grid(xy, order, keep, fill_value)
        return self._sample_at_points(
            np.asarray(xy, dtype=float), order, keep, fill_value
        )

    @property
    def _live_dims(self) -> np.ndarray:
        """Indices of non-singleton axes (0 = x, 1 = y)."""
        return np.flatnonzero(np.asarray(self.size) > 1)

    def _sample_at_points(self, xy, order, keep, fill_value) -> np.ndarray:
        live = self._live_dims
        if len(live) == 2:
            if order in (0, 1, 3):
                rows, cols = self._xy_to_fractional_rowcol(xy)
                values = sampling_ops.sample_grid_host(self.array.astype(float), rows, cols, order)
            else:
                values = self._scipy_point_sample(xy, order)
        elif len(live) == 1:
            dim = int(live[0])
            values = self._sample_1d(xy[:, dim], dim=dim, order=order)
        else:
            values = np.full(len(xy), self.array.flat[0], dtype=float)
        if keep is None:
            return values
        return np.where(keep, values, fill_value)

    def _sample_on_grid(self, xy, order, keep, fill_value) -> np.ndarray:
        x = np.asarray(xy[0], dtype=float)
        y = np.asarray(xy[1], dtype=float)
        live = self._live_dims
        if len(live) == 2:
            out = self._sample_grid_2d(x, y, order=order)
        elif len(live) == 1:
            dim = int(live[0])
            line = self._sample_1d((x, y)[dim], dim=dim, order=order)
            column_shaped = line.reshape((-1, 1) if dim else (1, -1))
            out = np.broadcast_to(column_shaped, (len(y), len(x))).copy()
        else:
            out = np.full((len(y), len(x)), self.array.flat[0], dtype=float)
        if keep is not None:
            out[~keep[1], :] = fill_value
            out[:, ~keep[0]] = fill_value
        return out

    def _scipy_point_sample(self, xy, order: int) -> np.ndarray:
        import scipy.interpolate

        signs = np.sign(self.d).astype(int)
        fun = scipy.interpolate.RectBivariateSpline(
            self.y[:: signs[1]],
            self.x[:: signs[0]],
            self.array[:: signs[1], :: signs[0]],
            kx=order,
            ky=order,
        )
        return fun(xy[:, 1], xy[:, 0], grid=False)

    def _sample_grid_2d(self, x, y, order: int = 1) -> np.ndarray:
        """Grid sampling with upstream's NaN-masking trick.

        NaN cells are replaced with the array minimum for spline stability;
        interpolated values that dip below the true minimum are masked back
        to NaN.
        """
        a = self.array.astype(float)
        is_nan = np.isnan(a)
        any_nan = is_nan.any()
        if any_nan and order > 0:
            zmin = np.nanmin(a)
            a = np.where(is_nan, helpers.numpy_dtype_minmax(a.dtype)[0] / 1e10, a)
        cols = (np.asarray(x) - self.xlim[0]) / self.d[0] - 0.5
        rows = (np.asarray(y) - self.ylim[0]) / self.d[1] - 0.5
        if order in (0, 1, 3):
            C, R = np.meshgrid(cols, rows)
            samples = sampling_ops.sample_grid_host(a, R, C, order)
        else:
            import scipy.interpolate

            signs = np.sign(self.d).astype(int)
            fun = scipy.interpolate.RectBivariateSpline(
                self.y[:: signs[1]], self.x[:: signs[0]],
                a[:: signs[1], :: signs[0]], kx=order, ky=order,
            )
            xdir = 1 if (len(x) < 2) or x[1] > x[0] else -1
            ydir = 1 if (len(y) < 2) or y[1] > y[0] else -1
            samples = fun(y[::ydir], x[::xdir], grid=True)[::ydir, ::xdir]
        if any_nan and order > 0:
            samples[samples < np.nanmin(self.array)] = np.nan
        return samples

    def _sample_1d(self, x, dim: int, order: int = 1) -> np.ndarray:
        """Sample along the single non-singleton dimension."""
        import scipy.interpolate

        kinds = ("nearest", "linear", "quadratic", "cubic", "quartic", "quintic")
        xdir = int(np.sign(self.d[dim]))
        xi = (self.y if dim else self.x)[::xdir]
        zi = (self.array[:, 0] if dim else self.array[0])[::xdir]
        fun = scipy.interpolate.interp1d(
            x=xi, y=zi, kind=kinds[order], assume_sorted=True,
            fill_value="extrapolate",
        )
        return fun(np.asarray(x, dtype=float))

    def resample(self, grid: Grid, **kwargs: Any) -> None:
        """Resample values onto another grid's coordinate system."""
        target = grid.copy()  # decouple adopted coordinates from the source
        self.array = self.sample((target.x, target.y), grid=True, **kwargs)
        self.xlim, self.ylim = target.xlim, target.ylim
        self._x, self._y = target.x, target.y

    # ---- Editing ---- #

    def crop(self, xlim=None, ylim=None, zlim=None) -> None:
        """Crop to x/y bounds (grid-aligned) and/or clip values outside zlim to NaN."""
        if xlim is not None or ylim is not None:
            new_xlim, new_ylim, rows, cols = self.crop_extent(xlim=xlim, ylim=ylim)
            self.array = self.array[rows[0] : rows[1] + 1, cols[0] : cols[1] + 1]
            self.xlim = new_xlim
            self.ylim = new_ylim
        if zlim is not None:
            lo, hi = min(zlim), max(zlim)
            clipped = (self.array < lo) | (self.array > hi)
            if clipped.any():
                if self.array.dtype.kind != "f":
                    warnings.warn("array cast to float to accommodate NaN")
                    self.array = self.array.astype(float)
                self.array = np.where(clipped, np.nan, self.array)

    def resize(self, scale: Number, order: int = 1) -> None:
        """Resize values by a scale factor (limits unchanged)."""
        import scipy.ndimage

        self.array = scipy.ndimage.zoom(self.array, zoom=float(scale), order=order)
        self._x = self._y = self._X = self._Y = None

    def shift(self, dx: Number = None, dy: Number = None, dz: Number = None) -> None:
        """Shift in x, y, and/or z."""
        Grid.shift(self, dx=dx, dy=dy)
        if dz is not None:
            self._array = self._array + dz

    def fill_circle(self, center, radius: Number, value: Any = np.nan) -> None:
        """Fill a circular region with a fixed value."""
        dx = self.X - center[0]
        dy = self.Y - center[1]
        inside = dx * dx + dy * dy <= radius * radius
        if not np.issubdtype(self.array.dtype, np.floating) and isinstance(
            value, float
        ) and np.isnan(value):
            self.array = self.array.astype(float)
        self.array[inside] = value

    # ---- Terrain analysis ---- #

    def gradient(self) -> Tuple[np.ndarray, np.ndarray]:
        """Gradients (dz/dx, dz/dy)."""
        dzdy, dzdx = np.gradient(self.array, self.d[1], self.d[0])
        return dzdx, dzdy

    def hillshade(self, azimuth: Number = 315, altitude: Number = 45) -> np.ndarray:
        """Illumination intensity of the surface (Lambertian, normalized).

        Horn-style gradient normal dotted with the light direction, scaled
        to [0, 1] like matplotlib's LightSource.hillshade.
        """
        az = np.deg2rad(90 - azimuth)
        alt = np.deg2rad(altitude)
        light = np.array(
            [np.cos(alt) * np.cos(az), np.cos(alt) * np.sin(az), np.sin(alt)]
        )
        dzdx, dzdy = self.gradient()
        # Surface normal (unnormalized): (-dzdx, -dzdy, 1); y gradient sign
        # follows the world frame (d[1] signed), matching LightSource.
        nz = 1.0 / np.sqrt(1 + dzdx ** 2 + dzdy ** 2)
        intensity = (-dzdx * light[0] - dzdy * light[1] + light[2]) * nz
        imin, imax = np.nanmin(intensity), np.nanmax(intensity)
        if imax > imin:
            intensity = (intensity - imin) / (imax - imin)
        return np.clip(intensity, 0, 1)

    def fill_crevasses(
        self,
        maximum: dict = {"size": 5},
        gaussian: dict = {"sigma": 5},
        mask=None,
        fill: bool = False,
    ) -> None:
        """Maximum filter then Gaussian smoothing (crevasse removal)."""
        resolved = mask(self.array) if callable(mask) else mask
        peaks = helpers.maximum_filter(self.array, mask=resolved, fill=fill, **maximum)
        self.array = helpers.gaussian_filter(
            peaks, mask=resolved, fill=fill, **gaussian
        )

    def _correction_tuple(self, correction) -> Optional[Tuple[float, float]]:
        if correction is True:
            correction = {}
        if isinstance(correction, dict):
            return (
                correction.get("radius", 6.3781e6),
                correction.get("refraction", 0.13),
            )
        return None

    def viewshed(
        self, origin, correction=False, method: str = "polar", device="cuda", **kwargs
    ) -> np.ndarray:
        """Binary viewshed from a world viewpoint (x, y, z).

        ``method='polar'`` (default) is the dense polar-resampling algorithm
        (``ops.terrain.viewshed``), computed on ``device`` (float32 on a
        card, float64 on the CPU, or the ``dtype`` given) and returned as an
        array; it agrees with the ring sweep on at least 98 % of cells
        (disagreements sit on grazing visibility boundaries).
        ``method='rings'`` is upstream's sequential ring sweep itself
        (host-only).
        """
        if not all(abs(self.d[0]) == abs(self.d)):
            warnings.warn(
                f"DEM cells not square {tuple(abs(self.d))} - "
                "may lead to unexpected results"
            )
        if not self.inbounds_xy(np.atleast_2d(origin[0:2])):
            warnings.warn("Origin not in DEM - may lead to unexpected results")
        rowcol = self.xy_to_rowcol(np.atleast_2d(np.asarray(origin[0:2], dtype=float)))
        args = (
            self.array.astype(float),
            (float(rowcol[0, 0]), float(rowcol[0, 1])),
            float(origin[2]),
            float(abs(self.d[0])),
        )
        if method == "rings":
            return terrain_ops.viewshed_rings(
                *args, correction=self._correction_tuple(correction)
            )
        return terrain_ops.viewshed(
            *args, correction=self._correction_tuple(correction), device=device, **kwargs
        ).cpu().numpy()

    def horizon(
        self, origin, headings=range(360), correction=False, device="cuda", dtype=None
    ) -> List[np.ndarray]:
        """Horizon from a world viewpoint, as unbroken world-coordinate segments.

        Vectorized polar formulation of upstream's per-heading ray walk: one
        dense resample over (headings, radii), computed on ``device``.
        """
        headings = np.asarray(list(headings), dtype=float)
        # World heading (deg CW from north) -> index-space angle.
        sx = np.sin(np.deg2rad(headings))
        sy = np.cos(np.deg2rad(headings))
        dcol = sx / self.d[0]
        drow = sy / self.d[1]
        norm = np.sqrt(dcol ** 2 + drow ** 2)
        thetas = np.arctan2(drow / norm, dcol / norm)
        rowcol = self.xy_to_rowcol(np.atleast_2d(np.asarray(origin[0:2], dtype=float)))
        cellsize = float(abs(self.d[0]))
        _, r_at_max, z_at_max, valid = (
            t.cpu().numpy()
            for t in terrain_ops.horizon_angles(
                self.array.astype(float),
                (float(rowcol[0, 0]), float(rowcol[0, 1])),
                float(origin[2]),
                cellsize,
                thetas,
                correction=self._correction_tuple(correction),
                device=device,
                dtype=dtype,
            )
        )
        r_at_max, z_at_max = r_at_max.astype(float), z_at_max.astype(float)
        dist = r_at_max * cellsize
        hxyz = np.full((len(headings), 3), np.nan)
        hxyz[valid, 0] = origin[0] + sx[valid] * dist[valid]
        hxyz[valid, 1] = origin[1] + sy[valid] * dist[valid]
        hxyz[valid, 2] = z_at_max[valid]
        mask = np.isnan(hxyz[:, 0])
        splits = helpers.boolean_split(hxyz, mask, axis=0, circular=True)
        return splits[int(mask[0]) :: 2]

    # ---- Rasterization ---- #

    def rasterize(self, xy, values) -> np.ndarray:
        """Scatter points into the raster grid, averaging values per cell."""
        xy = np.asarray(xy)
        values = np.asarray(values)
        mask = self.inbounds_xy(xy)
        rowcol = self.xy_to_rowcol(xy[mask, :], snap=True)
        array = self.array.copy()
        helpers.rasterize_points(rowcol[:, 0], rowcol[:, 1], values[mask], a=array)
        return array

    def rasterize_polygons(self, polygons, holes=None) -> np.ndarray:
        """Boolean mask of grid cells inside world-coordinate polygons."""
        size = (int(self.size[0]), int(self.size[1]))
        polygons = [self.xy_to_rowcol(np.asarray(xy))[:, ::-1] + 0.5 for xy in polygons]
        if holes is not None:
            holes = [self.xy_to_rowcol(np.asarray(xy))[:, ::-1] + 0.5 for xy in holes]
        return helpers.polygons_to_mask(polygons, size=size, holes=holes)

    # ---- Data extent ---- #

    def data_extent(self) -> Tuple[slice, slice]:
        """Row and column slices bounding all non-missing values."""
        data = ~np.isnan(self.array)
        data_row = np.any(data, axis=1)
        first_row = int(np.argmax(data_row))
        if first_row == 0 and not data_row[0]:
            raise ValueError("No non-missing values present")
        last_row = data_row.size - int(np.argmax(data_row[::-1]))
        data_col = np.any(data, axis=0)
        first_col = int(np.argmax(data_col))
        last_col = data_col.size - int(np.argmax(data_col[::-1]))
        return slice(first_row, last_row), slice(first_col, last_col)

    def crop_to_data(self) -> None:
        """Crop to the bounds of non-missing values."""
        rows, cols = self.data_extent()
        keep_x, keep_y = self.x[cols], self.y[rows]
        half = 0.5 * self.d
        self.array = self.array[rows, cols]
        self.xlim = np.array([keep_x[0] - half[0], keep_x[-1] + half[0]])
        self.ylim = np.array([keep_y[0] - half[1], keep_y[-1] + half[1]])
        self._x, self._y = keep_x, keep_y

    def plot(self, array: np.ndarray = None, **kwargs: Any):
        """Plot with matplotlib, extent in world coordinates."""
        import matplotlib.pyplot

        data = self.array if array is None else array
        left, right = self.xlim
        top, bottom = self.ylim
        kwargs.setdefault("extent", (left, right, bottom, top))
        return matplotlib.pyplot.imshow(data, **kwargs)


class RasterInterpolant:
    """Linear interpolation of a raster time series with error propagation.

    ``means``/``sigmas`` may be Rasters, paths, or scalars (infinite
    rasters); ``x`` are 1-D coordinates (numbers or datetimes). Interpolated
    sigma combines the endpoint variances with an interpolation-uncertainty
    term ((1/3) dz (dx_near/dx))^2.
    """

    def __init__(self, means, sigmas=None, x=None) -> None:
        self.means = means
        if x is None:
            x = [raster.datetime for raster in means]
        self.x = np.asarray(x)
        self.sigmas = sigmas

    def _as_raster(
        self, obj, xi=None, d=None, xlim=None, ylim=None
    ) -> Raster:
        """Materialize a mean/sigma source as a Raster on the requested grid.

        Paths open windowed; scalars become infinite constant rasters;
        in-memory rasters are cropped/rescaled on a copy (never mutating the
        caller's object) only when the request differs from their grid.
        """
        stamp = xi if isinstance(xi, datetime_module.datetime) else None
        if isinstance(obj, (str, Path)):
            return Raster.open(obj, d=d, xlim=xlim, ylim=ylim, datetime=stamp)
        if isinstance(obj, numbers.Number):
            return Raster(
                obj,
                x=(-np.inf, np.inf) if xlim is None else xlim,
                y=(-np.inf, np.inf) if ylim is None else ylim,
                datetime=stamp,
            )
        if not isinstance(obj, Raster):
            raise ValueError(f"Cannot cast as Raster: {type(obj)}")

        def same_span(want, have):
            return want is None or sorted(want) == sorted(have)

        needs_crop = not (
            same_span(xlim, obj.xlim) and same_span(ylim, obj.ylim)
        )
        needs_rescale = d is not None and d != np.abs(obj.d).mean()
        if not (needs_crop or needs_rescale):
            return obj
        out = obj.copy()
        if needs_crop:
            out.crop(xlim=xlim, ylim=ylim)
        if needs_rescale:
            out.resize(np.abs(out.d).mean() / d)
        return out

    def _mean_grid(self, index: int) -> Grid:
        source = self.means[index]
        if isinstance(source, numbers.Number):
            return Grid((1, 1), x=(-np.inf, np.inf), y=(-np.inf, np.inf))
        if isinstance(source, (str, Path)):
            return Grid.read(source)
        if not isinstance(source, Raster):
            raise ValueError(f"Cannot cast as Grid: {type(source)}")
        return source.grid

    def _read_mean(self, index, d=None, xlim=None, ylim=None, zlim=None,
                   fun: Callable = None, **kwargs) -> Raster:
        source = self.means[index]
        raster = self._as_raster(source, self.x[index], d=d, xlim=xlim, ylim=ylim)
        mutators = []
        if zlim is not None:
            mutators.append(lambda r: r.crop(zlim=zlim))
        if fun is not None:
            mutators.append(lambda r: fun(r, **kwargs))
        if mutators and raster is source:
            raster = raster.copy()  # never mutate the caller's raster in place
        for mutate in mutators:
            mutate(raster)
        return raster

    def _read_sigma(self, index, d=None, xlim=None, ylim=None) -> Raster:
        xi = self.x[index]
        obj = 0 if self.sigmas is None else self.sigmas[index]
        return self._as_raster(obj, xi, d=d, xlim=xlim, ylim=ylim)

    def nearest(self, xi, extrapolate: bool = False) -> Tuple[int, int]:
        """Indices of the two nearest rasters (bracketing unless extrapolate)."""
        offsets = self.x - xi
        zero = type(offsets[0])(0)
        candidates = range(len(offsets))
        if extrapolate:
            pair = sorted(candidates, key=lambda k: abs(offsets[k]))[:2]
        else:
            at_or_before = [k for k in candidates if offsets[k] <= zero]
            at_or_after = [k for k in candidates if offsets[k] >= zero]
            if not (at_or_before and at_or_after):
                raise ValueError("Not bounded on both sides by a Raster")
            pair = [
                min(at_or_before, key=lambda k: abs(offsets[k])),
                min(at_or_after, key=lambda k: offsets[k]),
            ]
        lo, hi = sorted(pair, key=lambda k: self.x[k])
        return lo, hi

    def _interpolate(self, means, x, xi, sigmas=None):
        x0, x1 = x
        w = (xi - x0) / (x1 - x0)
        stamp = xi if isinstance(xi, datetime_module.datetime) else None
        template = means[0]

        def wrap(values):
            return template.__class__(
                values, x=template.xlim, y=template.ylim, datetime=stamp
            )

        step = means[1].array - template.array
        blended = wrap(template.array + w * step)
        if sigmas is None:
            return blended
        # Endpoint variance propagation plus an interpolation-uncertainty
        # term (1/3 of the elevation change, scaled by proximity to the
        # nearer endpoint).
        var0, var1 = sigmas[0].array ** 2, sigmas[1].array ** 2
        propagated = var0 + w ** 2 * (var0 + var1)
        near_frac = min(abs(xi - x0), abs(x1 - xi)) / (x1 - x0)
        wiggle = (step * (near_frac / 3)) ** 2
        return blended, wrap(np.sqrt(propagated + wiggle))

    def __call__(
        self,
        xi,
        d=None,
        xlim=None,
        ylim=None,
        zlim=None,
        return_sigma: bool = False,
        extrapolate: bool = False,
        fun: Callable = None,
        **kwargs,
    ):
        """Interpolate the raster (and optionally sigma) at coordinate ``xi``."""
        lo, hi = self.nearest(xi, extrapolate=extrapolate)
        grids = (self._mean_grid(lo), self._mean_grid(hi))
        if d is None:
            d = max(float(np.abs(grid.d).max()) for grid in grids)
        # Common footprint: both grids intersected with the requested window.
        wx = (-np.inf, np.inf) if xlim is None else sorted(xlim)
        wy = (-np.inf, np.inf) if ylim is None else sorted(ylim)
        common = helpers.intersect_boxes(
            [grids[0].box2d, grids[1].box2d, (wx[0], wy[0], wx[1], wy[1])]
        )
        window = dict(d=d, xlim=common[0::2], ylim=common[1::2])

        def align(pair, originals):
            # Resample the later raster onto the earlier one's grid, never
            # mutating a raster owned by this interpolant.
            first, second = pair
            if first.grid != second.grid:
                if second is originals:
                    second = second.copy()
                second.resample(first)
            return first, second

        means = align(
            tuple(
                self._read_mean(k, zlim=zlim, fun=fun, **window, **kwargs)
                for k in (lo, hi)
            ),
            self.means[hi],
        )
        sigmas = None
        if return_sigma:
            sigmas = align(
                tuple(self._read_sigma(k, **window) for k in (lo, hi)),
                None if self.sigmas is None else self.sigmas[hi],
            )
        return self._interpolate(
            means=means, sigmas=sigmas, x=(self.x[lo], self.x[hi]), xi=xi
        )
