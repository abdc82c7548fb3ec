"""Host-side helpers: serialization, formatting, boxes, geometry, statistics, time.

The counterpart of :mod:`glimpse_tpu.helpers`, NumPy and SciPy only, holding
the functions the port's host objects use (JSON, list formatting, sorted
search, masked filters, uncertainty propagation, boxes and grids,
rasterization, polyline clipping and interpolation, pairwise distances,
datetime selection), with their examples. The reference's other helpers are
not part of this module yet: pickles, histogram matching and CLAHE, ray and
plane intersection, Bresenham rasterization, elevation corrections, the GIS
functions (``crs_to_wkt``, ``write_raster``, ``average_rasters``, the
file-format lookup) and ``plot_quivers``.
"""
import datetime
import itertools
import json
import os
import warnings
from pathlib import Path
from typing import Any, Iterable, List, Optional, Tuple, Union

import numpy as np
import scipy.ndimage
import scipy.spatial.distance

Number = Union[int, float]


# ---- Formatting ---- #


def format_list(
    x: Any, length: int = None, default: Any = None, dtype: type = None
) -> list:
    """Coerce a scalar or iterable to a list of a given length.

    If the input is shorter than ``length``, it is padded with ``default``
    (if given) or repeated (if ``length`` is a multiple of the input length).

    Examples:
        >>> format_list([0, 1], length=1)
        [0]
        >>> format_list([0, 1], length=3, default=2)
        [0, 1, 2]
        >>> format_list([0, 1], length=4)
        [0, 1, 0, 1]
        >>> format_list([0, 1], dtype=float)
        [0.0, 1.0]
    """
    if x is None:
        raise ValueError("Input cannot be None")
    items = list(x) if np.iterable(x) else [x]
    if length and len(items) > length:
        del items[length:]
    elif length and len(items) < length:
        if default is not None:
            items.extend([default] * (length - len(items)))
        elif items:
            if length % len(items):
                raise ValueError("Output length is not multiple of input length")
            items = list(itertools.islice(itertools.cycle(items), length))
    return [dtype(v) for v in items] if dtype else items


def numpy_dtype_minmax(dtype: np.dtype) -> Tuple[Any, Any]:
    """Return the (min, max) representable values for a numpy dtype."""
    kind = np.dtype(dtype).kind
    probes = {"f": np.finfo, "i": np.iinfo, "u": np.iinfo}
    if kind in probes:
        info = probes[kind](dtype)
        return info.min, info.max
    if kind == "b":
        return False, True
    raise ValueError(f"Cannot determine min, max for {dtype}")


def numpy_to_native(x: Any) -> Any:
    """Convert numpy scalars/arrays to native Python types (lists)."""
    return getattr(x, "tolist", lambda: x)()


def strip_path(path: Union[str, Path], extensions: Union[bool, int] = True) -> str:
    """Return the final path component with extensions removed."""
    basename = Path(path).name
    if extensions:
        if extensions is True:
            extensions = -1
        return basename[::-1].split(".", maxsplit=extensions)[-1][::-1]
    return basename


def get_scale_from_size(old: Iterable[int], new: Iterable[int]) -> Optional[float]:
    """Return the scale factor mapping integer size `old` to `new`, if it exists."""
    old = np.atleast_1d(old)
    new = np.atleast_1d(new)
    if len(old) != len(new):
        n = max(len(old), len(new))
        old, new = np.resize(old, n), np.resize(new, n)
    if np.array_equal(new, old):
        return 1.0
    initial = new / old
    if np.all(initial[0] == initial):
        return float(initial[0])
    # Search for a scale whose rounded product hits the target exactly.
    lo, hi = float(np.floor(initial.min())), float(np.ceil(initial.max()))
    # Dense scan is robust and fast at these sizes (integer image dimensions).
    candidates = np.unique(np.concatenate([np.linspace(lo, hi, 20001), initial]))
    err = np.abs(np.round(candidates[:, None] * old) - new).sum(axis=1)
    hits = np.nonzero(err == 0)[0]
    if hits.size:
        return float(candidates[hits[0]])
    return None


# ---- Sorted search ---- #


def _sorted_neighbors(x: Iterable, y: Iterable) -> np.ndarray:
    """Return left/right neighbor indices (in ascending `x`) for each value in `y`."""
    x = np.asarray(x)
    # clip handles both edges: values before x[0] bracket (0, 1), values at
    # or past x[-1] bracket (len-2, len-1).
    left = np.clip(np.searchsorted(x, y) - 1, 0, len(x) - 2)
    return np.column_stack((left, left + 1))


def sorted_nearest(x: Iterable, y: Iterable) -> np.ndarray:
    """Return index of the nearest value in ascending `x` for each value in `y`."""
    x, y = np.asarray(x), np.asarray(y)
    bracket = _sorted_neighbors(x, y)
    gaps = np.abs(x[bracket] - y[:, None])
    pick_right = gaps[:, 1] < gaps[:, 0]
    return bracket[np.arange(len(y)), pick_right.astype(int)]


# ---- JSON ---- #


def read_json(path: Union[str, Path], **kwargs: Any) -> Union[dict, list]:
    """Read JSON from a file."""
    with open(path, mode="r") as fp:
        return json.load(fp, **kwargs)


def write_json(
    obj: Union[dict, list],
    path: Union[str, Path] = None,
    flat_arrays: bool = False,
    **kwargs: Any,
) -> Optional[str]:
    """Write an object to JSON (file or returned string).

    With ``flat_arrays=True`` and an ``indent``, arrays are squeezed onto a
    single line each.
    """
    txt = json.dumps(obj, **kwargs)
    indent = kwargs.get("indent")
    if flat_arrays and indent is not None and indent >= 0:
        item_sep = (kwargs.get("separators") or (", ",))[0]
        txt = "".join(
            json.dumps(json.loads(span), separators=(item_sep, ": "))
            if is_array
            else span
            for span, is_array in _iter_array_spans(txt)
        )
    if path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(txt)
        return None
    return txt


def _iter_array_spans(txt: str):
    """Split JSON text into (span, is_pure_array) chunks.

    A pure array is a balanced ``[...]`` region (possibly nested) containing
    no objects and no strings — i.e. a numeric leaf suitable for collapsing
    onto a single line. Scanning is stack-based rather than regex-based so
    nesting depth is unlimited.
    """
    cursor = 0
    i = 0
    n = len(txt)
    while i < n:
        if txt[i] == '"':  # skip string literals (may contain brackets)
            i += 1
            while i < n and txt[i] != '"':
                i += 2 if txt[i] == "\\" else 1
            i += 1
            continue
        if txt[i] == "[":
            depth = 0
            j = i
            pure = True
            while j < n:
                c = txt[j]
                if c == '"' or c == "{":
                    pure = False
                elif c == "[":
                    depth += 1
                elif c == "]":
                    depth -= 1
                    if depth == 0:
                        break
                j += 1
            if pure and j < n:
                yield txt[cursor:i], False
                yield txt[i : j + 1], True
                cursor = j + 1
                i = j + 1
                continue
        i += 1
    yield txt[cursor:], False


# ---- Array statistics ---- #


def normalize(a: np.ndarray) -> np.ndarray:
    """Normalize array to mean 0, variance 1.

    Examples:
        >>> x = normalize(np.array([0, 1, 2, 3]))
        >>> float(x.mean()), float(x.std())
        (0.0, 1.0)
    """
    return (a - a.mean()) * (1 / a.std())


def gaussian_filter(
    a: np.ndarray, mask: np.ndarray = None, fill: bool = False, **kwargs: Any
) -> np.ndarray:
    """Gaussian filter with optional mask of cells to include.

    Masked filtering follows the normalized-convolution identity: filter the
    zero-filled array and divide by the filtered indicator.
    """
    blur = lambda arr: scipy.ndimage.gaussian_filter(arr, **kwargs)
    if mask is None:
        return blur(a)
    indicator = mask.astype(a.dtype)
    smoothed = blur(np.where(mask, a, 0)) / blur(indicator)
    return smoothed if fill else np.where(mask, smoothed, a)


def maximum_filter(
    a: np.ndarray, mask: np.ndarray = None, fill: bool = False, **kwargs: Any
) -> np.ndarray:
    """Maximum filter with optional mask of cells to include."""
    if mask is None:
        return scipy.ndimage.maximum_filter(a, **kwargs)
    dtype_min = numpy_dtype_minmax(a.dtype)[0]
    x = a.copy()
    excluded = ~mask
    x[excluded] = dtype_min
    x = scipy.ndimage.maximum_filter(x, **kwargs)
    if fill:
        excluded = x == dtype_min
    x[excluded] = a[excluded]
    return x


def _numpy_dropdims(a: np.ndarray, axis: int = None, keepdims: bool = False) -> Any:
    """Collapse a length-1 reduction axis (or a scalar) unless keepdims."""
    a = np.asarray(a)
    if keepdims:
        return a
    if axis is None:
        return a.item() if a.size == 1 else a
    return a.squeeze(axis=axis) if a.shape[axis] == 1 else a


def sum_normals(
    means: np.ndarray,
    sigmas: np.ndarray,
    weights: np.ndarray = None,
    normalize: bool = False,
    correlation: float = 0,
    axis: int = None,
    keepdims: bool = False,
    ignore_nan: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Mean and sigma of a (weighted) sum of normal random variables.

    Standard linear error propagation with an assumed uniform pairwise
    correlation. Used for merging forward/backward tracking runs
    (correlation=0) and time-averaging velocities (correlation=1).

    The cross term uses the algebraic identity
    ``2 rho * sum_{i<j} (w s)_i (w s)_j = rho * [(sum w s)^2 - sum (w s)^2]``,
    which is O(n) instead of enumerating index pairs.
    """
    means = np.asarray(means, dtype=float)
    sigmas = np.asarray(sigmas, dtype=float)
    missing = np.isnan(means)
    if (missing ^ np.isnan(sigmas)).any():
        raise ValueError("Means and sigmas have missing values at different indices")
    if (sigmas == 0).any():
        raise ValueError("Sigmas cannot be zero")
    w = np.ones_like(means) if weights is None else np.asarray(weights, dtype=float)
    if normalize:
        valid_total = np.nansum(np.where(missing, 0.0, w), axis=axis, keepdims=True)
        with np.errstate(divide="ignore", invalid="ignore"):
            w = w / valid_total
    ws = w * sigmas
    total_mean = np.nansum(w * means, axis=axis, keepdims=True)
    variance = np.nansum(ws ** 2, axis=axis, keepdims=True)
    if correlation:
        cross = np.nansum(ws, axis=axis, keepdims=True) ** 2 - variance
        variance = variance + correlation * cross
    # Propagate NaN: any missing input poisons the output, unless ignore_nan,
    # in which case only an all-missing reduction does.
    reducer = np.all if ignore_nan else np.any
    bad = reducer(missing, axis=axis, keepdims=True)
    total_mean = np.where(bad, np.nan, total_mean)
    variance = np.where(bad, np.nan, variance)
    return (
        _numpy_dropdims(total_mean, axis=axis, keepdims=keepdims),
        _numpy_dropdims(np.sqrt(variance), axis=axis, keepdims=keepdims),
    )


# ---- Geometry ---- #


def boolean_split(
    a: np.ndarray,
    mask: np.ndarray,
    axis: int = 0,
    circular: bool = False,
    include: str = "all",
) -> List[np.ndarray]:
    """Split an array into runs of contiguous True/False mask values."""
    mask = np.asarray(mask, dtype=bool)
    cuts = np.flatnonzero(np.diff(mask.astype(np.int8))) + 1
    runs = np.split(a, cuts, axis=axis)
    if circular and cuts.size and mask[0] == mask[-1]:
        # Wrap the trailing run onto the leading one.
        runs[0] = np.concatenate((runs.pop(), runs[0]), axis=axis)
    if include == "all":
        return runs
    if include in ("true", "false"):
        want = include == "true"
        # Runs alternate in mask value starting from mask[0].
        offset = 0 if mask[0] == want else 1
        return runs[offset::2]
    return []


def unravel_box(box: Iterable) -> np.ndarray:
    """Return box (xmin, ..., xmax, ...) as a 2-row array [(mins), (maxs)]."""
    box = np.asarray(box)
    if box.size % 2 != 0:
        raise ValueError("Box length is not divisible by 2")
    return box.reshape(-1, box.size // 2)


def bounding_box(points: Iterable[Iterable]) -> np.ndarray:
    """Return bounding box [xmin, ..., xmax, ...] of points."""
    points = np.asarray(points)
    return np.hstack((np.min(points, axis=0), np.max(points, axis=0)))


def box_to_polygon(box: Iterable) -> np.ndarray:
    """Return 2-D box as closed polygon vertices (5, 2)."""
    box = unravel_box(box)
    return np.column_stack((box[(0, 0, 1, 1, 0), 0], box[(0, 1, 1, 0, 0), 1]))


def in_box(points: np.ndarray, box: Iterable) -> np.ndarray:
    """Test whether points are in (or on) a box.

    Examples:
        >>> points = np.array([(0, 0), (1, 1), (2, 2), (3, 3)])
        >>> in_box(points, box=[1, 1, 2.5, 2.5])
        array([False,  True,  True, False])
    """
    box = unravel_box(box)
    return np.all((points >= box[0, :]) & (points <= box[1, :]), axis=1)


def intersect_boxes(boxes: Iterable[Iterable]) -> np.ndarray:
    """Return the intersection of boxes (xmin, ..., xmax, ...).

    Examples:
        >>> intersect_boxes(((0, 0, 10, 10), (5, 5, 15, 15)))
        array([ 5,  5, 10, 10])
    """
    boxes = np.asarray(boxes)
    if boxes.shape[1] % 2:
        raise ValueError("Box lengths are not divisible by 2")
    # View as (n, 2, ndim): row 0 = lower corner, row 1 = upper corner.
    corners = boxes.reshape(boxes.shape[0], 2, -1)
    lo = np.nanmax(corners[:, 0], axis=0)
    hi = np.nanmin(corners[:, 1], axis=0)
    if not (hi > lo).all():
        raise ValueError("Boxes do not intersect")
    return np.concatenate([lo, hi])


def box_to_grid(
    box: Iterable,
    step: Union[float, Iterable[float]],
    snap: Iterable = None,
    mode: str = "grids",
) -> Union[np.ndarray, Tuple[np.ndarray, ...]]:
    """Return a grid of points inside a box, optionally aligned to a snap point."""
    lo, hi = unravel_box(box)
    steps = np.broadcast_to(np.asarray(step, dtype=float), lo.shape)
    anchor = lo if snap is None else np.asarray(snap, dtype=float)

    def axis_coords(a0, a1, d, s):
        # First grid coordinate >= a0 on the lattice {s + k*d}, then march to a1.
        first = a0 + (s - a0) % d
        count = int((a1 - first) // d) + 1
        return first + d * np.arange(count)

    axes = tuple(axis_coords(*args) for args in zip(lo, hi, steps, anchor))
    if mode == "vectors":
        return axes
    mesh = tuple(np.meshgrid(*axes))
    if mode == "grids":
        return mesh
    if mode == "points":
        return grid_to_points(mesh)
    raise ValueError(f"Unsupported mode: {mode}")


def grid_to_points(grid: Iterable[np.ndarray]) -> np.ndarray:
    """Return meshgrid coordinate arrays as point rows."""
    grid = tuple(grid)
    return np.reshape(grid, (len(grid), -1)).T


def clip_polyline_box(
    line: np.ndarray, box: Iterable, t: bool = False
) -> List[np.ndarray]:
    """Return segments of a polyline within a box, inserting boundary vertices.

    Runs of in-box vertices are located directly from the membership mask;
    each run is extended with the point where the connecting edge to its
    out-of-box neighbor crosses the box boundary (when that crossing exists).
    """
    line = np.asarray(line)
    cols = slice(None, -1) if t else slice(None)
    inside = in_box(line[:, cols], box)
    # Run boundaries: starts where False->True, ends where True->False.
    padded = np.concatenate([[False], inside, [False]])
    starts = np.flatnonzero(padded[1:] & ~padded[:-1])
    ends = np.flatnonzero(padded[:-1] & ~padded[1:])  # exclusive

    def boundary_point(inner_idx, outer_idx):
        # Anchor at the out-of-box vertex: the crossing fraction is then the
        # box *entry* time, numerically exact when the box edge lies on the
        # sample lattice.
        a = line[outer_idx]
        step = line[inner_idx] - a
        frac = intersect_edge_box(a[cols], step[cols], box)
        return None if frac is None else a + frac * step

    pieces = []
    for lo, hi in zip(starts, ends):
        parts = [line[lo:hi]]
        if lo > 0:
            entry = boundary_point(lo, lo - 1)
            if entry is not None:
                parts.insert(0, entry[None, :])
        if hi < len(line):
            exit_ = boundary_point(hi - 1, hi)
            if exit_ is not None:
                parts.append(exit_[None, :])
        pieces.append(np.concatenate(parts, axis=0) if len(parts) > 1 else parts[0])
    return pieces


def intersect_edge_box(
    origin: Iterable, distance: Iterable, box: Iterable
) -> Optional[float]:
    """Return multiple of `distance` at which an edge crosses into a box."""
    distance = np.asarray(distance).reshape(1, -1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        t = np.nanmin(intersect_rays_box(origin, distance, box, t=True))
    if 0 < t < 1:
        return float(t)
    return None


def intersect_rays_box(
    origin: Iterable, directions: np.ndarray, box: Iterable, t: bool = False
) -> Tuple[np.ndarray, np.ndarray]:
    """Intersect rays from a common origin with an axis-aligned 2-D/3-D box.

    Slab method. Returns ray entrances and exits (NaN on miss, entrance NaN if
    origin inside box), as absolute coordinates or as multiples of direction.
    """
    origin = np.asarray(origin, dtype=float)
    directions = np.atleast_2d(np.asarray(directions, dtype=float))
    box = unravel_box(box).astype(float)  # (2, ndim): [mins; maxs]
    ndim = directions.shape[1]
    with np.errstate(divide="ignore", invalid="ignore"):
        invdir = 1 / directions
    sign = (invdir < 0).astype(int)  # 0: min slab first, 1: max slab first
    # Per-dimension slab entry/exit times: bounds[sign, dim] and bounds[1-sign, dim]
    tmins = (box[sign, np.arange(ndim)] - origin[:ndim]) * invdir
    tmaxs = (box[1 - sign, np.arange(ndim)] - origin[:ndim]) * invdir
    tmin = tmins[:, 0].copy()
    tmax = tmaxs[:, 0].copy()
    for d in range(1, ndim):
        misses = (tmin > tmaxs[:, d]) | (tmins[:, d] > tmax)
        tmin[misses] = np.nan
        tmax[misses] = np.nan
        closer = tmins[:, d] > tmin
        tmin[closer] = tmins[closer, d]
        farther = tmaxs[:, d] < tmax
        tmax[farther] = tmaxs[farther, d]
    tmin[tmin < 0] = np.nan
    tmax[tmax < 0] = np.nan
    if t:
        return tmin[:, None], tmax[:, None]
    return origin + tmin[:, None] * directions, origin + tmax[:, None] * directions


def pairwise_distance(x: Iterable, y: Iterable, **kwargs: Any) -> np.ndarray:
    """Pairwise distances between two sets of points."""
    def as2d(p):
        arr = np.asarray(p)
        return arr.reshape(len(arr), -1)

    return scipy.spatial.distance.cdist(as2d(x), as2d(y), **kwargs)


def interpolate_line(
    vertices: np.ndarray,
    x: Iterable = None,
    xi: Iterable = None,
    n: int = None,
    dx: float = None,
    error: bool = True,
    fill: Any = "endpoints",
) -> np.ndarray:
    """Return points at specified (or evenly spaced) distances along a polyline.

    Interpolation is done by locating each query once with ``searchsorted``
    and applying the resulting linear weights to every coordinate column
    simultaneously (instead of per-column ``np.interp``).
    """
    if xi is None and n is None and dx is None:
        raise ValueError("One of xi, n, or dx is required")
    vertices = np.asarray(vertices, dtype=float)
    if x is None:
        seglen = np.linalg.norm(np.diff(vertices, axis=0), axis=1)
        x = np.concatenate([[0.0], np.cumsum(seglen)])
    else:
        x = np.asarray(x, dtype=float)
    descending = len(x) > 1 and x[1] < x[0]
    auto = xi is None
    if auto:
        if n is None:
            span = abs(x[-1] - x[0]) / dx
            # A whole number of steps still gets its trailing endpoint.
            n = int(round(span + 1)) if span == int(span) else int(round(span))
        xi = np.linspace(x[0], x[-1], num=n)
        error, fill = False, "endpoints"
    xi = np.asarray(xi, dtype=float)
    if descending:
        x, vertices = x[::-1], vertices[::-1]
    # One location pass, shared linear weights for all columns.
    hi = np.clip(np.searchsorted(x, xi), 1, len(x) - 1)
    x0, x1 = x[hi - 1], x[hi]
    with np.errstate(divide="ignore", invalid="ignore"):
        w = np.where(x1 > x0, (xi - x0) / np.where(x1 > x0, x1 - x0, 1.0), 0.0)
    w = np.clip(w, 0.0, 1.0)[:, None]
    result = (1 - w) * vertices[hi - 1] + w * vertices[hi]
    below, above = xi < x[0], xi > x[-1]
    if error and (below.any() or above.any()):
        raise ValueError("Requested distance outside range")
    if isinstance(fill, str) and fill == "endpoints":
        first, last = vertices[0], vertices[-1]
    elif np.iterable(fill):
        first, last = fill
    else:
        first = last = fill
    # Note: fill[0] pairs with the below-range side in the ascending frame
    # (vertices are reversed alongside x when distances run backwards).
    result[below] = first
    result[above] = last
    return result


# ---- Scatter / gather ---- #


def rasterize_points(
    rows: Iterable[int],
    cols: Iterable[int],
    values: Iterable,
    shape: Iterable[int] = None,
    a: np.ndarray = None,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Scatter points into raster cells, averaging values landing in a cell.

    Examples:
        >>> idx, means = rasterize_points((0, 0, 1), (0, 0, 1), (1, 2, 3), shape=(4, 3))
        >>> idx.tolist(), means.tolist()
        ([0, 4], [1.5, 3.0])
    """
    values = np.asarray(values, dtype=float)
    if shape is None:
        shape = a.shape
    nrows, ncols = int(shape[0]), int(shape[1])
    flat = np.asarray(rows) * ncols + np.asarray(cols)
    squeeze = values.ndim == 1 or (a is not None and values.shape[1] == 1)
    stacked = values.reshape(len(flat), -1)
    # Dense scatter-add over the raster, then keep only occupied cells.
    hits = np.zeros(nrows * ncols, dtype=np.intp)
    np.add.at(hits, flat, 1)
    totals = np.zeros((nrows * ncols, stacked.shape[1]))
    np.add.at(totals, flat, stacked)
    occupied = np.flatnonzero(hits)
    means = totals[occupied] / hits[occupied, None]
    if squeeze:
        means = means[:, 0]
    if a is None:
        return occupied, means
    a[np.unravel_index(occupied, (nrows, ncols))] = means
    return None


def polygons_to_mask(
    polygons: Iterable[Iterable[Iterable[Number]]],
    size: Iterable[int],
    holes: Iterable[Iterable[Iterable[Number]]] = None,
) -> np.ndarray:
    """Return boolean mask of grid cells inside polygons (GDAL-free).

    Matches GDAL's all-touched=False convention: a cell is burned if its
    center is inside the polygon.
    """
    import matplotlib.path

    nx, ny = int(size[0]), int(size[1])
    xs = np.arange(nx) + 0.5
    ys = np.arange(ny) + 0.5
    X, Y = np.meshgrid(xs, ys)
    pts = np.column_stack((X.ravel(), Y.ravel()))
    mask = np.zeros(nx * ny, dtype=bool)
    for polygon in polygons:
        path = matplotlib.path.Path(np.asarray(polygon, dtype=float))
        mask |= path.contains_points(pts)
    if holes:
        for polygon in holes:
            path = matplotlib.path.Path(np.asarray(polygon, dtype=float))
            mask &= ~path.contains_points(pts)
    return mask.reshape(ny, nx)


# ---- Time ---- #


def pairwise_distance_datetimes(
    x: Iterable[datetime.datetime], y: Iterable[datetime.datetime]
) -> np.ndarray:
    """Pairwise absolute distances in seconds between two sets of datetimes."""
    xs = np.array([xi.timestamp() for xi in x])
    ys = np.array([yi.timestamp() for yi in y])
    return np.abs(xs[:, None] - ys[None, :])


def datetime_range(
    start: datetime.datetime, stop: datetime.datetime, step: datetime.timedelta
) -> List[datetime.datetime]:
    """Evenly spaced datetimes in [start, stop]."""
    max_steps = (stop - start) // step
    return [start + n * step for n in range(max_steps + 1)]


def select_datetimes(
    datetimes: Iterable[datetime.datetime],
    start: datetime.datetime = None,
    end: datetime.datetime = None,
    snap: datetime.timedelta = None,
    maxdt: datetime.timedelta = None,
    origin: datetime.datetime = datetime.datetime(1970, 1, 1, 0, 0, 0),
) -> np.ndarray:
    """Boolean mask of datetimes within [start, end], optionally snapped to a grid.

    With ``snap``, the window is tiled with targets on the lattice
    ``{origin + k*snap}`` and only the datetime nearest each target (within
    ``maxdt``, default ``snap/2``) survives. Computation is done on float
    timestamps so the lattice math is plain arithmetic.
    """
    datetimes = np.asarray(datetimes)
    t = np.array([d.timestamp() for d in datetimes])
    pad = snap.total_seconds() if (snap and not (start and end)) else 0.0
    lo = start.timestamp() if start else t[0] - pad
    hi = end.timestamp() if end else t[-1] + pad
    if lo > hi:
        raise ValueError("Start datetime is after end datetime")
    selected = (t >= lo) & (t <= hi)
    if snap:
        period = snap.total_seconds()
        anchor = origin.timestamp()
        # Lattice targets covering [lo, hi].
        first = lo + (anchor - lo) % period
        targets = np.arange(first, hi + period * 1e-9, period)
        winners = sorted_nearest(t, targets)
        tol = (maxdt.total_seconds() if maxdt is not None else period / 2)
        close = np.abs(t[winners] - targets) <= tol
        keep = np.zeros(t.shape, dtype=bool)
        keep[winners[close]] = True
        selected &= keep
    return selected


# ---- Internal ---- #


def _parse_parallel(parallel: Union[int, bool]) -> int:
    """Parse a bool/int parallelism argument into a worker count."""
    if isinstance(parallel, bool):
        if not parallel:
            return 0
        count = os.cpu_count()
        if count is None:
            raise NotImplementedError("Cannot determine number of CPUs")
        return count
    return int(parallel)
