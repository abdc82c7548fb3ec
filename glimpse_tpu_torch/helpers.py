"""Host-side helpers: serialization, formatting, boxes, geometry, statistics, time.

The counterpart of :mod:`glimpse_tpu.helpers`, NumPy and SciPy only, holding
the functions the port's host objects use (JSON, list formatting, sorted
search, masked filters, uncertainty propagation, boxes and grids,
rasterization, polyline clipping and interpolation, pairwise distances,
datetime selection, pickles, histogram matching and CLAHE, ray and plane
intersection, Bresenham rasterization, elevation corrections), with their
examples, and the GDAL-free GIS helpers (``crs_to_wkt``, ``write_raster``,
``average_rasters``, the file-format lookup, ``plot_quivers``).
``crs_to_wkt`` passes a compound EPSG designation such as
``"EPSG:4326+5773"`` through unchanged, where the reference raises.
"""
import datetime
import gzip
import itertools
import json
import os
import pickle
import re
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


# ---- Pickle / JSON ---- #


def write_pickle(
    obj: Any, path: Union[str, Path], gz: bool = False, binary: bool = True, **kwargs: Any
) -> None:
    """Write an object to a (optionally gzipped) pickle file."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    mode = "wb" if binary else "w"
    opener = gzip.open if gz else open
    with opener(path, mode=mode) as fp:
        pickle.dump(obj, fp, **kwargs)


def read_pickle(
    path: Union[str, Path], gz: bool = False, binary: bool = True, **kwargs: Any
) -> Any:
    """Read an object from a (optionally gzipped) pickle file."""
    mode = "rb" if binary else "r"
    opener = gzip.open if gz else open
    with opener(path, mode=mode) as fp:
        return pickle.load(fp, **kwargs)


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


def compute_cdf(
    a: np.ndarray, return_inverse: bool = False
) -> Union[Tuple[np.ndarray, np.ndarray], Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Return (unique values, quantiles) CDF of an array."""
    results = np.unique(a, return_inverse=return_inverse, return_counts=True)
    quantiles = np.cumsum(results[-1]) / a.size
    if return_inverse:
        return results[0], quantiles, results[1]
    return results[0], quantiles


def match_cdf(
    a: np.ndarray, cdf: Union[Tuple[Iterable, Iterable], np.ndarray]
) -> np.ndarray:
    """Transform array values to match a target CDF (histogram matching).

    Examples:
        >>> a = np.array([3, 2, 1, 2])
        >>> b = np.array([4, 2, 1, 2, 4, 2, 1, 2])
        >>> match_cdf(a, b)
        array([4., 2., 1., 2.])
    """
    if isinstance(cdf, np.ndarray):
        cdf = compute_cdf(cdf)
    # Each element's empirical quantile is the fraction of elements <= it
    # (right-continuous CDF), obtained by ranking against a sorted copy —
    # no unique/inverse pass needed.
    flat = np.ravel(a)
    ranks = np.searchsorted(np.sort(flat), flat, side="right")
    return np.interp(ranks / flat.size, cdf[1], cdf[0]).reshape(a.shape)


def clahe(
    a: np.ndarray,
    clip_limit: float = 40.0,
    tile_grid_size: Tuple[int, int] = (8, 8),
) -> np.ndarray:
    """Contrast-limited adaptive histogram equalization of a uint8 image.

    Pure-NumPy stand-in for ``cv2.createCLAHE(...).apply`` (reference relies
    on cv2 for this, optimize.py:2346-2365): the image is divided into a
    ``tile_grid_size`` grid, each tile's 256-bin histogram is clipped at
    ``clip_limit * tile_area / 256`` with the excess redistributed uniformly
    (cv2 semantics), each clipped CDF becomes a tile LUT, and every pixel is
    mapped by bilinear interpolation between the four nearest tile LUTs.
    Differences from cv2 are sub-level rounding only.
    """
    a = np.asarray(a)
    if a.dtype != np.uint8:
        raise ValueError(f"clahe expects a uint8 image, got {a.dtype}")
    if a.ndim != 2:
        raise ValueError(f"clahe expects a 2-D image, got shape {a.shape}")
    ty, tx = int(tile_grid_size[0]), int(tile_grid_size[1])
    h, w = a.shape
    # cv2 pads with BORDER_REFLECT_101 so dims divide the grid evenly.
    th, tw = -(-h // ty), -(-w // tx)
    padded = np.pad(a, ((0, th * ty - h), (0, tw * tx - w)), mode="reflect")
    tiles = padded.reshape(ty, th, tx, tw).transpose(0, 2, 1, 3)  # (ty,tx,th,tw)
    # Per-tile 256-bin histograms via a single bincount over offset values.
    tile_ids = np.repeat(np.arange(ty * tx), th * tw)
    hist = np.bincount(
        tile_ids * 256 + tiles.reshape(ty * tx, -1).ravel().astype(np.intp),
        minlength=ty * tx * 256,
    ).reshape(ty * tx, 256)
    if clip_limit > 0:
        limit = max(int(clip_limit * th * tw / 256.0), 1)
        excess = np.clip(hist - limit, 0, None).sum(axis=1)
        hist = np.minimum(hist, limit)
        # Uniform redistribution of the clipped mass: every bin gets
        # excess//256, then the residual is spread one count per
        # max(256//residual, 1) bins starting at 0 (cv2's exact scheme —
        # first-bins-only redistribution skews the low-value CDF by up to
        # residual counts, ~20 gray levels at default settings).
        hist = hist + (excess // 256)[:, None]
        residual = (excess % 256)[:, None]
        step = np.maximum(256 // np.maximum(residual, 1), 1)
        bins = np.arange(256)[None, :]
        hist = hist + ((bins % step == 0) & (bins // step < residual))
    lut_scale = 255.0 / (th * tw)
    luts = np.rint(np.cumsum(hist, axis=1) * lut_scale).astype(np.float32)
    luts = luts.reshape(ty, tx, 256)
    # Bilinear interpolation between the 4 surrounding tile centres
    # (cv2 convention: txf = x / tile_width - 0.5, no half-pixel offset).
    yy = np.arange(h) / th - 0.5
    xx = np.arange(w) / tw - 0.5
    y0 = np.clip(np.floor(yy).astype(np.intp), 0, ty - 1)
    x0 = np.clip(np.floor(xx).astype(np.intp), 0, tx - 1)
    y1 = np.minimum(y0 + 1, ty - 1)
    x1 = np.minimum(x0 + 1, tx - 1)
    fy = np.clip(yy - y0, 0.0, 1.0)[:, None]
    fx = np.clip(xx - x0, 0.0, 1.0)[None, :]
    v = a.astype(np.intp)
    top = luts[y0[:, None], x0[None, :], v] * (1 - fx) + luts[
        y0[:, None], x1[None, :], v
    ] * fx
    bot = luts[y1[:, None], x0[None, :], v] * (1 - fx) + luts[
        y1[:, None], x1[None, :], v
    ] * fx
    return np.clip(np.rint(top * (1 - fy) + bot * fy), 0, 255).astype(np.uint8)


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


def intersect_ray_planes(ray: Iterable, planes: Iterable) -> np.ndarray:
    """Intersect one ray with many planes (NaN for parallel/behind)."""
    ray = np.asarray(ray, dtype=float)
    planes = np.atleast_2d(planes).astype(float)
    points = np.full((planes.shape[0], 3), np.nan)
    normals = np.cross(planes[:, 3:6], planes[:, 6:9])
    dots = (ray[3:6] * normals).sum(axis=1)
    mask = np.abs(dots) > 1e-14
    shifts = planes[mask, :3] - ray[:3]
    tvals = (normals[mask] * shifts).sum(axis=1) / dots[mask]
    infront = tvals >= 0
    mask[mask] &= infront
    points[mask] = ray[:3] + tvals[infront, None] * ray[3:6]
    return points


def intersect_rays_plane(rays: Iterable, plane: Iterable) -> np.ndarray:
    """Intersect many rays with one plane (NaN for parallel/behind)."""
    rays = np.atleast_2d(rays).astype(float)
    plane = np.asarray(plane, dtype=float)
    points = np.full((rays.shape[0], 3), np.nan)
    normal = np.cross(plane[3:6], plane[6:9])
    dots = (normal * rays[:, 3:6]).sum(axis=1)
    mask = np.abs(dots) > 1e-14
    shifts = plane[:3] - rays[mask, :3]
    tvals = (normal * shifts).sum(axis=1) / dots[mask]
    infront = tvals >= 0
    mask[mask] &= infront
    points[mask] = rays[mask, :3] + tvals[infront, None] * rays[mask, 3:6]
    return points


def bresenham_line(start: Iterable[int], end: Iterable[int]) -> np.ndarray:
    """Return grid indices along a line (Bresenham), fully vectorized.

    Matches the classic run-length algorithm: exactly max(|dx|, |dy|) + 1
    cells, stepping the minor axis when the accumulated error crosses zero.

    Examples:
        >>> bresenham_line((0, 0), (2, 1))
        array([[0, 0],
               [1, 0],
               [2, 1]])
        >>> bresenham_line((0, 0), (0, 2))
        array([[0, 0],
               [0, 1],
               [0, 2]])
    """
    x1, y1 = int(start[0]), int(start[1])
    x2, y2 = int(end[0]), int(end[1])
    steep = abs(y2 - y1) > abs(x2 - x1)
    if steep:
        x1, y1, x2, y2 = y1, x1, y2, x2
    swapped = x1 > x2
    if swapped:
        x1, x2, y1, y2 = x2, x1, y2, y1
    dx = x2 - x1
    abs_dy = abs(y2 - y1)
    ystep = 1 if y1 < y2 else -1
    xs = np.arange(x1, x2 + 1)
    if dx == 0:
        ys = np.array([y1])
    else:
        # error after k steps: e_k = floor(dx/2) - k*abs_dy; y increments when e < 0.
        k = np.arange(dx + 1)
        increments = (k * abs_dy - int(dx / 2) + dx - 1) // dx
        increments = np.maximum(increments, 0)
        ys = y1 + ystep * increments
    points = np.column_stack((ys, xs) if steep else (xs, ys))
    if swapped:
        points = points[::-1]
    return points


def bresenham_circle(center: Iterable[Number], radius: float) -> np.ndarray:
    """Return grid indices along a circle (midpoint algorithm), ordered CW."""
    x0, y0 = center
    octant_size = int(np.floor((np.sqrt(2) * (radius - 1) + 4) / 2))
    n_points = 8 * octant_size
    x, y = 0, radius
    f = 1 - radius
    dx, dy = 1, -2 * radius
    xy = np.full((n_points, 2), np.nan)
    xy[0] = [x0 + x, y0 + y]
    xy[8 * octant_size - 1] = [x0 - x, y0 + y]
    xy[4 * octant_size - 1] = [x0 + x, y0 - y]
    xy[4 * octant_size] = [x0 - x, y0 - y]
    xy[2 * octant_size - 1] = [x0 + y, y0 + x]
    xy[6 * octant_size] = [x0 - y, y0 + x]
    xy[2 * octant_size] = [x0 + y, y0 - x]
    xy[6 * octant_size - 1] = [x0 - y, y0 - x]
    for i in range(2, octant_size + 1):
        if f > 0:
            y -= 1
            dy += 2
            f += dy
        x += 1
        dx += 2
        f += dx
        xy[i - 1] = [x0 + x, y0 + y]
        xy[8 * octant_size - i] = [x0 - x, y0 + y]
        xy[4 * octant_size - i] = [x0 + x, y0 - y]
        xy[4 * octant_size + i - 1] = [x0 - x, y0 - y]
        xy[2 * octant_size - i] = [x0 + y, y0 + x]
        xy[6 * octant_size + i - 1] = [x0 - y, y0 + x]
        xy[2 * octant_size + i - 1] = [x0 + y, y0 - x]
        xy[6 * octant_size - i] = [x0 - y, y0 - x]
    unique = [True] + (np.diff(xy, axis=0) != 0).any(axis=1).tolist()
    return xy[unique]


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


# ---- Physics ---- #


def elevation_corrections(
    squared_distances: Iterable, radius: float = 6.3781e6, refraction: float = 0.13
) -> np.ndarray:
    """Elevation corrections for earth curvature and atmospheric refraction.

    Follows the (refraction - 1) d^2 / (2 radius) survey correction.

    Examples:
        >>> round(float(elevation_corrections(np.array([1e8]))[0]), 2)
        -6.82
    """
    return (refraction - 1) * np.asarray(squared_distances) / (2 * radius)


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


# ---- GIS (GDAL-free) ---- #


# WKT1 building blocks for the EPSG definitions this domain uses
# (the original glimpse resolves arbitrary codes through GDAL's
# SpatialReference; GDAL-free here, so the
# common geographic/UTM/Alaska codes are generated from their published
# EPSG parameters and anything else falls back to an "EPSG:<code>"
# identifier string).
_WKT_GEOGCS = {
    # datum name, spheroid name, inverse flattening, datum code, geogcs code
    "WGS 84": (
        "WGS_1984", "WGS 84", 6378137, "298.257223563", 6326, 4326
    ),
    "NAD83": (
        "North_American_Datum_1983", "GRS 1980", 6378137,
        "298.257222101", 6269, 4269,
    ),
}


def _wkt_geogcs(name: str) -> str:
    datum, sph, a, inv_f, dcode, gcode = _WKT_GEOGCS[name]
    return (
        f'GEOGCS["{name}",DATUM["{datum}",SPHEROID["{sph}",{a},{inv_f},'
        f'AUTHORITY["EPSG","{7030 if sph == "WGS 84" else 7019}"]],'
        f'AUTHORITY["EPSG","{dcode}"]],'
        f'PRIMEM["Greenwich",0,AUTHORITY["EPSG","8901"]],'
        f'UNIT["degree",0.0174532925199433,AUTHORITY["EPSG","9122"]],'
        f'AUTHORITY["EPSG","{gcode}"]]'
    )


def _wkt_projcs(name, geogcs, projection, parameters, code):
    params = ",".join(
        f'PARAMETER["{k}",{v}]' for k, v in parameters
    )
    return (
        f'PROJCS["{name}",{_wkt_geogcs(geogcs)},'
        f'PROJECTION["{projection}"],{params},'
        f'UNIT["metre",1,AUTHORITY["EPSG","9001"]],'
        f'AXIS["Easting",EAST],AXIS["Northing",NORTH],'
        f'AUTHORITY["EPSG","{code}"]]'
    )


def _epsg_to_wkt(code: int) -> Optional[str]:
    """WKT1 for an EPSG code, or None if outside the built-in table."""
    if code in (4326, 4269):
        return _wkt_geogcs("WGS 84" if code == 4326 else "NAD83")
    if 32601 <= code <= 32660 or 32701 <= code <= 32760:  # WGS 84 / UTM
        zone = code % 100
        south = code >= 32701
        return _wkt_projcs(
            f"WGS 84 / UTM zone {zone}{'S' if south else 'N'}",
            "WGS 84", "Transverse_Mercator",
            [
                ("latitude_of_origin", 0),
                ("central_meridian", zone * 6 - 183),
                ("scale_factor", 0.9996),
                ("false_easting", 500000),
                ("false_northing", 10000000 if south else 0),
            ],
            code,
        )
    if 26901 <= code <= 26923:  # NAD83 / UTM (Alaska imagery CRS family)
        zone = code % 100
        return _wkt_projcs(
            f"NAD83 / UTM zone {zone}N", "NAD83", "Transverse_Mercator",
            [
                ("latitude_of_origin", 0),
                ("central_meridian", zone * 6 - 183),
                ("scale_factor", 0.9996),
                ("false_easting", 500000),
                ("false_northing", 0),
            ],
            code,
        )
    if code == 3338:  # NAD83 / Alaska Albers (Columbia Glacier rasters)
        return _wkt_projcs(
            "NAD83 / Alaska Albers", "NAD83", "Albers_Conic_Equal_Area",
            [
                ("latitude_of_center", 50),
                ("longitude_of_center", -154),
                ("standard_parallel_1", 55),
                ("standard_parallel_2", 65),
                ("false_easting", 0),
                ("false_northing", 0),
            ],
            code,
        )
    if code == 3413:  # WGS 84 / NSIDC polar stereographic north
        return _wkt_projcs(
            "WGS 84 / NSIDC Sea Ice Polar Stereographic North",
            "WGS 84", "Polar_Stereographic",
            [
                ("latitude_of_origin", 70),
                ("central_meridian", -45),
                ("false_easting", 0),
                ("false_northing", 0),
            ],
            code,
        )
    return None


def crs_to_wkt(crs: Union[int, str]) -> str:
    """Convert a CRS designation to WKT where possible.

    GDAL-free: integer EPSG codes (or "EPSG:<code>" strings) in the
    built-in table — geographic WGS 84/NAD83, all WGS 84 and NAD83 UTM
    zones, Alaska Albers (3338), NSIDC polar stereographic (3413) — are
    expanded to real WKT1 from their published EPSG parameters, so written
    GeoTIFFs round-trip through external GIS tools. Codes outside the
    table degrade to the "EPSG:<code>" identifier (stored opaquely; the
    framework itself never reprojects). WKT and Proj4 strings pass
    through unchanged.
    """
    if isinstance(crs, str) and crs.upper().startswith("EPSG:"):
        try:
            crs = int(crs.split(":", 1)[1])
        except ValueError:
            # A compound designation (horizontal + vertical, "EPSG:4326+5773")
            # is carried opaquely like any Proj4 string; anything else after
            # the colon is malformed.
            if not re.fullmatch(r"\d+(\+\d+)+", crs.split(":", 1)[1].strip()):
                raise ValueError(f"Malformed EPSG designation: {crs}") from None
            return crs
    if isinstance(crs, (int, np.integer)):
        wkt = _epsg_to_wkt(int(crs))
        return wkt if wkt is not None else f"EPSG:{int(crs)}"
    if isinstance(crs, str):
        if "[" in crs or "+" in crs:
            return crs
        raise ValueError(f"String CRS format not Proj4, WKT, or EPSG: {crs}")
    raise ValueError(f"Unsupported CRS format: {crs}")


def write_raster(
    a: np.ndarray,
    path: Union[str, Path],
    nan: Union[float, int] = None,
    crs: Union[int, str] = None,
    transform: Iterable[Union[int, float]] = None,
    **kwargs: Any,
) -> None:
    """Write an array to a GeoTIFF (see glimpse_tpu_torch.io.geotiff.write)."""
    from .io import geotiff

    geotiff.write(
        path, a, transform=transform,
        crs=crs_to_wkt(crs) if crs is not None else None, nodata=nan,
    )


def average_rasters(paths: Iterable[Union[str, Path]]) -> np.ndarray:
    """Return the mean of several same-shaped rasters (streamed)."""
    from .io import geotiff

    paths = [str(path) for path in paths]
    base = np.atleast_3d(geotiff.read(paths[0])).astype(float)
    n = len(paths)
    total = base / n
    for path in paths[1:]:
        a = np.atleast_3d(geotiff.read(path)).astype(float)
        if a.shape != base.shape:
            raise ValueError(
                f"Inconsistent shape at {path}: {a.shape} (expected {base.shape})"
            )
        total += a / n
    return total


def driver_from_path(path, raster: bool = True, vector: bool = True):
    """Infer an IO driver name from a file extension.

    GDAL-free stand-in for the reference's ``gdal_driver_from_path``
    (helpers.py:651-678): returns the driver name string this package's IO
    layer would use ('GTiff', 'JPEG', 'PNG', 'SVG', ...) or None when the
    extension is unrecognized.
    """
    from pathlib import Path as _Path

    ext = _Path(str(path)).suffix[1:].lower()
    raster_drivers = {
        "tif": "GTiff", "tiff": "GTiff", "jpg": "JPEG", "jpeg": "JPEG",
        "png": "PNG", "bmp": "BMP", "gif": "GIF",
    }
    vector_drivers = {"svg": "SVG", "json": "GeoJSON", "geojson": "GeoJSON"}
    if raster and ext in raster_drivers:
        return raster_drivers[ext]
    if vector and ext in vector_drivers:
        return vector_drivers[ext]
    return None


#: Alias matching the reference name (returns a driver name string, not an
#: osgeo.gdal.Driver — this package has no GDAL dependency).
gdal_driver_from_path = driver_from_path


def plot_quivers(x, dx, c=None, ax=None, **kwargs):
    """Plot displacement quivers with map-scale defaults.

    Parity: ``helpers.plot_quivers`` (reference helpers.py:1958-1993) —
    arrows drawn in data units (scale=1), tail-pivoted, headless.
    """
    import matplotlib.pyplot as plt

    defaults = dict(
        width=5, headaxislength=0, headwidth=1, minlength=0,
        pivot="tail", angles="xy", scale_units="xy", scale=1,
    )
    for key, value in defaults.items():
        kwargs.setdefault(key, value)
    x = np.asarray(x)
    dx = np.asarray(dx)
    args = [x[:, 0], x[:, 1], dx[:, 0], dx[:, 1]]
    if c is not None:
        args.append(c)
    return (ax or plt.gca()).quiver(*args, **kwargs)

