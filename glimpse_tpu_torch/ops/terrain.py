"""Terrain visibility on tensors: viewshed and horizon by dense polar resampling.

The counterpart of :mod:`glimpse_tpu.ops.terrain`. Upstream computes
viewsheds with a sequential ring sweep over sorted cells and horizons by
per-heading Bresenham walks, both serial and host-bound. The formulation
here is dense and parallel:

1. Resample the DEM onto a polar grid centered on the viewpoint
   (headings x radii) with bilinear interpolation: one big gather.
2. Convert to elevation angles (dz + curvature/refraction correction) / r.
3. A running maximum along the radius axis gives the blocking envelope at
   every polar sample.
4. Visibility of each raster cell is a single comparison of its own
   elevation angle against the envelope just inside its radius; the horizon
   is the argmax of elevation angle along each heading.

:func:`viewshed` and :func:`horizon_angles` take the DEM as an array or a
tensor, work on ``device`` (the card unless the caller asks for the CPU) and
return tensors there. The sines and cosines of the headings, a few thousand
values, are taken on the host in float64 and cast, so the polar grid is the
same on every device. :func:`viewshed_rings` is the sequential sweep itself,
host-only NumPy, kept for bit parity with upstream.
"""
import math
from typing import Optional, Tuple

import numpy as np
import torch

from .sampling import bilinear_sample

NEG_INF = -1e30

# Most headings the polar grid of :func:`viewshed` takes.
MAX_HEADINGS = 8192


def _dem_tensor(array, device, dtype) -> torch.Tensor:
    """The DEM as a float tensor on ``device``: float64 on the CPU and
    float32 on a card unless ``dtype`` says otherwise."""
    device = torch.device(device)
    if dtype is None:
        dtype = torch.float64 if device.type == "cpu" else torch.float32
    return torch.as_tensor(array).to(device=device, dtype=dtype)


def _max_radius(shape, origin_rc) -> float:
    """Distance from the viewpoint to the farthest corner, in cells, plus one."""
    H, W = shape
    r0, c0 = origin_rc
    corners = np.array(
        [[0.0, 0.0], [0.0, W - 1.0], [H - 1.0, 0.0], [H - 1.0, W - 1.0]]
    )
    return float(
        np.sqrt(((corners - np.array([float(r0), float(c0)])) ** 2).sum(axis=1)).max()
    ) + 1.0


def _polar_positions(array, origin_rc, thetas: np.ndarray, n_radii: int, dr_cells: float):
    """Polar sample positions in index space: (rows, cols, inside, radii)."""
    like = dict(dtype=array.dtype, device=array.device)
    cos = torch.as_tensor(np.cos(thetas), **like)
    sin = torch.as_tensor(np.sin(thetas), **like)
    radii = (torch.arange(n_radii, **like) + 1.0) * dr_cells
    rows = origin_rc[0] + sin[:, None] * radii[None, :]
    cols = origin_rc[1] + cos[:, None] * radii[None, :]
    H, W = array.shape
    inside = (rows >= 0) & (rows <= H - 1) & (cols >= 0) & (cols <= W - 1)
    return rows.clamp(0, H - 1), cols.clamp(0, W - 1), inside, radii


def _polar_elevation_angles(
    array: torch.Tensor,
    origin_rc: Tuple[float, float],
    origin_z: float,
    cellsize: float,
    n_headings: int,
    n_radii: int,
    dr_cells: float,
    correction: Optional[Tuple[float, float]],
    sample_mode: str = "bilinear",
    distance_mode: str = "polar",
):
    """Sample elevation angles on a polar grid (headings, radii).

    ``origin_rc`` is the viewpoint in fractional (row, col) index space;
    radii are in cells. Angles at NaN samples are NEG_INF (no blocking).
    ``sample_mode='nearest'`` takes cell-center values (upstream's ring
    sweep interpolates between cell centers) and ``distance_mode='cell'``
    measures distance to the sampled cell's center rather than to the polar
    sample. Returns (angles, radii_cells, thetas).
    """
    thetas = np.arange(n_headings) * (2 * math.pi / n_headings) - math.pi
    rows_c, cols_c, inside, radii = _polar_positions(array, origin_rc, thetas, n_radii, dr_cells)
    if sample_mode == "nearest":
        ri = torch.round(rows_c).long()
        ci = torch.round(cols_c).long()
        z = array[ri, ci]
    else:
        z = bilinear_sample(array, rows_c, cols_c)
    if distance_mode == "cell" and sample_mode == "nearest":
        # Distance to the sampled cell's center.
        dr_ = ri.to(array.dtype) - origin_rc[0]
        dc_ = ci.to(array.dtype) - origin_rc[1]
        dist = torch.sqrt(dr_ * dr_ + dc_ * dc_) * cellsize
        dist = torch.where(dist > 0, dist, 1e-9)
    else:
        dist = radii[None, :] * cellsize
    dz = z - origin_z
    if correction is not None:
        radius_e, refraction = correction
        dz = dz + (refraction - 1) * (dist * dist) / (2 * radius_e)
    angles = dz / dist
    angles = torch.where(inside & ~torch.isnan(angles), angles, NEG_INF)
    return angles, radii, torch.as_tensor(thetas, dtype=array.dtype, device=array.device)


def visibility_margin(
    array,
    origin_rc: Tuple[float, float],
    origin_z: float,
    cellsize: float,
    correction: Optional[Tuple[float, float]] = None,
    oversample: float = 2.0,
    backoff: float = 1.0,
    sample_mode: str = "bilinear",
    distance_mode: str = "polar",
    device="cuda",
    dtype=None,
):
    """Each cell's elevation angle less the blocking envelope before it.

    Returns (margin, array, cell_r): a cell is blocked where its margin is
    negative; ``array`` is the DEM as the tensor that was used and
    ``cell_r`` each cell's distance from the viewpoint in cells.
    """
    array = _dem_tensor(array, device, dtype)
    like = dict(dtype=array.dtype, device=array.device)
    H, W = array.shape
    r0, c0 = origin_rc
    r_max = _max_radius((H, W), origin_rc)
    dr_cells = 1.0 / oversample
    n_radii = int(math.ceil(r_max / dr_cells))
    n_headings = int(min(max(int(math.ceil(2 * math.pi * r_max * oversample)), 64), MAX_HEADINGS))
    angles, _, _ = _polar_elevation_angles(
        array, origin_rc, origin_z, cellsize, n_headings, n_radii, dr_cells,
        correction, sample_mode=sample_mode, distance_mode=distance_mode,
    )
    # Blocking envelope: max elevation angle over strictly smaller radii.
    cmax = torch.cummax(angles, dim=1).values
    del angles
    env = torch.cat([torch.full((n_headings, 1), NEG_INF, **like), cmax[:, :-1]], dim=1)
    del cmax
    # Per-cell query.
    rr = torch.arange(H, **like)[:, None] - r0
    cc = torch.arange(W, **like)[None, :] - c0
    cell_r = torch.sqrt(rr * rr + cc * cc)  # (H, W) in cells
    cell_theta = torch.atan2(rr.expand(H, W), cc.expand(H, W))
    dist = cell_r * cellsize
    dz = array - origin_z
    if correction is not None:
        radius_e, refraction = correction
        dz = dz + (refraction - 1) * (dist * dist) / (2 * radius_e)
    safe_dist = torch.where(dist > 0, dist, 1.0)
    cell_angle = dz / safe_dist
    # Envelope lookup just inside the cell's own radius: back off by
    # ``backoff`` cell radii so same-cell polar samples cannot self-block
    # (1.0 is safe; ~0.5 matches the ring sweep's granularity).
    j = torch.floor((cell_r - backoff) / dr_cells).long().clamp(0, n_radii - 1)
    k = torch.round((cell_theta + math.pi) / (2 * math.pi / n_headings)).long()
    k = k % n_headings
    return cell_angle - env[k, j], array, cell_r


def viewshed(
    array,
    origin_rc: Tuple[float, float],
    origin_z: float,
    cellsize: float,
    correction: Optional[Tuple[float, float]] = None,
    oversample: float = 2.0,
    backoff: float = 1.0,
    sample_mode: str = "bilinear",
    distance_mode: str = "polar",
    device="cuda",
    dtype=None,
) -> torch.Tensor:
    """Binary viewshed of a DEM from a viewpoint.

    Arguments:
        array: DEM elevations (H, W), array or tensor; NaN cells are never
            visible and never block.
        origin_rc: Viewpoint in fractional (row, col) index space.
        origin_z: Viewpoint elevation (world units).
        cellsize: Cell size in world units (cells assumed square).
        correction: None or (radius, refraction) for curvature/refraction.
        oversample: Polar sampling density relative to the cell size
            (radial step = cellsize / oversample; one heading per
            ~cell-width arc at the outermost radius, at most
            :data:`MAX_HEADINGS`).
        device: Where the work is done and the mask returned.
        dtype: Working precision; float64 on the CPU and float32 on a card
            when None.

    Returns:
        Boolean (H, W) visibility mask, a tensor on ``device``.
    """
    margin, array, cell_r = visibility_margin(
        array, origin_rc, origin_z, cellsize, correction=correction,
        oversample=oversample, backoff=backoff, sample_mode=sample_mode,
        distance_mode=distance_mode, device=device, dtype=dtype,
    )
    # A NaN margin (NaN cell) compares false and is masked out below; the
    # origin cell itself is visible (if not NaN).
    return (~(margin < 0) | (cell_r < 0.5)) & ~torch.isnan(array)


def viewshed_rings(
    array,
    origin_rc: Tuple[float, float],
    origin_z: float,
    cellsize: float,
    correction: Optional[Tuple[float, float]] = None,
) -> np.ndarray:
    """Ring-sweep viewshed with upstream's semantics (host-only, NumPy).

    Cells are bucketed into integer-radius rings, swept outward with a
    max-elevation-angle envelope linearly interpolated over heading
    (period 2*pi). Sequential over rings, vectorized within each: use it
    for bit parity with upstream; the polar :func:`viewshed` is the
    device-friendly formulation.
    """
    array = np.asarray(array)
    H, W = array.shape
    r0, c0 = origin_rc
    drow = np.arange(H)[:, None] - r0
    dcol = np.arange(W)[None, :] - c0
    dist = np.sqrt(drow * drow + dcol * dcol).ravel() * cellsize
    dz = array.ravel() - origin_z
    if correction is not None:
        radius_e, refraction = correction
        dz = dz + (refraction - 1) * dist * dist / (2 * radius_e)
    # Heading convention is irrelevant as long as it is continuous: use
    # atan2 over index offsets.
    heading = np.arctan2(
        np.broadcast_to(drow, (H, W)), np.broadcast_to(dcol, (H, W))
    ).ravel()
    ring = np.floor(dist / cellsize + 0.5).astype(int)
    with np.errstate(divide="ignore", invalid="ignore"):
        angle = dz / dist

    visible = np.zeros(H * W, dtype=bool)
    order = np.lexsort((heading, ring))
    sorted_rings = ring[order]
    boundaries = np.searchsorted(
        sorted_rings, np.arange(sorted_rings[-1] + 2)
    )
    env_h = env_a = None
    for k in range(len(boundaries) - 1):
        members = order[boundaries[k]: boundaries[k + 1]]
        if members.size == 0 or (k == 0 and len(boundaries) > 2):
            continue  # the viewpoint's own ring is never marked
        if k == 0:
            return np.ones((H, W), dtype=bool)  # single co-located ring
        h = heading[members]
        a = angle[members]
        if env_h is None:
            vis = ~np.isnan(a)
            merged = a
        else:
            base = np.interp(h, env_h, env_a, period=2 * np.pi)
            with np.errstate(invalid="ignore"):
                vis = a > base
            vis |= np.isnan(base) & ~np.isnan(a)
            merged = np.where(vis, a, base)
        visible[members] = vis
        env_h, env_a = h, merged
    return visible.reshape(H, W)


def horizon_angles(
    array,
    origin_rc: Tuple[float, float],
    origin_z: float,
    cellsize: float,
    headings_rad,
    correction: Optional[Tuple[float, float]] = None,
    oversample: float = 2.0,
    device="cuda",
    dtype=None,
):
    """Per-heading horizon: max elevation angle and its polar position.

    ``headings_rad`` are math-convention angles (CCW from +col axis) in the
    *index* frame (rows increase downward). Returns (max_angle, r_at_max,
    z_at_max, valid) per heading as tensors on ``device``, where r is in
    cells and ``valid`` marks headings whose maximum is not the last
    non-NaN sample along the ray (a cell that is the last non-missing cell
    along a sighting is not part of the horizon). A heading with no valid
    sample reports its first sample, and is not valid.
    """
    array = _dem_tensor(array, device, dtype)
    dr_cells = 1.0 / oversample
    n_radii = int(math.ceil(_max_radius(array.shape, origin_rc) / dr_cells))
    thetas = np.asarray(headings_rad, dtype=float)
    rows_c, cols_c, inside, radii = _polar_positions(array, origin_rc, thetas, n_radii, dr_cells)
    z = bilinear_sample(array, rows_c, cols_c)
    valid_sample = inside & ~torch.isnan(z)
    dist = radii[None, :] * cellsize
    dz = z - origin_z
    if correction is not None:
        radius_e, refraction = correction
        dz = dz + (refraction - 1) * (dist * dist) / (2 * radius_e)
    angles = torch.where(valid_sample, dz / dist, NEG_INF)
    imax = torch.argmax(angles, dim=1)
    max_angle = angles.gather(1, imax[:, None])[:, 0]
    r_at_max = (imax + 1.0).to(array.dtype) * dr_cells
    z_at_max = z.gather(1, imax[:, None])[:, 0]
    any_valid = valid_sample.any(dim=1)
    # Valid horizon: some non-NaN sample lies beyond the maximum.
    idx = torch.arange(n_radii, device=array.device)[None, :]
    beyond = valid_sample & (idx > imax[:, None])
    valid = any_valid & beyond.any(dim=1)
    return max_angle, r_at_max, z_at_max, valid
