"""Projection through a distorted camera, on tensors: world to image and back.

The counterpart of :mod:`glimpse_tpu.ops.projection`. Every function works
in the dtype and on the device of the tensors it is given: float32 on the
card for the tracker, float64 on the CPU for the host :class:`Camera`. A
camera is a 20-float vector:

====== =========== ==========================================================
Index  Name        Meaning
====== =========== ==========================================================
0:3    xyz         Camera position in world coordinates
3:6    viewdir     (yaw, pitch, roll) in degrees
6:8    imgsz       Image size in pixels (nx, ny)
8:10   f           Focal length in pixels (fx, fy)
10:12  c           Principal point offset from image center in pixels
12:18  k           Radial distortion coefficients (k1..k6, rational model)
18:20  p           Tangential distortion coefficients (p1, p2)
====== =========== ==========================================================

Points at or behind the camera plane project to NaN. The inverse half
(:func:`undistort`, :func:`image_to_camera`, :func:`unproject`) takes the
camera's intrinsics either as tensors or as a host (numpy) copy; only a host
copy lets :func:`undistort` pick the identity or the closed-form k1 solver,
as the reference does from concrete coefficients, so nothing is read back
from the card to decide.
"""
import math
from typing import Optional, Tuple

import numpy as np
import torch

XYZ = slice(0, 3)
VIEWDIR = slice(3, 6)
IMGSZ = slice(6, 8)
F = slice(8, 10)
C = slice(10, 12)
K = slice(12, 18)
P = slice(18, 20)

EARTH_RADIUS = 6.3781e6
REFRACTION = 0.13


def rotation_matrix(viewdir: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (3, 3) from (yaw, pitch, roll) in degrees.

    Maps world offsets (+x east, +y north, +z up) into camera coordinates
    (x right, y down, z forward).
    """
    radians = viewdir * (math.pi / 180)
    C_, S_ = torch.cos(radians), torch.sin(radians)
    c0, c1, c2 = C_[..., 0], C_[..., 1], C_[..., 2]
    s0, s1, s2 = S_[..., 0], S_[..., 1], S_[..., 2]
    row0 = torch.stack([c0 * c2 + s0 * s1 * s2, c0 * s1 * s2 - c2 * s0, -c1 * s2], dim=-1)
    row1 = torch.stack([c2 * s0 * s1 - c0 * s2, s0 * s2 + c0 * c2 * s1, -c1 * c2], dim=-1)
    row2 = torch.stack([c1 * s0, c0 * c1, s1], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def viewdir_from_rotation(R):
    """(yaw, pitch, roll) in degrees from a :func:`rotation_matrix` (..., 3, 3).

    Exact inverse for pitch in (-90, 90).
    """
    pitch = torch.asin(torch.clamp(R[..., 2, 2], -1.0, 1.0))
    yaw = torch.atan2(R[..., 2, 0], R[..., 2, 1])
    roll = torch.atan2(-R[..., 0, 2], -R[..., 1, 2])
    return torch.stack([yaw, pitch, roll], dim=-1) * (180.0 / math.pi)


def rotation_matrix_gradient(viewdir: torch.Tensor) -> torch.Tensor:
    """Derivative of :func:`rotation_matrix` by viewdir, shape (3, 3, 3).

    Axis 0 indexes the viewdir component (yaw, pitch, roll), so
    ``result[i] == dR/dviewdir[i]``.
    """
    radians = viewdir * (math.pi / 180)
    C_, S_ = torch.cos(radians), torch.sin(radians)
    c0, c1, c2 = C_[..., 0], C_[..., 1], C_[..., 2]
    s0, s1, s2 = S_[..., 0], S_[..., 1], S_[..., 2]
    zero = torch.zeros_like(c0)

    def block(*rows):
        return torch.stack([torch.stack(row, -1) for row in rows], -2)

    d_yaw = block(
        [c0 * s1 * s2 - s0 * c2, s0 * s2 + c0 * s1 * c2, c0 * c1],
        [-s0 * s1 * s2 - c0 * c2, c0 * s2 - s0 * s1 * c2, -s0 * c1],
        [zero, zero, zero],
    )
    d_pitch = block(
        [s0 * c1 * s2, s0 * c1 * c2, -s0 * s1],
        [c0 * c1 * s2, c0 * c1 * c2, -c0 * s1],
        [s1 * s2, s1 * c2, c1],
    )
    d_roll = block(
        [s0 * s1 * c2 - c0 * s2, -s0 * s1 * s2 - c0 * c2, zero],
        [s0 * s2 + c0 * s1 * c2, s0 * c2 - c0 * s1 * s2, zero],
        [-c1 * c2, c1 * s2, zero],
    )
    stacked = torch.stack([d_yaw, d_pitch, d_roll], dim=-3)
    return stacked.transpose(-1, -2) * (math.pi / 180)


def radial_distortion_factor(r2, k):
    """Rational radial multiplier (1 + k1 r2 + k2 r4 + k3 r6) / (1 + k4 r2 + k5 r4 + k6 r6)."""
    r4 = r2 * r2
    r6 = r4 * r2
    num = 1 + k[..., 0] * r2 + k[..., 1] * r4 + k[..., 2] * r6
    den = 1 + k[..., 3] * r2 + k[..., 4] * r4 + k[..., 5] * r6
    return num / den


def tangential_distortion(xy, r2, p):
    """Tangential distortion additive [dtx, dty]."""
    x, y = xy[..., 0], xy[..., 1]
    xty = x * y
    dtx = 2 * xty * p[..., 0] + p[..., 1] * (r2 + 2 * x * x)
    dty = p[..., 0] * (r2 + 2 * y * y) + 2 * xty * p[..., 1]
    return torch.stack([dtx, dty], dim=-1)


def distort(xy, k, p):
    """Apply radial + tangential distortion to normalized camera coordinates."""
    r2 = torch.sum(xy * xy, dim=-1)
    dr = radial_distortion_factor(r2, k)
    return xy * dr[..., None] + tangential_distortion(xy, r2, p)


def _like(x, ref: torch.Tensor) -> torch.Tensor:
    """``x`` (array, number or tensor) as a tensor of ``ref``'s dtype and device."""
    return torch.as_tensor(x, dtype=ref.dtype, device=ref.device)


def undistort_k1(xy, k1):
    """Closed-form undistortion when only k1 is nonzero: the cubic
    r^3 + r/k1 - r'/k1 = 0 in polar coordinates, trigonometric or Cardano
    branch.

    The reference writes R = -x / (2 k1 cos(phi)); that is -r' / (2 k1),
    which is taken here from r' directly: dividing by cos(phi) loses up to
    6e-5 of float32 precision near phi = +-90 deg.
    """
    k1 = _like(k1, xy)
    phi = torch.atan2(xy[..., 1], xy[..., 0])
    Q = -1 / (3 * k1)
    cos_phi = torch.cos(phi)
    sin_phi = torch.sin(phi)
    R = -torch.hypot(xy[..., 0], xy[..., 1]) / (2 * k1)
    three_roots = (R * R) < (Q * Q * Q)
    Qsafe = torch.where(Q > 0, Q, torch.ones_like(Q))
    th = torch.acos(torch.clamp(R * Qsafe**-1.5, -1.0, 1.0))
    r_three = -2 * torch.sqrt(torch.abs(Q)) * torch.cos((th - 2 * math.pi) / 3)
    disc = torch.clamp(R * R - Q * Q * Q, min=0.0)
    A = -torch.sign(R) * (torch.abs(R) + torch.sqrt(disc)) ** (1.0 / 3)
    B = torch.where(A != 0, Q / torch.where(A != 0, A, torch.ones_like(A)), torch.zeros_like(A))
    r = torch.where(three_roots, r_three, A + B)
    return torch.stack([cos_phi, sin_phi], dim=-1) * r[..., None]


def undistort_oulu(xy, k, p, iterations: int = 20):
    """Fixed-point undistortion: uxy <- (xy - tangential(uxy)) / radial(|uxy|^2)."""
    uxy = xy
    for _ in range(iterations):
        r2 = torch.sum(uxy * uxy, dim=-1)
        uxy = (xy - tangential_distortion(uxy, r2, p)) / radial_distortion_factor(r2, k)[..., None]
    return uxy


def undistort_regulafalsi(xy, k, p, iterations: int = 100):
    """Elementwise regula falsi undistortion, robust under extreme distortion.

    The bracket starts at the image center and halfway to the distorted
    coordinate; an element whose bracket stops moving (dy == 0 on both
    coordinates) is frozen at that estimate. The reference's loop also stops
    once every element is frozen; running all ``iterations`` gives the same
    result, since a frozen element keeps its estimate, and needs no read of
    the card to decide.

    Where only one coordinate's bracket has stopped moving, that coordinate
    keeps its estimate. The reference divides by 1 there instead, which
    sends the coordinate to x1 y2 - x2 y1 (0 once it has converged): in
    float32 about one point in a hundred of a moderately distorted frame
    ends at 0 (ROADMAP.md C).
    """
    x1 = torch.zeros_like(xy)
    y1 = -xy
    x2 = xy / 2
    y2 = distort(x2, k, p) - xy
    uxy = torch.full_like(xy, math.nan)
    frozen = torch.zeros(xy.shape[:-1], dtype=torch.bool, device=xy.device)
    for _ in range(iterations):
        dy = y2 - y1
        newly = torch.all(dy == 0, dim=-1) & ~frozen
        uxy = torch.where(newly[..., None], x2, uxy)
        frozen = frozen | newly
        still = dy == 0
        x3 = torch.where(still, x2, (x1 * y2 - x2 * y1) / torch.where(still, torch.ones_like(dy), dy))
        x3 = torch.where(frozen[..., None], x2, x3)
        x1, y1, x2, y2 = x2, y2, x3, distort(x3, k, p) - xy
    return torch.where(frozen[..., None], uxy, x2)


def undistort_lookup(xy, k, p, imgsz, f, c, density: float = 1.0):
    """Undistortion by scattered-data lookup (host-only: scipy's ``griddata``).

    Distorts a regular grid of normalized coordinates covering the frame and
    interpolates the inverse mapping at the query points. Stable under
    extreme distortion and slower than the iterative solvers. ``xy`` is a
    CPU tensor; the intrinsics are arrays or CPU tensors.
    """
    import scipy.interpolate

    if xy.device.type != "cpu":
        raise ValueError("Lookup undistortion is host-only (pass CPU tensors)")
    imgsz, f, c = (np.asarray(v, dtype=float) for v in (imgsz, f, c))
    like = dict(dtype=xy.dtype)

    def distorted(points: np.ndarray) -> np.ndarray:
        return distort(torch.as_tensor(points, **like), _like(k, xy), _like(p, xy)).numpy()

    corners = np.array(
        [[0, 0], [0.5, 0], [1, 0], [1, 0.5], [1, 1], [0.5, 1], [0, 1], [0, 0.5]]
    )
    uv_edges = imgsz * corners
    xyu_edges = (uv_edges - (imgsz / 2 + c)) / f
    xyd_edges = distorted(xyu_edges)
    ux = np.linspace(
        min(xyu_edges[:, 0].min(), xyd_edges[:, 0].min()),
        max(xyu_edges[:, 0].max(), xyd_edges[:, 0].max()),
        int(density * imgsz[0]),
    )
    uy = np.linspace(
        min(xyu_edges[:, 1].min(), xyd_edges[:, 1].min()),
        max(xyu_edges[:, 1].max(), xyd_edges[:, 1].max()),
        int(density * imgsz[1]),
    )
    UX, UY = np.meshgrid(ux, uy)
    uxy = np.column_stack((UX.ravel(), UY.ravel()))
    # Keep only the principal (monotone) branch of the radial map: beyond the
    # fold the distorted->undistorted relation is multivalued and scattered
    # interpolation would blend branches.
    radii = np.linspace(0, np.hypot(uxy[:, 0], uxy[:, 1]).max(), 2048)
    probe = np.column_stack((radii, np.zeros_like(radii)))
    distorted_radii = distorted(probe)[:, 0]
    folds = np.flatnonzero(np.diff(distorted_radii) <= 0)
    if folds.size:
        r_max = radii[folds[0]]
        uxy = uxy[uxy[:, 0] ** 2 + uxy[:, 1] ** 2 <= r_max ** 2]
    out = scipy.interpolate.griddata(distorted(uxy), uxy, xy.numpy(), method="linear")
    return torch.as_tensor(out, **like)


def undistort(xy, k, p, method: str = "oulu", **kwargs):
    """Remove distortion from normalized camera coordinates.

    With ``k`` and ``p`` as numpy arrays (a host copy of the camera), the
    identity is returned when the camera has no distortion and the
    closed-form cubic is used when only k1 is nonzero, as in the reference's
    host path; tensors go straight to the requested method, as on the
    reference's device path. ``method="lookup"`` is host-only scipy code
    (:func:`undistort_lookup`) and takes ``imgsz``, ``f`` and ``c`` besides.
    """
    if isinstance(k, np.ndarray) and isinstance(p, np.ndarray):
        if not k.any() and not p.any():
            return xy
        if k[..., 0].all() and not k[..., 1:].any() and not p.any():
            return undistort_k1(xy, k[..., 0])
    k = _like(k, xy)
    p = _like(p, xy)
    if method == "k1":
        return undistort_k1(xy, k[..., 0])
    if method == "oulu":
        return undistort_oulu(xy, k, p, **kwargs)
    if method == "regulafalsi":
        return undistort_regulafalsi(xy, k, p, **kwargs)
    if method == "lookup":
        return undistort_lookup(xy, k, p, **kwargs)
    raise ValueError(f"Undistort method not supported: {method}")


def elevation_correction(squared_distances, radius=EARTH_RADIUS, refraction=REFRACTION):
    """Elevation change from earth curvature and refraction over a distance."""
    return (refraction - 1) * squared_distances / (2 * radius)


def world_to_camera(
    xyz,
    cam_xyz,
    R,
    correction: Optional[Tuple[float, float]] = None,
    directions: bool = False,
    return_depth: bool = False,
):
    """World points (..., 3) -> normalized camera coordinates (..., 2).

    ``correction`` is None or (radius, refraction). ``directions=True``
    takes ``xyz`` as rays relative to the camera (no offset, no correction).
    Points at or behind the camera plane map to NaN. With ``return_depth``
    the depth along the optical axis comes back too.
    """
    if directions:
        dxyz = xyz
    else:
        dxyz = xyz - cam_xyz
        if correction is not None:
            radius, refraction = correction
            d2 = dxyz[..., 0] ** 2 + dxyz[..., 1] ** 2
            dz = dxyz[..., 2] + elevation_correction(d2, radius, refraction)
            dxyz = torch.cat([dxyz[..., 0:2], dz[..., None]], dim=-1)
    # In the type both promote to, as the reference's matmul: float64 points
    # meet a float32 camera's rotation in float64.
    dtype = torch.promote_types(dxyz.dtype, R.dtype)
    xyz_c = torch.matmul(dxyz.to(dtype), R.transpose(-1, -2).to(dtype))
    depth = xyz_c[..., 2]
    behind = depth <= 0
    safe_depth = torch.where(behind, torch.ones_like(depth), depth)
    xy = xyz_c[..., 0:2] / safe_depth[..., None]
    xy = xy.masked_fill(behind[..., None], math.nan)
    return (xy, depth) if return_depth else xy


def camera_to_world(xy, R, cam_xyz=None, directions: bool = True, depth=1):
    """Normalized camera coordinates (..., 2) -> world rays (..., 3) at unit
    optical-axis depth (times ``depth``), relative to the camera
    (``directions=True``) or absolute."""
    xyz = torch.matmul(xy, R[..., 0:2, :]) + R[..., 2, :]
    if not (isinstance(depth, (int, float)) and depth == 1):
        depth = _like(depth, xyz)
        xyz = xyz * (depth[..., None] if depth.ndim else depth)
    if not directions:
        xyz = xyz + cam_xyz
    return xyz


def camera_to_image(xy, imgsz, f, c, k, p):
    """Distort and scale camera coordinates to pixels."""
    return distort(xy, k, p) * f + (imgsz / 2 + c)


def image_to_camera(uv, imgsz, f, c, k, p, method: str = "oulu", **kwargs):
    """Pixels (..., 2) -> undistorted normalized camera coordinates.

    The intrinsics may be tensors or numpy arrays; numpy ``k`` and ``p``
    let :func:`undistort` specialize (see there).
    """
    xy = (uv - (_like(imgsz, uv) * 0.5 + _like(c, uv))) * (1 / _like(f, uv))
    if method == "lookup":
        kwargs = {"imgsz": imgsz, "f": f, "c": c, **kwargs}
    return undistort(xy, k, p, method=method, **kwargs)


def project(
    vector,
    xyz,
    correction: Optional[Tuple[float, float]] = None,
    directions: bool = False,
    return_depth: bool = False,
):
    """World coordinates (..., 3) -> image coordinates (..., 2), and the
    depth along the optical axis with ``return_depth``."""
    R = rotation_matrix(vector[..., VIEWDIR])
    xy, depth = world_to_camera(
        xyz, vector[..., XYZ], R, correction=correction, directions=directions,
        return_depth=True,
    )
    uv = camera_to_image(
        xy, vector[..., IMGSZ], vector[..., F], vector[..., C], vector[..., K],
        vector[..., P],
    )
    return (uv, depth) if return_depth else uv


def project_planes(
    vector, x, y, z, correction: Optional[Tuple[float, float]] = None
):
    """Forward projection of x/y/z coordinate planes -> (u, v) planes.

    The same math as :func:`project` on separate (...,)-shaped planes, with
    the rotation written as multiply-adds (as the reference's plane form is,
    so the two agree to rounding). The planes are first widened to the type
    they and ``vector`` promote to: float16 or bfloat16 particles meet a
    float32 camera as JAX arrays do, in float32, where torch would keep the
    16-bit type against the camera's 0-d entries.
    """
    dtype = torch.promote_types(torch.promote_types(x.dtype, y.dtype), torch.promote_types(z.dtype, vector.dtype))
    x, y, z = (t.to(dtype) for t in (x, y, z))
    R = rotation_matrix(vector[..., VIEWDIR])
    cam = vector[..., XYZ]
    dx = x - cam[..., 0]
    dy = y - cam[..., 1]
    dz = z - cam[..., 2]
    if correction is not None:
        radius, refraction = correction
        dz = dz + elevation_correction(dx * dx + dy * dy, radius, refraction)
    xc = R[..., 0, 0] * dx + R[..., 0, 1] * dy + R[..., 0, 2] * dz
    yc = R[..., 1, 0] * dx + R[..., 1, 1] * dy + R[..., 1, 2] * dz
    zc = R[..., 2, 0] * dx + R[..., 2, 1] * dy + R[..., 2, 2] * dz
    # Each plane is as large as the particles: drop those done with, so the
    # tracker's step holds a few at a time, not all fifteen.
    del x, y, z, dx, dy, dz
    behind = zc <= 0
    safe = torch.where(behind, torch.ones_like(zc), zc)
    xn = (xc / safe).masked_fill(behind, math.nan)
    yn = (yc / safe).masked_fill(behind, math.nan)
    del xc, yc, zc, safe, behind
    k = vector[..., K]
    p = vector[..., P]
    r2 = xn * xn + yn * yn
    dr = radial_distortion_factor(r2, k)
    xty = xn * yn
    dtx = 2 * xty * p[..., 0] + p[..., 1] * (r2 + 2 * xn * xn)
    dty = p[..., 0] * (r2 + 2 * yn * yn) + 2 * xty * p[..., 1]
    del r2, xty
    f = vector[..., F]
    c = vector[..., C]
    imgsz = vector[..., IMGSZ]
    u = (xn * dr + dtx) * f[..., 0] + (imgsz[..., 0] * 0.5 + c[..., 0])
    v = (yn * dr + dty) * f[..., 1] + (imgsz[..., 1] * 0.5 + c[..., 1])
    return u, v


def unproject(vector, uv, directions: bool = True, depth=1, method: str = "oulu", **kwargs):
    """Image coordinates (..., 2) -> world rays or points (..., 3).

    ``vector`` may be a tensor or a host (numpy) copy of the camera; from a
    host copy, :func:`undistort` specializes on the distortion coefficients.
    """
    host = vector if isinstance(vector, np.ndarray) else None
    vector = _like(vector, uv)
    k, p = (host[..., K], host[..., P]) if host is not None else (vector[..., K], vector[..., P])
    xy = image_to_camera(uv, vector[..., IMGSZ], vector[..., F], vector[..., C], k, p, method=method, **kwargs)
    R = rotation_matrix(vector[..., VIEWDIR])
    return camera_to_world(xy, R, cam_xyz=vector[..., XYZ], directions=directions, depth=depth)


def infront(vector, xyz, directions: bool = False):
    """Whether world points (..., 3) lie in front of the camera."""
    R = rotation_matrix(vector[..., VIEWDIR])
    dxyz = xyz if directions else xyz - vector[..., XYZ]
    return torch.sum(dxyz * R[..., 2, :], dim=-1) > 0


def inframe(vector, uv):
    """Whether image coordinates (..., 2) lie in (or on the edge of) the frame."""
    ok = (uv >= 0) & (uv <= vector[..., IMGSZ])
    return ok[..., 0] & ok[..., 1]


def spherical_to_xyz(cam_xyz, angles):
    """Spherical (azimuth clockwise from north, altitude, [distance]) in
    degrees -> world; directions without a distance."""
    azimuth_iso = (math.pi / 2 - angles[..., 0] * math.pi / 180) % (2 * math.pi)
    altitude_iso = (math.pi / 2 - angles[..., 1] * math.pi / 180) % (2 * math.pi)
    xyz = torch.stack(
        [
            torch.sin(altitude_iso) * torch.cos(azimuth_iso),
            torch.sin(altitude_iso) * torch.sin(azimuth_iso),
            torch.cos(altitude_iso),
        ],
        dim=-1,
    )
    if angles.shape[-1] > 2:
        xyz = xyz * angles[..., 2:3] + cam_xyz
    return xyz


def xyz_to_spherical(cam_xyz, xyz, directions: bool = False):
    """World -> spherical (azimuth clockwise from north, altitude, [distance])
    in degrees."""
    if not directions:
        xyz = xyz - cam_xyz
    r = torch.sqrt(torch.sum(xyz * xyz, dim=-1))
    azimuth_iso = torch.atan2(xyz[..., 1], xyz[..., 0])
    altitude_iso = torch.acos(xyz[..., 2] / r)
    angles = torch.stack([(90 - azimuth_iso * (180 / math.pi)) % 360, 90 - altitude_iso * (180 / math.pi)], dim=-1)
    if not directions:
        angles = torch.cat([angles, r[..., None]], dim=-1)
    return angles
