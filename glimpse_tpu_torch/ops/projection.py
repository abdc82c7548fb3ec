"""Forward projection of world points through a distorted camera, on tensors.

The counterpart of :mod:`glimpse_tpu.ops.projection` for the tracker's path.
A camera is a 20-float vector (float32 on the tensors' device):

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

Points at or behind the camera plane project to NaN.
"""
import math
from typing import Optional, Tuple

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


def elevation_correction(squared_distances, radius=EARTH_RADIUS, refraction=REFRACTION):
    """Elevation change from earth curvature and refraction over a distance."""
    return (refraction - 1) * squared_distances / (2 * radius)


def world_to_camera(
    xyz, cam_xyz, R, correction: Optional[Tuple[float, float]] = None
):
    """World points (..., 3) -> normalized camera coordinates (..., 2).

    ``correction`` is None or (radius, refraction). Points at or behind the
    camera plane map to NaN.
    """
    dxyz = xyz - cam_xyz
    if correction is not None:
        radius, refraction = correction
        d2 = dxyz[..., 0] ** 2 + dxyz[..., 1] ** 2
        dz = dxyz[..., 2] + elevation_correction(d2, radius, refraction)
        dxyz = torch.cat([dxyz[..., 0:2], dz[..., None]], dim=-1)
    xyz_c = torch.matmul(dxyz, R.transpose(-1, -2))
    depth = xyz_c[..., 2]
    behind = depth <= 0
    safe_depth = torch.where(behind, torch.ones_like(depth), depth)
    xy = xyz_c[..., 0:2] / safe_depth[..., None]
    return xy.masked_fill(behind[..., None], math.nan)


def camera_to_image(xy, imgsz, f, c, k, p):
    """Distort and scale camera coordinates to pixels."""
    return distort(xy, k, p) * f + (imgsz / 2 + c)


def project(vector, xyz, correction: Optional[Tuple[float, float]] = None):
    """World coordinates (..., 3) -> image coordinates (..., 2)."""
    R = rotation_matrix(vector[..., VIEWDIR])
    xy = world_to_camera(xyz, vector[..., XYZ], R, correction=correction)
    return camera_to_image(
        xy, vector[..., IMGSZ], vector[..., F], vector[..., C], vector[..., K],
        vector[..., P],
    )


def project_planes(
    vector, x, y, z, correction: Optional[Tuple[float, float]] = None
):
    """Forward projection of x/y/z coordinate planes -> (u, v) planes.

    The same math as :func:`project` on separate (...,)-shaped planes, with
    the rotation written as multiply-adds (as the reference's plane form is,
    so the two agree to rounding).
    """
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
    behind = zc <= 0
    safe = torch.where(behind, torch.ones_like(zc), zc)
    xn = (xc / safe).masked_fill(behind, math.nan)
    yn = (yc / safe).masked_fill(behind, math.nan)
    k = vector[..., K]
    p = vector[..., P]
    r2 = xn * xn + yn * yn
    dr = radial_distortion_factor(r2, k)
    xty = xn * yn
    dtx = 2 * xty * p[..., 0] + p[..., 1] * (r2 + 2 * xn * xn)
    dty = p[..., 0] * (r2 + 2 * yn * yn) + 2 * xty * p[..., 1]
    f = vector[..., F]
    c = vector[..., C]
    imgsz = vector[..., IMGSZ]
    u = (xn * dr + dtx) * f[..., 0] + (imgsz[..., 0] * 0.5 + c[..., 0])
    v = (yn * dr + dty) * f[..., 1] + (imgsz[..., 1] * 0.5 + c[..., 1])
    return u, v
