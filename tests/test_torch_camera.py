"""The port's host ``Camera`` and the float64 path of its projection ops
against the JAX package's ``Camera`` built from the same arguments.

Both work in float64 on the CPU, the port on tensors over the arrays'
memory, so forward projection, rotation and the Oulu, closed-form and lookup
undistortions are held to 1e-12 (pixels or world units); a projection round
trip stays under 1e-9 px.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import glimpse_tpu
import glimpse_tpu_torch
from glimpse_tpu_torch.ops import projection
from glimpse_tpu_torch.track import convert

CAMERAS = {
    "ideal": dict(imgsz=(100, 80), f=90),
    "k1": dict(imgsz=(800, 536), f=(900, 910), k=(-0.12, 0, 0, 0, 0, 0), xyz=(5, -3, 40), viewdir=(20, -15, 3)),
    "full": dict(
        imgsz=(800, 536), f=(900, 910), c=(3, -2), k=(-0.1, 0.05, 0.01, 0.002, 0.001, 0), p=(0.001, -0.002),
        xyz=(10, 20, 30), viewdir=(200, -35, 3), correction=True,
    ),
    "mm": dict(imgsz=(4288, 2848), fmm=20, sensorsz=(23.6, 15.8), cmm=(0.1, -0.05), viewdir=(-60, 5, -2),
               correction={"refraction": 0.2}),
}


def pair(name):
    return glimpse_tpu.Camera(**CAMERAS[name]), glimpse_tpu_torch.Camera(**CAMERAS[name])


def world_points(cam, n=500, seed=0):
    """Points around the camera, in front and behind."""
    rng = np.random.default_rng(seed)
    return cam.xyz + rng.uniform(-500, 500, (n, 3))


@pytest.mark.parametrize("name", list(CAMERAS))
def test_vector_and_attributes_equal(name) -> None:
    ref, port = pair(name)
    np.testing.assert_array_equal(port.to_array(), ref.to_array())
    assert port.to_array().dtype == np.float64
    for attr in ("xyz", "viewdir", "imgsz", "f", "c", "k", "p"):
        np.testing.assert_array_equal(getattr(port, attr), getattr(ref, attr))
    assert port.correction == ref.correction and port._correction_tuple == ref._correction_tuple
    if ref.sensorsz is not None:
        np.testing.assert_array_equal(port.fmm, ref.fmm)
        np.testing.assert_array_equal(port.cmm, ref.cmm)
    np.testing.assert_allclose(port.R, ref.R, atol=1e-15, rtol=0)
    np.testing.assert_allclose(port.Rprime, ref.Rprime, atol=1e-15, rtol=0)
    np.testing.assert_array_equal(port.grid(step=10), ref.grid(step=10))
    np.testing.assert_array_equal(port.edges(step=20), ref.edges(step=20))
    assert port.reversible() == ref.reversible()


@pytest.mark.parametrize("name", list(CAMERAS))
def test_xyz_to_uv_matches_with_nan_behind_the_camera(name) -> None:
    ref, port = pair(name)
    xyz = world_points(ref)
    want = ref.xyz_to_uv(xyz)
    got = port.xyz_to_uv(xyz)
    assert got.dtype == np.float64 and isinstance(got, np.ndarray)
    behind = np.isnan(want).any(axis=1)
    assert behind.any() and not behind.all()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    # Points near the camera plane project millions of pixels away: 1e-12
    # relative there, 1e-10 px near the frame.
    np.testing.assert_allclose(got[~behind], want[~behind], atol=1e-10, rtol=1e-12)
    np.testing.assert_array_equal(port.infront(xyz), ref.infront(xyz))
    if port._correction_tuple is None:  # infront applies no elevation correction
        np.testing.assert_array_equal(port.infront(xyz), ~behind)
    np.testing.assert_array_equal(port.inframe(got[~behind]), ref.inframe(want[~behind]))
    uv_d, depth = port.xyz_to_uv(xyz, return_depth=True)
    ref_uv_d, ref_depth = ref.xyz_to_uv(xyz, return_depth=True)
    np.testing.assert_allclose(depth, ref_depth, atol=1e-10, rtol=0)
    directions = xyz - ref.xyz
    np.testing.assert_allclose(
        port.xyz_to_uv(directions, directions=True)[~behind], ref.xyz_to_uv(directions, directions=True)[~behind],
        atol=1e-10, rtol=1e-12,
    )


@pytest.mark.parametrize("name", list(CAMERAS))
@pytest.mark.parametrize("method", [None, "lookup"])
def test_uv_to_xyz_matches(name, method) -> None:
    ref, port = pair(name)
    rng = np.random.default_rng(1)
    uv = rng.uniform(0.1, 0.9, (80, 2)) * ref.imgsz
    kwargs = dict(method=method, density=0.05) if method == "lookup" and name not in ("ideal", "k1") else dict(method=method)
    want = ref.uv_to_xyz(uv, **kwargs)
    got = port.uv_to_xyz(uv, **kwargs)
    np.testing.assert_allclose(got, want, atol=1e-12, rtol=0)
    np.testing.assert_allclose(
        port.uv_to_xyz(uv, directions=False, depth=25.0, **kwargs), ref.uv_to_xyz(uv, directions=False, depth=25.0, **kwargs),
        atol=1e-10, rtol=0,
    )


def test_regulafalsi_matches_where_the_reference_finds_a_root() -> None:
    """The reference's regula falsi sends a converged coordinate to 0 on
    some points (recorded in ROADMAP.md); the port is held to it on the
    others, and is a root of the distortion everywhere."""
    ref, port = pair("full")
    uv = np.random.default_rng(2).uniform(0.1, 0.9, (300, 2)) * ref.imgsz
    want = ref._uv_to_xy(uv, method="regulafalsi")
    got = port._uv_to_xy(uv, method="regulafalsi")
    good = np.abs(ref._xy_to_uv(want) - uv).max(axis=1) < 1e-9
    assert good.mean() > 0.9
    np.testing.assert_allclose(got[good], want[good], atol=1e-12, rtol=0)
    np.testing.assert_allclose(port._xy_to_uv(got), uv, atol=1e-9, rtol=0)


@pytest.mark.parametrize("name", list(CAMERAS))
def test_float64_round_trip_under_1e_9_px(name) -> None:
    _, port = pair(name)
    uv = np.random.default_rng(3).uniform(0.1, 0.9, (200, 2)) * port.imgsz
    back = port.xyz_to_uv(port.uv_to_xyz(uv), directions=True)
    assert np.abs(back - uv).max() < 1e-9
    absolute = port.uv_to_xyz(uv, directions=False, depth=100.0)
    if port._correction_tuple is None:
        assert np.abs(port.xyz_to_uv(absolute) - uv).max() < 1e-9


@pytest.mark.parametrize("name", ["k1", "full"])
def test_projection_ops_follow_the_dtype_of_their_input(name) -> None:
    """Every function of ``ops/projection`` works in its input's dtype:
    float64 in gives float64 out, within 1e-12 px of the reference; float32
    in gives float32 out."""
    ref, port = pair(name)
    xyz = world_points(ref, n=100, seed=4)
    xyz = xyz[ref.infront(xyz)]
    vec64 = torch.from_numpy(port.to_array())
    for dtype in (torch.float64, torch.float32):
        vec, pts = vec64.to(dtype), torch.from_numpy(xyz).to(dtype)
        uv = projection.project(vec, pts, correction=port._correction_tuple)
        u, v = projection.project_planes(vec, pts[:, 0], pts[:, 1], pts[:, 2], correction=port._correction_tuple)
        rays = projection.unproject(vec, uv)
        k, p = vec[projection.K], vec[projection.P]
        xy = projection.image_to_camera(uv, vec[projection.IMGSZ], vec[projection.F], vec[projection.C], k, p)
        outs = [uv, u, v, rays, xy, projection.undistort_regulafalsi(xy, k, p), projection.undistort_k1(xy, k[0]),
                projection.rotation_matrix(vec[projection.VIEWDIR]), projection.rotation_matrix_gradient(vec[projection.VIEWDIR]),
                projection.xyz_to_spherical(vec[projection.XYZ], pts), projection.distort(xy, k, p)]
        assert all(o.dtype == dtype for o in outs), [o.dtype for o in outs]
        if dtype == torch.float64:
            np.testing.assert_allclose(uv.numpy(), ref.xyz_to_uv(xyz), atol=1e-10, rtol=1e-12)
            np.testing.assert_allclose(torch.stack([u, v], -1).numpy(), uv.numpy(), atol=1e-9, rtol=1e-11)


@pytest.mark.parametrize("name", list(CAMERAS))
def test_json_round_trip(name, tmp_path) -> None:
    ref, port = pair(name)
    assert port.to_dict() == ref.to_dict()
    assert port.to_json() == ref.to_json()
    path = tmp_path / "cam.json"
    port.to_json(path)
    for cls in (glimpse_tpu_torch.Camera, glimpse_tpu.Camera):
        again = cls.from_json(path)
        np.testing.assert_array_equal(again.to_array(), port.to_array())
        assert again.correction == port.correction


def test_camera_from_the_reference_vector_is_bit_equal() -> None:
    ref, _ = pair("full")
    port = convert.camera_from_numpy(ref.to_array(), correction=ref.correction)
    np.testing.assert_array_equal(port.to_array(), ref.to_array())
    assert port._correction_tuple == ref._correction_tuple
    xyz = world_points(ref, n=50)
    np.testing.assert_array_equal(np.isnan(port.xyz_to_uv(xyz)), np.isnan(ref.xyz_to_uv(xyz)))


def test_state_management_and_resize_match() -> None:
    ref, port = pair("mm")
    for cam in (ref, port):
        cam.resize(0.25)
    np.testing.assert_array_equal(port.to_array(), ref.to_array())
    copy = port.copy()
    copy.viewdir = (1, 2, 3)
    copy.idealize()
    assert not copy.k.any() and port.k.any() is not None
    copy.reset()
    np.testing.assert_array_equal(copy.to_array(), port.to_array())
    for cam in (ref, port):
        cam.reset()
    np.testing.assert_array_equal(port.to_array(), ref.to_array())
    np.testing.assert_allclose(port.viewbox(50.0), ref.viewbox(50.0), atol=1e-9, rtol=0)
    np.testing.assert_allclose(port.viewpoly(50.0), ref.viewpoly(50.0), atol=1e-9, rtol=0)
    angles = np.array([[10.0, 5.0, 100.0], [200.0, -3.0, 40.0]])
    np.testing.assert_allclose(port.spherical_to_xyz(angles), ref.spherical_to_xyz(angles), atol=1e-10, rtol=0)
    np.testing.assert_allclose(
        port.xyz_to_spherical(port.spherical_to_xyz(angles)), ref.xyz_to_spherical(ref.spherical_to_xyz(angles)),
        atol=1e-10, rtol=0,
    )
    with pytest.raises(ValueError, match="missing"):
        glimpse_tpu_torch.Camera(imgsz=(10, 10))
    with pytest.raises(ValueError, match="both"):
        glimpse_tpu_torch.Camera(imgsz=(10, 10), f=5, fmm=5, sensorsz=(1, 1))
