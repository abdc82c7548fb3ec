"""The port's inverse projection against the reference's, on seeded inputs.

The port runs float32; the reference runs float32 on its JAX path
(``xp=jnp``) and float64 on its host path (``xp=np``). Both are held to
1e-5 (normalized coordinates and unit rays are about 1; pixels are
compared after division by the focal length).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

from glimpse_tpu.ops import projection as jax_projection
from glimpse_tpu_torch.ops import projection


def _camera(rng, k_scale=1.0, p_scale=1.0):
    vector = np.zeros(20)
    vector[0:3] = rng.uniform(-1000, 1000, 3) + (0, 0, 500)
    vector[3:6] = (rng.uniform(0, 360), rng.uniform(-30, 10), rng.uniform(-5, 5))
    vector[6:8] = (800, 536)
    vector[8:10] = rng.uniform(700, 1200, 2)
    vector[10:12] = rng.normal(0, 5, 2)
    vector[12:18] = rng.normal(0, 1, 6) * (0.1, 0.05, 0.01, 0.02, 0.01, 0.005) * k_scale
    vector[18:20] = rng.normal(0, 1e-3, 2) * p_scale
    return vector


def _pixels(rng, n=500):
    return np.column_stack([rng.uniform(0, 800, n), rng.uniform(0, 536, n)])


def _both(fn_jax, *args, **kwargs):
    """The reference on its JAX path (float32) and its host path (float64)."""
    f32 = fn_jax(*(jnp.asarray(np.asarray(a, np.float32)) for a in args), xp=jnp, **kwargs)
    f64 = fn_jax(*(np.asarray(a, np.float64) for a in args), xp=np, **kwargs)
    return np.asarray(f32), np.asarray(f64)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


@pytest.mark.parametrize("method", ["k1", "oulu", "regulafalsi"])
def test_undistort_solvers_match_jax(method) -> None:
    """Each solver on distorted points of a camera with nonzero k and p."""
    rng = np.random.default_rng(0)
    vector = _camera(rng)
    xy = (_pixels(rng) - (vector[6:8] / 2 + vector[10:12])) / vector[8:10]
    k, p = vector[12:18], vector[18:20]
    solver = {
        "k1": lambda a, kk, pp: projection.undistort_k1(a, kk[0]),
        "oulu": projection.undistort_oulu,
        "regulafalsi": projection.undistort_regulafalsi,
    }[method]
    got = solver(_t(xy), _t(k), _t(p)).numpy()
    if method == "k1":
        want32 = np.asarray(jax_projection.undistort_k1(jnp.asarray(xy, jnp.float32), jnp.float32(k[0]), xp=jnp))
        want64 = jax_projection.undistort_k1(xy, k[0], xp=np)
    else:
        fn = getattr(jax_projection, f"undistort_{method}")
        want32, want64 = _both(fn, xy, k, p)
    assert np.isfinite(got).all()
    if method == "regulafalsi":
        # The reference's regula falsi sends a coordinate whose bracket has
        # stopped moving, while the other's has not, to x1 y2 - x2 y1: 0 once
        # converged. The port keeps the estimate, so its result is a root of
        # the distortion everywhere; it is held to the reference where the
        # reference's result is one, and to the Oulu solver everywhere.
        def roots(u):
            return np.abs(jax_projection.distort(u, k, p, xp=np) - xy).max(axis=-1) < 1e-6

        assert roots(got).all()
        faulty = ~(roots(want32) & roots(want64))
        assert 0 < faulty.sum() < 0.05 * len(xy)
        assert ((want32[faulty] == 0) | (want64[faulty] == 0)).any(axis=-1).all()
        got, want32, want64 = got[~faulty], want32[~faulty], want64[~faulty]
        np.testing.assert_allclose(
            solver(_t(xy), _t(k), _t(p)).numpy(), jax_projection.undistort_oulu(xy, k, p, xp=np), atol=1e-5, rtol=0
        )
    np.testing.assert_allclose(got, want32, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, want64, atol=1e-5, rtol=0)
    # The dispatch with tensors runs the requested solver.
    np.testing.assert_array_equal(
        projection.undistort(_t(xy), _t(k), _t(p), method=method).numpy(), solver(_t(xy), _t(k), _t(p)).numpy()
    )


def test_undistort_dispatch_from_a_host_copy() -> None:
    """With numpy coefficients the port, like the reference's host path,
    returns the identity for a camera without distortion and the closed-form
    k1 solver when only k1 is nonzero; with tensors it runs the requested
    iterative method, as the reference's JAX path does."""
    rng = np.random.default_rng(1)
    xy = rng.uniform(-0.4, 0.4, (300, 2))
    zero_k, zero_p = np.zeros(6), np.zeros(2)
    xy_t = _t(xy)
    assert projection.undistort(xy_t, zero_k, zero_p) is xy_t
    assert jax_projection.undistort(xy, zero_k, zero_p, xp=np) is xy
    k = np.array([-0.3, 0, 0, 0, 0, 0])
    host = projection.undistort(xy_t, k, zero_p).numpy()
    np.testing.assert_array_equal(host, projection.undistort_k1(xy_t, -0.3).numpy())
    np.testing.assert_allclose(host, jax_projection.undistort(xy, k, zero_p, xp=np), atol=1e-5, rtol=0)
    on_tensors = projection.undistort(xy_t, _t(k), _t(zero_p)).numpy()
    want = np.asarray(jax_projection.undistort(jnp.asarray(xy, jnp.float32), jnp.asarray(k, jnp.float32),
                                               jnp.asarray(zero_p, jnp.float32), xp=jnp))
    np.testing.assert_array_equal(on_tensors, projection.undistort_oulu(xy_t, _t(k), _t(zero_p)).numpy())
    np.testing.assert_allclose(on_tensors, want, atol=1e-5, rtol=0)
    # The lookup solver (host scipy) takes the frame's geometry besides.
    frame = dict(imgsz=np.array([800.0, 536.0]), f=np.array([900.0, 910.0]), c=np.array([3.0, -2.0]))
    full_k, p = np.array([-0.1, 0.05, 0.01, 0.002, 0.001, 0.0]), np.array([0.001, -0.002])
    inner = rng.uniform(-0.25, 0.25, (50, 2))
    looked_up = projection.undistort(torch.from_numpy(inner), full_k, p, method="lookup", density=0.1, **frame).numpy()
    np.testing.assert_allclose(
        looked_up, jax_projection.undistort(inner, full_k, p, method="lookup", xp=np, density=0.1, **frame),
        atol=1e-12, rtol=0,
    )
    with pytest.raises(ValueError, match="not supported"):
        projection.undistort(xy_t, _t(k), _t(zero_p), method="table")


@pytest.mark.parametrize("directions, depth", [(True, 1), (False, 250.0), (False, "array")])
def test_unproject_matches_jax_and_inverts_project(directions, depth) -> None:
    """image_to_camera, camera_to_world and unproject against both reference
    paths; unprojected points project back to their pixels."""
    rng = np.random.default_rng(2)
    for _ in range(3):
        vector = _camera(rng)
        uv = _pixels(rng)
        d = rng.uniform(50, 2000, len(uv)) if depth == "array" else depth
        want32 = np.asarray(jax_projection.unproject(jnp.asarray(vector, jnp.float32), jnp.asarray(uv, jnp.float32),
                                                     directions=directions, depth=d, xp=jnp))
        want64 = jax_projection.unproject(vector, uv, directions=directions, depth=d, xp=np)
        for camera in (_t(vector), vector):  # a tensor, and a host copy
            got = projection.unproject(camera, _t(uv), directions=directions, depth=d).numpy()
            scale = np.abs(want64 - (0 if directions else vector[0:3])).max(axis=-1, keepdims=True)
            rays = (got - (0 if directions else vector[0:3].astype(np.float32))) / scale
            np.testing.assert_allclose(rays, (want32 - (0 if directions else vector[0:3].astype(np.float32))) / scale,
                                       atol=1e-5, rtol=0)
            np.testing.assert_allclose(rays, (want64 - (0 if directions else vector[0:3])) / scale, atol=1e-5, rtol=0)
        xy = projection.image_to_camera(_t(uv), vector[6:8], vector[8:10], vector[10:12], vector[12:18],
                                        vector[18:20]).numpy()
        np.testing.assert_allclose(xy, jax_projection.image_to_camera(
            uv, vector[6:8], vector[8:10], vector[10:12], vector[12:18], vector[18:20], xp=np), atol=1e-5, rtol=0)
        R = projection.rotation_matrix(_t(vector[3:6]))
        np.testing.assert_allclose(
            projection.camera_to_world(_t(xy), R).numpy(),
            jax_projection.camera_to_world(xy, jax_projection.rotation_matrix(vector[3:6], xp=np), xp=np),
            atol=1e-5, rtol=0,
        )
        if not directions:
            back = projection.project(_t(vector), torch.from_numpy(got)).numpy()
            np.testing.assert_allclose(back / vector[8:10], uv / vector[8:10], atol=1e-5, rtol=0)


def test_infront_inframe_and_behind_camera() -> None:
    """Points behind the camera are not in front, and project to NaN, on
    both sides; inframe agrees on pixels in, on and beyond the frame's edge."""
    rng = np.random.default_rng(3)
    vector = _camera(rng)
    R = jax_projection.rotation_matrix(vector[3:6], xp=np)
    depth = rng.uniform(100, 2000, 400) * np.where(np.arange(400) % 3 == 0, -1, 1)
    xyz = vector[0:3] + np.column_stack([rng.uniform(-0.4, 0.4, (400, 2)) * depth[:, None], depth]) @ R
    got = projection.infront(_t(vector), _t(xyz)).numpy()
    np.testing.assert_array_equal(got, jax_projection.infront(vector, xyz, xp=np))
    np.testing.assert_array_equal(got, depth > 0)
    uv = projection.project(_t(vector), _t(xyz)).numpy()
    assert np.isnan(uv[depth < 0]).all() and np.isfinite(uv[depth > 0]).all()
    dirs = projection.infront(_t(vector), _t(xyz - vector[0:3]), directions=True).numpy()
    np.testing.assert_array_equal(dirs, got)
    uv = np.vstack([_pixels(rng, 200), [[0, 0], [800, 536], [-1e-3, 5], [5, 536.5], [800.01, 1]]])
    np.testing.assert_array_equal(
        projection.inframe(torch.from_numpy(vector), torch.from_numpy(uv)).numpy(),
        jax_projection.inframe(vector, uv, xp=np),
    )


def test_spherical_and_viewdir_round_trips() -> None:
    """spherical_to_xyz / xyz_to_spherical against both reference paths, and
    viewdir_from_rotation inverting rotation_matrix."""
    rng = np.random.default_rng(4)
    cam = np.array([100.0, -200.0, 50.0])
    angles = np.column_stack([rng.uniform(0, 360, 300), rng.uniform(-80, 80, 300), rng.uniform(10, 1000, 300)])
    for a in (angles[:, :2], angles):
        got = projection.spherical_to_xyz(_t(cam), _t(a)).numpy()
        want32, want64 = _both(jax_projection.spherical_to_xyz, cam, a)
        scale = 1 if a.shape[-1] == 2 else 1000
        np.testing.assert_allclose(got / scale, want32 / scale, atol=1e-5, rtol=0)
        np.testing.assert_allclose(got / scale, want64 / scale, atol=1e-5, rtol=0)
    xyz = jax_projection.spherical_to_xyz(cam, angles, xp=np)
    got = projection.xyz_to_spherical(torch.from_numpy(cam), torch.from_numpy(xyz)).numpy()
    np.testing.assert_allclose(got, jax_projection.xyz_to_spherical(cam, xyz, xp=np), atol=1e-9, rtol=0)
    np.testing.assert_allclose(got, angles, atol=1e-9, rtol=1e-12)
    dirs = projection.xyz_to_spherical(_t(cam), _t(xyz - cam), directions=True).numpy()
    want32, _ = _both(jax_projection.xyz_to_spherical, cam, xyz - cam, directions=True)
    np.testing.assert_allclose(dirs / 360, want32 / 360, atol=1e-5, rtol=0)
    viewdirs = np.column_stack([rng.uniform(-180, 180, 50), rng.uniform(-85, 85, 50), rng.uniform(-180, 180, 50)])
    R = jax_projection.rotation_matrix(viewdirs, xp=np)
    got = projection.viewdir_from_rotation(_t(R)).numpy()
    np.testing.assert_allclose(got / 180, np.asarray(jax_projection.viewdir_from_rotation(
        jnp.asarray(R, jnp.float32), xp=jnp)) / 180, atol=1e-5, rtol=0)
    np.testing.assert_allclose(projection.viewdir_from_rotation(torch.from_numpy(R)).numpy(), viewdirs, atol=1e-9)
