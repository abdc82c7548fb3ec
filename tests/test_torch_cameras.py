"""Camera calibration of the port against the JAX package, on the CPU.

The same synthetic cameras and control, made from a seed with numpy, go
through ``glimpse_tpu.optimize`` and ``glimpse_tpu_torch.optimize``
(``device="cpu"``): the control classes' observed and predicted coordinates,
``Cameras``' parameter bookkeeping (masks, breaks, bounds, scales, sparsity),
its residuals, its exact Jacobian, its fits, ``ransac`` and ``Polynomial``.

The port's Jacobian is ``torch.func.jacfwd`` in float64; the reference's is
``jax.jacfwd`` in float32. So the two are held to each other at float32
rounding (1e-5 of each column's largest entry) and the port's to central
differences tightly (1e-6 of each column's largest entry).
"""
import numpy as np
import pytest
import torch

import glimpse_tpu
import glimpse_tpu_torch
from chip_smoke import BA_PROBLEMS
from glimpse_tpu import optimize as jax_optimize
from glimpse_tpu_torch import optimize

PACKAGES = {"jax": (glimpse_tpu.Camera, jax_optimize, {}), "torch": (glimpse_tpu_torch.Camera, optimize, {"device": "cpu"})}
SMALL = {
    "points": dict(n_cams=3, n_points=200),
    "matches": dict(n_cams=3, n_pts=200),
    "lines": dict(n_cams=2, n_ridge=100, n_obs=150),
}


def both(build, **kwargs):
    """``build(Camera, optimize, **model_args)`` through both packages."""
    return {name: build(Camera, module, **model_args, **kwargs) for name, (Camera, module, model_args) in PACKAGES.items()}


def camera_pair(Camera, seed: int = 0, distorted: bool = True):
    rng = np.random.default_rng(seed)
    k = (-0.12, 0.03) if distorted else ()
    cam_a = Camera(imgsz=(400, 300), f=(350.0, 352.0), viewdir=(1.0, -2.0, 0.5), k=k, p=(1e-3, -2e-3) if distorted else ())
    cam_b = Camera(imgsz=(400, 300), f=(350.0, 352.0), viewdir=(3.5, -1.0, -0.5), k=k, c=(2.0, -1.0))
    uv_a = np.column_stack([rng.uniform(30, 370, 60), rng.uniform(30, 270, 60)])
    uv_b = cam_b.xyz_to_uv(cam_a.uv_to_xyz(uv_a), directions=True)
    ok = np.isfinite(uv_b).all(axis=1) & cam_b.inframe(uv_b)
    uv_b = uv_b + rng.normal(scale=0.3, size=uv_b.shape)
    return cam_a, cam_b, uv_a[ok], uv_b[ok]


def point_control(Camera, module, directions: bool, seed: int = 1):
    rng = np.random.default_rng(seed)
    cam = Camera(imgsz=(400, 300), f=340.0, xyz=(10.0, -20.0, 30.0), viewdir=(4.0, -6.0, 1.0), k=(-0.1, 0.02), p=(1e-3, 0))
    xyz = np.column_stack([rng.uniform(-300, 300, 80), rng.uniform(300, 900, 80), rng.uniform(-200, 150, 80)])
    uv = cam.xyz_to_uv(xyz) + rng.normal(scale=0.5, size=(80, 2))
    keep = np.isfinite(uv).all(axis=1)
    xyz, uv = xyz[keep], uv[keep]
    if directions:
        xyz = xyz - cam.xyz
    cam.viewdir = (4.4, -5.7, 0.8)
    return cam, module.Points(cam=cam, uv=uv, xyz=xyz, directions=directions)


def line_control(Camera, module, seed: int = 11):
    rng = np.random.default_rng(seed)
    true_cam = Camera(imgsz=(400, 300), f=350.0, xyz=(0, 0, 50), viewdir=(10.0, -4.0, 0.5))
    uv_sets = [
        np.column_stack([np.linspace(20, 380, 40), v0 + 8 * np.sin(np.linspace(0, 3, 40))]) for v0 in (60.0, 220.0)
    ] + [np.column_stack([200 + 6 * np.sin(np.linspace(0, 3, 30)), np.linspace(30, 270, 30)])]
    xyzs = [true_cam.xyz + true_cam.uv_to_xyz(uv, directions=True) * 4e3 for uv in uv_sets]
    uvs = [uv + rng.normal(scale=0.05, size=uv.shape) for uv in uv_sets]
    cam = true_cam.copy()
    cam.viewdir = (9.3, -3.4, 0.0)
    return cam, module.Lines(cam=cam, uvs=uvs, xyzs=xyzs, density=2)


def build_model(Camera, module, kind: str, **model_args):
    """One ``Cameras`` model for each control class and parameter layout."""
    if kind in ("points", "directions"):
        cam, control = point_control(Camera, module, directions=kind == "directions")
        params = {"viewdir": True, "f": True, "k": [0, 1]} if kind == "points" else {"viewdir": True, "c": True}
        if kind == "points":
            params["xyz"] = True
        return module.Cameras(cams=[cam], controls=[control], cam_params=[params], **model_args)
    if kind == "lines":
        cam, control = line_control(Camera, module)
        return module.Cameras(cams=[cam], controls=[control], cam_params=[{"viewdir": True, "f": 0}], **model_args)
    if kind in ("matches", "rotation", "rotation_xy"):
        cam_a, cam_b, uv_a, uv_b = camera_pair(Camera)
        cls = {"matches": module.Matches, "rotation": module.RotationMatches, "rotation_xy": module.RotationMatchesXY}[kind]
        control = cls(cams=[cam_b, cam_a], uvs=[uv_b, uv_a])
        cam_params = [{"viewdir": True}, {"viewdir": [0, 1]}]
        if kind == "matches":  # internals may move only under plain Matches
            return module.Cameras(
                cams=[cam_a, cam_b], controls=[control], cam_params=cam_params,
                group_indices=[[0, 1]], group_params=[{"f": True, "k": 0}], **model_args)
        return module.Cameras(cams=[cam_a, cam_b], controls=[control], cam_params=cam_params, **model_args)
    if kind == "anchored":  # a camera that controls reference but that is not fit
        cam_a, cam_b, uv_a, uv_b = camera_pair(Camera, seed=7)
        control = module.Matches(cams=[cam_b, cam_a], uvs=[uv_b, uv_a])
        return module.Cameras(cams=[cam_b], controls=[control], cam_params=[{"viewdir": True, "k": 0}], **model_args)
    if kind == "weighted":  # two controls, weights, a group parameter a camera overrides
        cam_a, cam_b, uv_a, uv_b = camera_pair(Camera, seed=3)
        cam_p, points = point_control(Camera, module, directions=False, seed=5)
        matches = module.Matches(cams=[cam_b, cam_a], uvs=[uv_b, uv_a])
        weights = np.random.default_rng(9).uniform(0.2, 2.0, points.size + matches.size)
        return module.Cameras(
            cams=[cam_a, cam_b, cam_p], controls=[points, matches],
            cam_params=[{"viewdir": True}, {"viewdir": True, "f": 0}, {"viewdir": True}],
            group_indices=[[0, 1], [2]], group_params=[{"f": True}, {"k": [0]}], weights=weights, **model_args)
    raise ValueError(kind)


KINDS = ("points", "directions", "lines", "matches", "rotation", "rotation_xy", "anchored", "weighted")


def central_differences(fun, x0: np.ndarray, eps: float = 1e-6) -> np.ndarray:
    columns = []
    for col in range(len(x0)):
        hi, lo = x0.copy(), x0.copy()
        step = eps * max(1.0, abs(x0[col]))
        hi[col] += step
        lo[col] -= step
        columns.append((fun(hi) - fun(lo)) / (hi[col] - lo[col]))
    return np.column_stack(columns)


def column_error(got: np.ndarray, want: np.ndarray) -> float:
    """Largest |got - want| as a share of each column's largest entry."""
    return float((np.abs(got - want) / np.maximum(np.abs(want).max(axis=0), 1e-300)).max())


# ---- Control classes ---- #


@pytest.mark.parametrize("directions", [False, True])
def test_points_observed_predicted(directions) -> None:
    """Tolerance: 1e-10 px absolute on float64 projections of a few hundred px."""
    got = both(lambda C, m, **kw: point_control(C, m, directions)[1])
    assert got["torch"].size == got["jax"].size
    np.testing.assert_array_equal(got["torch"].observed(), got["jax"].observed())
    np.testing.assert_allclose(got["torch"].predicted(), got["jax"].predicted(), rtol=0, atol=1e-10)
    index = [3, 1, 7]
    np.testing.assert_allclose(got["torch"].predicted(index), got["jax"].predicted(index), rtol=0, atol=1e-10)
    if directions:
        for control in got.values():
            control.cam.xyz = (0, 0, 1)
            with pytest.raises(ValueError, match="position has changed"):
                control.predicted()


def test_points_resize_scales_coordinates() -> None:
    got = both(lambda C, m, **kw: point_control(C, m, False)[1])
    for control in got.values():
        control.resize(0.5)
    np.testing.assert_array_equal(got["torch"].cam.imgsz, got["jax"].cam.imgsz)
    np.testing.assert_allclose(got["torch"].observed(), got["jax"].observed(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(got["torch"].predicted(), got["jax"].predicted(), rtol=0, atol=1e-10)


def test_lines_observed_predicted_and_candidates() -> None:
    """The projected, clipped and densified lines, the nearest points and
    the world candidates of the Jacobian path: 1e-9 px / 1e-9 m."""
    got = both(lambda C, m, **kw: line_control(C, m)[1])
    assert got["torch"].size == got["jax"].size == 110
    np.testing.assert_array_equal(got["torch"].observed(), got["jax"].observed())
    for a, b in zip(got["torch"]._project_xyzs(), got["jax"]._project_xyzs()):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)
    np.testing.assert_allclose(got["torch"].predicted(), got["jax"].predicted(), rtol=0, atol=1e-9)
    np.testing.assert_allclose(got["torch"]._world_candidates(), got["jax"]._world_candidates(), rtol=0, atol=1e-9)
    np.testing.assert_allclose(got["torch"]._world_candidates(budget=64), got["jax"]._world_candidates(budget=64), rtol=0, atol=1e-9)


def test_lines_contract() -> None:
    """``tests/test_optimize.py``'s contract case on the port alone."""
    cam = glimpse_tpu_torch.Camera(imgsz=10, f=1)
    lines = optimize.Lines(cam=cam, uvs=[[(2, 4), (4, 4)], [(6, 4), (8, 4)]], xyzs=[[(-10, 1, 0), (0, 1, 0), (10, 1, 0)]], density=10)
    assert lines.size == 4
    np.testing.assert_allclose(lines.predicted() - lines.observed(), [[0, 1]] * 4, atol=1e-9)
    cam.viewdir = (0, -45, 0)
    np.testing.assert_allclose(lines.predicted() - lines.observed(), 0, atol=1e-9)


@pytest.mark.parametrize("kind", ["Matches", "RotationMatches", "RotationMatchesXY"])
def test_matches_observed_predicted(kind) -> None:
    """Both directions of each matches class; 1e-9 px (1e-12 in normalized
    coordinates): the inverse projection iterates 20 times in both."""
    def build(Camera, module, **kw):
        cam_a, cam_b, uv_a, uv_b = camera_pair(Camera)
        return getattr(module, kind)(cams=[cam_b, cam_a], uvs=[uv_b, uv_a])

    got = both(build)
    atol = 1e-12 if kind == "RotationMatchesXY" else 1e-9
    for cam in (0, 1):
        np.testing.assert_allclose(got["torch"].observed(cam), got["jax"].observed(cam), rtol=0, atol=atol)
        np.testing.assert_allclose(got["torch"].predicted(cam), got["jax"].predicted(cam), rtol=0, atol=atol)
        np.testing.assert_allclose(
            got["torch"].predicted(cam, index=[0, 5]), got["jax"].predicted(cam, index=[0, 5]), rtol=0, atol=atol)
    assert got["torch"].size == got["jax"].size
    if kind != "Matches":
        for control in got.values():
            control.cams[0].f = (360, 360)
            with pytest.raises(ValueError, match="internal parameters"):
                control.predicted()


def test_matches_guards() -> None:
    cam = glimpse_tpu_torch.Camera(imgsz=10, f=1)
    other = glimpse_tpu_torch.Camera(imgsz=10, f=1, xyz=(1, 0, 0))
    uvs = [np.zeros((2, 2)), np.zeros((2, 2))]
    with pytest.raises(ValueError, match="same object"):
        optimize.Matches(cams=[cam, cam], uvs=uvs)
    with pytest.raises(ValueError, match="different positions"):
        optimize.Matches(cams=[cam, other], uvs=uvs)
    with pytest.raises(ValueError, match="same length"):
        optimize.Matches(cams=[cam, cam.copy()], uvs=[np.zeros((2, 2)), np.zeros((3, 2))])
    with pytest.raises(ValueError, match="missing"):
        optimize.RotationMatches(cams=[cam, cam.copy()])
    with pytest.raises(NotImplementedError):
        optimize.RotationMatchesXY(cams=[cam, cam.copy()], uvs=uvs).plot()


def test_matches_filter_to_type_resize() -> None:
    def build(Camera, module, **kw):
        cam_a, cam_b, uv_a, uv_b = camera_pair(Camera, seed=2)
        weights = np.random.default_rng(4).uniform(size=len(uv_a))
        return module.RotationMatches(cams=[cam_b, cam_a], uvs=[uv_b, uv_a], weights=weights)

    got = both(build)
    for name, control in got.items():
        module = PACKAGES[name][1]
        control.filter(n_best=40)
        control.filter(min_weight=0.1, max_error=0.6, max_distance=60.0)
        assert control.to_type(module.RotationMatches) is control
        plain = control.to_type(module.Matches)
        assert type(plain) is module.Matches
        xy = control.to_type(module.RotationMatchesXY)
        assert type(xy) is module.RotationMatchesXY
        xyz = xy.to_type(module.RotationMatchesXYZ)
        assert type(xyz) is module.RotationMatchesXYZ
        got[name] = (control, plain, xy, xyz)
    assert 0 < got["torch"][0].size == got["jax"][0].size < 40
    for a, b in zip(got["torch"][:3], got["jax"][:3]):
        np.testing.assert_allclose(a.observed(), b.observed(), rtol=0, atol=1e-9)
        np.testing.assert_allclose(a.predicted(), b.predicted(), rtol=0, atol=1e-9)
        np.testing.assert_allclose(a.weights, b.weights, rtol=0, atol=0)
    for cam in (0, 1):  # unit world rays
        rays = got["torch"][3].predicted(cam)
        np.testing.assert_allclose(rays, got["jax"][3].predicted(cam), rtol=0, atol=1e-12)
        np.testing.assert_allclose(np.linalg.norm(rays, axis=1), 1, atol=1e-12)
    with pytest.raises(NotImplementedError):
        got["torch"][3].observed()
    back = got["torch"][3].to_type(optimize.Matches)
    np.testing.assert_allclose(back.observed(), got["jax"][1].observed(), rtol=0, atol=1e-8)
    plain_t, plain_j = got["torch"][1], got["jax"][1]
    for plain in (plain_t, plain_j):
        plain.resize(0.5)
    np.testing.assert_allclose(plain_t.observed(1), plain_j.observed(1), rtol=0, atol=1e-12)
    np.testing.assert_allclose(plain_t.predicted(), plain_j.predicted(), rtol=0, atol=1e-9)


def test_rotation_matches_xyz_takes_vectors_and_cameras() -> None:
    """The stabilization path's camera vectors and the calibration path's
    ``Camera`` objects give the same rays."""
    cam_a, cam_b, uv_a, uv_b = camera_pair(glimpse_tpu_torch.Camera, seed=5)
    from_cameras = optimize.RotationMatchesXYZ(cams=[cam_a, cam_b], uvs=[uv_a, uv_b])
    from_vectors = optimize.RotationMatchesXYZ(cams=[cam_a.to_array(), cam_b.to_array()], uvs=[uv_a, uv_b])
    for cam in (0, 1):
        np.testing.assert_array_equal(from_cameras.predicted(cam), from_vectors.predicted(cam))
    assert from_cameras._cam_index(cam_b) == 1


# ---- Cameras: bookkeeping ---- #


@pytest.mark.parametrize("params", [
    None, {}, {"viewdir": True}, {"viewdir": 0}, {"k": [0, 2]}, {"f": (True, 100, 5000)},
    {"xyz": ([0, 2], [-1, -2], [1, 2]), "c": (0, -5, 5)}, {"p": False, "imgsz": True, "other": 3},
])
def test_parse_params_equal(params) -> None:
    defaults = np.column_stack([np.arange(20.0) - 30, np.arange(20.0) + 30])
    for default_bounds in (None, defaults):
        want = jax_optimize.Cameras.parse_params(params, default_bounds=default_bounds)
        got = optimize.Cameras.parse_params(params, default_bounds=default_bounds)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("kind", KINDS + ("ba_points", "ba_matches", "ba_lines"))
def test_cameras_bookkeeping_and_residuals_equal(kind) -> None:
    """Masks, breaks, start values, bounds, scales and sparsity equal; the
    residuals at the start and at a moved parameter vector within 1e-8 px."""
    if kind.startswith("ba_"):
        models = both(lambda C, m, **kw: BA_PROBLEMS[kind[3:]](C, m, **SMALL[kind[3:]], **kw)[0])
    else:
        models = both(lambda C, m, **kw: build_model(C, m, kind, **kw))
    got, want = models["torch"], models["jax"]
    for a, b in zip(got.cam_masks + got.group_masks, want.cam_masks + want.group_masks):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got.cam_breaks, want.cam_breaks)
    np.testing.assert_array_equal(got.group_breaks, want.group_breaks)
    np.testing.assert_array_equal(got.values, want.values)
    np.testing.assert_array_equal(got.bounds[0], want.bounds[0])
    np.testing.assert_array_equal(got.bounds[1], want.bounds[1])
    np.testing.assert_allclose(got.scales, want.scales, rtol=1e-12, atol=0)
    assert (got.sparsity != want.sparsity).nnz == 0
    assert got.size == want.size
    np.testing.assert_array_equal(got.observed(), want.observed())
    moved = want.values * (1 + 1e-4) + 1e-4
    np.testing.assert_allclose(got.residuals(), want.residuals(), rtol=0, atol=1e-8)
    np.testing.assert_allclose(got.residuals(moved, index=slice(3, 40)), want.residuals(moved, index=slice(3, 40)), rtol=0, atol=1e-8)
    np.testing.assert_allclose(got.errors(moved), want.errors(moved), rtol=0, atol=1e-8)
    for a, b in zip(got.cams, want.cams):  # residuals at params restore the cameras
        np.testing.assert_array_equal(a.to_array(), b.to_array())
    got.set_cameras(moved, save=True)
    want.set_cameras(moved, save=True)
    for a, b in zip(got.cams, want.cams):
        np.testing.assert_array_equal(a.to_array(), b.to_array())
    got.set_cameras(want.values)
    got.reset_cameras()
    for a, b in zip(got.cams, want.cams):
        np.testing.assert_array_equal(a.to_array(), b.to_array())


def test_cameras_guards() -> None:
    Camera = glimpse_tpu_torch.Camera
    cam, points = point_control(Camera, optimize, False)
    stranger = Camera(imgsz=(400, 300), f=340.0)
    with pytest.raises(ValueError, match="No controls"):
        optimize.Cameras(cams=[stranger], controls=[points], cam_params=[{"viewdir": True}], device="cpu")
    with pytest.raises(ValueError, match="Not all cameras with params"):
        optimize.Cameras(cams=[cam, stranger], controls=[points], cam_params=[{"viewdir": True}, {"viewdir": True}], device="cpu")
    small = Camera(imgsz=(200, 150), f=340.0)
    _, other = point_control(Camera, optimize, False)
    other.cam = small
    with pytest.raises(ValueError, match="image sizes not equal"):
        optimize.Cameras(cams=[cam, small], controls=[points, other], group_params=[{"f": True}], device="cpu")
    with pytest.raises(ValueError, match="multiple groups"):
        optimize.Cameras(
            cams=[cam], controls=[points], group_indices=[[0], [0]], group_params=[{"viewdir": True}, {"viewdir": 0}], device="cpu")
    # One camera, one control, one dict: the shorthand forms.
    model = optimize.Cameras(cams=cam, controls=points, cam_params={"viewdir": True}, device="cpu")
    assert model.values.shape == (3,)


@pytest.mark.skipif(torch.cuda.is_available(), reason="this host has a card")
def test_cameras_default_device_needs_a_card() -> None:
    cam, points = point_control(glimpse_tpu_torch.Camera, optimize, False)
    with pytest.raises((RuntimeError, AssertionError)):
        optimize.Cameras(cams=[cam], controls=[points], cam_params=[{"viewdir": True}])


# ---- Cameras: the exact Jacobian ---- #


@pytest.mark.parametrize("kind", KINDS)
def test_exact_jacobian(kind) -> None:
    """jacfwd in float64 against the reference's float32 jacfwd (1e-5 of each
    column's largest entry) and against central differences (1e-6).

    ``Lines``' host residual re-densifies its candidates at every camera, so
    its finite differences carry the quantisation of the candidates (0.5 px
    here); the Jacobian holds the assignment fixed, and is held to central
    differences of the same residual on tensors with the assignment fixed.
    """
    models = both(lambda C, m, **kw: build_model(C, m, kind, **kw))
    got, want = models["torch"], models["jax"]
    x0 = got.values * (1 + 1e-3) + 1e-3  # away from the start, where residuals restore the cameras
    J = got._autodiff_jac()(x0)
    assert J.shape == (2 * got.size, len(x0)) and J.dtype == np.float64
    assert np.isfinite(J).all()
    assert column_error(J, want._autodiff_jac()(x0).astype(float)) < 1e-5
    if kind == "lines":
        scatter, assign, residual_array, fixed = got._build_autodiff_residual()
        base = torch.from_numpy(np.stack([c.to_array() for c in got.cams + fixed]))
        held = assign(scatter(torch.from_numpy(x0), base))

        def fun(x):
            return residual_array(torch.from_numpy(x), base, held).reshape(-1).numpy()
    else:
        def fun(x):
            return np.nan_to_num(got.residuals(params=x).ravel(), nan=0.0)
    assert column_error(J, central_differences(fun, x0)) < 1e-6
    # Every row the sparsity structure leaves out is zero.
    np.testing.assert_array_equal(J[~got.sparsity.toarray().astype(bool)], 0.0)


def test_exact_jacobian_of_an_index_subset() -> None:
    model = build_model(glimpse_tpu_torch.Camera, optimize, "weighted", device="cpu")
    x0 = model.values + 1e-3
    full = model._autodiff_jac()(x0)
    index = np.array([5, 2, 90, 41])
    rows = np.column_stack([2 * index, 2 * index + 1]).ravel()
    # A subset projects only its own points: the same numbers up to the
    # rounding of a matrix product of another height (1e-12 relative).
    np.testing.assert_allclose(model._autodiff_jac(index)(x0), full[rows], rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(model._autodiff_jac(slice(10, 30))(x0), full[20:60], rtol=1e-12, atol=1e-12)
    lines = build_model(glimpse_tpu_torch.Camera, optimize, "lines", device="cpu")
    full = lines._autodiff_jac()(lines.values)
    np.testing.assert_allclose(lines._autodiff_jac(index)(lines.values), full[rows], rtol=1e-12, atol=1e-12)


def test_exact_jacobian_behind_camera_rows_are_zero() -> None:
    """A point behind the camera projects to NaN; its residual counts as 0
    and so do its derivatives, in both packages."""
    def build(Camera, module, **kw):
        cam, points = point_control(Camera, module, False)
        points.xyz[[2, 9]] = cam.xyz + (1.0, -500.0, 3.0)  # behind
        return module.Cameras(cams=[cam], controls=[points], cam_params=[{"viewdir": True, "f": True, "k": 0}], **kw)

    models = both(build)
    got = models["torch"]
    assert np.isnan(got.residuals()[[2, 9]]).all()
    J = got._autodiff_jac()(got.values)
    assert np.isfinite(J).all()
    np.testing.assert_array_equal(J[[4, 5, 18, 19]], 0.0)
    assert np.abs(J[[0, 1, 6, 7]]).max() > 0
    assert column_error(J, models["jax"]._autodiff_jac()(got.values).astype(float)) < 1e-5
    result = got.fit(full=True, jac="exact")
    assert result.success and np.isfinite(result.x).all()


def test_autodiff_supported() -> None:
    cam_a, cam_b, uv_a, uv_b = camera_pair(glimpse_tpu_torch.Camera)
    rays = optimize.RotationMatchesXYZ(cams=[cam_b, cam_a], uvs=[uv_b, uv_a])
    matches = optimize.Matches(cams=[cam_b, cam_a], uvs=[uv_b, uv_a])
    model = optimize.Cameras(cams=[cam_a, cam_b], controls=[matches], cam_params=[{}, {"viewdir": True}], device="cpu")
    assert model._autodiff_supported()
    model.controls = [matches, rays]
    assert not model._autodiff_supported()


# ---- Cameras: fits ---- #


@pytest.mark.parametrize("jac", ["2-point", "exact"])
@pytest.mark.parametrize("problem", ["points", "matches", "lines"])
def test_fit_recovers_the_reference_parameters(problem, jac) -> None:
    """``benchmarks/ba_autodiff.py``'s three problems cut small.

    points: the parameters within 1e-6 of the reference's and of the truth
    (f = 3,000 px, degrees). matches: a chain of pairs fixes no common
    rotation, so the optimum is a 3-parameter family and TRF's end point
    depends on the Jacobian's rounding; with scipy's own finite differences
    both packages take the same steps (1e-6), with the exact Jacobians each
    is held to a zero-cost optimum. lines: the same cost and parameters
    within 1e-6 deg.
    """
    models = both(lambda C, m, **kw: BA_PROBLEMS[problem](C, m, **SMALL[problem], **kw))
    (got, truth), (want, _) = models["torch"], models["jax"]
    start = [cam.to_array() for cam in got.cams]
    result = got.fit(full=True, jac=jac)
    reference = want.fit(full=True, jac=jac)
    assert result.success and reference.success
    for cam, vector in zip(got.cams, start):  # a fit leaves the cameras as they were
        np.testing.assert_array_equal(cam.to_array(), vector)
    if problem == "matches" and jac == "exact":
        assert result.cost < 1e-12 and reference.cost < 1e-12
        assert got.errors(result.x).max() < 1e-6
    else:
        np.testing.assert_allclose(result.x, reference.x, rtol=0, atol=1e-6)
        np.testing.assert_allclose(result.cost, reference.cost, rtol=1e-6, atol=1e-12)
    if truth is not None:
        np.testing.assert_allclose(result.x, truth, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got.fit(jac=jac), result.x)  # full=False returns the vector


def test_fit_auto_takes_the_exact_jacobian(monkeypatch) -> None:
    model, truth = BA_PROBLEMS["points"](glimpse_tpu_torch.Camera, optimize, device="cpu", **SMALL["points"])
    calls = []
    original = model._autodiff_jac
    monkeypatch.setattr(model, "_autodiff_jac", lambda index: calls.append(index) or original(index))
    np.testing.assert_allclose(model.fit(), truth, rtol=0, atol=1e-6)
    assert len(calls) == 1


def test_fit_staged_params_and_index_equal() -> None:
    """Staged ``cam_params`` pre-fits and an ``index`` subset, through scipy's
    finite differences in both packages: the same parameters within 1e-6;
    the exact Jacobian reaches a cost no higher."""
    models = both(lambda C, m, **kw: build_model(C, m, "points", **kw))
    index = np.arange(0, models["torch"].size, 2)
    fits = {
        name: model.fit(index=index, cam_params=[[{"viewdir": True}], [{"viewdir": True, "f": True}]], jac="2-point")
        for name, model in models.items()
    }
    np.testing.assert_allclose(fits["torch"], fits["jax"], rtol=0, atol=1e-6)
    # The noisy optimum is shallow (k1 ends on its bound), so the exact
    # Jacobian is held to the cost it reaches, not to the end point.
    exact = models["torch"].fit(index=index, jac="exact")
    costs = [float(np.sum(models["torch"].residuals(x, index=index) ** 2)) for x in (exact, fits["torch"])]
    assert costs[0] <= costs[1] * (1 + 1e-6)


def test_fit_recovers_viewdir_from_points() -> None:
    """``tests/test_optimize.py``'s first fit, on the port."""
    Camera = glimpse_tpu_torch.Camera
    true = Camera(imgsz=(200, 150), f=(180, 180), viewdir=(5, -3, 1))
    rng = np.random.default_rng(1)
    xyz = np.column_stack([rng.uniform(-50, 50, 40), rng.uniform(80, 120, 40), rng.uniform(-30, 30, 40)])
    uv = true.xyz_to_uv(xyz)
    keep = np.isfinite(uv).all(axis=1) & true.inframe(uv)
    cam = Camera(imgsz=(200, 150), f=(180, 180))
    points = optimize.Points(cam=cam, uv=uv[keep], xyz=xyz[keep])
    model = optimize.Cameras(cams=[cam], controls=[points], cam_params=[{"viewdir": True}], device="cpu")
    values = model.fit()
    np.testing.assert_allclose(values, (5, -3, 1), atol=1e-6)
    model.set_cameras(values)
    assert model.errors().max() < 1e-6


# ---- RANSAC and Polynomial ---- #


def test_polynomial_equal_and_ransac_inliers() -> None:
    xy = [(0, 0), (1.1, 1), (1.9, 2), (3.1, 3), (3.9, 4), (3, 0.1), (0.1, 3)]
    got, want = optimize.Polynomial(xy, deg=1), jax_optimize.Polynomial(xy, deg=1)
    assert got.size == want.size == 7
    np.testing.assert_array_equal(got.fit(), want.fit())
    np.testing.assert_array_equal(got.fit([0, 1, 4]), want.fit([0, 1, 4]))
    np.testing.assert_array_equal(got.errors(got.fit()), want.errors(want.fit()))
    np.testing.assert_array_equal(got.predict([2.0, 1.0], [1, 2]), want.predict([2.0, 1.0], [1, 2]))
    results = [
        module.ransac(model, n=2, max_error=0.2, min_inliers=2, iterations=100, rng=np.random.default_rng(0))
        for module, model in ((optimize, got), (jax_optimize, want))
    ]
    np.testing.assert_array_equal(results[0][1], results[1][1])
    np.testing.assert_array_equal(results[0][0], results[1][0])
    assert set(results[0][1]) == {0, 1, 2, 3, 4}


def test_ransac_samples_equal_and_guards() -> None:
    for n, size in ((2, 5), (3, 40)):
        got = list(optimize._ransac_samples(n, size, iterations=12, rng=np.random.default_rng(3)))
        want = list(jax_optimize._ransac_samples(n, size, iterations=12, rng=np.random.default_rng(3)))
        assert [sorted(s) for s in got] == [sorted(s) for s in want]
    assert len(list(optimize._ransac_samples(2, 4, iterations=100, rng=np.random.default_rng(0)))) == 6
    with pytest.raises(ValueError, match="larger or equal"):
        next(optimize._ransac_samples(5, 5))
    model = optimize.Polynomial([(0, 0), (1, 5), (2, -3), (3, 9)], deg=1)
    with pytest.raises(ValueError, match="acceptance"):
        optimize.ransac(model, n=2, max_error=1e-6, min_inliers=2, rng=np.random.default_rng(0))


def test_ransac_on_cameras_picks_the_same_inliers() -> None:
    """A camera's view direction from points of which 15 % are gross
    outliers: the same generator gives the same samples, so both packages
    pick the same inliers, the true ones."""
    def build(Camera, module, **kw):
        cam, points = point_control(Camera, module, False, seed=21)
        rng = np.random.default_rng(22)
        bad = rng.choice(points.size, size=points.size * 15 // 100, replace=False)
        points.uv[bad] += rng.uniform(20, 60, size=(len(bad), 2)) * rng.choice([-1, 1], size=(len(bad), 2))
        model = module.Cameras(cams=[cam], controls=[points], cam_params=[{"viewdir": True}], **kw)
        return model, np.setdiff1d(np.arange(points.size), bad)

    found = {}
    for name, (model, good) in both(build).items():
        module = PACKAGES[name][1]
        params, inliers = module.ransac(
            model, n=4, max_error=3.0, min_inliers=20, iterations=8, rng=np.random.default_rng(5), jac="2-point")
        found[name] = (params, inliers)
        np.testing.assert_array_equal(inliers, good)
    np.testing.assert_array_equal(found["torch"][1], found["jax"][1])
    np.testing.assert_allclose(found["torch"][0], found["jax"][0], rtol=0, atol=1e-6)
    model, good = build(glimpse_tpu_torch.Camera, optimize, device="cpu")
    _, inliers = optimize.ransac(model, n=4, max_error=3.0, min_inliers=20, iterations=8, rng=np.random.default_rng(5), jac="exact")
    np.testing.assert_array_equal(inliers, good)


# ---- Plots ---- #


def test_plots_run_headless() -> None:
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    model = build_model(glimpse_tpu_torch.Camera, optimize, "weighted", device="cpu")
    assert len(model.plot(cam=0)) == 1 and len(model.plot(params=model.values, cam=2)) == 1
    assert model.plot_weights() is not None
    _, lines = line_control(glimpse_tpu_torch.Camera, optimize)
    drawn = lines.plot()
    assert set(drawn) == {"observed", "predicted", "selected", "unselected"}
    poly = optimize.Polynomial([(0, 0), (1, 1), (2, 2.1)], deg=1)
    assert poly.plot(index=[0, 1])["predicted"] is not None
    plt.close("all")
