"""The port's stabilization fit against the reference's, on synthetic matches.

The reference's own match objects (``glimpse_tpu.optimize.RotationMatchesXYZ``
of its cameras) pass straight into the port's ``ObserverCameras``. Held:
the chained start within 1e-6 deg; the objective and its gradient at the
same point within 1e-5 relative; every fit method recovers the scene of
tests/test_optimize.py::test_observer_cameras_stabilization within 1e-2 deg
and agrees with the reference's device L-BFGS within 2e-3 deg.
"""
import functools

import numpy as np
import pytest
import scipy.sparse

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from glimpse_tpu import Camera
from glimpse_tpu import optimize as jax_optimize
from glimpse_tpu_torch import optimize


class FakeImage:
    def __init__(self, cam):
        self.cam = cam


class FakeObserver:
    def __init__(self, cams):
        self.images = [FakeImage(c) for c in cams]


def _coo(entries, n):
    rows, cols, objs = zip(*entries)
    matches = scipy.sparse.coo_matrix((np.ones(len(objs)), (rows, cols)), shape=(n, n))
    matches.data = np.array(objs, dtype=object)
    return matches


def _two_images():
    """tests/test_optimize.py's scene: camera B turned (1.5, -1, 0.5) deg
    from camera A, 50 exact matches, B starting from (0, 0, 0)."""
    camA = Camera(imgsz=(200, 150), f=(180, 180))
    true_viewdir = (1.5, -1.0, 0.5)
    camB = Camera(imgsz=(200, 150), f=(180, 180), viewdir=true_viewdir)
    rng = np.random.default_rng(3)
    uvA = rng.uniform(20, 130, size=(50, 2))
    uvB = camB.xyz_to_uv(camA.uv_to_xyz(uvA), directions=True)
    keep = np.isfinite(uvB).all(axis=1)
    match = jax_optimize.RotationMatchesXYZ(cams=(camA, camB), uvs=[uvA[keep], uvB[keep]])
    camB.viewdir = (0, 0, 0)
    return [camA, camB], _coo([(0, 1, match)], 2), np.array([(0, 0, 0), true_viewdir])


def _sequence(n=6, seed=0):
    """n frames of a wobbling camera with distortion, matched at offsets 1
    and 2 with 0.05 px of noise; every camera starts at the nominal view."""
    rng = np.random.default_rng(seed)
    kwargs = dict(imgsz=(240, 160), f=(200, 205), k=(-0.05, 0.01, 0, 0, 0, 0), p=(1e-4, -2e-4))
    truth = np.array([20.0, -10.0, 2.0]) + np.vstack([np.zeros(3), rng.normal(0, 0.3, (n - 1, 3))])
    cams = [Camera(viewdir=v, **kwargs) for v in truth]
    entries = []
    for i in range(n):
        for j in (i + 1, i + 2):
            if j >= n:
                continue
            uv = rng.uniform(10, (230, 150), size=(80, 2))
            uvj = cams[j].xyz_to_uv(cams[i].uv_to_xyz(uv), directions=True)
            keep = np.isfinite(uvj).all(axis=1) & (uvj > 0).all(axis=1) & (uvj < (240, 160)).all(axis=1)
            noisy = [u[keep] + rng.normal(0, 0.05, (keep.sum(), 2)) for u in (uv, uvj)]
            entries.append((i, j, jax_optimize.RotationMatchesXYZ(cams=(cams[i], cams[j]), uvs=noisy)))
    for c in cams:
        c.viewdir = truth[0]
    return cams, _coo(entries, n), truth


def _rotation_errors(a, b):
    from glimpse_tpu.ops import projection as jax_projection

    R = np.einsum("nij,nkj->nik", *(jax_projection.rotation_matrix(np.asarray(v, float), xp=np) for v in (a, b)))
    return np.degrees(np.arccos(np.clip((np.trace(R, axis1=-2, axis2=-1) - 1) / 2, -1, 1)))


class _Capture(jax_optimize.ObserverCameras):
    """The reference's fit, stopped where it hands its objective to the
    device L-BFGS."""

    def _fit_lbfgs_device(self, objective, x0, data, free, kwargs):
        self.captured = objective, x0, data, free


def test_rotation_matches_take_the_reference_cameras() -> None:
    """xys from camera vectors and pixels equal the reference's, through the
    k1 solver, the Oulu solver and no distortion."""
    rng = np.random.default_rng(1)
    uv = [rng.uniform(0, 200, (40, 2)), rng.uniform(0, 150, (40, 2))]
    for k, p in [((-0.1, 0, 0, 0, 0, 0), (0, 0)), ((-0.1, 0.02, 0, 0, 0, 0), (1e-3, 0)), ((0,) * 6, (0, 0))]:
        cams = [Camera(imgsz=(200, 150), f=(180, 175), c=(2, -1), k=k, p=p) for _ in range(2)]
        want = jax_optimize.RotationMatchesXYZ(cams=cams, uvs=uv)
        got = optimize.RotationMatchesXYZ(cams=[c.to_array() for c in cams], uvs=uv)
        assert got.size == want.size == 40
        for a, b in zip(got.xys, want.xys):
            np.testing.assert_allclose(a, b, atol=1e-12, rtol=0)


@pytest.mark.parametrize("anchors", [[0], [2]])
def test_initialize_matches_jax(anchors) -> None:
    cams, matches, truth = _sequence()
    want = jax_optimize.ObserverCameras(FakeObserver(cams), matches=matches, anchors=anchors).initialize()
    got = optimize.ObserverCameras(FakeObserver(cams), matches=matches, anchors=anchors, device="cpu").initialize()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    if anchors == [0]:  # anchored at the truth; the noise leaves the chain within 0.05 deg
        assert _rotation_errors(got, truth).max() < 0.05


@pytest.mark.parametrize("smooth", [1e-5, 0.0])
def test_objective_and_gradient_match_jax(smooth) -> None:
    """At a point about 1 deg from the start. Near the optimum some ray
    residual components come within float32 rounding of 0, where the
    smoothed L1's slope turns over within 1e-5 and either package's float32
    gradient moves by 5e-5 of its largest component (against float64); away
    from it both agree to 1e-7 or so."""
    cams, matches, _ = _sequence()
    ref = _Capture(FakeObserver(cams), matches=matches, anchors=[1])
    ref.fit(smooth=smooth)
    objective, x0, data, free = ref.captured
    x = np.asarray(x0) + np.random.default_rng(1).normal(0, 1.0, len(x0)).astype(np.float32)
    value, grad = jax.value_and_grad(objective)(jax.numpy.asarray(x), data)
    ours = optimize.ObserverCameras(FakeObserver(cams), matches=matches, anchors=[1], device="cpu")
    flat = torch.from_numpy(x).requires_grad_(True)
    v = ours.objective(free, smooth)(flat)
    v.backward()
    assert abs(v.item() - float(value)) <= 1e-5 * abs(float(value))
    np.testing.assert_allclose(flat.grad.numpy(), np.asarray(grad), atol=1e-5 * np.abs(np.asarray(grad)).max(), rtol=0)


@functools.lru_cache(maxsize=1)
def _jax_device_fit():
    cams, matches, _ = _two_images()
    return jax_optimize.ObserverCameras(FakeObserver(cams), matches=matches, anchors=[0]).fit(method="lbfgs-device").x


@pytest.mark.parametrize("method", ["lbfgs-device", "l-bfgs-b", "bfgs", "newton-cg"])
def test_fit_recovers_the_rotation(method) -> None:
    cams, matches, truth = _two_images()
    model = optimize.ObserverCameras(FakeObserver(cams), matches=matches, anchors=[0], device="cpu")
    result = model.fit(method=method)
    # scipy's line searches report a loss of precision on a float32
    # objective; the device L-BFGS must succeed.
    assert result.success or method != "lbfgs-device"
    fitted = result.x.reshape(-1, 3)
    np.testing.assert_array_equal(fitted[0], (0, 0, 0))  # the anchor is held exactly
    np.testing.assert_allclose(fitted[1], truth[1], atol=1e-2)
    np.testing.assert_allclose(fitted, _jax_device_fit().reshape(-1, 3), atol=2e-3)
    np.testing.assert_array_equal(cams[1].viewdir, (0, 0, 0))  # the cameras are restored


def test_fit_on_a_sequence_matches_jax() -> None:
    """Six frames with distortion and noisy matches: the device L-BFGS of
    both packages land within 2e-3 deg of each other and near the truth."""
    cams, matches, truth = _sequence()
    want = jax_optimize.ObserverCameras(FakeObserver(cams), matches=matches, anchors=[0]).fit().x.reshape(-1, 3)
    result = optimize.ObserverCameras(FakeObserver(cams), matches=matches, anchors=[0], device="cpu").fit()
    got = result.x.reshape(-1, 3)
    assert result.nit > 0 and np.isfinite(result.fun) and np.isfinite(result.grad_norm)
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=0)
    assert _rotation_errors(got, truth).max() < 1e-2


def test_lbfgs_follows_optax() -> None:
    """The port's L-BFGS takes optax.lbfgs's steps: on a 6-dimensional
    Rosenbrock function both are at the same point after 10 iterations, to
    float32 rounding (its line-search scalars are float64 on the host, so
    the paths part slowly, as Rosenbrock's valley amplifies rounding)."""
    import optax

    def rosenbrock(x):
        return (100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2).sum()

    x0 = np.array([-1.2, 1.0, -0.5, 0.8, 0.3, -1.0], np.float32)
    opt = optax.lbfgs(memory_size=30)
    value_and_grad = optax.value_and_grad_from_state(rosenbrock)
    params = jax.numpy.asarray(x0)
    state = opt.init(params)
    for _ in range(10):
        value, grad = value_and_grad(params, state=state)
        updates, state = opt.update(grad, state, params, value=value, grad=grad, value_fn=rosenbrock)
        params = optax.apply_updates(params, updates)

    def torch_value_and_grad(x):
        x = x.detach().requires_grad_(True)
        v = rosenbrock(x)
        return v.detach(), torch.autograd.grad(v, x)[0]

    x, value, _, n_iter = optimize.lbfgs(torch_value_and_grad, torch.from_numpy(x0), max_iter=10)
    assert n_iter == 10
    np.testing.assert_allclose(x.numpy(), np.asarray(params), atol=1e-5, rtol=0)
    assert abs(value - float(rosenbrock(params))) < 1e-4


def test_device_keypoint_wrappers() -> None:
    """cv2 keyword spellings reach the detector; matching two images'
    keypoints equals the reference's wrapper, max_distance and ratios too."""
    import scipy.ndimage

    rng = np.random.default_rng(4)
    t = scipy.ndimage.gaussian_filter(rng.normal(size=(100, 100)), 1.5)
    a = np.clip(128 + 70 * t / np.abs(t).max(), 0, 255).astype(np.uint8)
    images = [a[:96, :96], np.clip(a[3:99, 2:98] + rng.normal(0, 3, (96, 96)), 0, 255).astype(np.uint8)]
    ours = optimize.detect_keypoints_device(images, nfeatures=128, n_octaves=2, contrastThreshold=0.01,
                                            device="cpu")
    assert all(len(k[0]) > 20 for k in ours)
    strict = optimize.detect_keypoints_device(images, nfeatures=128, n_octaves=2, contrastThreshold=0.03,
                                              device="cpu")
    assert sum(len(k[0]) for k in strict) < sum(len(k[0]) for k in ours)
    matcher = optimize.DescriptorMatcher(device="cpu")
    got = optimize.match_keypoints_device(*ours, max_ratio=0.8, max_distance=5.0, return_ratios=True, matcher=matcher)
    want = jax_optimize.match_keypoints_device(*ours, max_ratio=0.8, max_distance=5.0, return_ratios=True)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    # Close matches: a^2 + b^2 - 2 ab cancels to about 1e-2, so the ratio
    # carries float32 rounding of the sums' order (1e-6 on test_torch_matching's).
    np.testing.assert_allclose(got[2], want[2], atol=1e-5, rtol=0)
    assert len(got[0]) > 10
    np.testing.assert_allclose(np.median(got[1] - got[0], axis=0), (-2, -3), atol=0.05)
