"""The calibration and stabilization programs on the CPU.

The reference compiles its calibration and stabilization path: the fit's
whole L-BFGS loop (``ObserverCameras._fit_lbfgs_device``), the exact
Jacobian (``Cameras._autodiff_jac``), match refinement and the detection
and matching batches. The port runs each as a program over static buffers
(``glimpse_tpu_torch.graphs.Program``): on a card a replay of a CUDA graph
captured from its eager code (``tests/test_torch_cuda.py`` holds that), here
the eager code on the buffers. Held here, bit for bit:

- the graphed L-BFGS driver (``optimize.LBFGSPrograms`` under the shared
  host loop) against the eager ``optimize.lbfgs``: Rosenbrock functions
  through every history fill level and past it, an objective that is NaN
  off its start (every line search fails, the step is 0, the stall stop),
  and ``ObserverCameras.fit`` on 20 frames to its stall stop;
- the Jacobian program against the eager ``jacfwd`` on the three
  calibration problems, full and on a row subset, and its cache;
- the refinement, detection and matching programs against their eager
  functions;
- the ``Lines`` assigner: the device select gives the old host branch's
  assignment when nothing is in frame, and no program body reads the card
  on the host (what capture refuses), checked by making every host read
  raise (:func:`no_host_reads`).

Each case runs a few hundred milliseconds to a few seconds at these sizes.
"""
import collections
import contextlib

import numpy as np
import pytest
import scipy.ndimage
import scipy.sparse

torch = pytest.importorskip("torch")

from chip_smoke import BA_PROBLEMS
from glimpse_tpu_torch import Camera, graphs, optimize
from glimpse_tpu_torch.ops import features, matching, refine

HOST_READS = ("__bool__", "__float__", "__int__", "item", "tolist", "cpu", "numpy")


@contextlib.contextmanager
def no_host_reads():
    """Every tensor method that reads values on the host raises: the CPU's
    stand-in for a capture, which refuses such reads."""
    saved = {name: getattr(torch.Tensor, name) for name in HOST_READS}

    def refuse(name):
        def read(self, *args, **kwargs):
            raise RuntimeError(f"host read: Tensor.{name}")

        return read

    try:
        for name in HOST_READS:
            setattr(torch.Tensor, name, refuse(name))
        yield
    finally:
        for name, method in saved.items():
            setattr(torch.Tensor, name, method)


def value_and_grad_of(f):
    def value_and_grad(x):
        x = x.detach().requires_grad_(True)
        v = f(x)
        return v.detach(), torch.autograd.grad(v, x)[0]

    return value_and_grad


def rosenbrock(x):
    return (100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2).sum()


START = torch.tensor([0.3, -0.2, 0.5])


def nan_off_start(x):
    """|x|^2, NaN at every point but :data:`START` (its gradient there finite)."""
    off = ((x - START) ** 2).sum() > 0
    return (x * x).sum() + torch.where(off, torch.full_like(x[0], float("nan")), torch.zeros_like(x[0]))


def graphed_lbfgs(f, x0, max_iter, memory, gtol=1e-7):
    steps = optimize.LBFGSPrograms(value_and_grad_of(f), x0, memory)
    return optimize._lbfgs_loop(steps, max_iter, gtol, memory), steps


def assert_same(got, want) -> None:
    (x, value, grad, n_iter), (x0, value0, grad0, n_iter0) = got, want
    assert n_iter == n_iter0 and value == value0
    assert torch.equal(x, x0) and torch.equal(grad, grad0)


@pytest.mark.parametrize("f, x0, max_iter, memory", [
    (rosenbrock, torch.tensor([-1.2, 1.0, -0.5, 0.8, 0.3, -1.0]), 12, 3),
    (rosenbrock, torch.from_numpy(np.random.default_rng(0).normal(size=40).astype(np.float32)), 60, 5),
    (nan_off_start, START.clone(), 100, 4),
], ids=["rosenbrock-6", "rosenbrock-40", "nan-off-start"])
def test_graphed_lbfgs_equals_lbfgs(f, x0, max_iter, memory) -> None:
    """x, value, gradient and iterations bit for bit; every fill level from
    0 to ``memory`` ran, and the history went past it (shifted by copy)."""
    want = optimize.lbfgs(value_and_grad_of(f), x0, max_iter=max_iter, memory=memory)
    got, steps = graphed_lbfgs(f, x0, max_iter, memory)
    assert_same(got, want)
    assert set(steps.directions) == set(range(memory + 1))
    assert steps.directions[memory].calls >= 3  # full, then full and shifted
    if f is nan_off_start:
        # Every search fails at t = 0 (each evaluation NaN): the stall stop.
        assert want[3] == 20 and steps.evaluations == 20 * 20 and torch.equal(got[0], START)


class _Image:
    def __init__(self, cam):
        self.cam = cam


class _Observer:
    def __init__(self, cams):
        self.images = [_Image(c) for c in cams]


def observer_scene(n=20, seed=0, noise=0.05):
    """n frames of a wobbling camera with distortion, matched at offsets 1
    and 2 with ``noise`` px; every camera starts at the first's view."""
    rng = np.random.default_rng(seed)
    kwargs = dict(imgsz=(240, 160), f=(200, 205), k=(-0.05, 0.01, 0, 0, 0, 0), p=(1e-4, -2e-4))
    truth = np.array([20.0, -10.0, 2.0]) + np.vstack([np.zeros(3), rng.normal(0, 0.3, (n - 1, 3))])
    cams = [Camera(viewdir=v, **kwargs) for v in truth]
    entries = []
    for i in range(n):
        for j in (i + 1, i + 2):
            if j < n:
                uv = rng.uniform(10, (230, 150), size=(40, 2))
                uvj = cams[j].xyz_to_uv(cams[i].uv_to_xyz(uv), directions=True)
                keep = np.isfinite(uvj).all(axis=1) & (uvj > 0).all(axis=1) & (uvj < (240, 160)).all(axis=1)
                pair = [u[keep] + rng.normal(0, noise, (keep.sum(), 2)) for u in (uv, uvj)]
                entries.append((i, j, optimize.RotationMatchesXYZ(cams=(cams[i], cams[j]), uvs=pair)))
    for c in cams:
        c.viewdir = truth[0]
    rows, cols, objs = zip(*entries)
    matches = scipy.sparse.coo_matrix((np.ones(len(objs)), (rows, cols)), shape=(n, n))
    matches.data = np.array(objs, dtype=object)
    return _Observer(cams), matches


def test_observer_fit_through_programs_equals_eager(monkeypatch) -> None:
    """``ObserverCameras.fit`` through :class:`LBFGSPrograms` and through
    the eager tensor steps: the same view directions, value, gradient norm,
    iterations and stop message; the noise makes line searches fail near
    the optimum, so it stops on them, and one accepted step was an earlier
    evaluation kept aside."""
    observer, matches = observer_scene()
    model = optimize.ObserverCameras(observer, matches=matches, anchors=[0], device="cpu")
    accepted = collections.Counter()
    accept = optimize.LBFGSPrograms.accept

    def counted(self, t, handle):
        accepted["latest" if handle == self.evaluations - 1 else "start" if handle == -1 else "kept"] += 1
        return accept(self, t, handle)

    monkeypatch.setattr(optimize.LBFGSPrograms, "accept", counted)
    got = model.fit(maxiter=400, memory_size=4)
    monkeypatch.setattr(optimize, "LBFGSPrograms", lambda value_and_grad, x0, memory: optimize._TensorSteps(
        value_and_grad, x0))
    want = model.fit(maxiter=400, memory_size=4)
    assert np.array_equal(got.x, want.x) and got.fun == want.fun and got.grad_norm == want.grad_norm
    assert got.nit == want.nit < 400 and got.message == want.message and "line searches fail" in got.message
    assert accepted["kept"] >= 1 and sum(accepted.values()) == got.nit


def _program_bodies():
    """Each program's body on small inputs, as (name, body)."""
    steps = optimize.LBFGSPrograms(value_and_grad_of(rosenbrock), torch.tensor([-1.2, 1.0, -0.5, 0.8]), 3)
    steps.start()
    rng = np.random.default_rng(2)
    texture = scipy.ndimage.gaussian_filter(rng.normal(size=(2, 64, 64)), (0, 1.5, 1.5))
    images = torch.from_numpy(np.clip(128 + 400 * texture, 0, 255).astype(np.uint8))
    da = torch.from_numpy(rng.normal(size=(2, 16, 8)).astype(np.float32))
    model, _ = BA_PROBLEMS["lines"](Camera, optimize, device="cpu", n_cams=2, n_ridge=60, n_obs=40)
    jacobian = optimize._JacobianProgram(model, None)
    jacobian.params.copy_(torch.from_numpy(model.values))
    jacobian.base.copy_(torch.from_numpy(np.stack([c.to_array() for c in model.cams])))
    corners = torch.from_numpy(rng.integers(0, 30, size=(2, 5, 2)))
    return [
        ("lbfgs evaluation", steps.evaluation.body),
        ("lbfgs direction", steps._direction(2).body),
        ("jacobian", jacobian.program.body),
        ("refine", lambda: refine.refine_chunk(images.float(), images.float(), corners, corners, 7, 13, 3)),
        ("detect", lambda: features.detect_batch(images, images > 0, nfeatures=32, n_octaves=2)),
        ("match", lambda: matching.match_batch(da, da.flip(1), torch.tensor([16, 9]), torch.tensor([12, 16]),
                                               torch.tensor(0.8), True)),
    ]


@pytest.mark.parametrize("index", range(6), ids=["lbfgs-evaluation", "lbfgs-direction", "jacobian", "refine",
                                                 "detect", "match"])
def test_program_bodies_read_nothing_on_the_host(index) -> None:
    """What capture refuses: no program body reads the card on the host."""
    name, body = _program_bodies()[index]
    with no_host_reads():
        out = body()
    assert out is not None, name


def test_lines_assigner_selects_on_the_device() -> None:
    """The ``Lines`` assigner on a camera turned off its ridge (no candidate
    in frame, some in front): the device select assigns what the old host
    branch did (nearest in-front candidate), and with a view on the ridge
    what it did too; under :func:`no_host_reads` it runs, where the old
    ``bool(inside.any())`` raised."""
    model, _ = BA_PROBLEMS["lines"](Camera, optimize, device="cpu", n_cams=1, n_ridge=60, n_obs=40)
    scatter, assign, _, _ = model._build_autodiff_residual()
    control, cam = model.controls[0], model.cams[0]
    base = torch.from_numpy(np.stack([cam.to_array()]))
    world = torch.from_numpy(np.asarray(control._world_candidates(), dtype=float))
    uv_obs = torch.from_numpy(np.asarray(control.uv, dtype=float))
    for turn in (0.0, 100.0):
        params = torch.from_numpy(model.values.copy())  # the view direction (yaw, pitch, roll)
        params[0] += turn  # 100 deg of yaw puts the ridge out of frame, partly in front
        vs = scatter(params, base)
        uvc = optimize.projection.project(vs[0], world, correction=cam._correction_tuple)
        finite = torch.isfinite(uvc[:, 0]) & torch.isfinite(uvc[:, 1])
        uvc = torch.where(finite[:, None], uvc, 1e9)
        inside = finite & (uvc[:, 0] >= 0) & (uvc[:, 0] <= vs[0, 6]) & (uvc[:, 1] >= 0) & (uvc[:, 1] <= vs[0, 7])
        assert bool(inside.any()) == (turn == 0.0) and bool(finite.any())
        use = inside if bool(inside.any()) else finite  # the old host branch
        d2 = torch.where(use[None, :], torch.sum((uv_obs[:, None, :] - uvc[None, :, :]) ** 2, dim=-1), np.inf)
        with no_host_reads():
            (held,) = assign(vs)
        assert torch.equal(held, torch.argmin(d2, dim=1))


PROBLEM_SIZES = {"points": dict(n_cams=3, n_points=150), "matches": dict(n_cams=3, n_pts=150),
                 "lines": dict(n_cams=2, n_ridge=100, n_obs=120)}


@pytest.mark.parametrize("problem", list(BA_PROBLEMS))
def test_jacobian_program_equals_jacfwd(problem) -> None:
    """``Cameras._autodiff_jac`` through its program against the eager
    ``jacfwd`` (:func:`optimize._exact_jacobian` on fresh tensors), bit for
    bit, full and on a row subset, three calls each; the program is kept
    per row selection and rebuilt when the controls change size."""
    model, _ = BA_PROBLEMS[problem](Camera, optimize, device="cpu", **PROBLEM_SIZES[problem])
    x0 = model.values.copy()
    rng = np.random.default_rng(3)
    for index in (slice(None), np.sort(rng.choice(model.size, size=model.size // 3, replace=False))):
        rows = np.arange(model.size)[index]
        closures = model._build_autodiff_residual(None if len(rows) == model.size else rows)
        base = torch.from_numpy(np.stack([c.to_array() for c in model.cams + closures[3]]))
        for k in range(3):
            x = x0 + 1e-3 * k
            want = optimize._exact_jacobian(*closures[:3], torch.from_numpy(x), base).numpy()
            got = model._autodiff_jac(index)(x)
            assert got.shape == (2 * len(rows), len(x0)) and np.array_equal(got, want)
    programs = model._jac_cache["programs"]
    assert len(programs) == 2 and None in programs
    assert all(p.program.calls == 3 and p.program.graph is None for p in programs.values())
    model.controls = model.controls[:-1]  # a control fewer: a new token
    model._autodiff_jac()
    assert list(model._jac_cache["programs"]) == [None]


def test_refine_program_equals_refine_chunk() -> None:
    """A refiner's chunk program against :func:`refine.refine_chunk` on the
    same chunk, and through ``refine_pairs`` two chunk shapes (full chunks
    and the last, smaller one), each kept."""
    rng = np.random.default_rng(4)
    imgs = [np.round(128 + 300 * scipy.ndimage.gaussian_filter(rng.normal(size=(80, 80)), 1.5)).clip(0, 255)
            .astype(np.float32) for _ in range(3)]
    tiles = torch.from_numpy(np.stack(imgs))
    ca = rng.integers(0, 60, size=(3, 12, 2))
    cb = np.clip(ca + rng.integers(-3, 4, size=ca.shape) - 7, 0, 80 - 25)
    program = refine.ChunkProgram(3, 12, 80, 80, 11, 25, 4, "cpu")
    for k in range(3):
        got = program(list(tiles.roll(k, 0)), list(tiles), ca, cb)
        want = refine.refine_chunk(tiles.roll(k, 0), tiles, torch.from_numpy(ca), torch.from_numpy(cb), 11, 25, 4)
        assert all(np.array_equal(g, w.numpy()) for g, w in zip(got, want))
    refiner = refine.MatchRefiner(pad_matches=16, pairs_per_dispatch=2, device="cpu")
    uv = rng.uniform(15, 65, size=(10, 2))
    refiner.refine_pairs([(0, 1), (1, 2), (0, 2)], [(uv, uv + 0.5)] * 3, lambda k: imgs[k])
    assert list(refiner._programs) == [(2, 16, 80, 80), (1, 16, 80, 80)]


def test_detect_program_equals_detect_batch() -> None:
    """The detection batch program against :func:`features.detect_batch`,
    masked and not, over three batches; ``detect_and_describe`` keeps one
    program a batch shape for the call."""
    rng = np.random.default_rng(5)
    batches = [np.clip(128 + 500 * scipy.ndimage.gaussian_filter(rng.normal(size=(2, 64, 64)), (0, 1.5, 1.5)), 0,
                       255).astype(np.uint8) for _ in range(3)]
    masks = (rng.random((2, 64, 64)) > 0.2).astype(np.uint8)
    settings = dict(nfeatures=48, n_octaves=2)
    for masked in (False, True):
        program = features.BatchProgram((2, 64, 64), masked, "cpu", **settings)
        for images in batches:
            got = program(images, masks if masked else None)
            want = features.detect_batch(torch.from_numpy(images), torch.from_numpy(masks) if masked else None,
                                         **settings)
            assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_match_program_equals_match_batch() -> None:
    """The matching batch program, its ratio a device scalar, against
    :func:`matching.match_batch` with the ratio as a number, with and
    without the cross check, over three batches."""
    rng = np.random.default_rng(6)
    for cross_check in (False, True):
        program = matching.BatchProgram(2, 32, 32, 16, cross_check, "cpu")
        for _ in range(3):
            da, db = (torch.from_numpy(rng.normal(size=(2, 32, 16)).astype(np.float32)) for _ in range(2))
            na, nb = [32, 20], [25, 32]
            got = program(list(da), list(db), na, nb, 0.8)
            want = matching.match_batch(da, db, torch.tensor(na), torch.tensor(nb), float(np.float32(0.8)),
                                        cross_check)
            assert all(np.array_equal(g, w.numpy()) for g, w in zip(got, want))
            assert got[2].any() and not got[2].all()


def test_program_runs_its_body_on_the_cpu() -> None:
    """On the CPU a program has no graph: every call runs its body."""
    calls = []
    program = graphs.Program(lambda: calls.append(1) or torch.ones(2), "cpu", "a test program")
    for _ in range(3):
        assert torch.equal(program(), torch.ones(2))
    assert program.graph is None and program.calls == 3 and len(calls) == 3
