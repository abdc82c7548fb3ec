"""The observer front-end kernel's wrapper on the CPU.

On a CPU tensor ``kernels.project.project_extract`` runs the plain version:
each observer's front end in turn, stacked observer-major. Here it is held
bit for bit to that front end as the tracker ran it observer by observer,
with its own ``torch.cat``; the kernel itself is held to the plain version
on the card by ``tests/test_torch_cuda.py`` and by ``chip_smoke.py`` (phase
30), through ``kernels.bench_project.check``, whose rule is tested here.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from glimpse_tpu_torch.kernels import _build, bench_project, project
from glimpse_tpu_torch.ops import projection
from glimpse_tpu_torch.track import batch

DTYPES = ("float32", "bfloat16", "float16", "float64")
# (O, N, P, H, W, th, tw, sh, sw): one and two observers, non-square frames
# and boxes, a particle count no block size divides.
SHAPES = ((1, 200, 257, 64, 48, 5, 5, 11, 9), (2, 200, 257, 64, 48, 5, 7, 11, 13))


def observer_front(image, camera_vector, correction, particles, template_duv, w_norm, template_size,
                   search_size, dtype):
    """One observer's front end as the tracker computed it before the kernel:
    projection planes, weighted means, corners, tile gather, SSE indices."""
    th, tw = template_size
    sh, sw = search_size
    H, W = image.shape
    u, v = projection.project_planes(
        camera_vector, particles[..., 0], particles[..., 1], particles[..., 2], correction=correction,
    )
    u = torch.nan_to_num(u, nan=-1e6)
    v = torch.nan_to_num(v, nan=-1e6)
    u_mean = torch.sum(u * w_norm, dim=1)
    v_mean = torch.sum(v * w_norm, dim=1)
    corner_col = torch.round(u_mean - sw * 0.5).long().clamp(0, W - sw)
    corner_row = torch.round(v_mean - sh * 0.5).long().clamp(0, H - sh)
    rows = corner_row[:, None] + torch.arange(sh)
    cols = corner_col[:, None] + torch.arange(sw)
    search = image[rows[:, :, None], cols[:, None, :]]
    sse_left = corner_col.to(dtype) + (tw * 0.5 - 0.5) + template_duv[:, 0]
    sse_top = corner_row.to(dtype) + (th * 0.5 - 0.5) + template_duv[:, 1]
    return search, u - sse_left[:, None] - 0.5, v - sse_top[:, None] - 0.5


@pytest.mark.parametrize("duv", ["computing", "particles"])
@pytest.mark.parametrize("name", DTYPES)
@pytest.mark.parametrize("shape", SHAPES, ids=["1obs", "2obs"])
def test_wrapper_equals_the_per_observer_front_end(shape, name, duv) -> None:
    """Particles behind the camera and at NaN, corners clamped at all four
    edges, distortion and an elevation correction (``bench_project.inputs``):
    tiles, cols and rows equal the per-observer front end stacked by
    ``torch.cat``, rtol = atol = 0, in its types."""
    dtype = getattr(torch, name)
    args = bench_project.inputs(shape, dtype, "cpu", seed=sum(shape),
                                duv_dtype=dtype if duv == "particles" else None)
    O, H, W = args["images"].shape
    weights = args["weights"]
    w_norm = weights / torch.sum(weights, dim=-1, keepdim=True)
    fronts = [observer_front(args["images"][o], args["camera_vectors"][o], args["corrections"][o],
                             args["particles"], args["template_duv"][o], w_norm, args["template_size"],
                             args["search_size"], dtype) for o in range(O)]
    want = [torch.cat(parts, dim=0) for parts in zip(*fronts)]
    got = project.project_extract(**args)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert got[1].dtype == (torch.float64 if name == "float64" else torch.float32)
    # The cases are there: clamped corners on every side, particles behind the camera.
    means = bench_project.plain_means(**args)
    sh, sw = args["search_size"]
    assert (means[:, 0] < sw / 2).any() and (means[:, 0] > W - sw / 2).any()
    assert (means[:, 1] < sh / 2).any() and (means[:, 1] > H - sh / 2).any()
    assert (got[1] < -1e5).any()


def test_a_cpu_tensor_never_reaches_the_kernel(monkeypatch) -> None:
    """The CPU path builds and launches nothing and counts no launch."""
    def refuse(*args):
        raise AssertionError("the kernel's library was asked for on the CPU")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "launch", refuse)
    launches, captured = project.project_extract.launches, project.project_extract.captured
    args = bench_project.inputs(SHAPES[1], torch.float32, "cpu")
    tiles, cols, rows = project.project_extract(**args)
    assert tiles.shape == (400, 11, 13) and cols.shape == rows.shape == (400, 257)
    assert (project.project_extract.launches, project.project_extract.captured) == (launches, captured)


def _args(**changes):
    args = bench_project.inputs((2, 4, 8, 16, 16, 3, 3, 7, 7), torch.float32, "cpu")
    args.update(changes)
    return args


@pytest.mark.parametrize(
    "changes",
    [
        {"images": torch.zeros(2, 16)},
        {"camera_vectors": torch.zeros(2, 19)},
        {"camera_vectors": torch.zeros(3, 20)},
        {"corrections": [None]},
        {"particles": torch.zeros(4, 8, 2)},
        {"weights": torch.ones(4, 9)},
        {"template_duv": torch.zeros(2, 5, 2)},
        {"search_size": (17, 7)},
        {"search_size": (7, 0)},
        {"images": torch.zeros(65, 16, 16), "camera_vectors": torch.zeros(65, 20), "corrections": [None] * 65,
         "template_duv": torch.zeros(65, 4, 2)},
        {"particles": torch.zeros(4, 8, 6, dtype=torch.int32), "weights": torch.ones(4, 8, dtype=torch.int32)},
        {"weights": torch.ones(4, 8, dtype=torch.float64)},
        {"camera_vectors": torch.zeros(2, 20, dtype=torch.bfloat16)},
        {"camera_vectors": torch.zeros(2, 20, dtype=torch.float64)},
        {"images": torch.zeros(2, 16, 16, dtype=torch.uint8)},
        {"template_duv": torch.zeros(2, 4, 2, dtype=torch.float16)},
        {"particles": torch.zeros(4, 8, 6, device="meta"), "weights": torch.ones(4, 8, device="meta"),
         "images": torch.zeros(2, 16, 16, device="meta"), "camera_vectors": torch.zeros(2, 20, device="meta"),
         "template_duv": torch.zeros(2, 4, 2, device="meta")},
        {"weights": torch.ones(4, 8, device="meta")},
    ],
    ids=["images-2d", "camera-width", "camera-count", "corrections-count", "particles-xy", "weights-shape",
         "duv-points", "search-taller-than-image", "search-empty", "65-observers", "int32-particles",
         "mixed-weights", "bfloat16-cameras", "float64-cameras", "uint8-images", "float16-duv", "meta-device", "two-devices"],
)
def test_wrapper_refuses(changes) -> None:
    """ValueError on what the kernel does not take: shapes, types, devices."""
    with pytest.raises(ValueError):
        project.project_extract(**_args(**changes))


def test_the_tracker_calls_the_front_end_once_a_step(monkeypatch) -> None:
    """A replay adds the captured front-end launches to the wrapper's count,
    and observer_log_likelihoods_multi makes one call for all observers."""
    assert _build.KERNELS["project"].wrapper is project.project_extract
    calls = []
    plain = project.project_extract

    def spy(*args, **kwargs):
        calls.append(args)
        return plain(*args, **kwargs)

    monkeypatch.setattr(batch.project_kernel, "project_extract", spy)
    args = bench_project.inputs((2, 6, 32, 64, 64, 15, 15, 31, 31), torch.float32, "cpu")
    O, N = 2, 6
    templates = torch.randn(O, N, 15, 15)
    table = torch.sort(torch.randn(O, N, 16), dim=-1).values
    ll = batch.observer_log_likelihoods_multi(
        args["images"], args["camera_vectors"], args["corrections"], [0.3, 0.5], args["particles"], templates,
        table, args["template_duv"], args["weights"], batch.BatchConfig(n_particles=32, n_quantiles=16),
    )
    assert ll.shape == (N, 32) and len(calls) == 1 and calls[0][0] is args["images"]


def test_correction_constants_round_as_the_cards_host_scalars() -> None:
    """(refraction - 1) rounded to the computing type, and the reciprocal of
    2 radius taken in it, as PyTorch's CUDA ops treat a host scalar factor
    and divisor; an observer without a correction passes zeros."""
    corrections = [None, (6.3781e6, 0.13)]
    wide = list(project._correction_constants(corrections, torch.float64))
    narrow = list(project._correction_constants(corrections, torch.float32))
    assert wide == [0.0, 0.0, 0.0, 1.0, 0.13 - 1, 1.0 / (2 * 6.3781e6)]
    assert narrow[:4] == [0.0, 0.0, 0.0, 1.0]
    assert narrow[4] == float(np.float32(0.13 - 1)) and narrow[5] == float(np.float32(1) / np.float32(2 * 6.3781e6))
    assert narrow[5] != wide[5]


def test_check_allows_a_moved_corner_only_at_a_tie() -> None:
    """``bench_project.check``: a point whose corner moved one pixel passes
    where the plain mean lies within TIE_EPSILONS epsilons of a tie, and
    fails elsewhere; a difference where the corners agree fails."""
    args = bench_project.inputs((1, 3, 16, 64, 64, 5, 5, 11, 11), torch.float32, "cpu")
    want = project.project_extract(**args)
    means = bench_project.plain_means(**args)
    moved = (want[0].clone(), want[1] - 1.0, want[2].clone())
    moved[1][1:] = want[1][1:]  # point 0's corner one column to the right
    tied = means.clone()
    tied[0, 0] = 30.0 + 5.5 + 0.5 + 1e-6  # within 64 epsilons of 30.5 + the box's half width
    assert bench_project.check(moved, want, tied, args["search_size"]) == {"points": 3, "ties": 1,
                                                                          "max_abs_err": 0.0}
    away = means.clone()
    away[0, 0] = 30.25 + 5.5
    with pytest.raises(AssertionError, match="moved away from a tie"):
        bench_project.check(moved, want, away, args["search_size"])
    nudged = (want[0], want[1].clone(), want[2])
    nudged[1][2, 3] = torch.nextafter(nudged[1][2, 3], torch.tensor(0.0))
    with pytest.raises(AssertionError, match="cols of point 2"):
        bench_project.check(nudged, want, means, args["search_size"])


def test_check_measures_the_largest_difference_where_the_corners_agree() -> None:
    """``bench_project.check``'s ``max_abs_err`` is measured: 0 for equal
    outputs, and the size of a planted difference in its message."""
    args = bench_project.inputs((1, 3, 16, 64, 64, 5, 5, 11, 11), torch.float32, "cpu")
    want = project.project_extract(**args)
    means = bench_project.plain_means(**args)
    same = tuple(t.clone() for t in want)
    assert bench_project.check(same, want, means, args["search_size"])["max_abs_err"] == 0.0
    planted = (want[0].clone(), want[1], want[2])
    planted[0][1, 2, 3] += 0.25
    with pytest.raises(AssertionError, match=r"tiles of point 1 .* 0\.25\)"):
        bench_project.check(planted, want, means, args["search_size"])


@pytest.mark.parametrize("name", DTYPES)
def test_bench_bytes_equal_the_roofline_reader(name) -> None:
    """``bench_project.project_bytes`` (chip_smoke phase 30 and the bench)
    and the benchmark's ``kernel.project.roofline_pct`` reader, which
    imports nothing of the program, count the same bytes at the north star."""
    from portbench import cells

    reader = cells.load_module(cells.ROOT / "metrics" / "kernel.project.roofline_pct.py")
    cell = cells.load_cell("columbia-2obs.north-star")
    cell["config"] = dict(cell["config"], dtype=name)
    cell["traffic"] = dict(cell["traffic"], points=10240, particles=2048)
    assert reader.project_bytes(cell) == bench_project.project_bytes(bench_project.SHAPES[0], getattr(torch, name))
