"""The DEM prior's wrapper (``kernels/prior.py``) on the CPU, and its kernel
on the card.

On a CPU tensor ``kernels.prior.dem_prior`` runs the plain version, which is
held here bit for bit to the prior as ``BatchMotion.log_likelihoods``
computed it before the kernel, on ``bench_prior.inputs`` (points inside and
outside the rasters, sigma cells at or below 0 and at NaN, a NaN DEM cell,
1 x 1 rasters, rasters one cell high or wide) in every particle type. The
card tests (marker ``cuda``; this file imports no JAX, so run them there as
``python -m pytest --noconftest -m cuda tests/test_torch_prior.py``) hold
the kernel to the plain version with rtol = atol = 0, read a NaN
coordinate (which the plain version cannot index) as a NaN sample, and
count its launches in a captured graph.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from glimpse_tpu_torch.kernels import _build, bench_prior, prior
from glimpse_tpu_torch.track import batch

DTYPES = ("float32", "bfloat16", "float16", "float64")
#: (N, P, H, W) of the CPU cases: a particle count no block size divides.
CPU_SHAPE = (37, 129, 40, 50)
#: (N, P, H, W) of the card cases: oblique-3d's rasters, and small ones
#: whose cells the particles' clouds straddle.
CARD_SHAPES = ((256, 2048, 640, 640), (256, 2048, 40, 50))


def prior_before_the_kernel(particles, dem, dem_sigma):
    """``BatchMotion.log_likelihoods`` of an informative motion as the
    tracker computed it before the kernel."""
    xy = particles[..., 0:2]
    z = dem.sample(xy)
    z_sigma = dem_sigma.sample(xy)
    safe = torch.where(z_sigma > 0, z_sigma, 1.0)
    ll = (z - particles[..., 2]) ** 2 / (2 * safe * safe)
    return torch.where(z_sigma > 0, ll, 0.0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("name", DTYPES)
@pytest.mark.parametrize("case", bench_prior.CASES)
def test_wrapper_equals_the_prior_before_the_kernel(case, name) -> None:
    """On the CPU the wrapper's plain path gives the earlier prior bit for
    bit, in its type (float64 for float64 particles, else float32), with NaN
    where it has NaN; the cases reach the NaN DEM cell and the sigma cells
    at or below 0, and nothing launches."""
    dtype = getattr(torch, name)
    args = bench_prior.inputs(CPU_SHAPE, dtype, "cpu", seed=5, case=case)
    launches, captured = prior.dem_prior.launches, prior.dem_prior.captured
    got = prior.dem_prior(**args)
    want = prior_before_the_kernel(**args)
    assert got.dtype == want.dtype == prior.compute_dtype(dtype)
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    assert (prior.dem_prior.launches, prior.dem_prior.captured) == (launches, captured)
    nan_dem = args["dem"].array.numel() > 1 and case != "zero_sigma"
    assert bool(torch.isnan(want[3]).any()) == nan_dem
    assert bool((want == 0).any()) == (case != "single_sigma")
    assert bool((want > 0).any()) == (case != "zero_sigma")
    xy = args["particles"][..., 0:2].double()
    outside = (xy[..., 0] < -200) | (xy[..., 0] > 600) | (xy[..., 1] < -200) | (xy[..., 1] > 600)
    assert (outside & (xy.abs() < 1e3).all(dim=-1)).any()


def test_registry_lists_the_prior_with_no_launch_on_the_cpu() -> None:
    """``prior`` is registered after ``project`` with its wrapper, and a CPU
    process launches nothing."""
    assert list(_build.KERNELS)[-2:] == ["project", "prior"]
    assert _build.KERNELS["prior"].wrapper is prior.dem_prior
    prior.dem_prior(**bench_prior.inputs(CPU_SHAPE, torch.float32, "cpu"))
    assert prior.dem_prior.launches == prior.dem_prior.captured == 0


def _refused(field: str):
    """bench_prior's CPU arguments with one thing the kernel does not take."""
    args = bench_prior.inputs(CPU_SHAPE, torch.float32, "cpu")
    dem = args["dem"]
    changes = {
        "float64_raster": lambda: dict(args, dem=dataclasses.replace(dem, array=dem.array.double())),
        "float64_scalar": lambda: dict(args, dem_sigma=dataclasses.replace(args["dem_sigma"],
                                                                           dx=args["dem_sigma"].dx.double())),
        "1d_raster": lambda: dict(args, dem=dataclasses.replace(dem, array=dem.array[0])),
        "empty_raster": lambda: dict(args, dem=dataclasses.replace(dem, array=dem.array[:0])),
        "vector_scalar": lambda: dict(args, dem=dataclasses.replace(dem, x0=dem.x0[None])),
        "raster_elsewhere": lambda: dict(args, dem=dataclasses.replace(dem, array=dem.array.to("meta"))),
        "two_columns": lambda: dict(args, particles=args["particles"][..., 0:2]),
        "integer_particles": lambda: dict(args, particles=args["particles"].int()),
    }
    return changes[field]()


@pytest.mark.parametrize("field", ["float64_raster", "float64_scalar", "1d_raster", "empty_raster", "vector_scalar",
                                   "raster_elsewhere", "two_columns", "integer_particles"])
def test_wrapper_refuses_what_the_kernel_does_not_take(field) -> None:
    """ValueError on a float64 raster or grid scalar, a raster not (H, W) of
    at least one cell, a grid scalar not 0-d, a raster on another device,
    particles without z, particles of another type."""
    with pytest.raises(ValueError):
        prior.dem_prior(**_refused(field))


@pytest.mark.parametrize("kind", ["cartesian", "cylindrical", "tangent"])
@pytest.mark.parametrize("dem_sigma", [True, False], ids=["dem_sigma", "flat"])
def test_the_motion_calls_the_kernel_once_where_its_prior_weighs(monkeypatch, kind, dem_sigma) -> None:
    """``BatchMotion.log_likelihoods`` calls ``dem_prior`` once, on its
    rasters, where it is informative (cartesian or cylindrical with a DEM
    sigma) and returns zeros of the particles' type without it otherwise."""
    args = bench_prior.inputs(CPU_SHAPE, torch.float32, "cpu")
    N = CPU_SHAPE[0]
    zeros = np.zeros((N, 3), np.float32)
    motion = batch.BatchMotion(
        kind=kind, xy=torch.zeros(N, 2), xy_sigma=torch.ones(N, 2), v_mean=torch.from_numpy(zeros),
        v_sigma=torch.ones(N, 3), a_mean=torch.from_numpy(zeros), a_sigma=torch.ones(N, 3),
        slope_sigma=torch.zeros(N), dem=args["dem"], dem_sigma=args["dem_sigma"], use_dem_sigma=dem_sigma,
    )
    calls = []
    plain = prior.dem_prior

    def spy(*call):
        calls.append(call)
        return plain(*call)

    monkeypatch.setattr(batch.prior_kernel, "dem_prior", spy)
    ll = motion.log_likelihoods(args["particles"])
    if motion.informative:
        assert len(calls) == 1 and calls[0][1] is args["dem"] and calls[0][2] is args["dem_sigma"]
        torch.testing.assert_close(ll, prior_before_the_kernel(**args), rtol=0, atol=0, equal_nan=True)
    else:
        assert calls == [] and ll.dtype == torch.float32 and (ll == 0).all()
    assert motion.informative == (dem_sigma and kind != "tangent")


@pytest.mark.parametrize("name", DTYPES)
def test_bench_bytes_equal_the_roofline_reader(name) -> None:
    """``bench_prior.prior_bytes`` and the benchmark's
    ``kernel.prior.roofline_pct`` reader, which imports nothing of the
    program, count the same bytes at oblique-3d."""
    from portbench import cells

    reader = cells.load_module(cells.ROOT / "metrics" / "kernel.prior.roofline_pct.py")
    cell = cells.load_cell("oblique-3d.north-star")
    cell["config"] = dict(cell["config"], dtype=name)
    assert (cell["traffic"]["points"], cell["traffic"]["particles"], *cell["config"]["dem"]["cells"]) == (
        bench_prior.SHAPES[0])
    assert reader.prior_bytes(cell) == bench_prior.prior_bytes(bench_prior.SHAPES[0], getattr(torch, name))


@pytest.mark.cuda
@pytest.mark.parametrize("name", DTYPES)
@pytest.mark.parametrize("case", bench_prior.CASES)
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=["x".join(map(str, s)) for s in CARD_SHAPES])
def test_prior_kernel_equals_its_plain_version(cuda, shape, case, name) -> None:
    """One launch, and the kernel's prior equal to the plain version's on
    the card (``bench_prior.check``: rtol = atol = 0, NaN where it has NaN),
    with particles at +-inf and 1e7 among the cases."""
    args = bench_prior.inputs(shape, getattr(torch, name), cuda, seed=sum(shape), case=case)
    before = prior.dem_prior.launches
    got = prior.dem_prior(**args)
    assert prior.dem_prior.launches == before + 1
    want = prior.dem_prior_plain(**args)
    assert bench_prior.check(got, want) == 0.0
    assert bool(torch.isnan(want[3]).any()) == (args["dem"].array.numel() > 1 and case != "zero_sigma")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["grid", "single_sigma"])
def test_prior_kernel_reads_a_nan_coordinate_as_a_nan_sample(cuda, case) -> None:
    """A particle at x NaN, which the plain version cannot index, reads NaN
    from both rasters: its prior is 0 where the sigma raster gives NaN and
    NaN under a 1 x 1 sigma; every other particle's is the plain version's."""
    args = bench_prior.inputs(CARD_SHAPES[1], torch.float32, cuda, seed=9, case=case)
    want = prior.dem_prior_plain(**args)
    args["particles"][6, 3, 0] = float("nan")
    got = prior.dem_prior(**args)
    assert torch.isnan(got[6, 3]) if case == "single_sigma" else got[6, 3] == 0
    got[6, 3] = want[6, 3]
    assert bench_prior.check(got, want) == 0.0


@pytest.mark.cuda
def test_prior_kernel_captured_equals_eager(cuda) -> None:
    """A call captured in a CUDA graph counts in ``captured``; each replay
    adds one launch and writes what an eager call writes."""
    from glimpse_tpu_torch import graphs

    args = bench_prior.inputs(CARD_SHAPES[0], torch.float32, cuda, seed=5)
    eager = prior.dem_prior(**args)
    captured, launches = prior.dem_prior.captured, prior.dem_prior.launches
    graph = graphs.Graph(lambda: prior.dem_prior(**args), cuda, "the DEM prior")
    assert prior.dem_prior.captured == captured + 1 and prior.dem_prior.launches == launches
    assert graph.launches["prior"] == 1
    for replay in range(1, 3):
        graph.outputs.zero_()
        out = graph.replay()
        torch.cuda.synchronize()
        assert prior.dem_prior.launches == launches + replay
        assert bench_prior.check(out, eager) == 0.0
