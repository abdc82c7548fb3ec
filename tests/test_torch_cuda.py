"""The port's CUDA kernels against their plain versions, on the card.

Skips without a CUDA card. The machine with the card has no JAX, and
``tests/conftest.py`` imports it, so run these there as
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from chip_smoke import (
    HIGHPASS_LARGE_TILES,
    LANE_CASES,
    PRECISION_TILES,
    THIN_TILES,
    highpass_case_tiles,
    highpass_check_cases,
    spline_case,
)
from glimpse_tpu_torch.kernels.highpass import SEPARABLE, covers, kernel_variant, median_highpass, median_highpass_plain
from glimpse_tpu_torch.kernels.resample import systematic_resample, systematic_resample_plain
from glimpse_tpu_torch.kernels.spline import bspline_sample, bspline_sample_plain
from glimpse_tpu_torch.kernels.spline import route as spline_route
from glimpse_tpu_torch.ops.resampling import systematic_thresholds


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("size", [(3, 3), (5, 5), (7, 7), (1, 5), (3, 7), (3, 15), (1, 25)])
@pytest.mark.parametrize("shape", [(37, 41, 41), (37, 15, 15)])
def test_highpass_kernel_bit_exact(cuda, shape, size) -> None:
    tiles = torch.from_numpy(np.random.default_rng(0).normal(size=shape).astype(np.float32)).to(cuda)
    before = median_highpass.launches
    got = median_highpass(tiles, size)
    assert median_highpass.launches == before + 1
    assert torch.equal(got, median_highpass_plain(tiles, size))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "label, shape, size, specials, misaligned", highpass_check_cases(),
    ids=[f"{c[0]}-{'x'.join(map(str, c[1]))}-{c[2][0]}x{c[2][1]}" for c in highpass_check_cases()],
)
def test_highpass_kernel_holds_nan_ties_and_inf(cuda, label, shape, size, specials, misaligned) -> None:
    """Tied values, NaN at a corner, an edge and inside, +-inf, every
    compiled window and generic ones, the smallest tiles: equal to the plain
    version with NaN exactly where it has NaN (chip_smoke phase 3's cases)."""
    tiles = highpass_case_tiles(shape, specials, misaligned, cuda)
    got = median_highpass(tiles, size)
    want = median_highpass_plain(tiles, size)
    variant = kernel_variant(size, torch.float32, shape)
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True, msg=lambda m: f"{variant}: {m}")
    if specials:
        assert torch.isnan(want).any()


@pytest.mark.cuda
def test_highpass_variants_match_the_wrapper(cuda) -> None:
    """The library runs a separable kernel exactly for the windows
    ``SEPARABLE`` names."""
    for kh in range(1, 50, 2):
        for kw in range(1, 50, 2):
            if kh * kw <= 49:
                assert kernel_variant((kh, kw), torch.float32, (37, 31, 31)).startswith("separable") == ((kh, kw) in SEPARABLE), (kh, kw)


@pytest.mark.cuda
@pytest.mark.parametrize("n, p", [(37, 1024), (64, 2048), (3, 20000)])
def test_resample_kernel_bit_exact(cuda, n, p) -> None:
    """Skewed weights exp(3 * normal); P = 20000 needs more than the 48 KB of
    shared memory a block gets without asking."""
    rng = np.random.default_rng(1)
    weights = torch.from_numpy(np.exp(3 * rng.normal(size=(n, p))).astype(np.float32)).to(cuda)
    u = torch.from_numpy(rng.random(n).astype(np.float32)).to(cuda)
    particles = torch.from_numpy(rng.normal(size=(n, p, 6)).astype(np.float32)).to(cuda)
    t = systematic_thresholds(weights, u)
    before = systematic_resample.launches
    got = systematic_resample(t, particles, weights)
    assert systematic_resample.launches == before + 1
    want = systematic_resample_plain(t, particles, weights)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_highpass_kernel_bit_exact_at_columbia_width(cuda) -> None:
    """The stacked search tiles of two observers x 10,240 points, one launch."""
    tiles = torch.from_numpy(np.random.default_rng(2).normal(size=(20480, 31, 31)).astype(np.float32)).to(cuda)
    before = median_highpass.launches
    got = median_highpass(tiles, (5, 5))
    assert median_highpass.launches == before + 1
    assert torch.equal(got, median_highpass_plain(tiles, (5, 5)))


# The spline read: the benchmark cells' stacks (cut to fewer surfaces), a
# non-square surface, the smallest ones, and surfaces whose folded table no
# block's shared memory holds (read from device memory): (B, h, w, P).
SPLINE_CARD_SHAPES = ((20480, 17, 17, 2048), (1024, 27, 27, 2048), (37, 9, 23, 1000), (8, 1, 2, 300),
                      (8, 2, 1, 300), (3, 250, 250, 5000))


@pytest.mark.cuda
@pytest.mark.parametrize("coords", ["float32", "float64"])
@pytest.mark.parametrize("name", ["float32", "bfloat16", "float16", "float64"])
@pytest.mark.parametrize("shape", SPLINE_CARD_SHAPES, ids=["x".join(map(str, s)) for s in SPLINE_CARD_SHAPES])
def test_spline_kernel_equals_its_plain_version(cuda, shape, name, coords) -> None:
    """Edges, points just inside them and outside, NaN and +-inf coordinates
    and coefficients (``chip_smoke.spline_case``), every coefficient type at
    each coordinate type the kernel takes: one launch, the plain version's output type, and
    its values with rtol = atol = 0 and NaN where it has NaN."""
    dtype, coord_dtype = getattr(torch, name), getattr(torch, coords)
    coeffs, rows, cols = spline_case(shape, dtype, coord_dtype, cuda, seed=sum(shape))
    before = bspline_sample.launches
    got = bspline_sample(coeffs, rows, cols)
    assert bspline_sample.launches == before + 1
    want = bspline_sample_plain(coeffs, rows, cols)
    assert got.dtype == want.dtype
    assert torch.isnan(want).any()
    route = spline_route(shape[1:3], dtype)
    assert route == ("global" if shape[1] == 250 else "staged")
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True, msg=lambda m: f"{route}: {m}")


@pytest.mark.cuda
def test_spline_kernel_captured_equals_eager(cuda) -> None:
    """A call captured in a CUDA graph counts in ``captured``; each replay
    adds one launch and writes what an eager call writes."""
    from glimpse_tpu_torch import graphs

    coeffs, rows, cols = spline_case((1024, 27, 27, 2048), torch.float32, torch.float32, cuda, seed=5)
    eager = bspline_sample(coeffs, rows, cols)
    captured, launches = bspline_sample.captured, bspline_sample.launches
    graph = graphs.Graph(lambda: bspline_sample(coeffs, rows, cols), cuda, "the spline read")
    assert bspline_sample.captured == captured + 1 and bspline_sample.launches == launches
    for replay in range(1, 3):
        graph.outputs.zero_()
        out = graph.replay()
        torch.cuda.synchronize()
        assert bspline_sample.launches == launches + replay
        torch.testing.assert_close(out, eager, rtol=0, atol=0, equal_nan=True)


@pytest.mark.cuda
def test_stream_equals_track_on_card(cuda) -> None:
    """Two observers, the second late and masked, a viewshed and ESS
    resampling: track_stream in chunks of 3 equals track bit for bit on the
    card, and both kernels carry every step."""
    import scipy.ndimage

    from glimpse_tpu_torch.track import batch, convert

    rng = np.random.default_rng(3)
    T, size = 7, 128
    base = scipy.ndimage.gaussian_filter(rng.normal(size=(size + 16, size + 16)), 0.8) * 100
    frames = np.stack([[base[i : i + size, i : i + size], base[i + 2 : i + 2 + size, i : i + size]] for i in range(T)])
    cam = np.zeros(20, np.float32)
    cam[0:3], cam[3:6], cam[6:10] = (size / 2, size / 2, size), (0, -90, 0), size
    flat = {"array": [[0.0]], "x0": 0.0, "y0": 0.0, "dx": 1e30, "dy": 1e30}
    n = 6
    motion = convert.motion_from_numpy(
        {
            "kind": "cartesian", "xy": rng.uniform(40, 88, size=(n, 2)), "xy_sigma": np.ones((n, 2)),
            "v_mean": np.zeros((n, 3)), "v_sigma": np.tile([1.0, 1.0, 0.0], (n, 1)), "a_mean": np.zeros((n, 3)),
            "a_sigma": np.tile([0.1, 0.1, 0.0], (n, 1)), "slope_sigma": np.zeros(n), "dem": flat, "dem_sigma": flat,
            "use_dem_sigma": False,
        },
        cuda,
    )
    viewshed = convert.raster_from_numpy(
        {"array": np.ones((8, 8)), "x0": -size, "y0": 2 * size, "dx": 3 * size / 8, "dy": -3 * size / 8}, cuda
    )
    config = batch.BatchConfig(n_particles=128, template_size=(11, 11), search_size=(25, 25), resample_threshold=0.5)
    tracker = batch.BatchTracker(np.stack([cam, cam]), [None] * 2, [0.3] * 2, motion, config, device=cuda, viewshed=viewshed)
    masks = np.ones((T - 1, 2), np.float32)
    masks[[0, 3], 1] = 0.0
    mask0 = np.array([1.0, 0.0])
    before = (median_highpass.launches, systematic_resample.launches)
    _, out = tracker.track(torch.Generator(device=cuda).manual_seed(0), frames, np.ones(T - 1), obs_masks=masks, obs_mask0=mask0)
    assert median_highpass.launches - before[0] == T - 1 + 2
    assert systematic_resample.launches - before[1] == T - 1
    _, outputs = tracker.track_stream(
        torch.Generator(device=cuda).manual_seed(0), frames[0], iter(frames[1:]), np.ones(T - 1),
        obs_masks=masks, obs_mask0=mask0, chunk=3,
    )
    assert [len(o["mean"]) for o in outputs] == [1, 1, 1, 3]
    for k in out:
        assert torch.equal(torch.cat([o[k] for o in outputs]), out[k]), k
    assert torch.isfinite(out["mean"]).all() and (out["valid"] == 1).all()


def _textures(n_images, size, seed):
    import scipy.ndimage

    rng = np.random.default_rng(seed)
    base = scipy.ndimage.gaussian_filter(rng.normal(size=(size + 8, size + 8)), 1.5)
    base = 128 + 70 * base / np.abs(base).max()
    return [np.clip(base[i : i + size, 2 * i : 2 * i + size], 0, 255).astype(np.uint8) for i in range(n_images)]


@pytest.mark.cuda
def test_detect_and_describe_on_card(cuda) -> None:
    """Keypoints on the card against the CPU: at least 98 % within 1e-2 px,
    their descriptors within 1e-3 (cuDNN and the CPU round differently)."""
    from glimpse_tpu_torch.ops import features

    images = _textures(3, 160, 4)
    mask = np.ones((160, 160), np.uint8)
    mask[60:90] = 0
    kwargs = dict(masks=[mask, None, mask], nfeatures=256, batch=2, n_octaves=3)
    card = features.detect_and_describe(images, device=cuda, **kwargs)
    cpu = features.detect_and_describe(images, device="cpu", **kwargs)
    for (gp, gd), (cp, cd) in zip(card, cpu):
        assert len(cp) > 100
        dist = np.linalg.norm(cp[:, None] - gp[None], axis=-1)
        nearest = dist.argmin(axis=1)
        close = dist[np.arange(len(cp)), nearest] < 1e-2
        assert close.sum() >= 0.98 * len(cp)
        np.testing.assert_allclose(gd[nearest[close]], cd[close], atol=1e-3, rtol=0)


@pytest.mark.cuda
def test_match_pairs_on_card(cuda) -> None:
    """Identical indices on the card and the CPU; ratios within 1e-5 plus
    the float32 rounding bound of the expanded distance
    (``chip_smoke.ratio_tolerance``): near-duplicate descriptors put the
    nearest squared distance at the rounding floor, where the two devices'
    summation orders part by up to 1e-3 in the ratio."""
    from chip_smoke import ratio_tolerance
    from glimpse_tpu_torch.ops import features, matching

    keypoints = features.detect_and_describe(_textures(4, 160, 5), nfeatures=256, batch=4, n_octaves=3, device="cpu")
    descs = [k[1] for k in keypoints]
    pairs = np.array([[0, 1], [1, 2], [0, 3], [2, 3]])
    for cross_check in (False, True):
        card = matching.DescriptorMatcher(device=cuda).match_pairs(descs, pairs, max_ratio=0.75, cross_check=cross_check)
        cpu = matching.DescriptorMatcher(device="cpu").match_pairs(descs, pairs, max_ratio=0.75, cross_check=cross_check)
        for (i, j), (gi, gr), (ci, cr) in zip(pairs, card, cpu):
            assert len(ci) > 10
            np.testing.assert_array_equal(gi, ci)
            assert (np.abs(gr - cr) <= ratio_tolerance(descs[i], descs[j], ci)).all()


@pytest.mark.cuda
def test_observer_fit_on_card(cuda) -> None:
    """Six frames of exact matches under a wobbling camera: the device
    L-BFGS on the card recovers the truth within 1e-2 deg and agrees with
    the CPU within 2e-3 deg."""
    from types import SimpleNamespace

    import scipy.sparse
    import torch

    from glimpse_tpu_torch import optimize
    from glimpse_tpu_torch.ops import projection

    rng = np.random.default_rng(6)
    n = 6
    truth = np.array([10.0, -20.0, 1.0]) + np.vstack([np.zeros(3), rng.normal(0, 0.3, (n - 1, 3))])
    cam = np.zeros(20)
    cam[6:10] = (240, 160, 200, 200)
    pairs, objs = [], []
    for i in range(n):
        for j in (i + 1, i + 2):
            if j < n:
                xy = rng.uniform(-0.5, 0.5, (60, 2))
                ray = projection.camera_to_world(torch.from_numpy(xy), projection.rotation_matrix(torch.from_numpy(truth[i])))
                rot = projection.rotation_matrix(torch.from_numpy(truth[j]))
                cj = (ray @ rot.T).numpy()
                objs.append(optimize.RotationMatchesXYZ(cams=(cam, cam), xys=[xy, cj[:, :2] / cj[:, 2:]]))
                pairs.append((i, j))
    matches = scipy.sparse.coo_matrix((np.ones(len(objs)), tuple(np.array(pairs).T)), shape=(n, n))
    matches.data = np.array(objs, dtype=object)
    fits = {}
    for name, device in (("card", cuda), ("cpu", torch.device("cpu"))):
        observer = SimpleNamespace(images=[SimpleNamespace(cam=SimpleNamespace(viewdir=truth[0].copy()))] * n)
        fits[name] = optimize.ObserverCameras(observer, matches, anchors=[0], device=device).fit().x.reshape(-1, 3)
    np.testing.assert_allclose(fits["card"], truth, atol=1e-2)
    np.testing.assert_allclose(fits["card"], fits["cpu"], atol=2e-3)


@pytest.mark.cuda
def test_terrain_on_card_follows_the_cpu(cuda) -> None:
    """``Raster.viewshed`` and ``horizon`` default to the card; the float32
    mask there parts from the CPU's float64 mask on at most 0.5 % of cells."""
    import scipy.ndimage

    from glimpse_tpu_torch import Raster

    z = scipy.ndimage.gaussian_filter(np.random.default_rng(0).normal(size=(256, 256)), 8) * 600
    z[40:50, 100:130] = np.nan
    dem = Raster(z, x=(0, 2560), y=(2560, 0))
    origin = (1100.0, 1500.0, float(dem.sample(np.array([[1100.0, 1500.0]]))[0]) + 5.0)
    on_card = dem.viewshed(origin, correction=True)
    on_cpu = dem.viewshed(origin, correction=True, device="cpu")
    assert 0.02 < on_cpu.mean() < 0.98
    assert (on_card != on_cpu).mean() <= 0.005
    assert len(dem.horizon(origin, range(0, 360, 2))) == len(dem.horizon(origin, range(0, 360, 2), device="cpu"))


@pytest.mark.cuda
def test_object_bridges_build_on_card(cuda) -> None:
    """``from_raster`` and ``from_motions`` default to the card and hold the
    same numbers as on the CPU."""
    import datetime

    from glimpse_tpu_torch import Raster
    from glimpse_tpu_torch.track import CartesianMotion, batch

    dem = Raster(np.random.default_rng(1).normal(size=(32, 32)), x=(0, 320), y=(320, 0))
    motions = [
        CartesianMotion(xy=(100.0 + i, 150.0), time_unit=datetime.timedelta(days=1), dem=dem, dem_sigma=0.5,
                        xy_sigma=(1, 1), vxyz_sigma=(1.5, 1.5, 0.05))
        for i in range(5)
    ]
    on_card, on_cpu = batch.BatchMotion.from_motions(motions), batch.BatchMotion.from_motions(motions, device="cpu")
    assert on_card.xy.device.type == "cuda" and on_card.dem.array.device.type == "cuda"
    for name in ("xy", "xy_sigma", "v_sigma", "a_sigma"):
        assert torch.equal(getattr(on_card, name).cpu(), getattr(on_cpu, name))
    assert torch.equal(batch.DeviceRaster.from_raster(dem).array.cpu(), on_cpu.dem.array)


@pytest.mark.cuda
@pytest.mark.parametrize("highpass", [(5, 5), (4, 4)])
def test_host_tracker_on_card_against_cpu(cuda, highpass) -> None:
    """The host ``Tracker`` defaults to the card, where its likelihoods run
    in float32 and the high-pass through the kernel for the windows it
    covers (once a template and once a step), through the plain version for
    the others: log likelihoods from shared particles within 1e-3 of the
    float64 ones on the CPU."""
    import datetime

    import scipy.ndimage

    from glimpse_tpu_torch import Raster, Tracker
    from glimpse_tpu_torch.track import CartesianMotion, Observer

    rng = np.random.default_rng(0)
    base = scipy.ndimage.gaussian_filter(rng.normal(size=(120, 120)), 0.8) * 100 + 100
    day = datetime.timedelta(days=1)
    images = [
        Raster(scipy.ndimage.shift(base, (i, 2 * i), order=1, mode="nearest"), x=(0, 120), y=(120, 0),
               datetime=datetime.datetime(2020, 1, 1) + i * day)
        for i in range(3)
    ]
    observer = Observer(images, sigma=0.15)
    particles = CartesianMotion(
        xy=(60.0, 60.0), time_unit=day, dem=0.0, n=512, xy_sigma=(2, 2), vxyz_sigma=(3, 3, 0), seed=1).initialize_particles()
    results = {}
    for device in (None, "cpu"):
        tracker = Tracker([observer], highpass={"size": highpass}, seed=0, **({} if device is None else {"device": device}))
        assert tracker.device.type == ("cuda" if device is None else "cpu")
        launches = median_highpass.launches
        tracker.particles = particles.copy()
        tracker.initialize_weights()
        tracker.initialize_template(obs=0, img=0, tile_size=(15, 15))
        tracker.particles[:, 0:2] += (2.0, -1.0)
        results[device] = tracker.compute_observer_log_likelihoods(obs=0, img=1)
        if device is None:
            assert median_highpass.launches - launches == (2 if covers(highpass) else 0)
            assert tracker.templates[0]["tile"].dtype == np.float32
    np.testing.assert_allclose(results[None], results["cpu"], rtol=0, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("problem", ["points", "matches", "lines"])
def test_exact_jacobian_on_card_against_cpu(cuda, problem) -> None:
    """``Cameras`` defaults to the card; its float64 Jacobian there within
    1e-9 of each column's largest entry of the CPU's, and a fit with it
    succeeds."""
    from chip_smoke import BA_PROBLEMS
    from glimpse_tpu_torch import Camera, optimize

    sizes = {"points": dict(n_cams=3, n_points=200), "matches": dict(n_cams=3, n_pts=200), "lines": dict(n_cams=2, n_ridge=100, n_obs=150)}
    on_card, _ = BA_PROBLEMS[problem](Camera, optimize, **sizes[problem])
    on_cpu, _ = BA_PROBLEMS[problem](Camera, optimize, device="cpu", **sizes[problem])
    assert on_card.device.type == "cuda"
    x0 = on_card.values.copy()
    J, J_cpu = on_card._autodiff_jac()(x0), on_cpu._autodiff_jac()(x0)
    assert J.dtype == np.float64 and np.isfinite(J).all()
    assert (np.abs(J - J_cpu) / np.abs(J_cpu).max(axis=0)).max() < 1e-9
    assert on_card.fit(full=True, jac="exact").success


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["nearest", "bilinear", "upsample1"])
def test_sse_modes_on_card_against_cpu(cuda, mode) -> None:
    """Each SSE sampling mode on the card against the CPU at 16 x 256, each
    step from a shared state within 1e-3 (chip_smoke phase 22's check)."""
    from chip_smoke import lockstep_from_shared_state, make_scene, make_tracker

    settings = {"nearest": dict(sse_sample_mode="nearest", sse_upsample=8),
                "bilinear": dict(sse_sample_mode="bilinear", sse_upsample=8),
                "upsample1": dict(sse_sample_mode="bilinear", sse_upsample=1)}[mode]
    frames, camera, rng = make_scene(6)
    points = rng.uniform(128, 384, size=(16, 2))
    draws = np.random.default_rng(22)
    noise = {"init": {"xy": draws.normal(size=(16, 256, 2)).astype(np.float32),
                      "v": draws.normal(size=(16, 256, 3)).astype(np.float32)},
             "a": draws.normal(size=(5, 16, 256, 3)).astype(np.float32),
             "resample_u": draws.random((5, 16)).astype(np.float32)}
    card = make_tracker(camera, points, 256, cuda, **settings)
    cpu = make_tracker(camera, points, 256, torch.device("cpu"), **settings)
    carried, flags = lockstep_from_shared_state(card, cpu, frames[:, None], noise, 5)
    assert carried <= 1e-3 and flags == 0


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    return [torch.device("cuda", 0), torch.device("cuda", 1)]


@pytest.mark.cuda
def test_mesh_on_two_cards_keeps_each_slice_on_its_card(two_cards, tmp_path) -> None:
    """A mesh over two cards: each slice's state and generator on its card,
    the outputs on the tracker's device; from injected draws the run agrees
    with the unsliced one as a free run (cuDNN picks algorithms by batch
    size); a MeshState resumes bit for bit on the same cards."""
    from chip_smoke import free_run_bounds, injected_draws, make_scene, make_tracker
    from glimpse_tpu_torch import parallel
    from glimpse_tpu_torch.track import checkpoint

    frames_np, camera, rng = make_scene(6)
    points = rng.uniform(128, 384, size=(37, 2))
    frames = torch.from_numpy(frames_np).to(two_cards[0])
    noise = injected_draws(37, 256, 5, two_cards[0], seed=3)
    mesh = make_tracker(camera, points, 256, two_cards[0], mesh=parallel.get_mesh(devices=two_cards))
    plain = make_tracker(camera, points, 256, two_cards[0])
    dts = torch.ones(5, device=two_cards[0])
    state, out = mesh.track(torch.Generator(device=two_cards[0]).manual_seed(0), frames[:, None], dts, noise=noise)
    _, want = plain.track(torch.Generator(device=two_cards[0]).manual_seed(0), frames[:, None], dts, noise=noise)
    assert out["mean"].device == two_cards[0]
    free_run_bounds(out["mean"].cpu().numpy(), want["mean"].cpu().numpy())
    for part, card in zip(state.parts, two_cards):
        assert part.generator.device == card and part.particles.device == card and part.templates.device == card
    checkpoint.save_state(state, tmp_path / "mesh.npz")
    restored = checkpoint.load_state(tmp_path / "mesh.npz")
    assert [p.generator.device for p in restored.parts] == two_cards
    a, _ = mesh.step(state, frames[1][None], dts[0])
    b, _ = mesh.step(restored, frames[1][None], dts[0])
    for x, y in zip(a.parts, b.parts):
        assert torch.equal(x.particles, y.particles)


@pytest.mark.cuda
@pytest.mark.parametrize("n, p", [(1024, 1024), (10240, 2048)])
def test_systematic_thresholds_do_not_depend_on_the_batch(cuda, n, p) -> None:
    """The first rows of a batch's threshold table equal those rows' table
    alone, bit for bit: a sliced run (a mesh, or one process a slice)
    resamples the rows the whole run resamples."""
    rng = np.random.default_rng(0)
    weights = torch.from_numpy(np.exp(3 * rng.normal(size=(n, p))).astype(np.float32)).to(cuda)
    u = torch.from_numpy(rng.random(n).astype(np.float32)).to(cuda)
    whole = systematic_thresholds(weights, u)
    for m in (n // 2, n // 4):
        assert torch.equal(whole[:m], systematic_thresholds(weights[:m].contiguous(), u[:m].contiguous()))


WIDE_AND_NARROW = ["bfloat16", "float16", "float64"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", WIDE_AND_NARROW)
@pytest.mark.parametrize(
    "label, shape, size, specials, misaligned", highpass_check_cases(),
    ids=[f"{c[0]}-{'x'.join(map(str, c[1]))}-{c[2][0]}x{c[2][1]}" for c in highpass_check_cases()],
)
def test_highpass_kernel_in_16_and_64_bits(cuda, label, shape, size, specials, misaligned, name) -> None:
    """Phase 3's held cases in bfloat16, float16 and float64 (a misaligned
    stack starts one element past a 16-byte line): the kernel launches,
    returns the tile's dtype and equals the plain version, NaN included."""
    dtype = getattr(torch, name)
    tiles = highpass_case_tiles(shape, specials, misaligned, cuda, dtype=dtype)
    before = median_highpass.launches
    got = median_highpass(tiles, size)
    assert median_highpass.launches == before + 1 and got.dtype == dtype
    torch.testing.assert_close(got, median_highpass_plain(tiles, size), rtol=0, atol=0, equal_nan=True,
                               msg=lambda m: f"{kernel_variant(size, dtype, shape)}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("name", WIDE_AND_NARROW)
@pytest.mark.parametrize("size", sorted(SEPARABLE), ids=[f"{k[0]}x{k[1]}" for k in sorted(SEPARABLE)])
@pytest.mark.parametrize("shape, misaligned", LANE_CASES,
                         ids=[f"{'x'.join(map(str, c[0]))}{'-misaligned' if c[1] else ''}" for c in LANE_CASES])
def test_highpass_kernel_lanes_without_a_partner(cuda, shape, misaligned, size, name) -> None:
    """Stacks the staged 16-bit kernel cannot pair whole (it packs two tiles
    into one register, lane by lane): one tile, odd counts, a partial last
    group, stacks 2 bytes past a 4-byte boundary; ties, NaN in three tiles
    at three places, +-inf. The kernel launches, returns the tile's dtype
    and equals the plain version, NaN included; float64 runs the same
    stacks through its NaN-flag kernel."""
    dtype = getattr(torch, name)
    tiles = highpass_case_tiles(shape, True, misaligned, cuda, seed=shape[0], dtype=dtype)
    before = median_highpass.launches
    got = median_highpass(tiles, size)
    assert median_highpass.launches == before + 1 and got.dtype == dtype
    torch.testing.assert_close(got, median_highpass_plain(tiles, size), rtol=0, atol=0, equal_nan=True,
                               msg=lambda m: f"{kernel_variant(size, dtype, shape)}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", PRECISION_TILES, ids=["x".join(map(str, s)) for s in PRECISION_TILES])
def test_highpass_variant_names_the_design(cuda, shape) -> None:
    """The main paths' stacks take the staged kernel of each dtype's
    design: the float32 network, the packed 16-bit one, the float64 one
    with its NaN flag."""
    assert kernel_variant((5, 5), torch.float32, shape) == "separable<5,5,8>[float32]"
    assert kernel_variant((5, 5), torch.bfloat16, shape) == "separable_packed<5,5,8>[bfloat16]"
    assert kernel_variant((5, 5), torch.float16, shape) == "separable_packed<5,5,8>[float16]"
    assert kernel_variant((5, 5), torch.float64, shape).startswith("separable_nanflag<5,5,")


@pytest.mark.cuda
@pytest.mark.parametrize("name", WIDE_AND_NARROW)
@pytest.mark.parametrize("n, p", [(37, 1024), (3, 20000)])
def test_resample_kernel_in_16_and_64_bits(cuda, n, p, name) -> None:
    """16- and 64-bit payloads over float32 thresholds: exact row copies,
    equal to the plain version."""
    dtype = getattr(torch, name)
    rng = np.random.default_rng(2)
    weights = torch.from_numpy(np.exp(3 * rng.normal(size=(n, p)))).to(cuda, dtype)
    u = torch.from_numpy(rng.random(n).astype(np.float32)).to(cuda)
    particles = torch.from_numpy(rng.normal(size=(n, p, 6))).to(cuda, dtype)
    t = systematic_thresholds(weights, u)
    before = systematic_resample.launches
    got = systematic_resample(t, particles, weights)
    assert systematic_resample.launches == before + 1 and got[0].dtype == got[1].dtype == dtype
    want = systematic_resample_plain(t, particles, weights)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["float32", *WIDE_AND_NARROW])
@pytest.mark.parametrize("shape, size, misaligned", HIGHPASS_LARGE_TILES,
                         ids=[f"{'x'.join(map(str, c[0]))}-{c[1][0]}x{c[1][1]}" for c in HIGHPASS_LARGE_TILES])
def test_highpass_kernel_takes_large_tiles(cuda, shape, size, misaligned, name) -> None:
    """Tiles one block's shared memory cannot hold in float32 (chip_smoke
    phase 3's, one stack one element past a 16-byte line), with ties, NaN
    and +-inf: the kernel launches, by the global route (a few tiles, each
    more work than a block's threads, take it in every dtype, whether or
    not they fit), and equals the plain version, NaN included."""
    dtype = getattr(torch, name)
    tiles = highpass_case_tiles(shape, True, misaligned, cuda, seed=3, dtype=dtype)
    variant = kernel_variant(size, dtype, shape)
    assert "_global" in variant, variant
    before = median_highpass.launches
    got = median_highpass(tiles, size)
    assert median_highpass.launches == before + 1 and got.dtype == dtype
    torch.testing.assert_close(got, median_highpass_plain(tiles, size), rtol=0, atol=0, equal_nan=True,
                               msg=lambda m: f"{variant}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["float32", *WIDE_AND_NARROW])
@pytest.mark.parametrize("tile, size", THIN_TILES, ids=[f"{t[0]}x{t[1]}-{k[0]}x{k[1]}" for t, k in THIN_TILES])
def test_highpass_kernel_takes_tiles_thinner_than_half_the_window(cuda, tile, size, name) -> None:
    """Tiles whose padding reflects more than once (ROADMAP C13), with
    ties, NaN and +-inf: the kernel launches by the folded route, returns
    the tile's dtype and equals the plain version, NaN included."""
    dtype = getattr(torch, name)
    shape = (37, *tile)
    variant = kernel_variant(size, dtype, shape)
    assert variant.startswith("generic_folded<"), variant
    tiles = highpass_case_tiles(shape, True, False, cuda, seed=6, dtype=dtype)
    before = median_highpass.launches
    got = median_highpass(tiles, size)
    assert median_highpass.launches == before + 1 and got.dtype == dtype
    want = median_highpass_plain(tiles, size)
    assert torch.isnan(want).any()
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True, msg=lambda m: f"{variant}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("shape, size, name, spread", [
    ((20480, 31, 31), (5, 5), "float32", False), ((20480, 31, 31), (5, 5), "float64", False),
    ((1024, 31, 31), (7, 5), "float32", False), ((1, 31, 42), (5, 5), "float32", False),
    ((1, 160, 160), (5, 5), "float32", True), ((1, 110, 110), (5, 5), "float64", True),
    ((37, 31, 31), (3, 5), "float32", True), ((2, 260, 260), (3, 5), "bfloat16", True),
])
def test_highpass_route_follows_tile_count_and_work(cuda, shape, size, name, spread) -> None:
    """Stacks that fit in one block's shared memory: many tiles, or tiles
    of no more work items than a block's threads, keep the staged route; a
    few tiles of more work take the global route, which spreads them over
    the card (``kernels/bench_highpass.py --routes``). Either way the kernel
    equals the plain version."""
    dtype = getattr(torch, name)
    variant = kernel_variant(size, dtype, shape)
    assert ("_global" in variant) == spread, variant
    tiles = highpass_case_tiles(shape, True, False, cuda, seed=4, dtype=dtype)
    torch.testing.assert_close(median_highpass(tiles, size), median_highpass_plain(tiles, size), rtol=0, atol=0,
                               equal_nan=True, msg=lambda m: f"{variant}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("name, search", [("float64", (131, 131)), ("float32", (201, 201))])
def test_tracker_takes_search_boxes_past_shared_memory(cuda, name, search) -> None:
    """A float64 tracker with 131 x 131 search boxes and a float32 one with
    201 x 201, whose search tiles one block cannot stage: a step on the card
    launches the high-pass and follows the CPU from the same draws."""
    from chip_smoke import cartesian_motion, make_scene
    from glimpse_tpu_torch.track import batch

    frames, camera, rng = make_scene(2)
    points_xy = rng.uniform(200, 312, size=(8, 2))
    dtype = getattr(torch, name)
    draws = np.random.default_rng(5)
    noise = {
        "init": {"xy": draws.normal(size=(8, 64, 2)).astype(np.float32), "v": draws.normal(size=(8, 64, 3)).astype(np.float32)},
        "a": draws.normal(size=(1, 8, 64, 3)).astype(np.float32), "resample_u": draws.random((1, 8)).astype(np.float32),
    }
    means = {}
    for device in (cuda, torch.device("cpu")):
        motion = cartesian_motion(points_xy, 1.5, (3.0, 3.0, 0.0), (0.2, 0.2, 0.0), device)
        config = batch.BatchConfig(n_particles=64, template_size=(15, 15), search_size=search, dtype=dtype)
        tracker = batch.BatchTracker(camera[None], [None], [0.3], motion, config, device=device)
        images = torch.from_numpy(frames[:, None]).to(device)
        state = tracker.initialize(torch.Generator(device=device).manual_seed(0), images[0], noise=noise["init"])
        before = median_highpass.launches
        _, out = tracker.step(state, images[1], torch.tensor(1.0, device=device),
                              noise={"a": noise["a"][0], "resample_u": noise["resample_u"][0]})
        if device.type == "cuda":
            assert median_highpass.launches == before + 1
            assert "_global" in kernel_variant((5, 5), dtype, (8, *search))
        means[device.type] = out["mean"].double().cpu().numpy()
    assert np.isfinite(means["cuda"]).all()
    np.testing.assert_allclose(means["cuda"], means["cpu"], rtol=0, atol=1e-3)


@pytest.mark.cuda
def test_host_tracker_finishes_a_wide_cloud_on_card(cuda) -> None:
    """chip_smoke phase 16 (f) at its size on a small oblique scene: the
    host Tracker whose particle cloud makes search tiles past 170 x 170
    finishes every track on the card, and each step from the CPU's carried
    particles projects within 0.1 px of the CPU's."""
    from chip_smoke import oblique_points, oblique_scene, wide_cloud_run

    scene = oblique_scene(4, cuda)
    points = oblique_points(scene, 16)
    draws = np.random.default_rng(16)
    n, p, t = 4, 2048, 4
    noise = {
        "init": {"xy": draws.normal(size=(n, p, 2)).astype(np.float32), "z": draws.normal(size=(n, p)).astype(np.float32),
                 "v": draws.normal(size=(n, p, 3)).astype(np.float32)},
        "a": draws.normal(size=(t - 1, n, p, 3)).astype(np.float32),
        "resample_u": draws.random((t - 1, n)).astype(np.float32),
    }
    line, largest = wide_cloud_run(scene, points, noise, {"card": cuda, "cpu": torch.device("cpu")}, p, n_points=n,
                                   n_frames=t)
    assert "_global" in largest["variant"] and largest["variant"] in line


def _graph_scene(cuda, T: int = 12, n: int = 48, **settings):
    """Two observers on 128 x 128 frames, the second late (its template cut
    at step 4, after the step program is built) and masked at step 7, a
    viewshed, ESS resampling and covariances:
    (tracker, frames (T, 2, 128, 128), masks, mask0, per-frame cameras)."""
    import scipy.ndimage

    from glimpse_tpu_torch.track import batch, convert

    rng = np.random.default_rng(13)
    size = 128
    base = scipy.ndimage.gaussian_filter(rng.normal(size=(size + 32, size + 32)), 0.8) * 100
    frames = np.stack([[base[i : i + size, i : i + size], base[i + 2 : i + 2 + size, i : i + size]] for i in range(T)])
    cam = np.zeros(20, np.float32)
    cam[0:3], cam[3:6], cam[6:10] = (size / 2, size / 2, size), (0, -90, 0), size
    cams = np.stack([[cam, cam]] * T)
    cams[:, :, 3] = 0.05 * np.sin(np.arange(T))[:, None]
    flat = {"array": [[0.0]], "x0": 0.0, "y0": 0.0, "dx": 1e30, "dy": 1e30}
    motion = convert.motion_from_numpy(
        {
            "kind": "cartesian", "xy": rng.uniform(40, 88, size=(n, 2)), "xy_sigma": np.ones((n, 2)),
            "v_mean": np.zeros((n, 3)), "v_sigma": np.tile([1.0, 1.0, 0.0], (n, 1)), "a_mean": np.zeros((n, 3)),
            "a_sigma": np.tile([0.1, 0.1, 0.0], (n, 1)), "slope_sigma": np.zeros(n), "dem": flat, "dem_sigma": flat,
            "use_dem_sigma": False,
        },
        cuda,
    )
    viewshed = convert.raster_from_numpy(
        {"array": np.ones((8, 8)), "x0": -size, "y0": 2 * size, "dx": 3 * size / 8, "dy": -3 * size / 8}, cuda
    )
    config = batch.BatchConfig(n_particles=256, template_size=(11, 11), search_size=(25, 25), resample_threshold=0.5,
                               return_covariances=True, **settings)
    tracker = batch.BatchTracker(np.stack([cam, cam]), [None] * 2, [0.3] * 2, motion, config, device=cuda,
                                 viewshed=viewshed)
    masks = np.ones((T - 1, 2), np.float32)
    masks[0:3, 1] = 0.0
    masks[6:7, 1] = 0.0
    return tracker, frames, masks, np.array([1.0, 0.0]), cams


def _step_loop(tracker, generator, frames, masks, mask0, cams=None, lo=0, hi=None, state=None):
    """initialize (unless ``state`` is given), then the eager ``step`` from
    frame ``lo + 1`` to ``hi``: (state, time-major outputs, the kernels'
    launches)."""
    from glimpse_tpu_torch.track import batch

    dtype = tracker.config.dtype
    images = batch._as_tensor(frames, tracker.device, dtype)
    cams = None if cams is None else torch.as_tensor(cams, device=tracker.device)
    hi = len(frames) - 1 if hi is None else hi
    _, plan = tracker._template_plan(masks, mask0)
    before = (median_highpass.launches, systematic_resample.launches)
    if state is None:
        state = tracker.initialize(generator, images[0], obs_mask0=tuple(mask0 > 0),
                                   camera_vectors=None if cams is None else cams[0])
    outs = []
    for i in range(lo, hi):
        state, out = tracker.step(
            state, images[1 + i], torch.tensor(1.0, dtype=dtype, device=tracker.device),
            obs_mask=batch._as_tensor(masks[i], tracker.device, dtype), init_template_for=plan.get(i + 1, ()),
            camera_vectors=None if cams is None else cams[1 + i],
        )
        outs.append(out)
    launches = (median_highpass.launches - before[0], systematic_resample.launches - before[1])
    return state, {k: torch.stack([o[k] for o in outs]) for k in outs[0]}, launches


def _programs(monkeypatch):
    """Record every StepProgram built and every call of one."""
    from glimpse_tpu_torch.track import batch

    seen = {"built": [], "calls": 0}
    init, call = batch.StepProgram.__init__, batch.StepProgram.__call__

    def built(self, *args):
        init(self, *args)
        seen["built"].append(self)

    def called(self, *args):
        seen["calls"] += 1
        return call(self, *args)

    monkeypatch.setattr(batch.StepProgram, "__init__", built)
    monkeypatch.setattr(batch.StepProgram, "__call__", called)
    return seen


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["einsum", "nearest", "bilinear"])
@pytest.mark.parametrize("name", ["float32", "bfloat16", "float16", "float64"])
@pytest.mark.parametrize("entry", ["track", "track_stream"])
def test_graphed_run_equals_the_step_loop_on_card(cuda, monkeypatch, entry, name, mode) -> None:
    """``track`` and ``track_stream(chunk=8)`` with per-frame cameras replay
    one captured graph a step after the first (the late observer's template
    step eager between replays, the next replay copying its state in): bit
    for bit the eager step loop's outputs
    and state from the same generator seed, the generator's next draw the
    same, and both kernels' launch counts the same."""
    from glimpse_tpu_torch.track import batch

    dtype = getattr(torch, name)
    tracker, frames, masks, mask0, cams = _graph_scene(cuda, sse_sample_mode=mode, dtype=dtype)
    T = len(frames)
    generators = [torch.Generator(device=cuda).manual_seed(21) for _ in range(2)]
    want_state, want, want_launches = _step_loop(tracker, generators[1], frames, masks, mask0,
                                                 cams=None if entry == "track" else cams)
    seen = _programs(monkeypatch)
    before = (median_highpass.launches, systematic_resample.launches)
    if entry == "track":
        state, out = tracker.track(generators[0], frames, np.ones(T - 1), obs_masks=masks, obs_mask0=mask0)
    else:
        state, outputs = tracker.track_stream(generators[0], frames[0], iter(frames[1:]), np.ones(T - 1),
                                              camera_vectors_seq=cams, obs_masks=masks, obs_mask0=mask0, chunk=8)
        assert [len(o["mean"]) for o in outputs] == [1] * 8 + [3]
        out = {k: torch.cat([o[k] for o in outputs]) for k in outputs[0]}
    assert (median_highpass.launches - before[0], systematic_resample.launches - before[1]) == want_launches
    assert len(seen["built"]) == 1 and seen["built"][0].graph is not None and seen["calls"] == T - 3
    # One high-pass, one resample, in the einsum mode one spline read, and one front end a replay; on a
    # flat DEM without a sigma no DEM prior.
    assert seen["built"][0].graph.launches == {"highpass": 1, "resample": 1, "spline": 1 if mode == "einsum" else 0,
                                               "project": 1, "prior": 0}
    for k in want:
        assert torch.equal(out[k], want[k]), k
    for field in batch.STATE_FIELDS:
        assert torch.equal(getattr(state, field), getattr(want_state, field)), field
    assert torch.equal(generators[0].get_state(), generators[1].get_state())
    assert torch.equal(*(torch.randn(7, generator=g, device=cuda) for g in generators))
    assert torch.isfinite(out["mean"]).all() and (out["valid"] == 1).all()


#: The spans a replayed step times on the card, by event nodes of its graph.
REPLAYED_SPANS = ("step", "step.evolve", "step.validity", "step.weights", "step.resample", "ops.project_extract",
                  "ops.histogram_match", "ops.highpass", "ops.sse", "ops.prefilter", "ops.spline_read")


@pytest.mark.cuda
def test_span_events_leave_replays_bit_equal_and_time_each_span_on_card(cuda) -> None:
    """``track`` with the program's spans recording (event-record nodes
    captured in the step's graph) against the same run without: bit-equal
    outputs and state; each span of the replayed step has one sample of
    positive device time, and its stages together take no longer than the
    step; the late observer's template step, eager only, has eager time."""
    from glimpse_tpu_torch import profiling
    from glimpse_tpu_torch.track import batch

    tracker, frames, masks, mask0, _ = _graph_scene(cuda)
    T = len(frames)
    runs = {}
    for on in (False, True):
        profiling.reset()
        with profiling.tracing(on):
            state, out = tracker.track(torch.Generator(device=cuda).manual_seed(9), frames, np.ones(T - 1),
                                       obs_masks=masks, obs_mask0=mask0)
        runs[on] = (state, out, profiling.report())
    profiling.reset()
    for k in runs[False][1]:
        assert torch.equal(runs[True][1][k], runs[False][1][k]), k
    for field in batch.STATE_FIELDS:
        assert torch.equal(getattr(runs[True][0], field), getattr(runs[False][0], field)), field
    assert runs[False][2]["spans"] == {}
    spans, counters = runs[True][2]["spans"], runs[True][2]["counters"]
    for name in REPLAYED_SPANS:
        assert spans[name]["replay_samples"] == 1 and spans[name]["replay_device_s"] > 0, name
        assert spans[name]["eager_device_s"] > 0, name
    assert spans["step.template"]["replay_samples"] == 0 and spans["step.template"]["eager_device_s"] > 0
    stages = sum(spans[name]["replay_device_s"] for name in REPLAYED_SPANS[1:])
    assert stages <= spans["step"]["replay_device_s"]
    assert spans["graph.capture"]["programs"] == ["the tracking step"] and spans["graph.capture"]["parent"] == "entry.call"
    assert counters["graph.captures"] == 1 and counters["entry.calls"] == 1
    assert counters["entry.eager_steps"] == 2 and counters["entry.replays"] == T - 3


@pytest.mark.cuda
def test_dem_prior_replays_equal_the_step_loop_on_card(cuda) -> None:
    """A motion on a DEM with a sigma raster, so each step's weights carry
    the prior's two bilinear reads a particle, with the program's spans
    recording (``step.prior``'s event nodes in the captured graph): ``track``
    equals the eager step loop bit for bit, outputs, state and the
    generator's next draw, and the prior has device time in the replayed
    step. The prior kernel launches once a step, eager or replayed, and once
    under the graph's capture."""
    import dataclasses

    from glimpse_tpu_torch import profiling
    from glimpse_tpu_torch.kernels.prior import dem_prior
    from glimpse_tpu_torch.track import batch, convert

    flat, frames, masks, mask0, _ = _graph_scene(cuda)
    rng = np.random.default_rng(17)
    grid = {"x0": -128.0, "y0": 256.0, "dx": 24.0, "dy": -24.0}
    motion = dataclasses.replace(
        flat.motion, use_dem_sigma=True,
        dem=convert.raster_from_numpy(dict(grid, array=rng.normal(size=(16, 16)) * 2), cuda),
        dem_sigma=convert.raster_from_numpy(dict(grid, array=rng.uniform(0.3, 1.5, size=(16, 16))), cuda),
    )
    tracker = batch.BatchTracker(flat.camera_vectors, [None] * 2, [0.3] * 2, motion, flat.config, device=cuda,
                                 viewshed=flat.viewshed)
    assert tracker.motion.informative
    T = len(frames)
    generators = [torch.Generator(device=cuda).manual_seed(23) for _ in range(2)]
    profiling.reset()
    with profiling.tracing(True):
        launches = dem_prior.launches
        want_state, want, _ = _step_loop(tracker, generators[1], frames, masks, mask0)
        assert dem_prior.launches == launches + T - 1
        launches, captured = dem_prior.launches, dem_prior.captured
        state, out = tracker.track(generators[0], frames, np.ones(T - 1), obs_masks=masks, obs_mask0=mask0)
    assert dem_prior.captured == captured + 1 and dem_prior.launches == launches + T - 1
    report = profiling.report()
    profiling.reset()
    for k in want:
        assert torch.equal(out[k], want[k]), k
    for field in batch.STATE_FIELDS:
        assert torch.equal(getattr(state, field), getattr(want_state, field)), field
    assert torch.equal(*(torch.randn(7, generator=g, device=cuda) for g in generators))
    prior = report["spans"]["step.prior"]
    assert prior["parent"] == "step" and prior["replay_samples"] == 1 and prior["replay_device_s"] > 0
    assert report["counters"]["motion.informative_calls"] == 1


@pytest.mark.cuda
def test_capture_waits_for_the_callers_queued_work(cuda) -> None:
    """capture_begin fills a registered generator's seed and offset on the
    capture stream, in tensors allocated on the caller's stream: the capture
    stream first waits for the caller's queued work, so an event recorded on
    it after the capture is not done while the caller's stream still runs."""
    from glimpse_tpu_torch import graphs

    generator = torch.Generator(device=cuda).manual_seed(0)
    shift = torch.zeros(16, device=cuda)
    torch.cuda.synchronize()
    torch.cuda._sleep(2_000_000_000)  # about a second of the caller's stream
    graph = graphs.Graph(lambda: torch.rand(16, generator=generator, device=cuda) + shift, cuda, "a probe",
                         generators=(generator,))
    captured = torch.cuda.Event()
    captured.record(graph.stream)
    waited = not captured.query()
    torch.cuda.synchronize()
    assert waited


@pytest.mark.cuda
def test_graphed_outputs_survive_later_replays_on_card(cuda, monkeypatch) -> None:
    """Each output ``track`` stacks is a copy out of the graph's pool: the
    whole list after the run equals snapshots taken as each step returned."""
    tracker, frames, masks, mask0, _ = _graph_scene(cuda)
    from glimpse_tpu_torch.track import batch

    snapshots, kept = [], []
    call = batch.StepProgram.__call__

    def spy(self, state, inputs):
        new_state, out = call(self, state, inputs)
        snapshots.append({k: v.clone() for k, v in out.items()})
        kept.append(out)
        return new_state, out

    monkeypatch.setattr(batch.StepProgram, "__call__", spy)
    tracker.track(torch.Generator(device=cuda).manual_seed(2), frames, np.ones(len(frames) - 1), obs_masks=masks,
                  obs_mask0=mask0)
    assert len(kept) == len(frames) - 3
    for out, snapshot in zip(kept, snapshots):
        for k in snapshot:
            assert torch.equal(out[k], snapshot[k]), k


@pytest.mark.cuda
def test_graphed_calls_share_one_pool_on_card(cuda) -> None:
    """Every call's programs capture into the one memory pool of this
    thread's capture context and give its blocks back at the call's end: the
    next call reuses them, so later calls reserve no more device memory, and
    every graph-pool segment belongs to that pool."""
    from glimpse_tpu_torch import graphs

    tracker, frames, masks, mask0, _ = _graph_scene(cuda)

    def run(seed):
        tracker.track(torch.Generator(device=cuda).manual_seed(seed), frames, np.ones(len(frames) - 1),
                      obs_masks=masks, obs_mask0=mask0)
        torch.cuda.synchronize()
        assert tracker._programs == {}
        pools = {tuple(s["segment_pool_id"]) for s in torch.cuda.memory_snapshot()
                 if tuple(s.get("segment_pool_id", (0, 0))) != (0, 0)}
        return torch.cuda.memory_reserved(), pools

    first, pools = run(0)
    anchor = graphs.capture_context()[1]
    assert anchor is not None and pools == {tuple(anchor.pool())}
    for seed in (1, 2, 3):
        assert run(seed) == (first, pools)
    assert graphs.capture_context()[1] is anchor


@pytest.mark.cuda
def test_graphed_checkpoint_resumes_bit_exactly_on_card(cuda, tmp_path) -> None:
    """A state that replays produced, saved after step 5 and loaded, runs
    on through the step programs (its first step eager, the rest replays)
    to the uninterrupted graphed run's outputs, state and generator, bit for
    bit."""
    from glimpse_tpu_torch.track import batch, checkpoint

    tracker, frames, masks, mask0, _ = _graph_scene(cuda)
    T = len(frames)
    whole, out = tracker.track(torch.Generator(device=cuda).manual_seed(5), frames, np.ones(T - 1), obs_masks=masks,
                               obs_mask0=mask0)
    half, _ = tracker.track(torch.Generator(device=cuda).manual_seed(5), frames[:6], np.ones(5), obs_masks=masks[:5],
                            obs_mask0=mask0)
    checkpoint.save_state(half, tmp_path / "state.npz")
    state = checkpoint.load_state(tmp_path / "state.npz")
    images = batch._as_tensor(frames, cuda, torch.float32)
    masks_t = batch._as_tensor(masks, cuda, torch.float32)
    outs = []
    for i in range(5, T - 1):
        state, step_out = tracker._advance(state, images[1 + i], torch.ones((), device=cuda), obs_mask=masks_t[i])
        outs.append(step_out)
    assert isinstance(list(tracker._programs.values())[0], batch.StepProgram)
    tracker._release()
    for k in out:
        assert torch.equal(torch.stack([o[k] for o in outs]), out[k][5:]), k
    for field in batch.STATE_FIELDS:
        assert torch.equal(getattr(state, field), getattr(whole, field)), field
    assert torch.equal(state.generator.get_state(), whole.generator.get_state())


@pytest.mark.cuda
def test_graphed_mesh_on_one_card_equals_its_step_loop(cuda) -> None:
    """Two mesh slices on one card, each replaying its own graph with its
    own generator: bit for bit the mesh's eager step loop."""
    from glimpse_tpu_torch import parallel
    from glimpse_tpu_torch.track import batch

    tracker, frames, masks, mask0, _ = _graph_scene(cuda)
    mesh = batch.BatchTracker(tracker.camera_vectors, tracker.corrections, tracker.sigmas, tracker.motion,
                              tracker.config, device=cuda, viewshed=tracker.viewshed,
                              mesh=parallel.get_mesh(devices=[cuda, cuda]))
    T = len(frames)
    before = (median_highpass.launches, systematic_resample.launches)
    state, out = mesh.track(torch.Generator(device=cuda).manual_seed(8), frames, np.ones(T - 1), obs_masks=masks,
                            obs_mask0=mask0)
    graphed = (median_highpass.launches - before[0], systematic_resample.launches - before[1])
    images = batch._as_tensor(frames, cuda, torch.float32)
    _, plan = mesh._template_plan(masks, mask0)
    before = (median_highpass.launches, systematic_resample.launches)
    want = mesh.initialize(torch.Generator(device=cuda).manual_seed(8), images[0], obs_mask0=(True, False))
    outs = []
    for i in range(T - 1):
        want, step_out = mesh.step(want, images[1 + i], torch.ones((), device=cuda),
                                   obs_mask=batch._as_tensor(masks[i], cuda, torch.float32),
                                   init_template_for=plan.get(i + 1, ()))
        outs.append(step_out)
    assert graphed == (median_highpass.launches - before[0], systematic_resample.launches - before[1])
    for k in out:
        assert torch.equal(out[k], torch.stack([o[k] for o in outs])), k
    for mine, theirs in zip(state.parts, want.parts):
        assert torch.equal(mine.particles, theirs.particles)
        assert torch.equal(mine.generator.get_state(), theirs.generator.get_state())


def _value_and_grad_of(f):
    def value_and_grad(x):
        x = x.detach().requires_grad_(True)
        v = f(x)
        return v.detach(), torch.autograd.grad(v, x)[0]

    return value_and_grad


def _rosenbrock(x):
    return (100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2).sum()


@pytest.mark.cuda
def test_lbfgs_programs_equal_eager_on_card(cuda, monkeypatch) -> None:
    """``ObserverCameras.fit`` on 20 frames through ``LBFGSPrograms`` (each
    evaluation and each direction past its first a graph replay) and
    through the eager tensor steps, memory 4 so that the history fills and
    shifts by copy for many iterations: bit for bit the same view
    directions, value, gradient norm, iterations and message. A second
    object with another objective and shape (a 40-dimensional Rosenbrock
    function) captures its own graphs and equals ``optimize.lbfgs``; the
    first fit, run again after it, still does."""
    from test_torch_stab_programs import observer_scene

    from glimpse_tpu_torch import optimize

    observer, matches = observer_scene()
    model = optimize.ObserverCameras(observer, matches=matches, anchors=[0], device=cuda)
    built = []
    programs = optimize.LBFGSPrograms

    def recorded(*args):
        built.append(programs(*args))
        return built[-1]

    monkeypatch.setattr(optimize, "LBFGSPrograms", recorded)
    got = model.fit(maxiter=300, memory_size=4)
    steps = built[-1]
    assert steps.evaluation.graph is not None and steps.directions[4].graph is not None
    assert all(steps.directions[level].graph is None for level in range(4))  # each ran once, eagerly
    x0 = torch.from_numpy(np.random.default_rng(0).normal(size=40).astype(np.float32)).to(cuda)
    rosenbrock = optimize._lbfgs_loop(programs(_value_and_grad_of(_rosenbrock), x0, 5), 80, 1e-7, 5)
    again = model.fit(maxiter=300, memory_size=4)
    monkeypatch.setattr(optimize, "LBFGSPrograms", lambda value_and_grad, x0, memory: optimize._TensorSteps(
        value_and_grad, x0))
    want = model.fit(maxiter=300, memory_size=4)
    for fit in (got, again):
        assert np.array_equal(fit.x, want.x) and fit.fun == want.fun and fit.grad_norm == want.grad_norm
        assert fit.nit == want.nit and fit.message == want.message
    eager = optimize.lbfgs(_value_and_grad_of(_rosenbrock), x0, max_iter=80, memory=5)
    assert rosenbrock[1] == eager[1] and rosenbrock[3] == eager[3]
    assert torch.equal(rosenbrock[0], eager[0]) and torch.equal(rosenbrock[2], eager[2])


@pytest.mark.cuda
@pytest.mark.parametrize("problem", ["points", "matches", "lines"])
def test_jacobian_program_equals_jacfwd_on_card(cuda, problem) -> None:
    """The exact Jacobian's program (eager first call, then a captured
    graph) against the eager ``jacfwd`` at four points, bit for bit; a row
    subset gets a program and a graph of its own."""
    from chip_smoke import BA_PROBLEMS
    from glimpse_tpu_torch import Camera, optimize

    sizes = {"points": dict(n_cams=3, n_points=200), "matches": dict(n_cams=3, n_pts=200), "lines": dict(n_cams=2, n_ridge=100, n_obs=150)}
    model, _ = BA_PROBLEMS[problem](Camera, optimize, device=cuda, **sizes[problem])
    x0 = model.values.copy()
    subset = np.arange(0, model.size, 3)
    for index in (slice(None), subset):
        rows = None if isinstance(index, slice) else subset
        closures = model._build_autodiff_residual(rows)
        base = torch.as_tensor(np.stack([c.to_array() for c in model.cams + closures[3]]), device=cuda)
        jac = model._autodiff_jac(index)
        for k in range(4):
            x = x0 + 1e-3 * k
            want = optimize._exact_jacobian(*closures[:3], torch.as_tensor(x, device=cuda), base).cpu().numpy()
            assert np.array_equal(jac(x), want)
    assert [p.program.graph is not None for p in model._jac_cache["programs"].values()] == [True, True]


@pytest.mark.cuda
def test_chunk_programs_equal_eager_on_card(cuda) -> None:
    """Refinement, detection and matching programs: three calls each (the
    eager first, the capture, a replay) on changing inputs, each bit for
    bit the eager function's."""
    import scipy.ndimage

    from glimpse_tpu_torch.ops import features, matching, refine

    rng = np.random.default_rng(7)
    texture = scipy.ndimage.gaussian_filter(rng.normal(size=(4, 160, 160)), (0, 1.5, 1.5))
    images = np.clip(128 + 600 * texture, 0, 255).astype(np.uint8)
    masks = (rng.random(images.shape) > 0.1).astype(np.uint8)
    tiles = torch.from_numpy(images.astype(np.float32)).to(cuda)
    ca = rng.integers(0, 140, size=(2, 64, 2))
    cb = np.clip(ca - 7 + rng.integers(-3, 4, size=ca.shape), 0, 160 - 25)
    programs = []
    for C, N, B, K, n_pad in ((2, 64, 2, 256, 256), (1, 32, 1, 128, 128)):  # a second shape: programs of its own
        chunk = refine.ChunkProgram(C, N, 160, 160, 11, 25, 4, cuda)
        detect = features.BatchProgram((B, 160, 160), True, cuda, nfeatures=K, n_octaves=3)
        match = matching.BatchProgram(B, n_pad, n_pad, 128, True, cuda)
        programs.append((chunk, detect, match))
        for k in range(3):
            a, b = tiles.roll(k, 0)[:C], tiles[2:2 + C]
            got = chunk(list(a), list(b), ca[:C, :N], cb[:C, :N])
            want = refine.refine_chunk(a, b, torch.from_numpy(ca[:C, :N]).to(cuda), torch.from_numpy(cb[:C, :N]).to(cuda),
                                       11, 25, 4)
            assert all(np.array_equal(g, w.cpu().numpy()) for g, w in zip(got, want))
            batch = np.roll(images, k, 0)[:B]
            got = [t.cpu() for t in detect(batch, masks[:B])]
            want = features.detect_batch(torch.from_numpy(batch).to(cuda), torch.from_numpy(masks[:B]).to(cuda),
                                         nfeatures=K, n_octaves=3)
            assert all(torch.equal(g, w.cpu()) for g, w in zip(got, want))
            da, db = (torch.from_numpy(rng.normal(size=(B, n_pad, 128)).astype(np.float32)).to(cuda) for _ in range(2))
            na, nb = [n_pad, n_pad - 56][:B], [n_pad - 76, n_pad][:B]
            got = match(list(da), list(db), na, nb, 0.8)
            want = matching.match_batch(da, db, torch.tensor(na, device=cuda), torch.tensor(nb, device=cuda),
                                        float(np.float32(0.8)), True)
            assert all(np.array_equal(g, w.cpu().numpy()) for g, w in zip(got, want))
    captured = {p.program.graph for triple in programs for p in triple}
    assert None not in captured and len(captured) == 6


@pytest.mark.cuda
def test_uncapturable_step_raises_on_card(cuda, monkeypatch) -> None:
    """A step that reads the card on the host (an ``.item()``) cannot be
    captured: ``track`` raises with CUDA's reason and does not fall back
    to the eager loop."""
    from glimpse_tpu_torch.track import batch

    tracker, frames, masks, mask0, _ = _graph_scene(cuda, T=5)
    moments = batch.particle_moments

    def host_read(particles, weights):
        if float(weights.sum().item()) <= 0:
            raise AssertionError("no weight")
        return moments(particles, weights)

    monkeypatch.setattr(batch, "particle_moments", host_read)
    calls = []
    step = tracker.step

    def counted(*args, **kwargs):
        calls.append(torch.cuda.is_current_stream_capturing())
        return step(*args, **kwargs)

    monkeypatch.setattr(tracker, "step", counted)
    with pytest.raises(RuntimeError, match="captur"):
        tracker.track(torch.Generator(device=cuda).manual_seed(0), frames, np.ones(len(frames) - 1), obs_masks=masks,
                      obs_mask0=mask0)
    # Step 1 eager, step 2's capture failed; no step ran after it.
    assert calls == [False, True]
    assert tracker._programs == {}
    assert float(torch.ones(3, device=cuda).sum()) == 3.0


def _host_read(fn):
    """``fn`` with a read of the card on the host before it runs."""

    def reads(*args, **kwargs):
        if float(torch.ones(1, device="cuda").sum()) != 1.0:
            raise AssertionError("unreachable")
        return fn(*args, **kwargs)

    return reads


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["jacobian", "refine", "detect", "match"])
def test_uncapturable_chunk_programs_raise_on_card(cuda, monkeypatch, kind) -> None:
    """Each of the Jacobian, refinement, detection and matching programs,
    its body made to read on the host: the first call runs eagerly, the
    second raises at the capture, naming the program."""
    from chip_smoke import BA_PROBLEMS
    from glimpse_tpu_torch import Camera, optimize
    from glimpse_tpu_torch.ops import features, matching, refine

    images = np.random.default_rng(8).integers(0, 256, size=(1, 64, 64), dtype=np.uint8)
    if kind == "jacobian":
        monkeypatch.setattr(optimize, "_exact_jacobian", _host_read(optimize._exact_jacobian))
        model, _ = BA_PROBLEMS["points"](Camera, optimize, device=cuda, n_cams=2, n_points=50)
        jac = model._autodiff_jac()
        call, name = (lambda: jac(model.values)), "the exact Jacobian"
    elif kind == "refine":
        monkeypatch.setattr(refine, "refine_chunk", _host_read(refine.refine_chunk))
        tiles = [torch.from_numpy(images[0].astype(np.float32)).to(cuda)]
        corners = np.zeros((1, 4, 2), np.int64)
        program = refine.ChunkProgram(1, 4, 64, 64, 11, 25, 4, cuda)
        call, name = (lambda: program(tiles, tiles, corners, corners)), "match refinement"
    elif kind == "detect":
        monkeypatch.setattr(features, "detect_batch", _host_read(features.detect_batch))
        program = features.BatchProgram(images.shape, False, cuda, nfeatures=16, n_octaves=2)
        call, name = (lambda: program(images)), "keypoint detection"
    else:
        monkeypatch.setattr(matching, "match_batch", _host_read(matching.match_batch))
        stacks = [torch.ones((8, 128), device=cuda)]
        program = matching.BatchProgram(1, 8, 8, 128, False, cuda)
        call, name = (lambda: program(stacks, stacks, [8], [8], 0.8)), "descriptor matching"
    call()
    with pytest.raises(RuntimeError, match=f"{name}.* cannot be captured"):
        call()


@pytest.mark.cuda
def test_uncapturable_programs_raise_on_card(cuda) -> None:
    """A program body that reads the card on the host runs eagerly at its
    first call and raises at its capture, naming the program; an L-BFGS
    objective that does so raises from the fit at its second evaluation,
    with no eager fallback. A failed capture leaves the thread's pool as it
    was: a later program captures into it."""
    from glimpse_tpu_torch import graphs, optimize

    x = torch.ones(4, device=cuda)
    program = graphs.Program(lambda: x * float(x.sum()), cuda, "a test program")
    assert torch.equal(program(), x * 4)
    with pytest.raises(RuntimeError, match="a test program cannot be captured"):
        program()

    def reads(flat):
        if float(flat.sum()) > 1e9:
            raise AssertionError("unreachable")
        return _rosenbrock(flat)

    steps = optimize.LBFGSPrograms(_value_and_grad_of(reads), torch.zeros(6, device=cuda), 5)
    with pytest.raises(RuntimeError, match="an L-BFGS evaluation cannot be captured"):
        optimize._lbfgs_loop(steps, 10, 1e-7, 5)
    assert steps.evaluations == 1
    later = graphs.Program(lambda: x * 2, cuda, "a later program")
    for _ in range(3):
        assert torch.equal(later(), x * 2)
    assert later.graph is not None


# The front end: the benchmark cells' (cut to fewer points), a particle count
# past one block's (taken in chunks) and a small odd one: (O, N, P, H, W,
# th, tw, sh, sw).
PROJECT_CARD_SHAPES = ((2, 2048, 2048, 512, 512, 15, 15, 31, 31), (1, 1024, 2048, 1024, 1024, 15, 15, 41, 41),
                       (1, 2048, 2048, 512, 512, 15, 15, 41, 41), (2, 64, 5000, 128, 96, 5, 7, 21, 17),
                       (3, 37, 100, 40, 50, 3, 3, 9, 11))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["float32", "bfloat16", "float16", "float64"])
@pytest.mark.parametrize("shape", PROJECT_CARD_SHAPES, ids=["x".join(map(str, s[:3])) for s in PROJECT_CARD_SHAPES])
def test_project_kernel_equals_its_plain_version(cuda, shape, name) -> None:
    """Particles behind the camera and at NaN, corners clamped at all four
    edges, distortion and an elevation correction
    (``bench_project.inputs``), in each particle type: one launch, and
    ``bench_project.check``: tiles, cols and rows bit-equal to the plain
    version where the corners agree, a corner moved only at a half-pixel
    tie of the plain mean (the two sum the weighted means in other orders)."""
    from glimpse_tpu_torch.kernels import bench_project, project

    args = bench_project.inputs(shape, getattr(torch, name), cuda, seed=sum(shape))
    before = project.project_extract.launches
    got = project.project_extract(**args)
    assert project.project_extract.launches == before + 1
    want = project.project_extract_plain(**args)
    means = bench_project.plain_means(**args)
    held = bench_project.check(got, want, means, args["search_size"])
    assert held["ties"] <= max(1, held["points"] // 1000)
    O, H, W = args["images"].shape
    sh, sw = args["search_size"]
    assert (means[:, 0] < sw / 2).any() and (means[:, 0] > W - sw / 2).any()
    assert (means[:, 1] < sh / 2).any() and (means[:, 1] > H - sh / 2).any()
    assert (want[1] < -1e5).any()


@pytest.mark.cuda
@pytest.mark.parametrize("name, duv", [("bfloat16", "bfloat16"), ("float16", "float16"), ("float32", "float32")])
def test_project_kernel_takes_narrow_offsets(cuda, name, duv) -> None:
    """Template offsets of the particles' own type (a 16-bit tracker whose
    observers all start late holds them so), as the plain version promotes
    them."""
    from glimpse_tpu_torch.kernels import bench_project, project

    shape = (2, 512, 700, 200, 160, 7, 9, 17, 19)
    args = bench_project.inputs(shape, getattr(torch, name), cuda, seed=11, duv_dtype=getattr(torch, duv))
    got = project.project_extract(**args)
    want = project.project_extract_plain(**args)
    assert got[1].dtype == project.compute_dtype(getattr(torch, name))
    held = bench_project.check(got, want, bench_project.plain_means(**args), args["search_size"])
    assert held["max_abs_err"] == 0.0


@pytest.mark.cuda
def test_project_kernel_captured_equals_eager(cuda) -> None:
    """A call captured in a CUDA graph counts in ``captured``; each replay
    adds one launch and writes what an eager call writes."""
    from glimpse_tpu_torch import graphs
    from glimpse_tpu_torch.kernels import bench_project, project

    args = bench_project.inputs(PROJECT_CARD_SHAPES[0], torch.float32, cuda, seed=5)
    eager = project.project_extract(**args)
    captured, launches = project.project_extract.captured, project.project_extract.launches
    graph = graphs.Graph(lambda: project.project_extract(**args), cuda, "the front end")
    assert project.project_extract.captured == captured + 1 and project.project_extract.launches == launches
    for replay in range(1, 3):
        for out in graph.outputs:
            out.zero_()
        outs = graph.replay()
        torch.cuda.synchronize()
        assert project.project_extract.launches == launches + replay
        for out, want in zip(outs, eager):
            assert torch.equal(out, want)
