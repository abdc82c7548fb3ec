"""The port in bfloat16, float16 and float64 against the reference, on the CPU.

Inputs are made from a numpy seed and go through the JAX function and its
counterpart in the port. The reference follows its production routes: the
Pallas high-pass and resample kernels (interpret mode), whose systematic
threshold table is float32 in every dtype; float64, which the TPU does not
have, on its XLA routes under ``jax.enable_x64(True)`` (scoped, never the
global flag).

Kernels are held bit for bit. Elsewhere XLA keeps float32 intermediates
inside a fusion where torch rounds after every op, so the bar is the
precision the dtype gives: |port - reference in T| <= max |reference in T -
reference in float32| over the same (float32) inputs, plus one ulp of T at
the output's magnitude (:func:`assert_within_rule`; each assertion states
both numbers).
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

from chip_smoke import highpass_tiles
from glimpse_tpu import Camera as RefCamera
from glimpse_tpu.kernels.highpass_pallas import median_highpass as pallas_highpass
from glimpse_tpu.kernels.resample_pallas import systematic_resample_gather
from glimpse_tpu.ops import imageproc as jax_imageproc
from glimpse_tpu.ops import ncc as jax_ncc
from glimpse_tpu.ops import projection as jax_projection
from glimpse_tpu.ops import sampling as jax_sampling
from glimpse_tpu.track import batch as jax_batch
from glimpse_tpu_torch import parallel
from glimpse_tpu_torch.kernels.highpass import median_highpass
from glimpse_tpu_torch.kernels.resample import systematic_resample, systematic_resample_plain
from glimpse_tpu_torch.ops import imageproc, ncc, projection, resampling, sampling
from glimpse_tpu_torch.track import batch, checkpoint, convert
from test_batch_tracker import make_motion, make_scene

SIXTEEN = {"bfloat16": (torch.bfloat16, jnp.bfloat16), "float16": (torch.float16, jnp.float16)}


def to_numpy(x) -> np.ndarray:
    """A tensor or JAX array as float64 NumPy (16-bit values widen exactly)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().float() if x.element_size() == 2 else x.detach()
        return x.numpy().astype(np.float64)
    return np.asarray(jnp.asarray(x).astype(jnp.float32) if x.dtype.itemsize == 2 else x, dtype=np.float64)


def ulp(dtype: torch.dtype, magnitude: float) -> float:
    """The spacing of ``dtype`` at ``magnitude``."""
    return torch.finfo(dtype).eps * 2.0 ** np.floor(np.log2(max(magnitude, torch.finfo(dtype).tiny)))


def assert_within_rule(port, ref_t, ref_32, dtype: torch.dtype, what: str) -> None:
    """|port - ref_t| <= max |ref_t - ref_32| + one ulp of ``dtype`` at the
    output's magnitude, NaN where the reference has NaN."""
    port, ref_t, ref_32 = (to_numpy(x) for x in (port, ref_t, ref_32))
    np.testing.assert_array_equal(np.isnan(port), np.isnan(ref_t), err_msg=f"{what}: NaN mask")
    finite = np.isfinite(ref_t) & np.isfinite(ref_32)
    error = np.abs(port - ref_t)[finite].max()
    budget = np.abs(ref_t - ref_32)[finite].max() + ulp(dtype, np.abs(ref_t[finite]).max())
    assert error <= budget, (
        f"{what} in {dtype}: |port - reference| = {error:.6g} > |reference in {dtype} - reference in"
        f" float32| + 1 ulp = {budget:.6g}"
    )


# ---- Kernels: bit for bit ---- #

HIGHPASS_CASES = [
    ((6, 31, 31), (5, 5)), ((6, 41, 41), (5, 5)), ((6, 15, 15), (5, 5)),  # the main path's tiles
    ((5, 15, 15), (3, 3)), ((5, 15, 15), (7, 7)), ((5, 17, 13), (3, 7)), ((5, 15, 15), (9, 5)),
    ((5, 15, 15), (3, 11)), ((5, 3, 3), (5, 5)), ((3, 9, 11), (3, 9)),
]


@pytest.mark.parametrize("name", SIXTEEN)
@pytest.mark.parametrize("shape, size", HIGHPASS_CASES)
def test_highpass_plain_16_bit_is_the_pallas_kernel(shape, size, name) -> None:
    """The plain version in bfloat16 and float16, on tiles of ties, NaN at a
    corner, an edge and inside, and +-inf (``chip_smoke.highpass_tiles``),
    equals the reference's sort median bit for bit, in the tile's dtype,
    and the Pallas kernel (interpret mode) for windows of at most 25 taps.
    Above 25 taps (7x7, 9x5, 3x11) XLA's CPU compiler outgrew a 16 GB
    address-space limit compiling the interpreted 16-bit network, so there
    the sort median alone holds the port, as it holds the Pallas kernel in
    float32."""
    tdtype, jdtype = SIXTEEN[name]
    x = highpass_tiles(shape, seed=3)
    ours = median_highpass(torch.from_numpy(x).to(tdtype), size)
    assert ours.dtype == tdtype
    references = [jax_imageproc.highpass(jnp.asarray(x).astype(jdtype), size=size, xp=jnp)]
    if size[0] * size[1] <= 25:
        references.append(pallas_highpass(jnp.asarray(x).astype(jdtype), size=size, interpret=True))
    for reference in references:
        assert reference.dtype == jdtype
        np.testing.assert_array_equal(to_numpy(ours), to_numpy(reference))


@pytest.mark.parametrize("shape, size", HIGHPASS_CASES)
def test_highpass_plain_float64_is_the_pallas_kernel(shape, size) -> None:
    """Float64 tiles whose values float32 cannot hold, with the same NaN,
    +-inf and ties: the plain version equals the Pallas kernel (interpret
    mode, under jax.enable_x64) and the sort median bit for bit."""
    x = highpass_tiles(shape, seed=4).astype(np.float64)
    x += 1e-9 * np.random.default_rng(5).normal(size=shape) * np.isfinite(x)
    x[:, ::3] = np.round(x[:, ::3], 1)  # ties
    ours = median_highpass(torch.from_numpy(x), size).numpy()
    with jax.enable_x64(True):
        pallas = np.asarray(pallas_highpass(jnp.asarray(x), size=size, interpret=True))
        sort_median = np.asarray(jax_imageproc.highpass(jnp.asarray(x), size=size, xp=jnp))
    assert pallas.dtype == np.float64
    np.testing.assert_array_equal(ours, pallas)
    np.testing.assert_array_equal(ours, sort_median)


def _skewed_thresholds(rng, N, P):
    w = np.exp(3.0 * rng.normal(size=(N, P))).astype(np.float32)
    u = rng.random(N).astype(np.float32)
    cum = np.cumsum(w / w.sum(-1, keepdims=True), -1, dtype=np.float32)
    t = (P * cum - u[:, None]).astype(np.float32)
    t[::2] = np.round(t[::2] * 4) / 4  # thresholds tied with slots
    return t


@pytest.mark.parametrize("name", SIXTEEN)
def test_resample_plain_16_bit_payload_is_the_pallas_kernel(name) -> None:
    """float32 thresholds, 16-bit particles and weights at N = 37, P = 256:
    bit-equal to the Pallas kernel (interpret mode), which accumulates in
    float32 and narrows exactly at the store, and in the payload's dtype."""
    tdtype, jdtype = SIXTEEN[name]
    rng = np.random.default_rng(6)
    N, P = 37, 256
    t = _skewed_thresholds(rng, N, P)
    particles = torch.from_numpy(rng.normal(size=(N, P, 6)).astype(np.float32)).to(tdtype)
    weights = torch.from_numpy(rng.random((N, P)).astype(np.float32)).to(tdtype)
    new_p, new_w = systematic_resample(torch.from_numpy(t), particles, weights)
    assert new_p.dtype == new_w.dtype == tdtype
    cols = [jnp.asarray(particles[..., k].float().numpy()).astype(jdtype) for k in range(6)]
    cols.append(jnp.asarray(weights.float().numpy()).astype(jdtype))
    out = systematic_resample_gather(jnp.asarray(t), cols, interpret=True)
    assert all(c.dtype == jdtype for c in out)
    np.testing.assert_array_equal(to_numpy(new_p), np.stack([to_numpy(c) for c in out[:6]], axis=-1))
    np.testing.assert_array_equal(to_numpy(new_w), to_numpy(out[6]))


def test_resample_plain_float64_payload() -> None:
    """Float64 particles and weights, exact row copies. On payloads float32
    holds, bit-equal to the Pallas kernel (interpret mode, enable_x64). On
    payloads float32 does not hold, the Pallas kernel rounds them (its
    one-hot sum accumulates in float32), so there the plain version is held
    to the reference's float64 route, an exact row gather by the same
    searchsorted-left indices."""
    rng = np.random.default_rng(7)
    N, P = 37, 256
    t = _skewed_thresholds(rng, N, P)
    narrow = rng.normal(size=(N, P, 7)).astype(np.float32).astype(np.float64)
    wide = narrow + 1e-12 * rng.normal(size=(N, P, 7))
    idx = np.stack([np.clip(np.searchsorted(t[n], np.arange(P), side="left"), 0, P - 1) for n in range(N)])
    for payload in (narrow, wide):
        new_p, new_w = systematic_resample_plain(
            torch.from_numpy(t), torch.from_numpy(payload[..., :6].copy()), torch.from_numpy(payload[..., 6].copy())
        )
        assert new_p.dtype == torch.float64
        want = np.take_along_axis(payload, idx[..., None], axis=1)
        np.testing.assert_array_equal(new_p.numpy(), want[..., :6])
        np.testing.assert_array_equal(new_w.numpy(), want[..., 6])
    with jax.enable_x64(True):
        cols = [jnp.asarray(narrow[..., k]) for k in range(7)]
        out = [np.asarray(c) for c in systematic_resample_gather(jnp.asarray(t), cols, interpret=True)]
    assert out[0].dtype == np.float64
    np.testing.assert_array_equal(np.stack(out, axis=-1), np.take_along_axis(narrow, idx[..., None], axis=1))


def test_systematic_thresholds_stay_float32() -> None:
    """The threshold table is float32 from weights of every dtype, from the
    weights widened to float32 (as the reference's Pallas route builds it):
    a 16-bit cumulative sum could not count 2,048 particles."""
    rng = np.random.default_rng(8)
    w32 = torch.from_numpy(rng.random((3, 2048)).astype(np.float32))
    u = torch.from_numpy(rng.random(3).astype(np.float32))
    for dtype in (torch.bfloat16, torch.float16, torch.float64):
        w = w32.to(dtype)
        t = resampling.systematic_thresholds(w, u)
        assert t.dtype == torch.float32
        torch.testing.assert_close(t, resampling.systematic_thresholds(w.to(torch.float32), u), rtol=0, atol=0)


@pytest.mark.parametrize(
    "call",
    [
        lambda d: systematic_resample(torch.zeros(2, 8), torch.zeros(2, 8, 6, dtype=d), torch.zeros(2, 8)),
        lambda d: systematic_resample(torch.zeros(2, 8, dtype=d), torch.zeros(2, 8, 6, dtype=d),
                                      torch.zeros(2, 8, dtype=d)),
    ],
    ids=["mixed-payload", "16-bit-thresholds"],
)
def test_resample_refuses_mixed_types(call) -> None:
    with pytest.raises(ValueError):
        call(torch.bfloat16)


# ---- Ops in 16 bits: by the rule ---- #


def _tiles(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32) * 3 + 1


@pytest.mark.parametrize("name", SIXTEEN)
def test_imageproc_in_16_bits(name) -> None:
    """normalize, sorted_cdf, match_cdf and prepare_tile (the Pallas
    high-pass in the reference) in the tile's dtype, within the rule."""
    tdtype, jdtype = SIXTEEN[name]
    tile, other = _tiles((31, 31), 1), _tiles((31, 31), 2)

    def both(fn_port, fn_ref):
        port = fn_port(torch.from_numpy(tile).to(tdtype), torch.from_numpy(other).to(tdtype))
        ref_t = fn_ref(jnp.asarray(tile).astype(jdtype), jnp.asarray(other).astype(jdtype))
        ref_32 = fn_ref(jnp.asarray(tile), jnp.asarray(other))
        return port, ref_t, ref_32

    port, ref_t, ref_32 = both(lambda a, b: imageproc.normalize(a), lambda a, b: jax_imageproc.normalize(a, xp=jnp))
    assert port.dtype == tdtype
    assert_within_rule(port, ref_t, ref_32, tdtype, "normalize")
    port, ref_t, ref_32 = both(lambda a, b: imageproc.sorted_cdf(a), lambda a, b: jax_imageproc.sorted_cdf(a, xp=jnp))
    assert port[0].dtype == tdtype and port[1].dtype == torch.float32
    assert_within_rule(port[0], ref_t[0], ref_32[0], tdtype, "sorted_cdf values")
    np.testing.assert_array_equal(port[1].numpy(), np.asarray(ref_t[1]))
    port, ref_t, ref_32 = both(
        lambda a, b: imageproc.match_cdf(a, imageproc.sorted_cdf(b)),
        lambda a, b: jax_imageproc.match_cdf(a, jax_imageproc.sorted_cdf(b, xp=jnp), xp=jnp),
    )
    assert port.dtype == tdtype
    assert_within_rule(port, ref_t, ref_32, tdtype, "match_cdf")

    def ref_prepare(a, b):
        return jax_imageproc.prepare_tile(a, cdf=jax_imageproc.sorted_cdf(b, xp=jnp), highpass_size=(5, 5), xp=jnp)[0]

    port, ref_t, ref_32 = both(lambda a, b: imageproc.prepare_tile(a, cdf=imageproc.sorted_cdf(b))[0], ref_prepare)
    assert port.dtype == tdtype
    assert_within_rule(port, ref_t, ref_32, tdtype, "prepare_tile")


@pytest.mark.parametrize("name", SIXTEEN)
def test_tracker_tile_pipeline_in_16_bits(name) -> None:
    """The tracker's search and template pipelines (normalize, histogram
    match by the quantile table, the high-pass kernel's plain version) on
    (O*N) stacked tiles, against the reference's with its Pallas high-pass,
    within the rule; the outputs are in the tiles' dtype."""
    tdtype, jdtype = SIXTEEN[name]
    search, template = _tiles((6, 31, 31), 3), _tiles((6, 15, 15), 4)
    port_hp, port_table = batch._prepare_template_tiles(torch.from_numpy(template).to(tdtype), (5, 5), 64)
    refs = {
        dt: jax_batch._prepare_template_tiles(jnp.asarray(template).astype(dt), (5, 5), 64, mode="pallas")
        for dt in (jdtype, jnp.float32)
    }
    assert port_hp.dtype == port_table.dtype == tdtype
    assert_within_rule(port_hp, refs[jdtype][0], refs[jnp.float32][0], tdtype, "template high-pass")
    assert_within_rule(port_table, refs[jdtype][1], refs[jnp.float32][1], tdtype, "template table")
    port = batch._prepare_search_tiles(torch.from_numpy(search).to(tdtype), port_table, (5, 5))
    ref = {
        dt: jax_batch._prepare_search_tiles(jnp.asarray(search).astype(dt), refs[dt][1], (5, 5), mode="pallas")
        for dt in (jdtype, jnp.float32)
    }
    assert port.dtype == tdtype
    assert_within_rule(port, ref[jdtype], ref[jnp.float32], tdtype, "search pipeline")


@pytest.mark.parametrize("name", SIXTEEN)
def test_sse_map_in_16_bits(name) -> None:
    """The batched SSE map by grouped convolution runs in the tiles' dtype
    on this CPU (torch's CPU conv2d takes bfloat16 and float16 at these
    sizes), within the rule."""
    tdtype, jdtype = SIXTEEN[name]
    search, template = _tiles((6, 31, 31), 5), _tiles((6, 15, 15), 6)
    port = ncc.sse_map_batched(torch.from_numpy(search).to(tdtype), torch.from_numpy(template).to(tdtype))
    assert port.dtype == tdtype
    ref_t = jax_ncc.sse_map_batched(jnp.asarray(search).astype(jdtype), jnp.asarray(template).astype(jdtype), xp=jnp)
    ref_32 = jax_ncc.sse_map_batched(jnp.asarray(search), jnp.asarray(template), xp=jnp)
    assert_within_rule(port, ref_t, ref_32, tdtype, "SSE map")


@pytest.mark.parametrize("name", SIXTEEN)
def test_spline_sampling_in_16_bits(name) -> None:
    """The spline prefilter and upsample in the surface's dtype, and the
    exact read at particles with float32 indices (the reference's dense
    basis promotes to float32), within the rule."""
    tdtype, jdtype = SIXTEEN[name]
    rng = np.random.default_rng(7)
    sse = rng.random((5, 17, 17)).astype(np.float32) * 4
    rows, cols = (rng.uniform(0, 16, size=(5, 64)).astype(np.float32) for _ in range(2))
    coeffs = sampling.bspline_prefilter_2d(torch.from_numpy(sse).to(tdtype))
    assert coeffs.dtype == tdtype
    ref = {dt: jax_sampling.bspline_prefilter_2d(jnp.asarray(sse).astype(dt), xp=jnp, dtype=dt)
           for dt in (jdtype, jnp.float32)}
    assert_within_rule(coeffs, ref[jdtype], ref[jnp.float32], tdtype, "prefilter")
    fine = sampling.bspline_upsample(coeffs, 4)
    ref_fine = {dt: jax_sampling.bspline_upsample(ref[dt], 4, xp=jnp, dtype=dt) for dt in (jdtype, jnp.float32)}
    assert fine.dtype == tdtype
    assert_within_rule(fine, ref_fine[jdtype], ref_fine[jnp.float32], tdtype, "upsample")
    sampled = sampling.bspline_sample(coeffs, torch.from_numpy(rows), torch.from_numpy(cols))
    assert sampled.dtype == torch.float32

    def dense(c, dt):
        br = jax_sampling.bspline_basis_dense(jnp.asarray(rows), 17, xp=jnp, dtype=dt)
        bc = jax_sampling.bspline_basis_dense(jnp.asarray(cols), 17, xp=jnp, dtype=dt)
        tmp = jnp.einsum("nph,nhw->npw", br, c, precision=jax.lax.Precision.HIGHEST)
        return jnp.sum(tmp * bc, axis=-1)

    assert_within_rule(sampled, dense(ref[jdtype], jdtype), dense(ref[jnp.float32], jnp.float32), tdtype,
                       "spline read")


@pytest.mark.parametrize("name", SIXTEEN)
def test_projection_of_16_bit_particles(name) -> None:
    """Particle planes in 16 bits through a float32 camera come out float32,
    as the reference's promote, and equal its numbers to float32 rounding."""
    tdtype, jdtype = SIXTEEN[name]
    cam = RefCamera(imgsz=(640, 480), f=(500, 510), c=(3, -2), k=(0.05, -0.01, 0, 0, 0, 0), p=(1e-3, -2e-3),
                    xyz=(100, 200, 300), viewdir=(10, -80, 5)).to_array().astype(np.float32)
    rng = np.random.default_rng(9)
    xyz = np.column_stack([rng.uniform(60, 140, 256), rng.uniform(160, 240, 256), rng.uniform(-5, 5, 256)])
    planes = [torch.from_numpy(xyz[:, k].astype(np.float32)).to(tdtype).reshape(4, 64) for k in range(3)]
    u, v = projection.project_planes(torch.from_numpy(cam), *planes)
    assert u.dtype == v.dtype == torch.float32
    ref = jax_projection.project_planes(jnp.asarray(cam), *(jnp.asarray(p.float().numpy()).astype(jdtype)
                                                               for p in planes), xp=jnp)
    assert ref[0].dtype == jnp.float32
    for ours, theirs in zip((u, v), ref):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-6, atol=1e-3)


def test_float64_points_project_through_a_float32_camera() -> None:
    """Float64 points (a float64 tracker's particle means, from which a late
    observer's template is cut) through a float32 camera come out float64,
    as the reference's do under x64, and equal its numbers to float64
    rounding; the port's matmul raised on the mixed types before."""
    cam = RefCamera(imgsz=(640, 480), f=(500, 510), c=(3, -2), k=(0.05, -0.01, 0, 0, 0, 0), p=(1e-3, -2e-3),
                    xyz=(100, 200, 300), viewdir=(10, -80, 5)).to_array().astype(np.float32)
    rng = np.random.default_rng(10)
    xyz = np.column_stack([rng.uniform(60, 140, 64), rng.uniform(160, 240, 64), rng.uniform(-5, 5, 64)])
    uv = projection.project(torch.from_numpy(cam), torch.from_numpy(xyz), correction=(6.3e6, 0.13))
    assert uv.dtype == torch.float64
    with jax.enable_x64(True):
        ref = jax_projection.project(jnp.asarray(cam), jnp.asarray(xyz), correction=(6.3e6, 0.13), xp=jnp)
        assert ref.dtype == jnp.float64
        np.testing.assert_allclose(uv.numpy(), np.asarray(ref), rtol=1e-12, atol=1e-9)


def test_motion_draws_float32_and_casts_at_use() -> None:
    """BatchMotion.evolve of 16-bit particles draws float32 and returns
    float32, as the reference's does; the tracker casts to its dtype.
    Injected draws stay float32; float64 particles return float64."""
    motion = convert.motion_from_numpy(dataclasses.asdict(make_motion(np.array([[10.0, 20.0], [30.0, 40.0]]))), "cpu")
    a = np.random.default_rng(10).normal(size=(2, 8, 3)).astype(np.float32)
    base = motion.initialize(None, 8, noise={"xy": np.zeros((2, 8, 2), np.float32), "v": np.ones((2, 8, 3), np.float32)})
    assert base.dtype == torch.float32
    for dtype, want in ((torch.bfloat16, torch.float32), (torch.float16, torch.float32), (torch.float64, torch.float64)):
        evolved = motion.evolve(None, base.to(dtype), torch.tensor(1.0, dtype=dtype), noise={"a": a})
        assert evolved.dtype == want
        np.testing.assert_allclose(to_numpy(evolved), to_numpy(motion.evolve(None, base, torch.tensor(1.0),
                                                                              noise={"a": a})), atol=2e-2)
    assert batch._normal({"a": a.astype(np.float64)}, "a", a.shape, None, "cpu").dtype == torch.float32


# ---- The slice: the tracker in each dtype ---- #

N, P, T = 4, 64, 5
SIZES = dict(template_size=(7, 7), search_size=(15, 15), n_particles=P)
DTYPES = {
    "bfloat16": (torch.bfloat16, jnp.bfloat16),
    "float16": (torch.float16, jnp.float16),
    "float64": (torch.float64, jnp.float64),
}


@pytest.fixture(scope="module")
def small_scene():
    """64 x 64 frames of a moving texture, 4 points, injected draws."""
    cam, frames, _ = make_scene(n_frames=T, velocity=(2.0, 1.0), imgsz=64)
    points = np.random.default_rng(1).uniform(244, 256, size=(N, 2))
    rng = np.random.default_rng(5)
    noise = {
        "init": {"xy": rng.normal(size=(N, P, 2)).astype(np.float32), "v": rng.normal(size=(N, P, 3)).astype(np.float32)},
        "a": rng.normal(size=(T - 1, N, P, 3)).astype(np.float32),
        "resample_u": rng.random((T - 1, N)).astype(np.float32),
    }
    return cam.to_array()[None], frames[:, None].astype(np.float32), points, noise


def reference_tracker(cams, points, jdtype):
    """The reference on its production routes: Pallas (interpret mode) in
    16 and 32 bits, XLA in float64."""
    routes = {} if jdtype == jnp.float64 else dict(resample_mode="pallas", highpass_mode="pallas")
    return jax_batch.BatchTracker(cams, [None], [0.15], make_motion(points),
                                  jax_batch.BatchConfig(dtype=jdtype, **routes, **SIZES))


def port_tracker(cams, points, tdtype, **kwargs):
    motion = convert.motion_from_numpy(dataclasses.asdict(make_motion(points)), "cpu")
    return batch.BatchTracker(cams, [None], [0.15], motion, batch.BatchConfig(dtype=tdtype, **SIZES), device="cpu",
                              **kwargs)


def carried_run(reference, port, images, noise, jdtype, tdtype):
    """Every step of the reference from its own carried state, and the
    port's step from that same state: (reference means, port means, the
    port's first state) per step."""
    ref_step = jax.jit(reference.step)
    state = jax.jit(reference.initialize)(jax.random.PRNGKey(0), jnp.asarray(images[0]).astype(jdtype),
                                          noise=noise["init"])
    ref_means, port_means, first = [], [], None
    for i in range(T - 1):
        step_noise = {"a": noise["a"][i], "resample_u": noise["resample_u"][i]}
        leaves = {f.name: np.asarray(getattr(state, f.name)) for f in dataclasses.fields(state) if f.name != "key"}
        carried = convert.state_from_numpy(**leaves, device="cpu")
        first = first or carried
        _, out = port.step(carried, torch.from_numpy(images[1 + i]).to(tdtype), torch.tensor(1.0, dtype=tdtype),
                           noise=step_noise)
        state, ref_out = ref_step(state, jnp.asarray(images[1 + i]).astype(jdtype), jnp.asarray(1.0, jdtype),
                                  noise=step_noise)
        assert out["mean"].dtype == tdtype and ref_out["mean"].dtype == jdtype
        ref_means.append(ref_out["mean"])
        port_means.append(out["mean"])
    return ref_means, port_means, first


@pytest.fixture(scope="module")
def float32_reference(small_scene):
    cams, images, points, noise = small_scene
    reference = reference_tracker(cams, points, jnp.float32)
    return carried_run(reference, port_tracker(cams, points, torch.float32), images, noise, jnp.float32,
                       torch.float32)[0]


@pytest.mark.parametrize("name", DTYPES)
def test_tracker_steps_from_carried_state(small_scene, float32_reference, name) -> None:
    """Step 1 from the reference's initial state, then every step from its
    carried state, in the dtype: the state carries the dtype (the template
    offsets in float32 or wider, as the reference's), the outputs are in it,
    and the means are held by the rule against the float32 reference."""
    tdtype, jdtype = DTYPES[name]
    cams, images, points, noise = small_scene
    with jax.enable_x64(jdtype == jnp.float64):
        reference = reference_tracker(cams, points, jdtype)
        ref_means, port_means, first = carried_run(reference, port_tracker(cams, points, tdtype), images, noise,
                                                   jdtype, tdtype)
        ref_means = [to_numpy(m) for m in ref_means]
    assert first.particles.dtype == first.weights.dtype == first.templates.dtype == tdtype
    assert first.template_duv.dtype == torch.promote_types(tdtype, torch.float32)
    for i, (ours, theirs, ref_32) in enumerate(zip(port_means, ref_means, float32_reference)):
        assert_within_rule(ours, theirs, ref_32, tdtype, f"means at step {i + 1}")


@pytest.mark.parametrize("name", DTYPES)
def test_track_and_track_stream_in_each_dtype(small_scene, name) -> None:
    """track with injected draws runs in the dtype, state and outputs; and
    track_stream, frame by frame and in chunks of 3, equals track bit for
    bit from the same generator, in the dtype."""
    tdtype, _ = DTYPES[name]
    cams, images, points, noise = small_scene
    state, out = port_tracker(cams, points, tdtype).track(torch.Generator().manual_seed(0), images, np.ones(T - 1),
                                                          noise=noise)
    assert out["mean"].dtype == out["sigma"].dtype == out["valid"].dtype == state.particles.dtype == tdtype
    assert out["mean"].shape == (T - 1, N, 6) and torch.isfinite(out["mean"]).all()
    _, plain = port_tracker(cams, points, tdtype).track(torch.Generator().manual_seed(0), images, np.ones(T - 1))
    for chunk in (1, 3):
        stream_state, outs = port_tracker(cams, points, tdtype).track_stream(
            torch.Generator().manual_seed(0), images[0], iter(images[1:]), np.ones(T - 1), chunk=chunk)
        means = torch.cat([o["mean"] if o["mean"].ndim == 3 else o["mean"][None] for o in outs])
        assert stream_state.particles.dtype == tdtype
        assert means.dtype == tdtype and torch.equal(means, plain["mean"]), chunk


def test_empty_outputs_in_the_dtype(small_scene) -> None:
    cams, images, points, _ = small_scene
    _, out = port_tracker(cams, points, torch.bfloat16).track(torch.Generator().manual_seed(0), images[:1], np.ones(0))
    assert all(v.dtype == torch.bfloat16 and v.shape[0] == 0 for v in out.values())


# ---- Accuracy against the truth: benchmarks/lockstep.py's model ---- #


def lockstep_problem(n_points=8, n_particles=128, n_frames=6, imgsz=192):
    """``benchmarks/lockstep.py``'s scene at a small size: a shifted
    texture under a nadir camera (f = h), points moving at (1.2, -0.7) px a
    frame, a velocity prior offset to (1.0, -0.5), and its shared draws."""
    import scipy.ndimage

    velocity, prior_v = (1.2, -0.7), (1.0, -0.5)
    rng = np.random.default_rng(3)
    base = scipy.ndimage.gaussian_filter(rng.normal(size=(imgsz, imgsz)), 0.8) * 100
    frames = np.stack([scipy.ndimage.shift(base, (-velocity[1] * i, velocity[0] * i), order=3, mode="nearest")
                       for i in range(n_frames)]).astype(np.float32)
    cam = RefCamera(imgsz=imgsz, f=imgsz, xyz=(imgsz / 2, imgsz / 2, imgsz), viewdir=(0, -90, 0))
    drift = np.asarray(velocity) * (n_frames - 1)
    lo = 80 + np.maximum(-drift, 0)
    hi = imgsz - 80 - np.maximum(drift, 0)
    starts = rng.uniform(lo, hi, size=(n_points, 2))
    noise_rng = np.random.default_rng(77)
    noise = {
        "init": {"xy": noise_rng.standard_normal((n_points, n_particles, 2)).astype(np.float32),
                 "v": noise_rng.standard_normal((n_points, n_particles, 3)).astype(np.float32)},
        "a": noise_rng.standard_normal((n_frames - 1, n_points, n_particles, 3)).astype(np.float32),
        "resample_u": noise_rng.random((n_frames - 1, n_points)).astype(np.float32),
    }
    truth = starts[None] + np.asarray(velocity) * np.arange(1, n_frames).reshape(-1, 1, 1)
    n = n_points
    fields = dict(
        kind="cartesian", xy=starts.astype(np.float32), xy_sigma=np.full((n, 2), 1.5, np.float32),
        v_mean=np.tile(np.asarray([*prior_v, 0.0], np.float32), (n, 1)),
        v_sigma=np.tile(np.asarray([0.5, 0.5, 0.0], np.float32), (n, 1)), a_mean=np.zeros((n, 3), np.float32),
        a_sigma=np.tile(np.asarray([0.2, 0.2, 0.0], np.float32), (n, 1)), slope_sigma=np.zeros(n, np.float32),
        use_dem_sigma=False,
    )
    return cam.to_array()[None], frames[:, None], fields, noise, truth


def test_bfloat16_accuracy_against_the_truth() -> None:
    """RMSE of the tracked positions against the true ones, reference and
    port, float32 and bfloat16, from the same draws. The port's bfloat16
    RMSE is at most 1.5x the reference's; the message states both ratios to
    float32."""
    cams, images, fields, noise, truth = lockstep_problem()
    constant = {"array": np.zeros((1, 1), np.float32), "x0": 0.0, "y0": 0.0, "dx": 1e30, "dy": 1e30}
    sizes = dict(n_particles=128, template_size=(15, 15), search_size=(41, 41))
    rmse = {}
    for name, (tdtype, jdtype) in {"float32": (torch.float32, jnp.float32), "bfloat16": SIXTEEN["bfloat16"]}.items():
        ref_motion = jax_batch.BatchMotion(dem=jax_batch.DeviceRaster.constant(0.0),
                                           dem_sigma=jax_batch.DeviceRaster.constant(0.0),
                                           **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                                              for k, v in fields.items()})
        reference = jax_batch.BatchTracker(cams, [None], [0.15], ref_motion, jax_batch.BatchConfig(
            dtype=jdtype, resample_mode="pallas", highpass_mode="pallas", **sizes))
        _, ref_out = reference.track(jax.random.PRNGKey(0), images, np.ones(len(images) - 1), noise=noise)
        port = batch.BatchTracker(cams, [None], [0.15], convert.motion_from_numpy(
            dict(fields, dem=constant, dem_sigma=constant), "cpu"), batch.BatchConfig(dtype=tdtype, **sizes),
            device="cpu")
        _, out = port.track(torch.Generator().manual_seed(0), images, np.ones(len(images) - 1), noise=noise)
        for who, mean in (("reference", ref_out["mean"]), ("port", out["mean"])):
            error = np.linalg.norm(to_numpy(mean)[..., 0:2] - truth, axis=-1)
            rmse[who, name] = float(np.sqrt((error ** 2).mean()))
    ratios = {who: rmse[who, "bfloat16"] / rmse[who, "float32"] for who in ("reference", "port")}
    message = f"RMSE {rmse}; bfloat16 / float32: reference {ratios['reference']:.3f}, port {ratios['port']:.3f}"
    assert rmse["port", "bfloat16"] <= 1.5 * rmse["reference", "bfloat16"], message
    assert rmse["port", "float32"] <= 1.5 * rmse["reference", "float32"], message


# ---- Bridges ---- #


@pytest.mark.parametrize("name", ["bfloat16", "float16", "float64"])
def test_checkpoint_resumes_bit_for_bit(small_scene, tmp_path, name) -> None:
    """A checkpoint of a 16-bit or float64 state (16-bit arrays as their
    uint16 bits) resumes bit for bit: the rest of the run equals the run
    that never stopped."""
    tdtype = DTYPES[name][0]
    cams, images, points, noise = small_scene
    port = port_tracker(cams, points, tdtype)
    state = port.initialize(torch.Generator().manual_seed(0), torch.from_numpy(images[0]), noise=noise["init"])
    state, _ = port.step(state, torch.from_numpy(images[1]), torch.tensor(1.0))
    checkpoint.save_state(state, tmp_path / "state.npz")
    resumed = checkpoint.load_state(tmp_path / "state.npz")
    for field in ("particles", "weights", "templates", "template_table", "template_duv", "valid"):
        original, loaded = getattr(state, field), getattr(resumed, field)
        assert loaded.dtype == original.dtype
        assert torch.equal(loaded.view(torch.uint8), original.contiguous().view(torch.uint8))
    _, want = port.step(state, torch.from_numpy(images[2]), torch.tensor(1.0))
    _, got = port.step(resumed, torch.from_numpy(images[2]), torch.tensor(1.0))
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_version_1_checkpoint_still_loads(small_scene, tmp_path) -> None:
    """A snapshot of format version 1 (float32 arrays, no dtype tags) loads
    as it did."""
    cams, images, points, noise = small_scene
    port = port_tracker(cams, points, torch.float32)
    state = port.initialize(torch.Generator().manual_seed(0), torch.from_numpy(images[0]), noise=noise["init"])
    arrays = {k: getattr(state, k).numpy() for k in checkpoint._ARRAYS}
    np.savez_compressed(tmp_path / "v1.npz", format=np.asarray(checkpoint.FORMAT), format_version=np.asarray(1),
                        step=np.asarray(state.step), generator_state=state.generator.get_state().numpy(),
                        generator_device=np.asarray("cpu"), **arrays)
    loaded = checkpoint.load_state(tmp_path / "v1.npz")
    for k, v in arrays.items():
        np.testing.assert_array_equal(getattr(loaded, k).numpy(), v)
    assert checkpoint.FORMAT_VERSION == 2


def test_state_from_numpy_keeps_the_reference_dtype() -> None:
    """A reference state in bfloat16 arrives as ml_dtypes arrays: each array
    keeps its dtype, bit for bit."""
    rng = np.random.default_rng(11)
    leaves = {
        "particles": jnp.asarray(rng.normal(size=(3, 8, 6)), jnp.bfloat16),
        "weights": jnp.asarray(rng.random((3, 8)), jnp.bfloat16),
        "templates": jnp.asarray(rng.normal(size=(1, 3, 5, 5)), jnp.float16),
        "template_table": jnp.asarray(rng.normal(size=(1, 3, 16)), jnp.bfloat16),
        "template_duv": jnp.asarray(rng.normal(size=(1, 3, 2)), jnp.float32),
        "valid": jnp.ones(3, jnp.bfloat16),
    }
    state = convert.state_from_numpy(**{k: np.asarray(v) for k, v in leaves.items()}, step=2, device="cpu")
    for k, v in leaves.items():
        got = getattr(state, k)
        assert str(got.dtype).removeprefix("torch.") == v.dtype.name
        np.testing.assert_array_equal(to_numpy(got), to_numpy(v))


def test_to_tracks_takes_bfloat16_outputs(small_scene) -> None:
    cams, images, points, noise = small_scene
    _, out = port_tracker(cams, points, torch.bfloat16).track(torch.Generator().manual_seed(0), images,
                                                              np.ones(T - 1), noise=noise)
    import datetime

    day = datetime.timedelta(days=1)
    tracks = batch.to_tracks([datetime.datetime(2020, 1, 1) + i * day for i in range(T)], day, out)
    assert tracks.means.shape == (N, T, 6) and tracks.means.dtype == np.float64
    np.testing.assert_array_equal(tracks.means[:, 1:], np.moveaxis(to_numpy(out["mean"]), 0, 1))


def test_mesh_tracker_in_bfloat16_equals_no_mesh(small_scene) -> None:
    """A MeshTracker over ["cpu"] * 3 in bfloat16 equals the tracker
    without a mesh bit for bit, and its state is bfloat16 slice by slice."""
    cams, images, points, noise = small_scene
    _, plain = port_tracker(cams, points, torch.bfloat16).track(torch.Generator().manual_seed(0), images,
                                                                np.ones(T - 1), noise=noise)
    meshed = port_tracker(cams, points, torch.bfloat16, mesh=parallel.get_mesh(devices=["cpu"] * 3))
    state, out = meshed.track(torch.Generator().manual_seed(0), images, np.ones(T - 1), noise=noise)
    assert all(part.particles.dtype == torch.bfloat16 for part in state.parts)
    for k in plain:
        assert torch.equal(out[k], plain[k]), k
