"""The port's motion kinds, resamplers, covariances and bilinear SSE
sampling against the JAX package, on the CPU.

Motion runs the same float32 operations in the same order as the reference,
so it is held to a few ulps (rtol 1e-6, and atol 1e-6 for components near
zero, where the two libraries' cos, sin and sqrt part by an ulp). The resamplers get the uniforms
that ``jax.random.uniform`` draws from the reference's key, and give the same
indices. One tracker step per resample method, from the reference's own
state, draws the same uniforms and is held to 1e-3.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

from glimpse_tpu.ops import resampling as jax_resampling
from glimpse_tpu.track import batch as jax_batch
from glimpse_tpu_torch.ops import resampling
from glimpse_tpu_torch.track import batch, convert
from test_batch_tracker import make_motion, make_scene

N, P = 6, 256


def _rasters(rng):
    yy, xx = np.mgrid[0:20, 0:30]
    grid = dict(x0=np.float32(0.0), y0=np.float32(200.0), dx=np.float32(10.0), dy=np.float32(-10.0))
    dem = dict(array=(0.5 * xx + 0.2 * yy + rng.normal(size=xx.shape)).astype(np.float32), **grid)
    dem_sigma = dict(array=rng.uniform(0.5, 2.0, xx.shape).astype(np.float32), **grid)
    return dem, dem_sigma


@pytest.mark.parametrize("kind", ["cylindrical", "tangent", "tangent_cylindrical"])
def test_motion_kind_matches_reference(kind) -> None:
    """initialize (with "z" draws), evolve (with "zwalk" draws) and the
    DEM-distance prior (zero for the tangent kinds) on a sloped DEM with a
    DEM sigma."""
    rng = np.random.default_rng(7)
    dem, dem_sigma = _rasters(rng)
    polar = kind.endswith("cylindrical")
    v_mean = rng.normal(size=(N, 3)).astype(np.float32)
    if polar:  # (speed, heading, vz)
        v_mean[:, 0] = rng.uniform(0.5, 2.0, N)
        v_mean[:, 1] = rng.uniform(-np.pi, np.pi, N)
    fields = dict(
        kind=kind,
        xy=np.column_stack([rng.uniform(50, 250, N), rng.uniform(50, 150, N)]).astype(np.float32),
        xy_sigma=np.full((N, 2), 3.0, np.float32),
        v_mean=v_mean,
        v_sigma=np.tile(np.float32([0.5, 0.2 if polar else 0.5, 0.3]), (N, 1)),
        a_mean=rng.normal(scale=0.1, size=(N, 3)).astype(np.float32),
        a_sigma=np.tile(np.float32([0.1, 0.05 if polar else 0.1, 0.1]), (N, 1)),
        slope_sigma=rng.uniform(0.1, 0.3, N).astype(np.float32),
        use_dem_sigma=True,
    )
    on_jax = lambda tree: jax.tree_util.tree_map(jnp.asarray, tree)  # noqa: E731
    reference = jax_batch.BatchMotion(
        dem=jax_batch.DeviceRaster(**on_jax(dem)), dem_sigma=jax_batch.DeviceRaster(**on_jax(dem_sigma)),
        **{k: v if isinstance(v, (str, bool)) else jnp.asarray(v) for k, v in fields.items()},
    )
    port = convert.motion_from_numpy(dict(fields, dem=dem, dem_sigma=dem_sigma), "cpu")
    init = {k: rng.normal(size=(N, P) + s).astype(np.float32) for k, s in (("xy", (2,)), ("z", ()), ("v", (3,)))}
    step = {"a": rng.normal(size=(N, P, 3)).astype(np.float32), "zwalk": rng.normal(size=(N, P)).astype(np.float32)}
    ref_particles = reference.initialize(jax.random.PRNGKey(0), P, noise=on_jax(init))
    particles = port.initialize(None, P, noise=init)
    np.testing.assert_allclose(particles.numpy(), np.asarray(ref_particles), atol=1e-6, rtol=1e-6)
    if kind == "tangent":
        assert (particles[..., 5] == 0).all()
    ref_evolved = reference.evolve(jax.random.PRNGKey(1), ref_particles, np.float32(2.0), noise=on_jax(step))
    evolved = port.evolve(None, particles, torch.tensor(2.0), noise=step)
    np.testing.assert_allclose(evolved.numpy(), np.asarray(ref_evolved), atol=1e-6, rtol=1e-6)
    # The prior of the same particles: (z - dem)^2 would amplify the ulps
    # by which the evolved particles part.
    ll = port.log_likelihoods(torch.from_numpy(np.array(ref_evolved))).numpy()
    np.testing.assert_allclose(ll, np.asarray(reference.log_likelihoods(ref_evolved)), atol=1e-6, rtol=1e-6)
    assert (ll == 0).all() == kind.startswith("tangent")


def test_motion_draws_from_the_generator() -> None:
    """Without injected draws, the tangent kinds draw their z walk from the
    generator: the same seed gives the same particles, another seed others."""
    rng = np.random.default_rng(8)
    dem, dem_sigma = _rasters(rng)
    leaves = dataclasses.asdict(make_motion(rng.uniform(50, 150, size=(N, 2))))
    leaves.update(kind="tangent", dem=dem, dem_sigma=dem_sigma, slope_sigma=np.full(N, 0.2, np.float32))
    motion = convert.motion_from_numpy(leaves, "cpu")

    def run(seed):
        generator = torch.Generator().manual_seed(seed)
        return motion.evolve(generator, motion.initialize(generator, P), torch.tensor(1.0))

    assert torch.equal(run(0), run(0))
    assert not torch.equal(run(0)[..., 2], run(1)[..., 2])


@pytest.mark.parametrize("scale", [0.5, 3.0])
@pytest.mark.parametrize("method", ["stratified", "residual", "choice"])
def test_resampler_indices_match_reference(method, scale) -> None:
    """The same uniforms give the same indices: both search with ties to
    the right, and choice sorts its draws first."""
    rng = np.random.default_rng(9)
    weights = np.exp(scale * rng.normal(size=(16, 300))).astype(np.float32)
    weights[0, :5] = 0.0  # particles that cannot be drawn
    key = jax.random.PRNGKey(int(scale * 10))
    want = np.asarray(getattr(jax_resampling, f"{method}_jax")(key, jnp.asarray(weights)))
    u = torch.from_numpy(np.array(jax.random.uniform(key, weights.shape)))
    got = resampling.METHODS[method](torch.from_numpy(weights), u).numpy()
    np.testing.assert_array_equal(got, want)
    assert not np.isin(np.arange(5), got[0]).any()


def test_resampler_draws_from_the_generator() -> None:
    weights = torch.from_numpy(np.exp(np.random.default_rng(10).normal(size=(4, 64))).astype(np.float32))
    for method, fn in resampling.METHODS.items():
        a = fn(weights, generator=torch.Generator().manual_seed(1))
        b = fn(weights, generator=torch.Generator().manual_seed(1))
        assert torch.equal(a, b), method
        assert a.shape == (4, 64) and a.dtype == torch.int64 and 0 <= a.min() and a.max() < 64


def test_residual_handles_exact_counts() -> None:
    """Weights that are exact multiples of 1/P leave no residual: the
    deterministic copies fill every slot, with no division by zero."""
    weights = torch.tensor([[2.0, 0.0, 1.0, 1.0]])
    idx = resampling.residual(weights, torch.full((1, 4), 0.5))
    np.testing.assert_array_equal(idx.numpy(), [[0, 0, 2, 3]])


def test_gather_rows_copies_particles_and_weights() -> None:
    rng = np.random.default_rng(11)
    particles = torch.from_numpy(rng.normal(size=(3, 8, 6)).astype(np.float32))
    weights = torch.from_numpy(rng.random((3, 8)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 8, size=(3, 8)))
    got_p, got_w = batch._gather_rows(particles, weights, idx)
    want_p, want_w = jax_batch._gather_rows(jnp.asarray(particles.numpy()), jnp.asarray(weights.numpy()), jnp.asarray(idx.numpy()))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))


def test_particle_covariances_match_reference() -> None:
    rng = np.random.default_rng(12)
    particles = (rng.normal(size=(N, P, 6)) * [3, 3, 1, 0.5, 0.5, 0.1] + [200, 300, 10, 1, -1, 0]).astype(np.float32)
    weights = np.exp(2 * rng.normal(size=(N, P))).astype(np.float32)
    want = np.asarray(jax_batch.particle_covariances(jnp.asarray(particles), jnp.asarray(weights)))
    got = batch.particle_covariances(torch.from_numpy(particles), torch.from_numpy(weights)).numpy()
    assert got.shape == (N, 6, 6)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    _, sigma = batch.particle_moments(torch.from_numpy(particles), torch.from_numpy(weights))
    np.testing.assert_allclose(np.sqrt(np.diagonal(got, axis1=1, axis2=2)), sigma.numpy(), rtol=1e-5)


def test_bilinear_sse_sampling_matches_reference() -> None:
    rng = np.random.default_rng(13)
    sse = rng.random((5, 17, 17)).astype(np.float32)
    rows = rng.uniform(0, 16, (5, 300)).astype(np.float32)
    cols = rng.uniform(0, 16, (5, 300)).astype(np.float32)
    rows[:, :3], cols[:, :3] = [0, 16, 8], [16, 0, 8]
    want = np.asarray(
        jax_batch._sample_sse_surface(
            jnp.asarray(sse), jnp.asarray(rows), jnp.asarray(cols), jax_batch.BatchConfig(interpolation_order=1)
        )
    )
    got = batch._sample_sse_surface(
        torch.from_numpy(sse), torch.from_numpy(rows), torch.from_numpy(cols), batch.BatchConfig(interpolation_order=1)
    )
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


@pytest.fixture(scope="module")
def stepped():
    """The reference's initial state on an 8-point scene and the evolved
    particles of its first step, with injected draws."""
    n, p = 8, 256
    cam, frames, _ = make_scene(n_frames=3, velocity=(2.0, 1.0))
    points_xy = np.random.default_rng(1).uniform(180, 320, size=(n, 2))
    rng = np.random.default_rng(5)
    noise = {
        "init": {"xy": rng.normal(size=(n, p, 2)).astype(np.float32), "v": rng.normal(size=(n, p, 3)).astype(np.float32)},
        "a": rng.normal(size=(n, p, 3)).astype(np.float32),
    }
    motion = make_motion(points_xy)
    sizes = dict(n_particles=p, template_size=(15, 15), search_size=(41, 41))
    reference = jax_batch.BatchTracker(cam.to_array()[None], [None], [0.15], motion, jax_batch.BatchConfig(**sizes))
    state = jax.jit(reference.initialize)(jax.random.PRNGKey(0), frames[0][None], noise=noise["init"])
    leaves = {f.name: np.array(getattr(state, f.name)) for f in dataclasses.fields(state) if f.name != "key"}
    return cam, frames, motion, sizes, noise, state, leaves


def test_bilinear_likelihoods_match_reference(stepped) -> None:
    """observer_log_likelihoods_multi with interpolation_order=1, from the
    reference's state and evolved particles, within 1e-4 relative."""
    cam, frames, motion, sizes, noise, state, leaves = stepped
    ref_cfg = jax_batch.BatchConfig(interpolation_order=1, **sizes)
    particles = np.array(motion.evolve(jax.random.PRNGKey(1), state.particles, np.float32(1.0), noise={"a": noise["a"]}))
    templates, table, duv = (leaves[k] for k in ("templates", "template_table", "template_duv"))
    want = np.asarray(
        jax_batch.observer_log_likelihoods_multi(
            jnp.asarray(frames[1][None]), jnp.asarray(cam.to_array()[None]), [None], [0.15],
            jnp.asarray(particles), templates, table, duv, state.weights, ref_cfg,
        )
    )
    got = batch.observer_log_likelihoods_multi(
        torch.from_numpy(frames[1][None].astype(np.float32)), torch.from_numpy(cam.to_array()[None].astype(np.float32)),
        [None], [0.15], torch.from_numpy(particles), torch.from_numpy(templates), torch.from_numpy(table),
        torch.from_numpy(duv), torch.from_numpy(leaves["weights"]),
        batch.BatchConfig(interpolation_order=1, **sizes),
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("method", ["stratified", "residual", "choice"])
def test_step_with_each_resampler_matches_reference(stepped, method) -> None:
    """One step from the reference's state: the port gets the uniforms the
    reference draws from its step key, and resamples the same rows."""
    cam, frames, motion, sizes, noise, state, leaves = stepped
    reference = jax_batch.BatchTracker(
        cam.to_array()[None], [None], [0.15], motion, jax_batch.BatchConfig(resample_method=method, **sizes)
    )
    ref_next, ref_out = jax.jit(reference.step)(state, frames[1][None], np.float32(1.0), noise={"a": noise["a"]})
    k_resample = jax.random.split(state.key, 3)[2]
    u = np.array(jax.random.uniform(k_resample, state.weights.shape))
    port = batch.BatchTracker(
        cam.to_array()[None], [None], [0.15], convert.motion_from_numpy(dataclasses.asdict(motion), "cpu"),
        batch.BatchConfig(resample_method=method, **sizes), device="cpu",
    )
    nxt, out = port.step(
        convert.state_from_numpy(**leaves, device="cpu"), torch.from_numpy(frames[1][None]), torch.tensor(1.0),
        noise={"a": noise["a"], "resample_u": u},
    )
    np.testing.assert_allclose(out["mean"].numpy(), np.asarray(ref_out["mean"]), atol=1e-3, rtol=0)
    np.testing.assert_allclose(nxt.particles.numpy(), np.asarray(ref_next.particles), atol=1e-3, rtol=0)
    np.testing.assert_allclose(nxt.weights.numpy(), np.asarray(ref_next.weights), rtol=1e-3, atol=1e-30)
