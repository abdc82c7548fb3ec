"""The SSE sampling modes of the batched tracker and the last names of
``ops/sampling``, ``track/batch``, ``ops/imageproc`` and ``ops/ncc``, against
the JAX package on the CPU.

Each sampling function runs on the same seeded inputs in both packages and
is held within float32 rounding (bit for bit where both compute the same
operations in the same order, and for the float64 NumPy matrices). The
reference's one-hot ``grid_sample_*_dense`` spread a NaN cell down its column
(ROADMAP C, reference fault 1), so NaN cells are kept out of that comparison
and the port's NaN behaviour is pinned on its own. The tracker in
``sse_sample_mode='nearest'`` and ``'bilinear'`` (``sse_upsample=8``) and with
``sse_upsample=1`` is held, every step from the reference's carried state,
within 1e-3, as ``tests/test_torch_observers.py`` holds the exact mode.
"""
import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

from glimpse_tpu.ops import imageproc as ref_imageproc
from glimpse_tpu.ops import ncc as ref_ncc
from glimpse_tpu.ops import sampling as ref_sampling
from glimpse_tpu.track import batch as jax_batch
from glimpse_tpu_torch.ops import imageproc, ncc, sampling
from glimpse_tpu_torch.track import batch, convert
from test_batch_tracker import make_motion, make_scene

REPO = Path(__file__).resolve().parents[1]
F32 = dict(rtol=1e-6, atol=1e-6)


def rng(seed=0):
    return np.random.default_rng(seed)


def t(x):
    return torch.from_numpy(np.asarray(x))


def test_dense_nearest_sample_equals_the_reference_and_keeps_nan_to_its_cell() -> None:
    values = rng(0).normal(size=(23, 31)).astype(np.float32)
    ri = rng(1).integers(0, 23, size=(5, 400))
    ci = rng(2).integers(0, 31, size=(5, 400))
    want = np.asarray(ref_sampling.grid_sample_nearest_dense(jnp.asarray(values), jnp.asarray(ri), jnp.asarray(ci)))
    got = sampling.grid_sample_nearest_dense(t(values), t(ri), t(ci)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, values[ri, ci])
    values[4, 7] = np.nan
    got = sampling.grid_sample_nearest_dense(t(values), t(ri), t(ci)).numpy()
    at_cell = (ri == 4) & (ci == 7)
    assert at_cell.any() and np.isnan(got[at_cell]).all()
    np.testing.assert_array_equal(got[~at_cell], values[ri, ci][~at_cell])
    assert sampling.DENSE_SAMPLE_MAX_CELLS == ref_sampling.DENSE_SAMPLE_MAX_CELLS


def test_dense_bilinear_sample_equals_the_reference_and_keeps_nan_to_its_stencil() -> None:
    values = rng(3).normal(size=(17, 29)).astype(np.float32)
    # Inside, on the last row and column, and beyond the edges (extrapolated).
    rows = rng(4).uniform(-1.5, 17.5, size=(3, 500)).astype(np.float32)
    cols = rng(5).uniform(-1.5, 29.5, size=(3, 500)).astype(np.float32)
    want = np.asarray(ref_sampling.grid_sample_bilinear_dense(jnp.asarray(values), jnp.asarray(rows), jnp.asarray(cols)))
    got = sampling.grid_sample_bilinear_dense(t(values), t(rows), t(cols)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got, sampling.bilinear_sample(t(values), t(rows), t(cols)).numpy())
    values[8, 10] = np.nan
    got = sampling.grid_sample_bilinear_dense(t(values), t(rows), t(cols)).numpy()
    r0 = np.clip(np.floor(rows), 0, 15)
    c0 = np.clip(np.floor(cols), 0, 27)
    stencil = ((r0 == 8) | (r0 + 1 == 8)) & ((c0 == 10) | (c0 + 1 == 10))
    assert stencil.any()
    assert np.isnan(got[stencil]).all() and np.isfinite(got[~stencil]).all()


def test_cubic_kernel_and_dense_basis_equal_the_reference() -> None:
    x = rng(6).uniform(-3, 3, size=(7, 300)).astype(np.float32)
    np.testing.assert_allclose(sampling.cubic_bspline_kernel(t(x)).numpy(),
                               np.asarray(ref_sampling.cubic_bspline_kernel(jnp.asarray(x), xp=jnp)), **F32)
    for n in (1, 2, 5, 27):
        q = rng(n).uniform(0, n - 1, size=(4, 60)).astype(np.float32)
        got = sampling.bspline_basis_dense(t(q), n).numpy()
        want = np.asarray(ref_sampling.bspline_basis_dense(jnp.asarray(q), n, xp=jnp))
        assert got.shape == want.shape == (4, 60, n)
        np.testing.assert_allclose(got, want, **F32)


def test_padded_coefficients_and_their_16_taps_equal_the_reference() -> None:
    sse = rng(7).normal(size=(6, 11, 13)).astype(np.float32)
    coeffs = sampling.bspline_prefilter_2d(t(sse))
    padded = sampling.bspline_pad_coeffs(coeffs)
    want_padded = ref_sampling.bspline_pad_coeffs(jnp.asarray(coeffs.numpy()), xp=jnp)
    np.testing.assert_allclose(padded.numpy(), np.asarray(want_padded), **F32)
    rows = rng(8).uniform(0, 10, size=(6, 200)).astype(np.float32)
    cols = rng(9).uniform(0, 12, size=(6, 200)).astype(np.float32)
    rows[:, :4] = (0, 10, 0, 10)
    cols[:, :4] = (0, 12, 12, 0)
    got = sampling.bspline_sample_padded(padded, t(rows), t(cols)).numpy()
    want = jax.vmap(lambda c, r, q: ref_sampling.bspline_sample_padded(c, r, q, xp=jnp))(
        want_padded, jnp.asarray(rows), jnp.asarray(cols))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, sampling.bspline_sample(coeffs, t(rows), t(cols)).numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,factor", [(1, 4), (2, 3), (7, 8), (27, 8)])
def test_eval_matrix_equals_the_reference_bit_for_bit(n, factor) -> None:
    got, want = sampling.bspline_eval_matrix(n, factor), ref_sampling.bspline_eval_matrix(n, factor)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)


def test_upsample_equals_the_reference_and_interpolates_the_nodes() -> None:
    sse = rng(10).normal(size=(3, 9, 12)).astype(np.float32)
    coeffs = sampling.bspline_prefilter_2d(t(sse))
    got = sampling.bspline_upsample(coeffs, 4).numpy()
    want = np.asarray(ref_sampling.bspline_upsample(jnp.asarray(coeffs.numpy()), 4, xp=jnp))
    assert got.shape == want.shape == (3, 36, 48)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # With an odd factor a fine cell sits on each node: the spline there is the value.
    np.testing.assert_allclose(sampling.bspline_upsample(coeffs, 3).numpy()[:, 1::3, 1::3], sse, atol=1e-5)


def test_median_network_equals_the_reference() -> None:
    for k in (1, 2, 5, 8, 25):
        values = [rng(k + i).normal(size=(4, 6)) for i in range(k)]
        values[0][0, 0] = np.nan
        want = ref_imageproc.median_network(values, xp=np)
        got = imageproc.median_network([t(v) for v in values]).numpy()
        np.testing.assert_array_equal(got, want)
        assert np.isnan(got[0, 0]) and np.isfinite(got.flat[1:]).all()


def test_sse_map_numpy_equals_the_reference_and_the_tensor_form() -> None:
    search = rng(11).normal(size=(21, 25))
    template = rng(12).normal(size=(7, 9))
    got = ncc.sse_map_numpy(search, template)
    np.testing.assert_array_equal(got, ref_ncc.sse_map_numpy(search, template))
    np.testing.assert_allclose(got, ncc.sse_map(t(search), t(template)).numpy(), rtol=1e-12)


def test_config_validates_the_sse_modes() -> None:
    with pytest.raises(ValueError, match="sse_sample_mode must be 'einsum', 'nearest', or 'bilinear'"):
        batch.BatchConfig(sse_sample_mode="cubic")
    with pytest.raises(ValueError):
        jax_batch.BatchConfig(sse_sample_mode="cubic")
    with pytest.raises(ValueError, match="sse_upsample must be an integer"):
        batch.BatchConfig(sse_sample_mode="nearest", sse_upsample=2.5)
    defaults = batch.BatchConfig()
    assert (defaults.sse_sample_mode, defaults.sse_upsample) == ("einsum", 8)
    assert batch.BatchConfig(sse_sample_mode="bilinear", sse_upsample=1).sse_upsample == 1


N, P, T = 4, 256, 6
SIZES = dict(n_particles=P, template_size=(15, 15), search_size=(41, 41))
MODES = {
    "nearest": dict(sse_sample_mode="nearest", sse_upsample=8),
    "bilinear": dict(sse_sample_mode="bilinear", sse_upsample=8),
    "upsample1": dict(sse_sample_mode="nearest", sse_upsample=1),
}


@pytest.fixture(scope="module")
def scene():
    cam, frames, _ = make_scene(n_frames=T, velocity=(2.0, 1.0))
    points_xy = rng(1).uniform(200, 300, size=(N, 2))
    r = rng(21)
    noise = {
        "init": {"xy": r.normal(size=(N, P, 2)).astype(np.float32), "v": r.normal(size=(N, P, 3)).astype(np.float32)},
        "a": r.normal(size=(T - 1, N, P, 3)).astype(np.float32),
        "resample_u": r.random((T - 1, N)).astype(np.float32),
    }
    return cam.to_array().astype(np.float32), frames[:, None].astype(np.float32), make_motion(points_xy), noise


def trackers(scene, **settings):
    cam, _, motion, _ = scene
    reference = jax_batch.BatchTracker(cam[None], [None], [0.15], motion, jax_batch.BatchConfig(**SIZES, **settings))
    port = batch.BatchTracker(cam[None], [None], [0.15], convert.motion_from_numpy(dataclasses.asdict(motion), "cpu"),
                              batch.BatchConfig(**SIZES, **settings), device="cpu")
    return reference, port


@pytest.mark.parametrize("mode", list(MODES))
def test_each_step_from_carried_state_in_each_sse_mode(scene, mode) -> None:
    """Every step from the reference's own state, in the reference's
    sampling mode: means and sigmas within 1e-3, templates within 1e-4, and
    at least 98 % of the resampled rows with their weights."""
    _, images, _, noise = scene
    reference, port = trackers(scene, **MODES[mode])
    ref_step = jax.jit(reference.step)
    state = reference.initialize(jax.random.PRNGKey(0), images[0], noise=noise["init"])
    for i in range(T - 1):
        step_noise = {"a": noise["a"][i], "resample_u": noise["resample_u"][i]}
        leaves = {f.name: np.array(getattr(state, f.name)) for f in dataclasses.fields(state) if f.name != "key"}
        nxt, out = port.step(convert.state_from_numpy(**leaves, device="cpu"), torch.from_numpy(images[1 + i]),
                             torch.tensor(1.0), noise=step_noise)
        state, ref_out = ref_step(state, images[1 + i], np.float32(1.0), noise=step_noise)
        for k in ("mean", "sigma"):
            np.testing.assert_allclose(out[k].numpy(), np.asarray(ref_out[k]), atol=1e-3, rtol=0, err_msg=f"{k} {i}")
        np.testing.assert_allclose(nxt.templates.numpy(), np.asarray(state.templates), atol=1e-4, rtol=0)
        same = np.abs(nxt.particles.numpy() - np.asarray(state.particles)).max(-1) <= 1e-3
        assert same.mean() >= 0.98, (i, same.mean())
        np.testing.assert_allclose(nxt.weights.numpy()[same], np.asarray(state.weights)[same], rtol=1e-3, atol=1e-6)


def test_sse_modes_sample_the_spline_they_name(scene) -> None:
    """On one SSE stack: ``'nearest'`` and ``'bilinear'`` read the upsampled
    spline, ``sse_upsample=1`` and ``'einsum'`` the exact one (the same values
    within float32 rounding)."""
    sse = t(rng(30).normal(size=(3, 27, 27)).astype(np.float32))
    rows = t(rng(31).uniform(0, 26, size=(3, 100)).astype(np.float32))
    cols = t(rng(32).uniform(0, 26, size=(3, 100)).astype(np.float32))

    def read(**settings):
        return batch._sample_sse_surface(sse, rows, cols, batch.BatchConfig(**settings)).numpy()

    exact = read()
    np.testing.assert_allclose(read(sse_sample_mode="bilinear", sse_upsample=1), exact, rtol=1e-5, atol=1e-5)
    fine = sampling.bspline_upsample(sampling.bspline_prefilter_2d(sse), 8)
    fr, fc = (rows + 0.5) * 8 - 0.5, (cols + 0.5) * 8 - 0.5
    near = torch.stack([f[torch.round(r).long().clamp(0, 215), torch.round(c).long().clamp(0, 215)]
                        for f, r, c in zip(fine, fr, fc)])
    np.testing.assert_array_equal(read(sse_sample_mode="nearest"), near.numpy())
    bilinear = read(sse_sample_mode="bilinear")
    np.testing.assert_array_equal(bilinear, torch.stack([sampling.bilinear_sample(*a) for a in zip(fine, fr, fc)]).numpy())
    # The upsampled spline is the exact one at a fine cell's centre, and within a cell's slope elsewhere.
    assert np.abs(bilinear - exact).max() < np.abs(exact).max()


def test_observer_log_likelihoods_equals_the_reference_and_the_multi_form(scene) -> None:
    cam, images, motion, noise = scene
    reference, port = trackers(scene)
    ref_state = reference.initialize(jax.random.PRNGKey(0), images[0], noise=noise["init"])
    leaves = {f.name: np.array(getattr(ref_state, f.name)) for f in dataclasses.fields(ref_state) if f.name != "key"}
    state = convert.state_from_numpy(**leaves, device="cpu")
    image = images[1, 0]
    want = jax_batch.observer_log_likelihoods(
        image, cam, None, 0.15, ref_state.particles, ref_state.templates[0], ref_state.template_table[0],
        ref_state.template_duv[0], ref_state.weights, reference.config,
    )
    got = batch.observer_log_likelihoods(
        t(image), t(cam), None, 0.15, state.particles, state.templates[0], state.template_table[0],
        state.template_duv[0], state.weights, port.config,
    )
    assert got.shape == (N, P)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-3)
    multi = batch.observer_log_likelihoods_multi(
        t(image)[None], t(cam)[None], [None], [0.15], state.particles, state.templates, state.template_table,
        state.template_duv, state.weights, port.config,
    )
    torch.testing.assert_close(got, multi, rtol=0, atol=0)


def public_names(path: Path) -> set:
    tree = ast.parse(path.read_text())
    return {node.name for node in tree.body if isinstance(node, (ast.FunctionDef, ast.ClassDef))
            and not node.name.startswith("_")}


def test_every_public_name_of_the_reference_has_a_counterpart() -> None:
    """A name-by-name diff of the top-level public ``def``s and ``class``es of
    every module of ``glimpse_tpu`` against the port's module of the same
    path (the Pallas kernels' modules have other names in the port): only
    the ``*_jax`` resamplers, whose counterparts are the port's
    ``systematic``, ``stratified``, ``residual`` and ``choice``."""
    missing = {}
    for path in sorted((REPO / "glimpse_tpu").rglob("*.py")):
        rel = path.relative_to(REPO / "glimpse_tpu")
        if rel.parts[0] == "kernels":
            continue
        names = public_names(path) - public_names(REPO / "glimpse_tpu_torch" / rel)
        if names:
            missing[str(rel)] = sorted(names)
    assert missing == {"ops/resampling.py": ["choice_jax", "resample_jax", "residual_jax", "stratified_jax",
                                             "systematic_jax"]}
