"""The port's ops against the reference's JAX ops, on seeded numpy inputs.

Both sides run float32 on the CPU; tolerances allow for the two frameworks
rounding transcendental functions and summing in different orders.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

from glimpse_tpu.ops import imageproc as jax_imageproc
from glimpse_tpu.ops import ncc as jax_ncc
from glimpse_tpu.ops import projection as jax_projection
from glimpse_tpu.ops import resampling as jax_resampling
from glimpse_tpu.track import batch as jax_batch
from glimpse_tpu_torch.ops import imageproc, ncc, projection, resampling, sampling
from glimpse_tpu_torch.track import convert


def _random_camera(rng):
    vector = np.zeros(20)
    vector[0:3] = rng.uniform(-1000, 1000, 3) + (0, 0, 500)
    vector[3:6] = (rng.uniform(0, 360), rng.uniform(-30, 10), rng.uniform(-5, 5))
    vector[6:8] = (800, 536)
    vector[8:10] = rng.uniform(700, 1200, 2)
    vector[10:12] = rng.normal(0, 5, 2)
    vector[12:18] = rng.normal(0, 1, 6) * (0.1, 0.05, 0.01, 0.02, 0.01, 0.005)
    vector[18:20] = rng.normal(0, 1e-3, 2)
    return vector


def _points_around(rng, vector, n):
    """World points seen at normalized (x, y) in [-0.4, 0.4] and depths of
    100 to 2000; a quarter of them behind the camera."""
    R = jax_projection.rotation_matrix(vector[3:6], xp=np)
    depth = rng.uniform(100, 2000, n) * np.where(np.arange(n) % 4 == 0, -1, 1)
    xy = rng.uniform(-0.4, 0.4, (n, 2))
    cam = np.column_stack([xy * depth[:, None], depth])
    return vector[0:3] + cam @ R


@pytest.mark.parametrize("correction", [None, (6.3781e6, 0.13)], ids=["plain", "corrected"])
def test_projection_matches_jax(correction) -> None:
    """project and project_planes agree with the reference in float32 within
    1e-3 px; points behind the camera are NaN on both sides."""
    rng = np.random.default_rng(0)
    for _ in range(4):
        vector = _random_camera(rng)
        xyz = _points_around(rng, vector, 400).astype(np.float32)
        v32 = vector.astype(np.float32)
        want = np.asarray(jax_projection.project(jnp.asarray(v32), jnp.asarray(xyz), correction=correction, xp=jnp))
        got = projection.project(torch.from_numpy(v32), torch.from_numpy(xyz), correction=correction).numpy()
        behind = np.arange(len(xyz)) % 4 == 0
        assert np.isnan(want[behind]).all() and np.isnan(got[behind]).all()
        np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
        want_u, want_v = jax_projection.project_planes(
            jnp.asarray(v32), *(jnp.asarray(xyz[:, i]) for i in range(3)), correction=correction, xp=jnp
        )
        got_u, got_v = projection.project_planes(
            torch.from_numpy(v32), *(torch.from_numpy(xyz[:, i]) for i in range(3)), correction=correction
        )
        np.testing.assert_allclose(got_u.numpy(), np.asarray(want_u), atol=1e-3, rtol=0)
        np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), atol=1e-3, rtol=0)


def test_normalize_and_sse_match_jax() -> None:
    """normalize within 1e-5 (unit-variance values); SSE maps of 15x15
    templates, sums of 225 squares of about 1, within 1e-3."""
    rng = np.random.default_rng(1)
    tiles = (rng.normal(size=(6, 41, 41)) * 30 + 7).astype(np.float32)
    want = np.asarray(jax_imageproc.normalize(jnp.asarray(tiles), xp=jnp, axis=(-2, -1), eps=1e-12))
    got = imageproc.normalize(torch.from_numpy(tiles), dim=(-2, -1), eps=1e-12).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    search = got
    templates = np.ascontiguousarray(got[:, 10:25, 12:27][::-1])
    want = np.asarray(jax_ncc.sse_map_batched(jnp.asarray(search), jnp.asarray(templates), xp=jnp))
    sse = ncc.sse_map_batched(torch.from_numpy(search), torch.from_numpy(templates)).numpy()
    assert sse.shape == (6, 27, 27)
    np.testing.assert_allclose(sse, want, atol=1e-3, rtol=0)


def test_bspline_sampling_matches_jax() -> None:
    """Prefilter plus direct 16-tap evaluation against the reference's dense
    basis einsum (its device path), at random and edge indices, within 1e-5
    of surfaces valued about 1."""
    rng = np.random.default_rng(2)
    sse = rng.random((5, 27, 27)).astype(np.float32)
    rows = rng.uniform(0, 26, (5, 300)).astype(np.float32)
    cols = rng.uniform(0, 26, (5, 300)).astype(np.float32)
    rows[:, :4] = [0, 26, 0, 13]
    cols[:, :4] = [0, 26, 26, 13]
    want = np.asarray(
        jax_batch._sample_sse_surface(jnp.asarray(sse), jnp.asarray(rows), jnp.asarray(cols), jax_batch.BatchConfig())
    )
    coeffs = sampling.bspline_prefilter_2d(torch.from_numpy(sse))
    got = sampling.bspline_sample(coeffs, torch.from_numpy(rows), torch.from_numpy(cols)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # The spline interpolates: at the nodes it gives the surface back.
    np.testing.assert_allclose(got[:, 3], sse[:, 13, 13], atol=1e-5, rtol=0)


def test_device_raster_matches_jax_with_a_nan_cell() -> None:
    """Bilinear and nearest sampling agree with the reference on the CPU
    (where it gathers). A NaN cell turns exactly the samples whose
    four-cell stencil holds it into NaN, and no others."""
    rng = np.random.default_rng(3)
    H, W = 20, 30
    array = rng.normal(size=(H, W)).astype(np.float32)
    array[5, 7] = np.nan
    fields = dict(array=array, x0=np.float32(100.0), y0=np.float32(500.0), dx=np.float32(2.0), dy=np.float32(-3.0))
    ref = jax_batch.DeviceRaster(**{k: jnp.asarray(v) for k, v in fields.items()})
    ours = convert.raster_from_numpy(fields, "cpu")
    xy = np.column_stack([rng.uniform(90, 170, 4000), rng.uniform(430, 510, 4000)]).astype(np.float32)
    want = np.asarray(ref.sample(jnp.asarray(xy)))
    got = ours.sample(torch.from_numpy(xy)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    rows = (xy[:, 1] - 500.0) / -3.0 - 0.5
    cols = (xy[:, 0] - 100.0) / 2.0 - 0.5
    r0 = np.clip(np.floor(rows), 0, H - 2)
    c0 = np.clip(np.floor(cols), 0, W - 2)
    stencil = ((r0 == 5) | (r0 + 1 == 5)) & ((c0 == 7) | (c0 + 1 == 7))
    assert stencil.any()
    np.testing.assert_array_equal(np.isnan(got), stencil)
    np.testing.assert_array_equal(
        ours.sample_nearest(torch.from_numpy(xy)).numpy(), np.asarray(ref.sample_nearest(jnp.asarray(xy)))
    )


def test_systematic_indices_match_jax() -> None:
    """Systematic resampling indices equal the reference's on skewed weights
    with the same comb offsets (no threshold lands on a slot here, so the
    two tie rules cannot differ)."""
    rng = np.random.default_rng(4)
    weights = np.exp(3 * rng.normal(size=(16, 256))).astype(np.float32)
    u = rng.random(16).astype(np.float32)
    want = np.asarray(jax_resampling.systematic_jax(None, jnp.asarray(weights), u=jnp.asarray(u)))
    got = resampling.systematic(torch.from_numpy(weights), torch.from_numpy(u)).numpy()
    np.testing.assert_array_equal(got, want)
