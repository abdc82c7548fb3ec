"""The port's terrain ops (polar viewshed, ring sweep, horizon) against the
JAX package's on the CPU, from the same seeded DEMs.

In float64 the port follows the reference operation for operation (the
headings' sines and cosines are taken by NumPy in both), so masks must be
identical, or every differing cell must lie within 1e-9 of the blocking
envelope; horizons agree within 1e-12. In float32 the port is held to the
reference's ``xp=jnp`` path on at least 99.5 % of cells. Also here: the edge
and NaN-corner cases of ``bilinear_sample`` that terrain builds on.
"""
import inspect
import itertools

import numpy as np
import pytest
import scipy.ndimage

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

from glimpse_tpu.ops import sampling as ref_sampling
from glimpse_tpu.ops import terrain as ref_terrain
from glimpse_tpu_torch.ops import sampling, terrain

CORRECTION = (6.3781e6, 0.13)
ORIGINS = {"cell_centre": (30.0, 40.0), "between_cells": (41.3, 22.7)}


def make_dem(seed=0, shape=(60, 80), nan_block=True):
    z = scipy.ndimage.gaussian_filter(np.random.default_rng(seed).normal(size=shape), 4) * 200
    if nan_block:
        z[10:15, 20:30] = np.nan
    return z


def origin_z(dem, origin):
    return float(dem[int(round(origin[0])), int(round(origin[1]))]) + 5.0


@pytest.mark.parametrize("origin", list(ORIGINS))
@pytest.mark.parametrize(
    "sample_mode,distance_mode,correction",
    list(itertools.product(["bilinear", "nearest"], ["polar", "cell"], [None, CORRECTION])),
)
def test_viewshed_matches_reference_float64(origin, sample_mode, distance_mode, correction) -> None:
    dem = make_dem()
    rc = ORIGINS[origin]
    args = (dem, rc, origin_z(dem, rc), 10.0)
    kwargs = dict(correction=correction, sample_mode=sample_mode, distance_mode=distance_mode)
    want = ref_terrain.viewshed(*args, xp=np, **kwargs)
    got = terrain.viewshed(*args, device="cpu", **kwargs)
    assert got.dtype == torch.bool and got.shape == want.shape
    assert 0.02 < want.mean() < 0.98  # a scene with both classes
    assert not want[np.isnan(dem)].any() and not got.numpy()[np.isnan(dem)].any()
    differ = got.numpy() != want
    if differ.any():
        margin = terrain.visibility_margin(*args, device="cpu", **kwargs)[0].numpy()
        assert np.abs(margin[differ]).max() < 1e-9


def test_viewshed_without_nan_cells_and_backoff() -> None:
    dem = make_dem(seed=3, nan_block=False)
    args = (dem, (20.5, 61.0), origin_z(dem, (20.5, 61.0)), 10.0)
    for kwargs in (dict(), dict(backoff=0.5), dict(oversample=4.0)):
        want = ref_terrain.viewshed(*args, xp=np, **kwargs)
        np.testing.assert_array_equal(terrain.viewshed(*args, device="cpu", **kwargs).numpy(), want)


@pytest.mark.parametrize("origin", list(ORIGINS))
@pytest.mark.parametrize("correction", [None, CORRECTION])
def test_viewshed_float32_agrees_with_reference_jnp(origin, correction) -> None:
    """Float32 on both sides: at least 99.5 % of cells agree (roundings of
    the polar positions move grazing cells across the envelope)."""
    dem = make_dem()
    rc = ORIGINS[origin]
    z0 = origin_z(dem, rc)
    want = np.asarray(ref_terrain.viewshed(jnp.asarray(dem, jnp.float32), rc, z0, 10.0, correction=correction, xp=jnp))
    got = terrain.viewshed(dem, rc, z0, 10.0, correction=correction, device="cpu", dtype=torch.float32).numpy()
    assert (got == want).mean() >= 0.995
    exact = ref_terrain.viewshed(dem, rc, z0, 10.0, correction=correction, xp=np)
    assert (got == exact).mean() >= 0.995


@pytest.mark.parametrize("origin", list(ORIGINS))
@pytest.mark.parametrize("correction", [None, CORRECTION])
def test_viewshed_rings_identical(origin, correction) -> None:
    dem = make_dem()
    rc = ORIGINS[origin]
    args = (dem, rc, origin_z(dem, rc), 10.0)
    want = ref_terrain.viewshed_rings(*args, correction=correction)
    got = terrain.viewshed_rings(*args, correction=correction)
    assert isinstance(got, np.ndarray)
    np.testing.assert_array_equal(got, want)


def test_polar_viewshed_agrees_with_rings_at_the_reference_bar() -> None:
    """tests/test_terrain_parity.py's bar: >= 98 % of cells at oversample 4."""
    dem = make_dem(seed=1, shape=(72, 72), nan_block=False)
    rc = (35.5, 32.5)
    args = (dem, rc, origin_z(dem, rc) + 10.0, 10.0)
    polar = terrain.viewshed(*args, oversample=4.0, device="cpu").numpy()
    assert (polar == terrain.viewshed_rings(*args)).mean() >= 0.98


@pytest.mark.parametrize("origin", list(ORIGINS))
@pytest.mark.parametrize("correction", [None, CORRECTION])
@pytest.mark.parametrize("up", [-40.0, 400.0])
def test_horizon_angles_match_reference(origin, correction, up) -> None:
    """From inside the relief (headings with a horizon) and from far above it
    (the maximum is the last sample, so headings without one)."""
    dem = make_dem()
    rc = ORIGINS[origin]
    headings = np.deg2rad(np.arange(0.0, 360.0, 7.0))
    args = (dem, rc, origin_z(dem, rc) + up, 10.0, headings)
    want = ref_terrain.horizon_angles(*args, correction=correction, xp=np)
    got = terrain.horizon_angles(*args, correction=correction, device="cpu")
    assert want[3].any() if up < 0 else not want[3].all()
    for w, g in zip(want[:3], got[:3]):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-12, rtol=0)
    np.testing.assert_array_equal(got[3].numpy(), want[3])


def test_horizon_heading_without_a_valid_sample_reports_index_zero() -> None:
    """All-NaN DEM: argmax over equal NEG_INF angles takes the first sample
    in both packages, and no heading is valid."""
    dem = np.full((12, 12), np.nan)
    headings = np.deg2rad([0.0, 90.0, 200.0])
    want = ref_terrain.horizon_angles(dem, (5.0, 5.0), 0.0, 10.0, headings, xp=np)
    got = terrain.horizon_angles(dem, (5.0, 5.0), 0.0, 10.0, headings, device="cpu")
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_array_equal(got[1].numpy(), np.full(3, 0.5))
    np.testing.assert_array_equal(got[0].numpy(), np.full(3, terrain.NEG_INF))
    assert not got[3].any() and not want[3].any()


def test_heading_count_is_capped() -> None:
    assert terrain.MAX_HEADINGS == 8192
    dem = np.zeros((4, 1400))
    angles, radii, thetas = terrain._polar_elevation_angles(
        torch.from_numpy(dem), (2.0, 0.0), 1.0, 1.0, terrain.MAX_HEADINGS, 4, 0.5, None
    )
    assert angles.shape == (8192, 4) and thetas.shape == (8192,)
    margin, _, _ = terrain.visibility_margin(dem, (2.0, 0.0), 1.0, 1.0, device="cpu")
    assert margin.shape == dem.shape


def test_neg_inf_survives_float32() -> None:
    assert np.float32(terrain.NEG_INF) == np.float32(-1e30) and np.isfinite(np.float32(terrain.NEG_INF))
    dem = np.full((8, 8), np.nan)
    dem[4, 4] = 1.0
    vis = terrain.viewshed(dem, (4.0, 4.0), 2.0, 1.0, device="cpu", dtype=torch.float32)
    assert vis[4, 4] and vis.sum() == 1


@pytest.mark.parametrize("case", ["last_row_and_column", "nan_corner_with_zero_weight", "outside", "interior"])
def test_bilinear_sample_holds_the_reference_at_edges_and_nan(case) -> None:
    """Terrain samples at clipped coordinates that sit exactly on the last
    row or column, and on DEMs with NaN cells."""
    rng = np.random.default_rng(5)
    grid = rng.normal(size=(7, 9))
    H, W = grid.shape
    if case == "last_row_and_column":
        rows = np.array([H - 1.0, H - 1.0, 0.0, 2.5, H - 1.0])
        cols = np.array([W - 1.0, 3.25, W - 1.0, W - 1.0, 0.0])
    elif case == "nan_corner_with_zero_weight":
        grid[3, 4] = np.nan
        rows = np.array([2.0, 2.0, 3.0, 2.5, 4.0, 3.0])
        cols = np.array([3.0, 4.0, 3.0, 3.5, 4.0, 5.0])
    elif case == "outside":
        rows = np.array([-1.5, H + 0.5, 3.0, -0.25])
        cols = np.array([2.0, 3.0, W + 2.0, -0.75])
    else:
        rows = rng.uniform(0, H - 1, 50)
        cols = rng.uniform(0, W - 1, 50)
    want = ref_sampling.bilinear_sample(grid, rows, cols, xp=np)
    got = sampling.bilinear_sample(torch.from_numpy(grid), torch.from_numpy(rows), torch.from_numpy(cols)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, atol=1e-14, rtol=0)
    if case == "nan_corner_with_zero_weight":
        # A NaN cell reaches only the samples whose stencil holds it.
        assert np.isnan(want).sum() in range(1, len(rows))
    if case != "outside":
        nearest = ref_sampling.nearest_sample(grid, rows, cols, xp=np)
        got0 = sampling.nearest_sample(torch.from_numpy(grid), torch.from_numpy(rows), torch.from_numpy(cols)).numpy()
        np.testing.assert_array_equal(got0, nearest)


@pytest.mark.parametrize("order", [0, 1, 3])
def test_sample_grid_matches_reference(order) -> None:
    rng = np.random.default_rng(6)
    grid = rng.normal(size=(11, 13))
    rows = rng.uniform(0, 10, (6, 5))
    cols = rng.uniform(0, 12, (6, 5))
    want = ref_sampling.sample_grid(grid, rows, cols, order=order, xp=np)
    got = sampling.sample_grid_host(grid, rows, cols, order=order)
    assert got.shape == want.shape and got.dtype == np.float64
    np.testing.assert_allclose(got, want, atol=1e-12, rtol=0)
    with pytest.raises(ValueError, match="order"):
        sampling.sample_grid_host(grid, rows, cols, order=2)


def test_terrain_entry_points_default_to_the_card() -> None:
    for fn in (terrain.viewshed, terrain.horizon_angles, terrain.visibility_margin):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            terrain.viewshed(np.zeros((4, 4)), (1.0, 1.0), 1.0, 1.0)
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            terrain.horizon_angles(np.zeros((4, 4)), (1.0, 1.0), 1.0, 1.0, [0.0])
