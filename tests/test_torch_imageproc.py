"""The host tracker's tile ops and resamplers against the JAX package.

``glimpse_tpu_torch.ops.{imageproc,ncc,resampling}`` on CPU tensors against
``glimpse_tpu.ops`` with ``xp=np``, on the same arrays made from a seed with
numpy. Float64 results are held exactly unless a test says otherwise; the
float32 SSE map to 2e-6 of the map's largest value against the direct NumPy
sum and 2e-5 against OpenCV's ``matchTemplate``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glimpse_tpu.kernels.highpass_pallas import median_highpass as pallas_highpass
from glimpse_tpu.ops import imageproc as jax_imageproc
from glimpse_tpu.ops import ncc as jax_ncc
from glimpse_tpu.ops import resampling as jax_resampling
from glimpse_tpu_torch.kernels import highpass as highpass_kernel
from glimpse_tpu_torch.ops import imageproc, ncc, resampling


def tile(shape, seed: int = 0, levels: int = 0) -> np.ndarray:
    """A tile of normal draws, or of ``levels`` distinct values (many ties)."""
    rng = np.random.default_rng(seed)
    if levels:
        return rng.integers(0, levels, shape).astype(float)
    return rng.normal(size=shape)


def test_grayscale_equal_and_keeps_dtype_and_shape() -> None:
    rgb = tile((9, 11, 3), levels=256)
    np.testing.assert_array_equal(imageproc.grayscale(torch.from_numpy(rgb)).numpy(), jax_imageproc.grayscale(rgb, xp=np))
    gray = torch.from_numpy(rgb[..., 0])
    assert imageproc.grayscale(gray) is gray
    assert imageproc.grayscale(torch.from_numpy(rgb.astype(np.float32))).dtype == torch.float32


@pytest.mark.parametrize("levels", [0, 12])
def test_sorted_cdf_equal(levels) -> None:
    a = tile((15, 15), seed=1, levels=levels)
    values, quantiles = imageproc.sorted_cdf(torch.from_numpy(a))
    want_values, want_quantiles = jax_imageproc.sorted_cdf(a, xp=np)
    np.testing.assert_array_equal(values.numpy(), want_values)
    np.testing.assert_array_equal(quantiles.numpy(), want_quantiles)
    assert quantiles.dtype == torch.float64 and quantiles[-1] == 1.0


@pytest.mark.parametrize("seed", range(4))
def test_interp_is_numpy_interp(seed) -> None:
    """Tables with repeated abscissae (the CDF of tied values), queries on
    the table's points, between them and outside (numpy clamps): exact."""
    rng = np.random.default_rng(seed)
    xp = np.sort(rng.integers(0, 10, 30) / 10.0)
    fp = np.sort(rng.normal(size=30))
    x = np.concatenate([xp, rng.uniform(-0.5, 1.5, 500), [xp[0], xp[-1], -1.0, 2.0]])
    got = imageproc.interp(*(torch.from_numpy(v) for v in (x, xp, fp))).numpy()
    np.testing.assert_array_equal(got, np.interp(x, xp, fp))
    one = imageproc.interp(torch.from_numpy(x), torch.tensor([0.5], dtype=torch.float64), torch.tensor([3.0], dtype=torch.float64))
    np.testing.assert_array_equal(one.numpy(), np.interp(x, [0.5], [3.0]))


@pytest.mark.parametrize("levels, target_levels", [(0, 0), (20, 0), (0, 9), (16, 9)])
def test_match_cdf_equal(levels, target_levels) -> None:
    """A search tile of another size than the template, with and without
    ties on either side: exact in float64."""
    a = tile((23, 17), seed=2, levels=levels)
    target = tile((15, 15), seed=3, levels=target_levels)
    cdf = jax_imageproc.sorted_cdf(target, xp=np)
    got = imageproc.match_cdf(torch.from_numpy(a), tuple(torch.from_numpy(c) for c in cdf))
    np.testing.assert_array_equal(got.numpy(), jax_imageproc.match_cdf(a, cdf, xp=np))
    assert got.shape == a.shape


def test_match_cdf_in_float32_stays_float32() -> None:
    a = torch.from_numpy(tile((12, 12), seed=4).astype(np.float32))
    cdf = imageproc.sorted_cdf(torch.from_numpy(tile((15, 15), seed=5)))  # a float64 table
    got = imageproc.match_cdf(a, cdf)
    assert got.dtype == torch.float32
    want = jax_imageproc.match_cdf(a.double().numpy(), tuple(c.numpy() for c in cdf), xp=np)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6)


@pytest.mark.parametrize("size", [(5, 5), (3, 3), (3, 7), (1, 1), (4, 4), (2, 3), (9, 9), (6, 1), (1, 2), (8, 7)])
@pytest.mark.parametrize("levels", [0, 6])
def test_median_filter_and_highpass_equal_at_every_window(size, levels) -> None:
    """Odd, even and mixed windows, beyond 49 taps too, on stacks and single
    tiles: exact. scipy's ``median_filter`` is the reference's own check."""
    import scipy.ndimage

    stack = tile((3, 12, 14), seed=6, levels=levels)
    got = imageproc.median_filter(torch.from_numpy(stack), size)
    np.testing.assert_array_equal(got.numpy(), jax_imageproc.median_filter(stack, size=size, xp=np))
    if size[0] % 2 and size[1] % 2:
        np.testing.assert_array_equal(got[0].numpy(), scipy.ndimage.median_filter(stack[0], size=size, mode="reflect"))
    one = torch.from_numpy(stack[1])
    np.testing.assert_array_equal(imageproc.highpass(one, size).numpy(), jax_imageproc.highpass(stack[1], size=size, xp=np))


@pytest.mark.parametrize("size", [(4, 4), (5, 5)])
def test_median_filter_window_with_nan_gives_nan(size) -> None:
    a = tile((10, 10), seed=7)
    a[4, 5] = np.nan
    got = imageproc.median_filter(torch.from_numpy(a), size).numpy()
    ky, kx = size
    touched = np.zeros_like(a, dtype=bool)
    touched[4 - (ky - 1 - ky // 2) : 4 + ky // 2 + 1, 5 - (kx - 1 - kx // 2) : 5 + kx // 2 + 1] = True
    np.testing.assert_array_equal(np.isnan(got), touched)


@pytest.mark.parametrize("with_cdf", [False, True])
def test_prepare_tile_equal(with_cdf) -> None:
    """The whole tile pipeline on an RGB tile. The mean and variance are
    sums, whose order differs between the libraries: 1e-12."""
    rgb = tile((21, 19, 3), seed=8, levels=256)
    cdf = jax_imageproc.sorted_cdf(tile((15, 15), seed=9), xp=np) if with_cdf else None
    want, want_cdf = jax_imageproc.prepare_tile(rgb, cdf=cdf, highpass_size=(5, 5), xp=np)
    got, got_cdf = imageproc.prepare_tile(
        torch.from_numpy(rgb), cdf=None if cdf is None else tuple(torch.from_numpy(c) for c in cdf), highpass_size=(5, 5))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got_cdf[0].numpy(), want_cdf[0], rtol=0, atol=1e-12)
    np.testing.assert_array_equal(got_cdf[1].numpy(), want_cdf[1])


@pytest.mark.parametrize("shape", [((40, 33), (15, 15)), ((18, 18), (15, 15)), ((31, 52), (11, 7)), ((15, 15), (15, 15))])
def test_sse_map_against_numpy_and_cv2(shape) -> None:
    (sh, sw), (th, tw) = shape
    search = tile((sh, sw), seed=10).astype(np.float32)
    template = tile((th, tw), seed=11).astype(np.float32)
    got = ncc.sse_map(torch.from_numpy(search), torch.from_numpy(template))
    assert got.dtype == torch.float32 and got.shape == (sh - th + 1, sw - tw + 1)
    want = jax_ncc.sse_map_numpy(search, template)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6 * want.max())
    exact = jax_ncc.sse_map_numpy(search.astype(float), template.astype(float))
    got64 = ncc.sse_map(torch.from_numpy(search).double(), torch.from_numpy(template).double())
    np.testing.assert_allclose(got64.numpy(), exact, rtol=1e-13, atol=0)
    pytest.importorskip("cv2")
    np.testing.assert_allclose(got.numpy(), jax_ncc.sse_map(search, template, xp=np), rtol=0, atol=2e-5 * want.max())
    batched = ncc.sse_map_batched(torch.from_numpy(search)[None], torch.from_numpy(template)[None])[0]
    np.testing.assert_allclose(got.numpy(), batched.numpy(), rtol=0, atol=2e-5 * want.max())


@pytest.mark.parametrize("method", ["systematic", "stratified", "residual", "choice"])
def test_host_resamplers_draw_the_same_indices(method) -> None:
    """Index for index from equal seeds, on flat, skewed and degenerate weights."""
    rng = np.random.default_rng(12)
    for weights in (np.ones(64), np.exp(3 * rng.normal(size=500)), np.r_[np.full(99, 1e-300), 1.0], rng.random(7)):
        got = resampling.resample_np(weights, method=method, rng=np.random.default_rng(5))
        want = jax_resampling.resample_np(weights, method=method, rng=np.random.default_rng(5))
        np.testing.assert_array_equal(got, want)
        assert got.shape == weights.shape and got.min() >= 0 and got.max() < len(weights)
    named = getattr(resampling, f"{method}_np")(weights, np.random.default_rng(5))
    np.testing.assert_array_equal(named, got)
    assert resampling.resample_np(weights, method=method).shape == weights.shape  # a generator of its own


@pytest.mark.parametrize("shape, size, inside", [
    ((15, 15), (5, 5), True), ((18, 47), (5, 5), True), ((3, 3), (5, 5), True), ((31, 31), (4, 4), False),
    ((31, 31), (2, 3), False), ((31, 31), (9, 9), False), ((31, 31), (7, 7), True), ((31, 31), (1, 49), True),
    ((31, 31), (1, 51), False), ((160, 160), (5, 5), True), ((200, 240), (3, 5), True), ((31, 31), (5, 4), False),
])
def test_highpass_domain_predicate_and_route(shape, size, inside) -> None:
    """``covers`` is the kernel's domain, a predicate on the window alone:
    where it says no, the wrapper raises and ``kernels.highpass.highpass``
    takes the plain version; where it says yes, the wrapper takes the call.
    The reference's values either way."""
    assert highpass_kernel.covers(size) is inside
    tiles = torch.from_numpy(tile((2, *shape), seed=13).astype(np.float32))
    want = jax_imageproc.highpass(tiles.numpy(), size=size, xp=np)
    if inside:
        np.testing.assert_array_equal(highpass_kernel.median_highpass(tiles, size).numpy(), want)
    else:
        with pytest.raises(ValueError):
            highpass_kernel.median_highpass(tiles, size)
    np.testing.assert_array_equal(highpass_kernel.highpass(tiles, size).numpy(), want)


@pytest.mark.parametrize("shape, size", [
    ((1, 300, 300), (5, 5)), ((1, 250, 250), (1, 1)), ((1, 171, 171), (3, 7)), ((2, 200, 260), (3, 5)),
])
def test_highpass_takes_a_tile_of_any_size(shape, size) -> None:
    """Tiles at and past the largest that one block stages in float32, which
    the card reads from device memory: on a CPU tensor, the wrapper and the
    routing entry equal the reference's Pallas kernel (interpret mode) bit
    for bit, as the Pallas kernel, whose block is the whole padded tile,
    takes them. The Pallas kernel's padding slices fail on a window one
    pixel high or wide (``[pw - 1::-1]`` takes the whole axis at pw = 0), so
    the 1 x 1 window is held to the reference's sort median instead."""
    x = tile(shape, seed=17).astype(np.float32)
    if min(size) > 1:
        want = np.asarray(pallas_highpass(jnp.asarray(x), size=size, interpret=True))
    else:
        want = jax_imageproc.highpass(x, size=size, xp=np)
    for entry in (highpass_kernel.median_highpass, highpass_kernel.highpass):
        np.testing.assert_array_equal(entry(torch.from_numpy(x), size).numpy(), want)


def test_highpass_refuses_a_tile_smaller_than_half_the_window() -> None:
    """A (2, 9) tile under 5x5 taps, whose padding reflects more than once
    (the reference's Pallas slices cannot take it, reference fault 11): the
    wrapper and the routing entry take it, as the reference's NumPy and XLA
    routes do, and equal them bit for bit."""
    x = tile((1, 2, 9), seed=19).astype(np.float32)
    want = jax_imageproc.highpass(x, size=(5, 5), xp=np)
    np.testing.assert_array_equal(np.asarray(jax_imageproc.highpass(jnp.asarray(x), size=(5, 5), xp=jnp)), want)
    for entry in (highpass_kernel.median_highpass, highpass_kernel.highpass):
        np.testing.assert_array_equal(entry(torch.from_numpy(x), (5, 5)).numpy(), want)


# Tiles thinner than half the window (ROADMAP C13): the padding reflects more
# than once, as numpy's symmetric mode pads an axis by more than its length.
THIN_TILES = [((3, 2, 9), (5, 5)), ((3, 1, 9), (5, 5)), ((3, 9, 2), (5, 5)), ((3, 2, 2), (5, 5)), ((3, 3, 3), (7, 7))]
THIN_DTYPES = {"float32": (torch.float32, jnp.float32), "float64": (torch.float64, jnp.float64),
               "bfloat16": (torch.bfloat16, jnp.bfloat16), "float16": (torch.float16, jnp.float16)}


@pytest.mark.parametrize("name", THIN_DTYPES)
@pytest.mark.parametrize("shape, size", THIN_TILES, ids=[f"{s[1]}x{s[2]}-{k[0]}x{k[1]}" for s, k in THIN_TILES])
def test_highpass_on_tiles_thinner_than_half_the_window(shape, size, name) -> None:
    """The routed ``highpass``, the wrapper ``median_highpass`` and the plain
    ``median_filter`` on thin tiles equal the reference's routes bit for bit:
    in float32 and float64 its NumPy route (``xp=np``, what its host Tracker
    and its BatchTracker off a TPU run) and its XLA route (float64 under a
    scoped ``jax.enable_x64``); in 16 bits its XLA route in the tile's
    dtype, by the rule of ``tests/test_torch_dtypes.py`` (the sort median
    bit for bit)."""
    tdtype, jdtype = THIN_DTYPES[name]
    x = tile(shape, seed=20, levels=5 if name in ("bfloat16", "float16") else 0)
    x = x.astype(np.float64 if name == "float64" else np.float32)
    ported = torch.from_numpy(x).to(tdtype)
    with jax.enable_x64(name == "float64"):
        xla_low = jax_imageproc.median_filter(jnp.asarray(x).astype(jdtype), size=size, xp=jnp)
        xla = jax_imageproc.highpass(jnp.asarray(x).astype(jdtype), size=size, xp=jnp)
        assert xla.dtype == jdtype
        xla_low, xla = (np.asarray(a.astype(jnp.float32) if name in ("bfloat16", "float16") else a) for a in (xla_low, xla))
    wants = [(xla_low, xla)]
    if name in ("float32", "float64"):
        wants.append((jax_imageproc.median_filter(x, size=size, xp=np), jax_imageproc.highpass(x, size=size, xp=np)))
    for want_low, want in wants:
        np.testing.assert_array_equal(imageproc.median_filter(ported, size).double().numpy(), want_low.astype(np.float64))
        for entry in (highpass_kernel.highpass, highpass_kernel.median_highpass):
            got = entry(ported, size)
            assert got.dtype == tdtype
            np.testing.assert_array_equal(got.double().numpy(), want.astype(np.float64))


@pytest.mark.parametrize("shape, size", [((3, 2, 9), (5, 5)), ((3, 3, 3), (7, 7))], ids=["2x9-5x5", "3x3-7x7"])
def test_highpass_on_a_thin_tile_with_nan(shape, size) -> None:
    """NaN at a corner, an edge and inside a thin tile, and +-inf
    (``chip_smoke.highpass_tiles``): every window that reaches a NaN gives
    NaN, where the reference's NumPy and XLA routes give it, and every
    other pixel is equal."""
    from chip_smoke import highpass_tiles

    x = highpass_tiles(shape, seed=21)
    got = highpass_kernel.highpass(torch.from_numpy(x), size).numpy()
    assert np.isnan(got).any()
    for want in (jax_imageproc.highpass(x, size=size, xp=np),
                 np.asarray(jax_imageproc.highpass(jnp.asarray(x), size=size, xp=jnp))):
        np.testing.assert_array_equal(got, want)


def test_highpass_takes_a_large_float64_tile() -> None:
    """A (1, 131, 131) float64 tile, past what one block stages in float64
    (about 120 x 120), equals the reference's float64 Pallas kernel
    (interpret mode, under a scoped jax.enable_x64) bit for bit."""
    assert 2 * 131 * 131 * 8 > 232448  # two staging buffers of the tile, past one Hopper block's shared memory
    x = tile((1, 131, 131), seed=18)
    with jax.enable_x64(True):
        want = np.asarray(pallas_highpass(jnp.asarray(x), size=(5, 5), interpret=True))
    assert want.dtype == np.float64
    np.testing.assert_array_equal(highpass_kernel.median_highpass(torch.from_numpy(x), (5, 5)).numpy(), want)
