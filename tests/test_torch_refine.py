"""The port's match refiner against the reference's, on seeded textures.

Refined coordinates within 1e-4 px of the reference's on uint8-valued
images, as the pipeline's frames are: there both cut the same tiles (the
reference's bfloat16 one-hot matmuls are exact on integers up to 255, the
port's gathers on anything) and take the same exact SSE surfaces, then
float32 spline prefilters and Newton steps that sum in other orders. Also
the reference's own contracts (tests/test_refine.py): border pass-through,
empty and varied sizes, a known shift recovered, the spline derivatives.
"""
import numpy as np
import pytest
import scipy.ndimage

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

from glimpse_tpu.ops import refine as jax_refine
from glimpse_tpu.ops import sampling as jax_sampling
from glimpse_tpu_torch.ops import refine, sampling


def _texture(n=96, seed=0):
    t = scipy.ndimage.gaussian_filter(np.random.default_rng(seed).normal(size=(n, n)), 2.0)
    return (128 + 60 * t / np.abs(t).max()).astype(np.float32)


def _uint8(img):
    return np.round(img).astype(np.uint8).astype(np.float32)


def _shifted(img, dy, dx):
    """b(y, x) = a(y + dy, x + dx) by exact cubic B-spline resampling."""
    H, W = img.shape
    coeff = jax_sampling.bspline_prefilter_2d(img.astype(np.float64))
    by = jax_sampling.bspline_basis_dense(np.clip(np.arange(H, dtype=float) + dy, 0, H - 1), H)
    bx = jax_sampling.bspline_basis_dense(np.clip(np.arange(W, dtype=float) + dx, 0, W - 1), W)
    return (by @ coeff @ bx.T).astype(np.float32)


def _pairs():
    """Four uint8-valued images, three pairs with 49, 30 and 0 matches,
    biased match coordinates, some near and past the border."""
    a = _texture(seed=1)
    imgs = {0: _uint8(a), 1: _uint8(_shifted(a, 0.3, -0.4)), 2: _uint8(_shifted(a, 1.0, 0.0)),
            3: _uint8(_shifted(a, -0.6, 2.2))}
    rng = np.random.default_rng(5)
    ys, xs = np.meshgrid(np.arange(16, 80, 9), np.arange(16, 80, 9))
    uv = np.stack([xs.ravel() + 0.21, ys.ravel() - 0.13], axis=1)
    uv2 = rng.uniform(2, 94, (30, 2))
    pairs = [(0, 1), (2, 3), (1, 2)]
    uvs = [(uv, uv + [0.4, -0.3] + [0.08, -0.06]), (uv2, uv2 + [-2.2, -1.6]), (np.zeros((0, 2)), np.zeros((0, 2)))]
    return imgs, pairs, uvs


def test_refine_pairs_matches_jax() -> None:
    imgs, pairs, uvs = _pairs()
    kwargs = dict(pad_matches=32, pairs_per_dispatch=2)
    want = jax_refine.MatchRefiner(**kwargs).refine_pairs(pairs, uvs, lambda k: imgs[k])
    got = refine.MatchRefiner(device="cpu", **kwargs).refine_pairs(pairs, uvs, lambda k: imgs[k])
    for (ga, gb), (wa, wb) in zip(got, want):
        assert ga.shape == wa.shape and gb.shape == wb.shape
        np.testing.assert_array_equal(ga, wa)
        np.testing.assert_allclose(gb, wb, atol=1e-4, rtol=0)
    # The first pair recovers the true shift (0.4, -0.3) px (x, y).
    duv = got[0][1] - got[0][0]
    assert np.abs(np.median(duv, axis=0) - [0.4, -0.3]).max() < 0.03
    # Near the border some of the second pair's matches pass through.
    passed = (got[1][0] == uvs[1][0]).all(axis=1)
    assert 0 < passed.sum() < len(passed)
    np.testing.assert_array_equal(got[1][1][passed], uvs[1][1][passed])


def test_border_matches_pass_through() -> None:
    img_a = _uint8(_texture())
    img_b = _uint8(_shifted(_texture(), 0.5, 0.5))
    uv_a = np.array([[2.0, 2.0], [48.0, 48.0]])
    ra, rb = refine.refine_matches(img_a, img_b, uv_a, uv_a - 0.5, device="cpu")
    np.testing.assert_allclose(ra[0], uv_a[0])  # the window would cross the border
    np.testing.assert_allclose(rb[0], uv_a[0] - 0.5)
    assert np.all(ra[1] == np.round(uv_a[1]))
    want = jax_refine.refine_matches(img_a, img_b, uv_a, uv_a - 0.5)
    np.testing.assert_allclose(rb, want[1], atol=1e-4, rtol=0)


def test_empty_and_varied_sizes() -> None:
    img = _texture(seed=2)
    refiner = refine.MatchRefiner(pad_matches=8, pairs_per_dispatch=2, device="cpu")
    empty = np.zeros((0, 2))
    uv = np.array([[40.0, 40.0], [52.0, 44.0], [30.0, 60.0]])
    many = np.random.default_rng(6).uniform(20, 76, (11, 2))  # more than pad_matches
    outs = refiner.refine_pairs([(0, 1), (0, 1), (1, 0)], [(empty, empty), (uv, uv), (many, many)], lambda k: img)
    assert outs[0][0].shape == (0, 2)
    # Identical images: the refined displacement is about zero.
    assert np.abs(outs[1][1] - outs[1][0]).max() < 0.02
    assert np.abs(outs[2][1] - outs[2][0]).max() < 0.02 and outs[2][0].shape == (11, 2)


def test_spline_derivatives_match_the_dense_basis() -> None:
    """Value, gradient and Hessian of the 16-tap spline equal the
    reference's dense natural-boundary basis and its jvp derivatives
    (float32 rows, so within 4e-6 of the largest coefficient), inside and at
    the clipped edges 0 and o - 1."""
    rng = np.random.default_rng(7)
    o = 15
    sse = rng.random((6, o, o)) * 1e3
    edges = [[0.0, 0.0], [o - 1.0, o - 1.0], [0.0, o - 1.0], [o - 1.0, 0.0], [7.0, 3.0], [0.5, o - 1.0]]
    yx = np.concatenate([rng.uniform(0, o - 1, (6, 4, 2)), np.tile(edges, (6, 1, 1))], axis=1)
    y, x = yx[..., 0], yx[..., 1]
    coeff = sampling.bspline_prefilter_2d(torch.from_numpy(sse))
    got = [t.numpy() for t in sampling.bspline_derivatives(coeff, torch.from_numpy(y), torch.from_numpy(x))]
    c = coeff.numpy()
    for n in range(y.shape[1]):
        (by0, by1, by2), (bx0, bx1, bx2) = (
            [np.asarray(b, np.float64) for b in jax_refine._basis_with_derivs(jnp.asarray(q[:, n], jnp.float32), o)]
            for q in (y, x)
        )
        for k, (by, bx) in enumerate([(by0, bx0), (by1, bx0), (by0, bx1), (by2, bx0), (by0, bx2), (by1, bx1)]):
            want = np.einsum("ni,nij,nj->n", by, c, bx)
            np.testing.assert_allclose(got[k][:, n], want, atol=4e-6 * np.abs(c).max(), rtol=0)
    # At the nodes the value is the surface's.
    for n in range(4, 9):
        np.testing.assert_allclose(got[0][:, n], sse[:, int(y[0, n]), int(x[0, n])], atol=1e-8, rtol=0)


def test_tiles_are_exact_on_float_images() -> None:
    """The port cuts tiles by gathers, exact on any float image. The
    reference's bfloat16 one-hot matmuls round a non-integer image to 8
    significant bits (up to 0.5 at 128), so it is held to the port only on
    uint8-valued images."""
    img = _texture(seed=3)
    corners = np.array([[5, 9], [40, 2], [70, 85]])
    got = refine._extract_tiles(torch.from_numpy(img)[None], torch.from_numpy(corners)[None], 11)[0].numpy()
    for tile, (r, c) in zip(got, corners):
        np.testing.assert_array_equal(tile, img[r : r + 11, c : c + 11])
    ref = np.asarray(jax_refine._extract_tiles_onehot(jnp.asarray(img), jnp.asarray(corners), 11, jnp.bfloat16))
    assert 0.05 < np.abs(ref.astype(np.float32) - got).max() <= 0.5
    exact = _uint8(img)
    ref = np.asarray(jax_refine._extract_tiles_onehot(jnp.asarray(exact), jnp.asarray(corners), 11, jnp.bfloat16))
    got = refine._extract_tiles(torch.from_numpy(exact)[None], torch.from_numpy(corners)[None], 11)[0].numpy()
    np.testing.assert_array_equal(ref.astype(np.float32), got)
