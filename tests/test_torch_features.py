"""The port's keypoint detector against the reference's, on seeded images.

Three 96x96 textures, 128 keypoints, three octaves, batches of 2 (so the
last batch is filled up). Keypoint counts and validity must be identical,
points within 1e-3 px and descriptors within 1e-4: both sides run float32
convolutions that round differently, and the Newton fit of a broad extremum
amplifies that. The scene's seed was chosen by a scan so that no two scores
nearly tie at an octave's quota, where a rounding could swap a keypoint.
"""
import numpy as np
import pytest
import scipy.ndimage

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

from glimpse_tpu.ops import features as jax_features
from glimpse_tpu_torch.ops import features


def _scene(seed=1, n=96):
    rng = np.random.default_rng(seed)
    images = []
    for _ in range(3):
        t = scipy.ndimage.gaussian_filter(rng.normal(size=(n, n)), rng.uniform(1.0, 2.0))
        images.append(np.clip(128 + 70 * t / np.abs(t).max(), 0, 255).astype(np.uint8))
    left = np.zeros((n, n), np.uint8)
    left[:, : n * 2 // 3] = 255
    band = np.ones((n, n), np.uint8)
    band[n // 3 : n // 2] = 0
    return images, [left, None, band]


@pytest.mark.parametrize("refine, masked", [("lattice", True), ("lattice", False), ("bilinear", False)])
def test_detect_and_describe_matches_jax(refine, masked) -> None:
    images, masks = _scene()
    masks = masks if masked else None
    kwargs = dict(nfeatures=128, batch=2, n_octaves=3, refine=refine)
    want = jax_features.detect_and_describe(images, masks, **kwargs)
    got = features.detect_and_describe(images, masks, device="cpu", **kwargs)
    assert len(got) == len(images)
    for (gp, gd), (wp, wd) in zip(got, want):
        assert gp.shape == wp.shape and gd.shape == (len(gp), 128)
        assert len(gp) > 60
        np.testing.assert_allclose(gp, wp, atol=1e-3, rtol=0)
        np.testing.assert_allclose(gd, wd, atol=1e-4, rtol=0)
    if masked:
        # No keypoint on the masked-out band of image 3 (nor within the
        # descriptor border around it) or right of image 1's mask.
        assert (got[0][0][:, 0] < 64 - 3).all()
        y = got[2][0][:, 1]
        assert not ((y > 32 - 4) & (y < 48 + 3)).any()


def test_batch_validity_and_slots_match_jax() -> None:
    """The fixed-slot batch: validity identical, valid points within 1e-3 px,
    scores within 1e-6, and the slots' sizes (octave and level) identical."""
    images, masks = _scene()
    imgs = np.stack(images[:2])
    mask = np.stack([masks[0], np.ones_like(masks[0])])
    kwargs = dict(nfeatures=128, n_octaves=3, refine="lattice")
    want = [np.asarray(a) for a in jax_features._detect_batch(jnp.asarray(imgs), jnp.asarray(mask), has_mask=True, **kwargs)]
    got = [t.numpy() for t in features.detect_batch(torch.from_numpy(imgs), torch.from_numpy(mask), **kwargs)]
    np.testing.assert_array_equal(got[4], want[4])
    valid = got[4]
    np.testing.assert_allclose(got[0][valid], want[0][valid], atol=1e-3, rtol=0)
    np.testing.assert_array_equal(got[1][valid], want[1][valid])
    np.testing.assert_allclose(got[2], want[2], atol=1e-6, rtol=0)


@pytest.mark.parametrize("shape", [(2, 17, 23), (1, 8, 8)])
def test_upsample_matches_jax_resize(shape) -> None:
    """The 2x upsampling against jax.image.resize, borders included:
    "linear" within float32 rounding, "nearest" exactly."""
    rng = np.random.default_rng(4)
    x = rng.random(shape).astype(np.float32)
    big = (shape[0], 2 * shape[1], 2 * shape[2])
    got = features.upsample2(torch.from_numpy(x), "bilinear").numpy()
    want = np.asarray(jax.image.resize(jnp.asarray(x), big, "linear"))
    np.testing.assert_allclose(got, want, atol=3e-7, rtol=0)
    np.testing.assert_array_equal(got[:, 0, 0], x[:, 0, 0])  # the edges replicate
    np.testing.assert_array_equal(got[:, -1, -1], x[:, -1, -1])
    m = (rng.random(shape) > 0.5).astype(np.float32)
    np.testing.assert_array_equal(
        features.upsample2(torch.from_numpy(m), "nearest").numpy(),
        np.asarray(jax.image.resize(jnp.asarray(m), big, "nearest")),
    )


def test_equal_scores_keep_the_lower_index() -> None:
    """Two bit-identical blobs give two equal DoG scores; with a quota of 1
    both packages keep the one at the lower flat index (lax.top_k's rule),
    and with a quota of 2 both, in index order."""
    n_scales, H, W = 2, 32, 48
    yy, xx = np.mgrid[0:11, 0:11] - 5.0
    bump = np.exp(-(yy**2 + xx**2) / 8.0).astype(np.float32)
    levels = np.zeros((n_scales + 2, H, W), np.float32)
    for lev, c in enumerate((0.02, 0.06, 0.03, 0.01)):
        for x0 in (30, 8):  # the right blob first, so the order is not the writing order
            levels[lev, 10:21, x0 : x0 + 11] = c * bump
    gauss = np.concatenate([np.zeros((1, 1, H, W), np.float32), np.cumsum(levels, axis=0)[None]], axis=1)
    for quota in (1, 2):
        args = (quota, n_scales, 1.6, 0.001, 10.0, 4)
        want = jax.jit(jax_features._octave_detect, static_argnums=tuple(range(1, 8)))(jnp.asarray(gauss), None, *args)
        got = features._octave_detect(torch.from_numpy(gauss), None, *args)
        scores = got[3].numpy()[0]
        assert got[5].numpy()[0].all()
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        assert got[1].numpy()[0, 0] < 20  # the left blob, at the lower index
        if quota == 2:
            assert scores[0] == scores[1]
            assert got[1].numpy()[0, 1] > 30
