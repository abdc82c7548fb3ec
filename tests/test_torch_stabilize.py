"""The stabilization chain of both packages side by side on a rendered sequence.

Six 128x128 frames of benchmarks/columbia_pipeline.py's scene, cut down: a
static textured plane seen by an oblique camera that wobbles by (0.1, 0.1,
0.03) deg per frame. Each package detects keypoints (128 per frame),
matches the pairs at offsets (1, 2) (ratio 0.75, at most 20 px apart),
turns the matches into camera rays, fits the view directions with its
device L-BFGS (frame 0 anchored), refines the matches by correlation and
fits again. The fitted view directions of the two packages agree within
2e-3 deg in both fits.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import scipy.ndimage
import scipy.sparse

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from glimpse_tpu import Camera
from glimpse_tpu import optimize as jax_optimize
from glimpse_tpu.ops import features as jax_features
from glimpse_tpu.ops import matching as jax_matching
from glimpse_tpu.ops import projection as jax_projection
from glimpse_tpu.ops import refine as jax_refine
from glimpse_tpu_torch import optimize
from glimpse_tpu_torch.ops import features, matching, projection, refine

IMG = 128
CAM_XYZ = (IMG / 2, -50.0, 100.0)
CAM_VIEWDIR = (0.0, -35.0, 0.0)
JITTER_DEG = (0.1, 0.1, 0.03)
OFFSETS = (1, 2)


def _render(n_frames=6, pad=32):
    """Frames (n, IMG, IMG) uint8, the true view directions and the nominal
    camera vector."""
    rng = np.random.default_rng(0)
    terrain = scipy.ndimage.gaussian_filter(rng.normal(size=(IMG + 2 * pad,) * 2), 1.2) * 55 + 128
    truth = np.tile(CAM_VIEWDIR, (n_frames, 1))
    truth[1:] += np.random.default_rng(42).normal(0, JITTER_DEG, size=(n_frames - 1, 3))
    base = Camera(imgsz=IMG, f=IMG, xyz=CAM_XYZ, viewdir=CAM_VIEWDIR).to_array()
    u, v = np.meshgrid(np.arange(IMG) + 0.5, np.arange(IMG) + 0.5)
    uv = np.column_stack([u.ravel(), v.ravel()])
    frames = []
    for viewdir in truth:
        vector = base.copy()
        vector[3:6] = viewdir
        rays = jax_projection.unproject(vector, uv, xp=np)
        t = -CAM_XYZ[2] / rays[:, 2]
        wx, wy = CAM_XYZ[0] + t * rays[:, 0], CAM_XYZ[1] + t * rays[:, 1]
        img = scipy.ndimage.map_coordinates(terrain, [wy + pad, wx + pad], order=1, mode="nearest")
        frames.append(np.clip(img, 0, 255).astype(np.uint8).reshape(IMG, IMG))
    return np.stack(frames), truth, base


class _Image:
    def __init__(self, cam):
        self.cam = cam


class _Observer:
    def __init__(self, cams):
        self.images = [_Image(c) for c in cams]


def _pairs(n):
    return np.array([(i, i + s) for i in range(n) for s in OFFSETS if i + s < n])


def _matched_uvs(keypoints, pairs, found):
    out = []
    for (i, j), (idx, _) in zip(pairs, found):
        uva, uvb = keypoints[i][0][idx[:, 0]].astype(float), keypoints[j][0][idx[:, 1]].astype(float)
        ok = np.linalg.norm(uva - uvb, axis=1) < 20.0
        out.append((uva[ok], uvb[ok]))
    return out


def _coo(pairs, objs, n):
    matches = scipy.sparse.coo_matrix((np.ones(len(objs)), tuple(pairs.T)), shape=(n, n))
    matches.data = np.array(objs, dtype=object)
    return matches


def _jax_chain(frames, base):
    n = len(frames)
    keypoints = jax_features.detect_and_describe(list(frames), nfeatures=128, n_octaves=3, batch=n)
    pairs = _pairs(n)
    found = jax_matching.DescriptorMatcher().match_pairs([k[1] for k in keypoints], pairs, max_ratio=0.75)
    uvs = _matched_uvs(keypoints, pairs, found)
    cams = [Camera(imgsz=IMG, f=IMG, xyz=CAM_XYZ, viewdir=CAM_VIEWDIR) for _ in range(n)]

    def fit(uvs):
        objs = [jax_optimize.RotationMatchesXYZ(cams=(cams[i], cams[j]), uvs=list(uv)) for (i, j), uv in zip(pairs, uvs)]
        return jax_optimize.ObserverCameras(_Observer(cams), matches=_coo(pairs, objs, n), anchors=[0]).fit()

    first = fit(uvs)
    refined = jax_refine.MatchRefiner(pad_matches=64, pairs_per_dispatch=4).refine_pairs(
        [tuple(p) for p in pairs], uvs, lambda k: frames[k].astype(np.float32)
    )
    return keypoints, uvs, first, fit(refined)


def _port_chain(frames, base):
    n = len(frames)
    keypoints = features.detect_and_describe(list(frames), nfeatures=128, n_octaves=3, batch=n, device="cpu")
    pairs = _pairs(n)
    found = matching.DescriptorMatcher(device="cpu").match_pairs([k[1] for k in keypoints], pairs, max_ratio=0.75)
    uvs = _matched_uvs(keypoints, pairs, found)
    observer = SimpleNamespace(images=[SimpleNamespace(cam=SimpleNamespace(viewdir=np.array(CAM_VIEWDIR)))] * n)

    def fit(uvs):
        objs = []
        for uv in uvs:
            xys = [projection.image_to_camera(torch.from_numpy(u), base[6:8], base[8:10], base[10:12], base[12:18],
                                              base[18:20]).numpy() for u in uv]
            objs.append(optimize.RotationMatchesXYZ(cams=(base, base), xys=xys))
        return optimize.ObserverCameras(observer, matches=_coo(pairs, objs, n), anchors=[0], device="cpu").fit()

    first = fit(uvs)
    refined = refine.MatchRefiner(pad_matches=64, pairs_per_dispatch=4, device="cpu").refine_pairs(
        [tuple(p) for p in pairs], uvs, lambda k: frames[k].astype(np.float32)
    )
    return keypoints, uvs, first, fit(refined)


def _rotation_errors(a, b):
    R = np.einsum("nij,nkj->nik", *(jax_projection.rotation_matrix(np.asarray(v, float), xp=np) for v in (a, b)))
    return np.degrees(np.arccos(np.clip((np.trace(R, axis1=-2, axis2=-1) - 1) / 2, -1, 1)))


def test_stabilization_chain_matches_jax() -> None:
    frames, truth, base = _render()
    want = _jax_chain(frames, base)
    got = _port_chain(frames, base)
    # Keypoints and matches as tests/test_torch_features.py holds them, but
    # at 1e-2 px: this scene's seed was not scanned for near-ties.
    for (gp, gd), (wp, wd) in zip(got[0], want[0]):
        assert gp.shape == wp.shape and len(gp) > 60
        np.testing.assert_allclose(gp, wp, atol=1e-2, rtol=0)
    for (ga, gb), (wa, wb) in zip(got[1], want[1]):
        assert ga.shape == wa.shape and len(ga) > 10
        np.testing.assert_allclose(ga, wa, atol=1e-2, rtol=0)
        np.testing.assert_allclose(gb, wb, atol=1e-2, rtol=0)
    for g, w in zip(got[2:], want[2:]):
        assert g.success
        fitted, reference = g.x.reshape(-1, 3), w.x.reshape(-1, 3)
        np.testing.assert_allclose(fitted, reference, atol=2e-3, rtol=0)
        np.testing.assert_array_equal(fitted[0], CAM_VIEWDIR)
        assert _rotation_errors(fitted, truth).max() < 0.05
