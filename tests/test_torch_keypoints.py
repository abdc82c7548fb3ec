"""``optimize.KeypointMatcher`` and the keypoint entry points against the
reference's, on the CPU, from image files.

Four frames are reprojected from the test JPG (grayscale, 200 x 134) by
small rotations of its camera and written as PNG files, so both packages
decode the same bytes. Tolerances:

- the device detector: keypoints within 1e-3 px and descriptors within
  1e-4, the bounds of ``tests/test_torch_features.py``;
- the device matcher: identical ``row``/``col`` of the match matrix and
  match counts, uvs within 1e-3 px; the Lowe ratios behind the weights
  (``1 / weight``) within 1e-6 from the same descriptors, as
  ``tests/test_torch_matching.py`` holds them, and the weights within 1e-2
  relative from each package's own descriptors (they differ by up to 1e-4,
  and the ratio of two small descriptor distances amplifies that);
- the windows (``maxdt``, ``seq``, ``imgs``), ``drop_images``,
  ``match_breaks``, ``matches_per_image`` and ``images_per_image``: identical
  results, on the same keypoints;
- OpenCV's SIFT (where ``cv2`` imports): identical keypoints and
  descriptors, and ``KeypointMatcher`` held as the reference's
  ``tests/test_optimize.py:222`` holds it (FLANN's trees are randomized);
- ``ObserverCameras`` from the files to ``fit()``: view directions within
  2e-3 deg of the reference's, the bound of ``tests/test_torch_optimize.py``.
"""
import datetime

import numpy as np
import pytest
import scipy.ndimage

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
PIL = pytest.importorskip("PIL.Image")

import glimpse_tpu as ref
from glimpse_tpu import optimize as ref_optimize
import glimpse_tpu_torch as port
from glimpse_tpu_torch import optimize

from test_optimize import PATH
from test_torch_matching import _descriptors

SIZE = (200, 134)
CAM = {"imgsz": SIZE, "fmm": 20, "sensorsz": (23.6, 15.8)}
VIEWDIRS = [(0.0, 0.0, 0.0), (0.4, -0.3, 0.1), (0.9, -0.5, 0.2), (1.2, -0.9, 0.25)]
T0 = datetime.datetime(2020, 1, 1)
DETECT = dict(nfeatures=256, n_octaves=3, batch=4)
MATCH = dict(max_ratio=0.8, max_distance=40.0)


@pytest.fixture(scope="module")
def frame_paths(tmp_path_factory):
    """The PNG frames: frame i is the JPG seen through the camera turned
    to VIEWDIRS[i] (bilinear, edges held)."""
    base = np.asarray(PIL.open(PATH).convert("L").resize(SIZE, PIL.BILINEAR), dtype=float)
    cam0 = port.Camera(**CAM)
    u, v = np.meshgrid(np.arange(SIZE[0]) + 0.5, np.arange(SIZE[1]) + 0.5)
    uv = np.column_stack([u.ravel(), v.ravel()])
    folder = tmp_path_factory.mktemp("frames")
    paths = []
    for i, viewdir in enumerate(VIEWDIRS):
        cam = port.Camera(**CAM, viewdir=viewdir)
        puv = cam0.xyz_to_uv(cam.uv_to_xyz(uv), directions=True)
        frame = scipy.ndimage.map_coordinates(base, [puv[:, 1] - 0.5, puv[:, 0] - 0.5], order=1, mode="nearest")
        path = folder / f"frame_{i}.png"
        PIL.fromarray(np.clip(np.round(frame), 0, 255).astype(np.uint8).reshape(SIZE[1], SIZE[0])).save(path)
        paths.append(path)
    return paths


def images(module, paths):
    return [module.Image(p, cam=dict(CAM), datetime=T0 + datetime.timedelta(hours=i)) for i, p in enumerate(paths)]


def port_matcher(paths, **kwargs):
    return optimize.KeypointMatcher(images(port, paths), device="cpu", **kwargs)


def ref_matcher(paths, **kwargs):
    return ref_optimize.KeypointMatcher(images(ref, paths), **kwargs)


@pytest.fixture(scope="module")
def device_pair(frame_paths, tmp_path_factory):
    """Both packages' matchers after ``build_keypoints(detector="device")``
    and ``build_matches(matcher="device", weights=True)`` at offsets 1, 2."""
    folder = tmp_path_factory.mktemp("caches")
    pair = []
    for name, make in (("port", port_matcher), ("ref", ref_matcher)):
        matcher = make(frame_paths)
        matcher.build_keypoints(detector="device", path=folder / name / "kp", **DETECT)
        matcher.build_matches(seq=(1, 2), matcher="device", weights=True, clear_keypoints=False, **MATCH)
        pair.append(matcher)
    return pair


def test_device_keypoints_equal_the_reference(device_pair) -> None:
    got, want = device_pair
    for (gp, gd), (wp, wd) in zip(got.keypoints, want.keypoints):
        assert gp.shape == wp.shape and len(gp) > 100
        np.testing.assert_allclose(gp, wp, atol=1e-3, rtol=0)
        np.testing.assert_allclose(gd, wd, atol=1e-4, rtol=0)


def test_device_matches_equal_the_reference(device_pair) -> None:
    got, want = device_pair
    np.testing.assert_array_equal(got.matches.row, want.matches.row)
    np.testing.assert_array_equal(got.matches.col, want.matches.col)
    assert got.matches.shape == want.matches.shape
    for g, w in zip(got.matches.data, want.matches.data):
        assert g.size == w.size and g.size > 10
        for a, b in zip(g.uvs, w.uvs):
            np.testing.assert_allclose(a, b, atol=1e-3, rtol=0)
        np.testing.assert_allclose(g.weights, w.weights, rtol=1e-2, atol=0)
    np.testing.assert_array_equal(got.matches_per_image(), want.matches_per_image())
    np.testing.assert_array_equal(got.images_per_image(), want.images_per_image())


def test_refined_matches_equal_the_reference(frame_paths) -> None:
    """``refine=True`` re-measures each match by correlation on the images
    re-read from the files; the refined uvs agree within 1e-3 px."""
    pair = []
    for make in (port_matcher, ref_matcher):
        matcher = make(frame_paths)
        matcher.build_keypoints(detector="device", **DETECT)
        matcher.build_matches(seq=(1,), matcher="device", refine=dict(pad_matches=64, pairs_per_dispatch=4), **MATCH)
        pair.append(matcher)
    got, want = pair
    for g, w in zip(got.matches.data, want.matches.data):
        assert g.size == w.size and g.size > 10
        for a, b in zip(g.uvs, w.uvs):
            np.testing.assert_allclose(a, b, atol=1e-3, rtol=0)


def synthetic_keypoints(n_images: int, seed: int = 0):
    """Keypoints whose descriptors are SIFT-like unit vectors, each image's
    a noisy copy of half of one base set plus new rows (the descriptors of
    ``tests/test_torch_matching.py``), so that each pair matches."""
    rng = np.random.default_rng(seed)
    base = _descriptors(rng, 80)
    out = []
    for i in range(n_images):
        desc = _descriptors(rng, 60, base)
        out.append((rng.uniform(0, 100, size=(60, 2)).astype(np.float32), desc))
    return out


class _Img:
    def __init__(self, i: int, hours: float, camera):
        self.path = f"img_{i}.jpg"
        self.datetime = T0 + datetime.timedelta(hours=hours)
        self.cam = camera(imgsz=100, f=100)


@pytest.mark.parametrize("window", [
    dict(),
    dict(maxdt=datetime.timedelta(hours=2.5)),
    dict(seq=(1, 3, -1, 0)),
    dict(maxdt=datetime.timedelta(hours=1), seq=(4,)),
    dict(seq=(1, 2), imgs=[0, 2, 3]),
])
def test_windows_and_bookkeeping_equal_the_reference(window) -> None:
    hours = [0, 1, 2, 4, 5, 5.5, 9]
    kp = synthetic_keypoints(len(hours))
    pair = []
    for module, camera in ((optimize, port.Camera), (ref_optimize, ref.Camera)):
        kwargs = {"device": "cpu"} if module is optimize else {}
        matcher = module.KeypointMatcher([_Img(i, h, camera) for i, h in enumerate(hours)], **kwargs)
        matcher.keypoints = list(kp)
        matcher.build_matches(matcher="device", clear_keypoints=False, max_ratio=0.9, weights=True, **window)
        pair.append(matcher)
    got, want = pair
    np.testing.assert_array_equal(got.matches.row, want.matches.row)
    np.testing.assert_array_equal(got.matches.col, want.matches.col)
    assert [m.size for m in got.matches.data] == [m.size for m in want.matches.data]
    for g, w in zip(got.matches.data, want.matches.data):
        np.testing.assert_array_equal(g.uvs[0], w.uvs[0])
        np.testing.assert_allclose(1 / g.weights, 1 / w.weights, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got.matches_per_image(), want.matches_per_image())
    np.testing.assert_array_equal(got.images_per_image(), want.images_per_image())
    for min_matches in (0, 2, 3):
        np.testing.assert_array_equal(got.match_breaks(min_matches), want.match_breaks(min_matches))
    for m in (got, want):
        m.drop_images([1, 5])
    np.testing.assert_array_equal(got.matches.row, want.matches.row)
    np.testing.assert_array_equal(got.matches.col, want.matches.col)
    assert got.matches.shape == want.matches.shape
    assert [img.path for img in got.images] == [img.path for img in want.images]
    np.testing.assert_array_equal(got.match_breaks(), want.match_breaks())


def test_cache_contract_matches_the_reference(frame_paths, tmp_path, monkeypatch) -> None:
    """A second build reads the pickles and never detects; ``overwrite``
    detects again; ``clear_keypoints`` keeps nothing in memory; matches come
    back from their pickles unchanged; both packages leave the same files."""
    calls = []
    detect = optimize.detect_keypoints_device

    def counted(arrays, **kwargs):
        calls.append(len(arrays))
        return detect(arrays, **kwargs)

    monkeypatch.setattr(optimize, "detect_keypoints_device", counted)
    kp, mt = tmp_path / "kp", tmp_path / "m"
    first = port_matcher(frame_paths)
    first.build_keypoints(detector="device", path=kp, **DETECT)
    assert calls == [4] and len(list(kp.glob("*.pkl"))) == 4
    first.build_matches(seq=(1,), matcher="device", path=mt, clear_keypoints=False, **MATCH)
    second = port_matcher(frame_paths)
    second.build_keypoints(detector="device", path=kp, **DETECT)
    assert calls == [4]
    for (a, b), (c, d) in zip(first.keypoints, second.keypoints):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    second.build_matches(seq=(1,), matcher="device", path=mt, **MATCH)
    assert calls == [4]
    for g, w in zip(second.matches.data, first.matches.data):
        for a, b in zip(g.uvs, w.uvs):
            np.testing.assert_array_equal(a, b)
    second.build_keypoints(detector="device", path=kp, overwrite=True, **DETECT)
    assert calls == [4, 4]
    third = port_matcher(frame_paths)
    third.build_keypoints(detector="device", path=kp, clear_keypoints=True, **DETECT)
    assert calls == [4, 4] and third.keypoints == [None] * 4
    with pytest.raises(ValueError, match="path is required"):
        third.build_keypoints(detector="device", clear_keypoints=True)
    with pytest.raises(ValueError, match="keypoints_path is required"):
        third.build_matches(seq=(1,), matcher="device")
    third.build_matches(seq=(1,), matcher="device", keypoints_path=kp, path=tmp_path / "m2", clear_matches=True,
                        **MATCH)
    assert third.matches is None and len(list((tmp_path / "m2").glob("*.pkl"))) == 3
    with pytest.raises(TypeError, match="reduce"):  # the reference's fault, recorded
        ref_matcher(frame_paths).build_matches(seq=(1,), matcher="device", keypoints_path=kp, path=tmp_path / "m3",
                                               clear_matches=True, **MATCH)
    reference = ref_matcher(frame_paths)
    reference.build_keypoints(detector="device", path=tmp_path / "rkp", **DETECT)
    reference.build_matches(seq=(1,), matcher="device", path=tmp_path / "rm", **MATCH)
    assert sorted(p.name for p in mt.iterdir()) == sorted(p.name for p in (tmp_path / "rm").iterdir())
    assert sorted(p.name for p in kp.iterdir()) == sorted(p.name for p in (tmp_path / "rkp").iterdir())


def test_opencv_keypoints_equal_the_reference(frame_paths, tmp_path) -> None:
    """With OpenCV: ``detect_keypoints`` equals the reference's; the host
    ``KeypointMatcher`` caches, matches and chains as the reference's own
    test asks (FLANN's randomized trees make counts vary run to run)."""
    pytest.importorskip("cv2")
    array = np.asarray(PIL.open(frame_paths[0]), dtype=float)
    for root in (False, True):
        got = optimize.detect_keypoints(array, root=root, contrastThreshold=0.02)
        want = ref_optimize.detect_keypoints(array, root=root, contrastThreshold=0.02)
        np.testing.assert_array_equal(optimize._keypoint_pts(got[0]), ref_optimize._keypoint_pts(want[0]))
        np.testing.assert_array_equal(got[1], want[1])
    matcher = port_matcher(frame_paths[:3])
    kp_dir = tmp_path / "keypoints"
    matcher.build_keypoints(path=kp_dir, contrastThreshold=0.02)
    assert len(list(kp_dir.glob("*.pkl"))) == 3
    matcher.build_matches(maxdt=datetime.timedelta(hours=1), path=tmp_path / "matches")
    assert matcher.matches.data.size == 2
    counts = matcher.matches_per_image()
    assert counts.shape == (3,) and (counts > 0).all()
    assert len(matcher.match_breaks()) == 0


def test_host_path_needs_opencv(monkeypatch) -> None:
    """Without OpenCV the host detector and matcher raise ImportError and
    never fall back to the device."""
    monkeypatch.setitem(__import__("sys").modules, "cv2", None)
    with pytest.raises(ImportError):
        optimize.detect_keypoints(np.zeros((8, 8)))
    kp = synthetic_keypoints(2)
    with pytest.raises(ImportError):
        optimize.match_keypoints(kp[0], kp[1])
    assert len(optimize.match_keypoints(kp[0], kp[1], matcher="device", device="cpu")[0]) > 0
    clahe = optimize.KeypointMatcher._make_clahe(True)
    assert isinstance(clahe, optimize._NumpyCLAHE)
    with pytest.raises(TypeError):
        optimize.KeypointMatcher._make_clahe({"bogus": 1})


def test_observer_cameras_from_files_agree_with_the_reference(frame_paths, tmp_path) -> None:
    """``ObserverCameras`` from PNG files: device keypoints, device matches
    at offsets 1-2 with refinement, then ``fit(maxiter=300)`` (four frames
    converge well before the default 2,000 iterations, which cost the port
    about 20 ms each on the CPU); the fitted view directions agree with the
    reference's within 2e-3 deg and recover the frames' rotations within
    0.05 deg."""
    fits = []
    for module, kwargs in ((port, {"device": "cpu"}), (ref, {})):
        observer = module.Observer(images(module, frame_paths), cache=False)
        model = module.optimize.ObserverCameras(observer, anchors=[0], **kwargs)
        model.build_keypoints(detector="device", path=tmp_path / module.__name__ / "kp", **DETECT)
        model.build_matches(seq=(1, 2), matcher="device", refine=dict(pad_matches=64, pairs_per_dispatch=4),
                            path=tmp_path / module.__name__ / "m", **MATCH)
        assert len(model._flatten_matches()[0]) > 50
        fits.append(model.fit(maxiter=300).x.reshape(-1, 3))
    got, want = fits
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=0)
    np.testing.assert_allclose(got, VIEWDIRS, atol=0.05, rtol=0)
