"""``glimpse_tpu_torch.convert`` against ``glimpse_tpu.convert``.

The fourteen cases of ``tests/test_convert.py``, each run on the port
(``device="cpu"``) with the reference's assertions, and held to the
reference's own result on the same input: readers give identical
attributes and exact conversions agree within 1e-12 (residuals and camera
vectors). A fit with no ``jac`` runs the reference's algorithm (scipy's
2-point differences of the host residual) and gives the reference's
parameters bit for bit in all four formats. Optimized conversions also run
with ``jac="2-point"`` given, and with ``jac="exact"``. With the exact
Jacobian, the fits of Matlab's and Agisoft's distortion coefficients to a
port camera agree within 1e-6 relative too (6e-11 measured). The others are
not identifiable to that precision: a port camera's (f, c, k1-k6, p) against
a model with fewer radial terms (k4-k6 are nearly collinear with k1-k3; up
to 11 % apart at equal cost), PhotoModeler's focal length with its sensor
size and principal point (one common scale leaves the residuals unchanged,
and the exact fit walks along it), and PhotoModeler's k1-k3 (0.3 % apart).
Those are held to a cost (sum of squared residuals) no larger than the
reference's, within 1e-9 relative.
"""
from pathlib import Path

import numpy as np
import pytest

import glimpse_tpu as ref
from glimpse_tpu import convert as ref_convert
from glimpse_tpu_torch import Camera
from glimpse_tpu_torch import convert
from glimpse_tpu_torch.convert import Agisoft, Converter, Matlab, OpenCV, PhotoModeler

ASSETS = Path(__file__).parent / "assets"
CPU = dict(device="cpu")


def both_cameras(**kwargs):
    return Camera(**kwargs), ref.Camera(**kwargs)


def assert_same_xcam(got, want, rtol=0.0) -> None:
    assert type(got).__name__ == type(want).__name__
    a, b = vars(got), vars(want)
    assert sorted(a) == sorted(b)
    for key in a:
        np.testing.assert_allclose(np.asarray(a[key], dtype=float), np.asarray(b[key], dtype=float),
                                   rtol=rtol, atol=1e-12 if rtol == 0 else 0, err_msg=key)


def assert_same_cam(got, want) -> None:
    np.testing.assert_allclose(got.to_array(), want.to_array(), rtol=0, atol=1e-12)


def cost(xcam, cam, converter) -> float:
    return float(np.sum(converter(xcam, cam).residuals() ** 2))


def assert_fit_xcam(xcam, cam, rxcam, rcam, jac, identifiable: bool = True) -> None:
    """An external camera's fit against the reference's (see the module)."""
    a = np.concatenate([np.atleast_1d(np.asarray(v, dtype=float)) for v in vars(xcam).values()])
    b = np.concatenate([np.atleast_1d(np.asarray(v, dtype=float)) for v in vars(rxcam).values()])
    if jac == "2-point" or identifiable:
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=0)
    else:
        assert cost(xcam, cam, Converter) <= cost(rxcam, rcam, ref_convert.Converter) * (1 + 1e-9)


def assert_fit_cam(cam, xcam, rcam, rxcam, jac) -> None:
    """A port camera's fit against the reference's (see the module)."""
    if jac == "2-point":
        np.testing.assert_allclose(cam.to_array(), rcam.to_array(), rtol=1e-6, atol=0)
    else:
        assert cost(xcam, cam, Converter) <= cost(rxcam, rcam, ref_convert.Converter) * (1 + 1e-9)


def test_reads_matlab_means_from_report() -> None:
    xcam = Matlab.from_report(ASSETS / "Calib_Results.m", sigmas=False)
    assert vars(xcam) == vars(ref_convert.Matlab.from_report(ASSETS / "Calib_Results.m", sigmas=False))
    assert vars(xcam) == vars(Matlab(fc=(3750.8, 3747.9), cc=(2148.1, 1417.0), alpha_c=0.0,
                                     kc=(-0.1, 0.1, 0.0, 0.0, -0.0), imgsz=(4288, 2848)))


def test_reads_matlab_sigmas_from_report() -> None:
    xcam = Matlab.from_report(ASSETS / "Calib_Results.m", sigmas=True)
    assert vars(xcam) == vars(ref_convert.Matlab.from_report(ASSETS / "Calib_Results.m", sigmas=True))
    assert vars(xcam) == vars(Matlab(fc=(1.80 / 3, 1.82 / 3), cc=(1.0 / 3, 1.4 / 3), alpha_c=0,
                                     kc=(0.002 / 3, 0.004 / 3, 0.0, 0.0, 0.0), imgsz=(0, 0)))


DISTORTED = dict(imgsz=(4288, 2848), f=(3100, 3200), c=(5, -4), k=(0.1, -0.05, 0.02), p=(0.03, 0.04))
DISTORTED_K4 = dict(imgsz=(4288, 2848), f=(3100, 3200), c=(5, -4), k=(0.1, -0.05, 0.02, 0.003), p=(0.03, 0.04))


@pytest.mark.parametrize("fmt", ["Matlab", "Agisoft"])
def test_converts_and_back_exactly(fmt) -> None:
    cam, rcam = both_cameras(**DISTORTED)
    xcam = getattr(convert, fmt).from_camera(cam, **CPU)
    rxcam = getattr(ref_convert, fmt).from_camera(rcam)
    assert_same_xcam(xcam, rxcam)
    residuals = Converter(xcam, cam, **CPU).residuals()
    np.testing.assert_allclose(residuals, 0, rtol=0, atol=1e-11)
    np.testing.assert_allclose(residuals, ref_convert.Converter(rxcam, rcam).residuals(), rtol=0, atol=1e-12)
    cam2 = xcam.to_camera(**CPU)
    np.testing.assert_equal(cam.to_array(), cam2.to_array())
    assert_same_cam(cam2, rxcam.to_camera())


JACS = ["exact", "2-point"]


@pytest.mark.parametrize("jac", JACS)
def test_converts_to_matlab_and_back_by_optimization(jac) -> None:
    cam, rcam = both_cameras(**DISTORTED_K4)
    residuals_initial = Converter(Matlab.from_camera(cam, optimize=False), cam, **CPU).residuals()
    xcam = Matlab.from_camera(cam, jac=jac, **CPU)
    rxcam = ref_convert.Matlab.from_camera(rcam)
    assert_fit_xcam(xcam, cam, rxcam, rcam, jac)
    residuals = Converter(xcam, cam, **CPU).residuals()
    assert np.sum(residuals ** 2) < np.sum(residuals_initial ** 2)
    np.testing.assert_allclose(residuals, 0, rtol=0, atol=1e-2)
    xcam.alpha_c = 1e-6
    rxcam.alpha_c = 1e-6
    cam_initial = xcam.to_camera(optimize=False)
    residuals_initial = Converter(xcam, cam_initial, **CPU).residuals()
    cam = xcam.to_camera(jac=jac, **CPU)
    assert_fit_cam(cam, xcam, rxcam.to_camera(), rxcam, jac)
    residuals = Converter(xcam, cam, **CPU).residuals()
    assert np.sum(residuals ** 2) < np.sum(residuals_initial ** 2)
    np.testing.assert_allclose(residuals, 0, rtol=0, atol=1e-2)


def test_reads_agisoft_from_xml() -> None:
    xcam = Agisoft.from_xml(ASSETS / "agisoft.xml")
    assert vars(xcam) == vars(ref_convert.Agisoft.from_xml(ASSETS / "agisoft.xml"))
    assert vars(xcam) == vars(Agisoft(imgsz=(4288, 2848), f=3570.0, cx=3.0, cy=4.0, b2=15.0, k1=0.1, k2=-0.1,
                                      k3=0.01, p1=0.01, p2=-0.01))


@pytest.mark.parametrize("jac", JACS)
def test_converts_to_agisoft_and_back_by_optimization(jac) -> None:
    cam, rcam = both_cameras(**DISTORTED_K4)
    residuals_initial = Converter(Agisoft.from_camera(cam, optimize=False), cam, **CPU).residuals()
    xcam = Agisoft.from_camera(cam, jac=jac, **CPU)
    rxcam = ref_convert.Agisoft.from_camera(rcam)
    assert_fit_xcam(xcam, cam, rxcam, rcam, jac)
    residuals = Converter(xcam, cam, **CPU).residuals()
    assert np.sum(residuals ** 2) < np.sum(residuals_initial ** 2)
    np.testing.assert_allclose(residuals, 0, rtol=0, atol=1e-2)
    for x in (xcam, rxcam):
        x.k4 = 1e-7
        x.b2 = 1e-12
    cam_initial = xcam.to_camera(optimize=False)
    residuals_initial = Converter(xcam, cam_initial, **CPU).residuals()
    cam = xcam.to_camera(jac=jac, **CPU)
    assert_fit_cam(cam, xcam, rxcam.to_camera(), rxcam, jac)
    residuals = Converter(xcam, cam, **CPU).residuals()
    assert np.sum(residuals ** 2) < np.sum(residuals_initial ** 2)
    np.testing.assert_allclose(residuals, 0, rtol=0, atol=1e-9)


@pytest.mark.parametrize("sigmas", [False, True])
def test_reads_photomodeler_from_report(sigmas) -> None:
    imgsz = (4288, 2848)
    path = ASSETS / "CalibrationReport.txt"
    xcam = PhotoModeler.from_report(path, imgsz=imgsz, sigmas=sigmas)
    assert vars(xcam) == vars(ref_convert.PhotoModeler.from_report(path, imgsz=imgsz, sigmas=sigmas))
    if sigmas:
        want = dict(focal=0.001, xp=0.001, yp=7.1e-004, fw=1.7e-004, fh=0.0, k1=2.0e-007, k2=1.2e-009, k3=0.0,
                    p1=3.5e-007, p2=0.0)
    else:
        want = dict(focal=29.414069, xp=12.009446, yp=8.105847, fw=24.001371, fh=15.940299, k1=1.423e-004,
                    k2=-1.576e-007, k3=0.0, p1=3.703e-006, p2=0.0)
    assert vars(xcam) == vars(PhotoModeler(imgsz=imgsz, **want))


def test_converts_to_photomodeler_and_back_exactly() -> None:
    cam, rcam = both_cameras(imgsz=(4288, 2848), fmm=(3200, 3200), cmm=(0.5, -0.4), sensorsz=(35.1, 24.2))
    xcam = PhotoModeler.from_camera(cam, **CPU)
    assert_same_xcam(xcam, ref_convert.PhotoModeler.from_camera(rcam))
    residuals = Converter(xcam, cam, **CPU).residuals()
    np.testing.assert_allclose(residuals, 0, rtol=0, atol=1e-12)
    cam2 = xcam.to_camera(**CPU)
    np.testing.assert_allclose(cam.to_array(), cam2.to_array(), rtol=0, atol=1e-13)


@pytest.mark.parametrize("jac", JACS)
def test_converts_to_photomodeler_and_back_by_optimization(jac) -> None:
    cam, rcam = both_cameras(imgsz=(4288, 2848), fmm=(3100, 3200), cmm=(0.5, -0.4), sensorsz=(35.1, 24.2))
    residuals_initial = Converter(PhotoModeler.from_camera(cam, optimize=False), cam, **CPU).residuals()
    xcam = PhotoModeler.from_camera(cam, jac=jac, **CPU)
    assert_fit_xcam(xcam, cam, ref_convert.PhotoModeler.from_camera(rcam), rcam, jac, identifiable=False)
    residuals = Converter(xcam, cam, **CPU).residuals()
    assert np.sum(residuals ** 2) < np.sum(residuals_initial ** 2)
    np.testing.assert_allclose(residuals, 0, rtol=0, atol=1e-12)
    cam, rcam = both_cameras(imgsz=(4288, 2848), fmm=(3200, 3200), cmm=(0.5, -0.4), sensorsz=(35.1, 24.2),
                             k=(0.1, -0.05), p=(0.03, 0.04))
    residuals_initial = Converter(PhotoModeler.from_camera(cam, optimize=False), cam, **CPU).residuals()
    xcam = PhotoModeler.from_camera(cam, jac=jac, **CPU)
    rxcam = ref_convert.PhotoModeler.from_camera(rcam)
    assert_fit_xcam(xcam, cam, rxcam, rcam, jac, identifiable=False)
    residuals = Converter(xcam, cam, **CPU).residuals()
    assert np.sum(residuals ** 2) < np.sum(residuals_initial ** 2)
    np.testing.assert_allclose(residuals, 0, rtol=0, atol=1e-2)
    cam_initial = xcam.to_camera(optimize=False)
    residuals_initial = Converter(xcam, cam_initial, **CPU).residuals()
    cam = xcam.to_camera(jac=jac, **CPU)
    assert_fit_cam(cam, xcam, rxcam.to_camera(), rxcam, jac)
    residuals = Converter(xcam, cam, **CPU).residuals()
    assert np.sum(residuals ** 2) < np.sum(residuals_initial ** 2)
    np.testing.assert_allclose(residuals, 0, rtol=0, atol=1e-2)


def test_reads_opencv_from_xml() -> None:
    imgsz = (4288, 2848)
    f = {"fx": 3.57e03, "fy": 3.58e03}
    c = {"cx": 2.15e03, "cy": 1.43e03}
    coeffs = {
        "k1": 1.1e-01, "k2": -1.2e-01, "p1": -9.98e-03, "p2": 9.99e-03,
        "k3": 1.0e-02, "k4": 1.1e-03, "k5": 1.2e-03, "k6": 1.3e-03,
        "s1": 1.0e-05, "s2": 1.1e-05, "s3": 1.2e-05, "s4": 1.3e-05,
    }
    xcam = OpenCV.from_xml(ASSETS / "opencv.xml", imgsz=imgsz)
    assert vars(xcam) == vars(ref_convert.OpenCV.from_xml(ASSETS / "opencv.xml", imgsz=imgsz))
    assert vars(xcam) == vars(OpenCV(imgsz=imgsz, **{**f, **c, **coeffs}))
    arrays = OpenCV.from_arrays(imgsz=imgsz, cameraMatrix=[(f["fx"], 0, c["cx"]), (0, f["fy"], c["cy"]), (0, 0, 1)],
                                distCoeffs=list(coeffs.values()))
    assert vars(xcam) == vars(arrays)


OPENCV_CAM = dict(imgsz=(4288, 2848), f=(3100, 3200), c=(5, -4), k=(0.1, -0.05, 0.02, 0.003, 0.004, 0.005),
                  p=(0.03, 0.04))


def test_converts_to_opencv_and_back_exactly() -> None:
    cam, rcam = both_cameras(**OPENCV_CAM)
    xcam = OpenCV.from_camera(cam)
    assert_same_xcam(xcam, ref_convert.OpenCV.from_camera(rcam))
    residuals = Converter(xcam, cam, **CPU).residuals()
    np.testing.assert_equal(residuals, 0)
    cam2 = xcam.to_camera(**CPU)
    np.testing.assert_equal(cam.to_array(), cam2.to_array())


@pytest.mark.parametrize("jac", JACS)
def test_converts_to_opencv_and_back_by_optimization(jac) -> None:
    cam, rcam = both_cameras(**OPENCV_CAM)
    xcam = OpenCV.from_camera(cam)
    rxcam = ref_convert.OpenCV.from_camera(rcam)
    xcam.s1 = rxcam.s1 = 1e-5
    cam_initial = xcam.to_camera(optimize=False)
    residuals_initial = Converter(xcam, cam_initial, **CPU).residuals()
    cam = xcam.to_camera(jac=jac, **CPU)
    assert_fit_cam(cam, xcam, rxcam.to_camera(), rxcam, jac)
    residuals = Converter(xcam, cam, **CPU).residuals()
    assert np.sum(residuals ** 2) < np.sum(residuals_initial ** 2)
    np.testing.assert_allclose(residuals, 0, rtol=0, atol=1e-2)


def test_errors_for_unequal_image_size() -> None:
    cam = Camera(imgsz=(100, 200), f=(10, 10))
    xcam = Matlab(imgsz=(100, 100), fc=(10, 10))
    with pytest.raises(ValueError):
        Converter(xcam, cam, **CPU)


@pytest.mark.parametrize("which", ["cam", "xcam"])
def test_exact_jacobian_matches_central_differences(which) -> None:
    """The fits' exact Jacobian (through the Oulu undistortion for an
    outgoing model) against central differences of the host residual
    (steps of 1e-4 of each parameter, 1e-7 at most for a zero one), within
    1e-6 of each column's scale."""
    cam = Camera(**DISTORTED_K4)
    xcam = Matlab.from_camera(cam, optimize=False)
    xcam.alpha_c = 1e-4
    fitter = Converter(xcam, cam, uv=200, **CPU)
    if which == "cam":
        mask, _ = convert.converter.optimize_module.Cameras.parse_params({"f": True, "k": True, "p": True})
        vector = cam._vector
        x0 = vector[mask].copy()
        scatter = np.zeros((20, x0.size))
        scatter[np.flatnonzero(mask), np.arange(x0.size)] = 1
        held = fitter._const(np.where(mask, 0.0, vector))

        def build(values):
            return fitter._residual_tensor(held + fitter._const(scatter) @ values, xcam)

        def host(values):
            vector[mask] = values
            return fitter.residuals().ravel()
    else:
        slots = fitter._xcam_slots({"kc": True, "fc": True})
        x0 = np.concatenate([np.asarray(getattr(xcam, name), dtype=float)[picked] for name, picked in slots])

        def build(flat):
            return fitter._residual_tensor(fitter._const(cam._vector), fitter._xcam_on_tensors(slots, flat))

        def host(values):
            fitter._write_xcam(slots, values)
            return fitter.residuals().ravel()

    jac = fitter._jacobian(build, x0)
    for i in range(x0.size):
        h = 1e-4 * max(abs(x0[i]), 1e-3)
        up, down = x0.copy(), x0.copy()
        up[i] += h
        down[i] -= h
        column = (host(up) - host(down)) / (2 * h)
        host(x0)
        scale = np.abs(column).max()
        np.testing.assert_allclose(jac[:, i], column, rtol=0, atol=1e-6 * scale + 1e-9)


def flat_xcam(xcam) -> np.ndarray:
    return np.concatenate([np.atleast_1d(np.asarray(v, dtype=float)) for v in vars(xcam).values()])


@pytest.mark.parametrize("fmt", ["Matlab", "Agisoft", "PhotoModeler", "OpenCV"])
def test_default_fit_gives_the_references_parameters_bit_for_bit(fmt) -> None:
    """With no ``jac`` given, each format's optimized conversion from a port
    camera (where the format has one) and back to a port camera equals the
    reference's, parameter for parameter, bit for bit."""
    if fmt == "PhotoModeler":
        cam, rcam = both_cameras(imgsz=(4288, 2848), fmm=(3100, 3200), cmm=(0.5, -0.4), sensorsz=(35.1, 24.2),
                                 k=(0.1, -0.05), p=(0.03, 0.04))
    else:
        cam, rcam = both_cameras(**(OPENCV_CAM if fmt == "OpenCV" else DISTORTED_K4))
    port, ref_fmt = getattr(convert, fmt), getattr(ref_convert, fmt)
    if fmt == "OpenCV":
        xcam, rxcam = port.from_camera(cam), ref_fmt.from_camera(rcam)
        xcam.s1 = rxcam.s1 = 1e-5
    else:
        xcam, rxcam = port.from_camera(cam, **CPU), ref_fmt.from_camera(rcam)
        np.testing.assert_array_equal(flat_xcam(xcam), flat_xcam(rxcam))
    if fmt == "Matlab":
        xcam.alpha_c = rxcam.alpha_c = 1e-6
    if fmt == "Agisoft":
        for x in (xcam, rxcam):
            x.k4 = 1e-7
            x.b2 = 1e-12
    np.testing.assert_array_equal(xcam.to_camera(**CPU).to_array(), rxcam.to_camera().to_array())
