"""``optimize.project_images`` against the reference's, on the CPU.

Each band is sampled in float64 on the device (here the CPU) through
``ops.sampling.sample_grid``, so the written arrays equal the reference's
NumPy result bit for bit: bilinear and nearest, color and grayscale, the
whole frame and a sub-grid.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
pytest.importorskip("PIL")

import glimpse_tpu as ref
from glimpse_tpu.io import geotiff as ref_geotiff
import glimpse_tpu_torch as port
from glimpse_tpu_torch.io import geotiff

from test_optimize import PATH

CAM = {"imgsz": (100, 67), "fmm": 20, "sensorsz": (23.6, 15.8)}


def both(tmp_path, name, **kwargs):
    arrays = []
    for module, io, extra in ((port, geotiff, {"device": "cpu"}), (ref, ref_geotiff, {})):
        img = module.Image(PATH, cam=dict(CAM))
        cam = img.cam.copy()
        cam.viewdir = (1, -0.5, 0.2)
        out = tmp_path / module.__name__ / f"{name}.tif"
        module.optimize.project_images(cam=cam, images=[img], paths=[out], **kwargs, **extra)
        arrays.append(io.read(out))
    return arrays


@pytest.mark.parametrize("method, grayscale", [("linear", False), ("nearest", False), ("linear", True)])
def test_projection_equals_the_reference(tmp_path, method, grayscale) -> None:
    got, want = both(tmp_path, "p", method=method, grayscale=grayscale)
    assert got.shape[0:2] == (67, 100) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert np.count_nonzero(got) > 0.5 * got.size


def test_projection_on_a_sub_grid_equals_the_reference(tmp_path) -> None:
    u = np.linspace(10.5, 80.5, 36)
    v = np.linspace(5.5, 60.5, 23)
    got, want = both(tmp_path, "grid", u=u, v=v)
    assert got.shape[0:2] == (23, 36)
    np.testing.assert_array_equal(got, want)


def test_existing_outputs_are_kept_and_duplicates_raise(tmp_path) -> None:
    img = port.Image(PATH, cam=dict(CAM))
    out = tmp_path / "kept.tif"
    out.write_bytes(b"not a tiff")
    port.optimize.project_images(cam=img.cam.copy(), images=[img], paths=[out], device="cpu")
    assert out.read_bytes() == b"not a tiff"
    port.optimize.project_images(cam=img.cam.copy(), images=[img], paths=[out], overwrite=True, device="cpu")
    assert geotiff.read(out).shape[0:2] == (67, 100)
    with pytest.raises(ValueError, match="not unique"):
        port.optimize.project_images(cam=img.cam, images=[img, img], paths=[out, str(out)], device="cpu")


def test_projection_defaults_to_the_card(tmp_path) -> None:
    """With no ``device`` the bands go to the card; without one it raises
    instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    img = port.Image(PATH, cam=dict(CAM))
    with pytest.raises((RuntimeError, AssertionError)):
        port.optimize.project_images(cam=img.cam.copy(), images=[img], paths=[tmp_path / "x.tif"])
