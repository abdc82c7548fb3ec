"""The port's host ``Grid``/``Raster``/``RasterInterpolant``, ``Image``/``Exif``,
the GeoTIFF codec, the helpers and ``render.project_dem`` against the JAX
package's, on the same seeded arrays and the same asset files.

Both sides are float64 NumPy at their surface. The port samples and
projects through tensors over the arrays' memory with the reference's order
of operations, so values are held to 1e-12 (sampling), identical masks
(viewshed) and 1e-9 (rendering, horizon); pure-NumPy code is held exactly.
The files that decode an image need Pillow.
"""
import datetime
import inspect
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.ndimage

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import glimpse_tpu
import glimpse_tpu_torch
from glimpse_tpu import helpers as ref_helpers
from glimpse_tpu.io import geotiff as ref_geotiff
from glimpse_tpu_torch import helpers
from glimpse_tpu_torch.io import geotiff

ASSETS = Path(__file__).parent / "assets"
JPG = ASSETS / "AK10b_20141013_020336.JPG"


def make_dem(seed=0, size=64, nan_block=False):
    z = scipy.ndimage.gaussian_filter(np.random.default_rng(seed).normal(size=(size, size)), 4) * 150
    if nan_block:
        z[8:14, 20:30] = np.nan
    return z


def rasters(z, x=(-200, 600), y=(600, -200)):
    return glimpse_tpu.Raster(z, x=x, y=y), glimpse_tpu_torch.Raster(z.copy(), x=x, y=y)


def origin_on(raster, fx, fy, up):
    x = raster.xlim[0] + fx * (raster.xlim[1] - raster.xlim[0])
    y = raster.ylim[0] + fy * (raster.ylim[1] - raster.ylim[0])
    return (x, y, float(raster.sample(np.array([[x, y]]))[0]) + up)


def test_import_needs_neither_pillow_nor_matplotlib() -> None:
    """``import glimpse_tpu_torch`` loads no Pillow, matplotlib or jax module
    of its own: checked in a fresh interpreter."""
    import subprocess

    code = (
        "import sys; import glimpse_tpu_torch as g; "
        "bad = [m for m in ('PIL', 'matplotlib', 'jax', 'glimpse_tpu') if m in sys.modules]; "
        "assert not bad, bad; print(g.Camera.__module__)"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=Path(__file__).parent.parent)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "glimpse_tpu_torch.camera"


@pytest.mark.parametrize("order", [0, 1, 3])
@pytest.mark.parametrize("grid", [False, True])
def test_sample_matches(order, grid) -> None:
    ref, port = rasters(make_dem())
    rng = np.random.default_rng(1)
    if grid:
        xy = (np.linspace(-150, 550, 23), np.linspace(500, -100, 17))
    else:
        xy = rng.uniform(-190, 590, (300, 2))
    want = ref.sample(xy, grid=grid, order=order)
    got = port.sample(xy, grid=grid, order=order)
    assert got.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-12, rtol=0)


def test_sample_bounds_fill_and_nan() -> None:
    ref, port = rasters(make_dem(nan_block=True))
    xy = np.array([[0.0, 0.0], [700.0, 0.0], [100.0, 450.0], [75.0, 470.0]])
    with pytest.raises(ValueError, match="out of bounds"):
        port.sample(xy)
    for fill in (np.nan, -1.0, None):
        want = ref.sample(xy, bounds_error=False, fill_value=fill)
        got = port.sample(xy, bounds_error=False, fill_value=fill)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got, want, atol=1e-12, rtol=0, equal_nan=True)
    gx, gy = np.linspace(-100, 500, 9), np.linspace(550, 0, 7)
    np.testing.assert_allclose(
        port.sample((gx, gy), grid=True, order=1), ref.sample((gx, gy), grid=True, order=1), atol=1e-12, rtol=0,
        equal_nan=True,
    )
    np.testing.assert_allclose(port.sample(xy[:1], order=4), ref.sample(xy[:1], order=4), atol=1e-9, rtol=0)


def test_grid_geometry_matches() -> None:
    ref, port = rasters(make_dem(size=40), x=(10, 410), y=(900, 500))
    for attr in ("size", "xlim", "ylim", "d", "min", "max", "box2d", "x", "y", "X", "Y", "zlim", "box3d"):
        np.testing.assert_array_equal(getattr(port, attr), getattr(ref, attr), err_msg=attr)
    xy = np.random.default_rng(2).uniform([10, 500], [410, 900], (50, 2))
    xy[:3] = [[10, 900], [410, 500], [210, 700]]
    for kwargs in (dict(), dict(snap=True), dict(snap=True, inbounds=False)):
        np.testing.assert_array_equal(port.xy_to_rowcol(xy, **kwargs), ref.xy_to_rowcol(xy, **kwargs))
    rowcol = port.xy_to_rowcol(xy, snap=True)
    np.testing.assert_array_equal(port.rowcol_to_xy(rowcol), ref.rowcol_to_xy(rowcol))
    np.testing.assert_array_equal(port.rowcol_to_idx(rowcol), ref.rowcol_to_idx(rowcol))
    np.testing.assert_array_equal(port.inbounds_xy(xy + 5), ref.inbounds_xy(xy + 5))
    np.testing.assert_array_equal(port.snap_xy(xy, centers=True), ref.snap_xy(xy, centers=True))
    np.testing.assert_array_equal(port.snap_xy(xy, edges=True), ref.snap_xy(xy, edges=True))
    assert list(port.tile_indices(size=(16, 16), overlap=(1, 1))) == list(ref.tile_indices(size=(16, 16), overlap=(1, 1)))
    sub_r, sub_p = ref[3:20, 5:30:2], port[3:20, 5:30:2]
    np.testing.assert_array_equal(sub_p.array, sub_r.array)
    np.testing.assert_array_equal(sub_p.xlim, sub_r.xlim)
    np.testing.assert_array_equal(sub_p.ylim, sub_r.ylim)


@pytest.mark.parametrize("xlim,ylim", [((100, 300), None), (None, (850, 620)), ((55, 395), (880, 510)), ((0, 1000), (1000, 0))])
def test_crop_matches(xlim, ylim) -> None:
    ref, port = rasters(make_dem(size=40), x=(10, 410), y=(900, 500))
    for raster in (ref, port):
        raster.crop(xlim=xlim, ylim=ylim, zlim=(-20, 20))
    np.testing.assert_array_equal(port.array, ref.array)
    np.testing.assert_array_equal(port.xlim, ref.xlim)
    np.testing.assert_array_equal(port.ylim, ref.ylim)
    assert np.isnan(port.array).any()
    for raster in (ref, port):
        raster.crop_to_data() if not np.isnan(raster.array).all() else None
        raster.shift(dx=3, dy=-2, dz=1.5)
    np.testing.assert_array_equal(port.array, ref.array)
    np.testing.assert_array_equal(port.xlim, ref.xlim)


@pytest.mark.parametrize("correction", [False, True])
@pytest.mark.parametrize("nan_block", [False, True])
def test_viewshed_and_horizon_match(correction, nan_block) -> None:
    ref, port = rasters(make_dem(seed=3, size=72, nan_block=nan_block), x=(0, 720), y=(720, 0))
    origin = origin_on(ref, 0.45, 0.55, 15.0)
    want = ref.viewshed(origin, correction=correction)
    got = port.viewshed(origin, correction=correction, device="cpu")
    assert isinstance(got, np.ndarray) and got.dtype == bool
    assert 0.02 < want.mean() < 0.98
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        port.viewshed(origin, correction=correction, method="rings"), ref.viewshed(origin, correction=correction, method="rings")
    )
    # Float32, as on a card: the agreeing share against the float64 mask.
    assert (port.viewshed(origin, correction=correction, device="cpu", dtype=torch.float32) == want).mean() >= 0.995
    low = origin_on(ref, 0.45, 0.55, -30.0)
    ref_h = ref.horizon(low, headings=range(0, 360, 3), correction=correction)
    port_h = port.horizon(low, headings=range(0, 360, 3), correction=correction, device="cpu")
    assert len(port_h) == len(ref_h) > 0
    for a, b in zip(port_h, ref_h):
        np.testing.assert_allclose(a, b, atol=1e-9, rtol=0)


def test_horizon_takes_no_numpy_bool_as_an_index() -> None:
    """The reference slices its segments with a ``numpy.bool_`` start, which
    NumPy deprecates and newer releases refuse (recorded in ROADMAP.md); the
    port converts it, so it runs with that warning made an error."""
    import warnings

    ref, port = rasters(make_dem(seed=3, size=48), x=(0, 480), y=(480, 0))
    origin = origin_on(ref, 0.5, 0.5, -20.0)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        segments = port.horizon(origin, headings=range(0, 360, 5), device="cpu")
        with pytest.raises((DeprecationWarning, TypeError), match="index"):
            ref.horizon(origin, headings=range(0, 360, 5))
    assert len(segments) > 0


def test_terrain_methods_default_to_the_card() -> None:
    for fn in (glimpse_tpu_torch.Raster.viewshed, glimpse_tpu_torch.Raster.horizon):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    if not torch.cuda.is_available():
        _, port = rasters(make_dem(size=16))
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            port.viewshed((100.0, 100.0, 500.0))
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            port.horizon((100.0, 100.0, 0.0))


def test_hillshade_gradient_and_fill_match() -> None:
    ref, port = rasters(make_dem(seed=4))
    np.testing.assert_array_equal(port.hillshade(), ref.hillshade())
    for a, b in zip(port.gradient(), ref.gradient()):
        np.testing.assert_array_equal(a, b)
    for raster in (ref, port):
        raster.fill_circle((200, 200), 60, value=np.nan)
        raster.fill_crevasses(mask=lambda a: ~np.isnan(a), fill=True)
    np.testing.assert_array_equal(port.array, ref.array)
    xy = np.random.default_rng(5).uniform(-150, 550, (40, 2))
    values = np.arange(40.0)
    np.testing.assert_array_equal(port.rasterize(xy, values), ref.rasterize(xy, values))
    polygon = np.array([[0, 0], [300, 50], [250, 400], [0, 0.0]])
    np.testing.assert_array_equal(port.rasterize_polygons([polygon]), ref.rasterize_polygons([polygon]))


def test_geotiff_read_of_the_asset() -> None:
    path = ASSETS / "000nan.tif"
    ref, port = glimpse_tpu.Raster.open(path), glimpse_tpu_torch.Raster.open(path)
    np.testing.assert_array_equal(port.size, ref.size)
    np.testing.assert_array_equal(port.xlim, ref.xlim)
    np.testing.assert_array_equal(port.ylim, ref.ylim)
    np.testing.assert_array_equal(port.array, ref.array)
    assert port.array.dtype == ref.array.dtype
    np.testing.assert_array_equal(
        glimpse_tpu_torch.Raster.open(path, nan=0).array, glimpse_tpu.Raster.open(path, nan=0).array
    )
    info, ref_info = geotiff.read_info(path), ref_geotiff.read_info(path)
    assert info == ref_info or (info.size, info.transform, info.nodata, info.n_bands) == (
        ref_info.size, ref_info.transform, ref_info.nodata, ref_info.n_bands)
    box = (0, 0, int(port.size[0]) - 1, int(port.size[1]) - 1)
    np.testing.assert_array_equal(port.read(box), ref.read(box))


def test_geotiff_write_read_round_trip(tmp_path) -> None:
    _, port = rasters(make_dem(size=20, nan_block=False), x=(500000, 500200), y=(6780200, 6780000))
    port.array[2, 3] = np.nan
    path = tmp_path / "dem.tif"
    port.write(path)
    for cls in (glimpse_tpu_torch.Raster, glimpse_tpu.Raster):
        again = cls.open(path)
        np.testing.assert_array_equal(again.xlim, port.xlim)
        np.testing.assert_array_equal(again.ylim, port.ylim)
        np.testing.assert_allclose(again.array, port.array.astype(np.float32), rtol=0, atol=0, equal_nan=True)


def test_raster_interpolant_matches() -> None:
    t = [datetime.datetime(2020, 1, 1) + datetime.timedelta(days=d) for d in (0, 10)]
    za, zb = make_dem(seed=6, size=16), make_dem(seed=7, size=16)
    outs = []
    for pkg in (glimpse_tpu, glimpse_tpu_torch):
        means = [pkg.Raster(z, x=(0, 160), y=(160, 0), datetime=ti) for z, ti in zip((za, zb), t)]
        sigmas = [pkg.Raster(np.full_like(z, s), x=(0, 160), y=(160, 0), datetime=ti) for z, s, ti in zip((za, zb), (1.0, 2.0), t)]
        interpolant = pkg.RasterInterpolant(means, sigmas=sigmas, x=t)
        outs.append(interpolant(t[0] + datetime.timedelta(days=3), return_sigma=True))
    (mean_r, sigma_r), (mean_p, sigma_p) = outs
    np.testing.assert_array_equal(mean_p.array, mean_r.array)
    np.testing.assert_array_equal(sigma_p.array, sigma_r.array)


HELPER_CASES = {
    "format_list": lambda h: h.format_list([1, 2], length=4, default=0),
    "box_to_grid": lambda h: h.box_to_grid((0, 0, 10, 8), step=2, snap=(0.5, 0.5), mode="points"),
    "intersect_boxes": lambda h: h.intersect_boxes([(0, 0, 5, 5), (2, 1, 9, 4)]),
    "rasterize_points": lambda h: np.concatenate(
        [np.ravel(x) for x in h.rasterize_points(np.array([0, 0, 2, 2]), np.array([1, 1, 0, 3]), np.arange(4.0), shape=(3, 4))]
    ),
    "sum_normals": lambda h: np.stack(h.sum_normals(np.array([[1.0, 2.0], [3.0, np.nan]]), np.array([[0.5, 1.0], [2.0, np.nan]]), ignore_nan=True)),
    "boolean_split": lambda h: np.concatenate(h.boolean_split(np.arange(10.0), np.arange(10) % 4 == 0, circular=True)),
    "select_datetimes": lambda h: h.select_datetimes(
        [datetime.datetime(2020, 1, 1) + datetime.timedelta(hours=6 * i) for i in range(20)],
        start=datetime.datetime(2020, 1, 2), end=datetime.datetime(2020, 1, 4), snap=datetime.timedelta(days=1),
        maxdt=datetime.timedelta(hours=1)).astype(float),
    "sorted_nearest": lambda h: h.sorted_nearest(np.array([0.0, 1.0, 4.0, 9.0]), np.array([0.4, 2.6, 8.0, 20.0])),
    "maximum_filter": lambda h: h.maximum_filter(make_dem(size=12), mask=make_dem(size=12) > 0, fill=True, size=3),
    "in_box": lambda h: h.in_box(np.array([[1.0, 1.0], [6.0, 2.0], [5.0, 5.0]]), (0, 0, 5, 5)),
    "polygons_to_mask": lambda h: h.polygons_to_mask([np.array([[1, 1], [8, 2], [5, 7], [1, 1.0]])], size=(10, 9)),
    "gaussian_filter": lambda h: h.gaussian_filter(make_dem(size=12), mask=make_dem(size=12) > 0, fill=True, sigma=2),
    "numpy_to_native": lambda h: np.array(h.numpy_to_native(np.arange(3.0))),
}


@pytest.mark.parametrize("case", list(HELPER_CASES))
def test_helpers_match(case) -> None:
    want, got = HELPER_CASES[case](ref_helpers), HELPER_CASES[case](helpers)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_json_pickle_and_config(tmp_path) -> None:
    from glimpse_tpu import config as ref_config
    from glimpse_tpu_torch import config

    obj = {"a": [1.0, 2.5], "b": {"c": None, "d": [[1, 2], [3, 4]]}}
    assert helpers.write_json(obj, flat_arrays=True) == ref_helpers.write_json(obj, flat_arrays=True)
    helpers.write_json(obj, path=tmp_path / "x.json")
    assert helpers.read_json(tmp_path / "x.json") == obj
    for cfg in (config, ref_config):
        with cfg.backend(np=2) as pool:
            assert pool.map(lambda a, b: a * b, [(1, 2), (3, 4)], star=True) == [2, 12]
            assert pool.map(lambda a: (a, a), [1, 2], reduce=lambda a, b: a + b) == [2, 4]
        with cfg.thread_pool(2) as pool:
            assert list(pool.map(abs, [-1, 2])) == [1, 2]
    # Every function the reference's helpers define has its counterpart.
    defined = {name for name, value in vars(ref_helpers).items()
               if callable(value) and getattr(value, "__module__", None) == ref_helpers.__name__}
    assert {"crs_to_wkt", "clahe"} <= defined and defined <= set(dir(helpers))


# ---- Image, Exif, render ---- #


def test_exif_matches_on_the_asset() -> None:
    ref, port = glimpse_tpu.Exif(JPG), glimpse_tpu_torch.Exif(JPG)
    for attr in ("imgsz", "datetime", "exposure", "aperture", "iso", "fmm", "make", "model", "sensorsz"):
        assert getattr(port, attr) == getattr(ref, attr), attr
    assert port.tags == ref.tags
    assert port.imgsz == (800, 536)


def test_image_reads_the_asset_as_the_reference() -> None:
    pytest.importorskip("PIL")
    ref, port = glimpse_tpu.Image(JPG), glimpse_tpu_torch.Image(JPG)
    assert port.datetime == ref.datetime
    np.testing.assert_array_equal(port.cam.to_array(), ref.cam.to_array())
    np.testing.assert_array_equal(port.read(), ref.read())
    np.testing.assert_array_equal(port.read(box=(10, 20, 110, 90)), ref.read(box=(10, 20, 110, 90)))
    small = dict(imgsz=(200, 134), fmm=20, sensorsz=(23.6, 15.8))
    ref, port = glimpse_tpu.Image(JPG, cam=dict(small)), glimpse_tpu_torch.Image(JPG, cam=dict(small))
    np.testing.assert_array_equal(port.read(), ref.read())
    np.testing.assert_array_equal(port.read(box=(5, 5, 60, 40), cache=False), ref.read(box=(5, 5, 60, 40), cache=False))
    target = dict(small, viewdir=(2, 1, 0.5))
    want = ref.project(glimpse_tpu.Camera(**target))
    got = port.project(glimpse_tpu_torch.Camera(**target))
    np.testing.assert_allclose(got, want, atol=1e-9, rtol=0, equal_nan=True)


def test_image_with_a_set_array_is_never_decoded(monkeypatch) -> None:
    """An ``Image`` whose ``array`` is set at the camera's size reads from
    it: no file, no EXIF, no Pillow."""
    cam = glimpse_tpu_torch.Camera(imgsz=(32, 24), f=40)
    image = glimpse_tpu_torch.Image("no/such/file.jpg", cam=cam, datetime=datetime.datetime(2020, 1, 1))
    image.array = np.arange(24 * 32, dtype=np.float32).reshape(24, 32)
    def refuse():
        raise RuntimeError("Pillow was asked for")

    monkeypatch.setattr(geotiff, "pil", refuse)
    assert image.read() is image.array
    np.testing.assert_array_equal(image.read(box=(2, 3, 10, 9)), image.array[3:9, 2:10])
    assert image.exif is None
    image.cam.resize(0.5)  # now stale: a decode is needed, and refused here
    with pytest.raises(RuntimeError, match="Pillow was asked for"):
        image.read()


@pytest.mark.parametrize("return_depth", [False, True])
@pytest.mark.parametrize("scale_limits", [(1, 1), (1, 8)])
def test_project_dem_matches_on_a_64_cell_dem(return_depth, scale_limits) -> None:
    z = make_dem(seed=8) * 0.4
    texture = scipy.ndimage.gaussian_filter(np.random.default_rng(9).normal(size=(64, 64)), 0.8)[..., None] * 100
    cam_args = dict(imgsz=(64, 48), f=80, xyz=(200, -150, 260), viewdir=(0, -35, 0))
    outs = []
    for pkg in (glimpse_tpu, glimpse_tpu_torch):
        dem = pkg.Raster(z, x=(-200, 600), y=(600, -200))
        outs.append(pkg.render.project_dem(
            pkg.Camera(**cam_args), dem, values=texture, scale_limits=scale_limits, return_depth=return_depth))
    want, got = outs
    assert got.shape == (48, 64, 1 + return_depth)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert 0.3 < np.isfinite(want).mean()
    np.testing.assert_allclose(got, want, atol=1e-9, rtol=0, equal_nan=True)
    np.testing.assert_array_equal(
        glimpse_tpu_torch.Camera(**cam_args).project_dem(
            glimpse_tpu_torch.Raster(z, x=(-200, 600), y=(600, -200)), values=texture, scale_limits=scale_limits,
            return_depth=return_depth, parallel=2),
        got,
    )


@pytest.mark.parametrize("module", ["helpers", "camera", "raster"])
def test_port_module_doctests(module) -> None:
    """The inline examples came across with the host modules: they run as
    the reference's do (``tests/test_doctests.py``), the same count of them."""
    import doctest
    import importlib

    flags = doctest.NORMALIZE_WHITESPACE | doctest.ELLIPSIS
    port = doctest.testmod(importlib.import_module(f"glimpse_tpu_torch.{module}"), optionflags=flags)
    ref = doctest.testmod(importlib.import_module(f"glimpse_tpu.{module}"), optionflags=flags)
    assert port.failed == 0, f"{port.failed} doctest failures in glimpse_tpu_torch.{module}"
    assert port.attempted > 0
    if module != "helpers":  # the GIS helpers and their examples stayed behind
        assert port.attempted == ref.attempted
