"""The port's remaining host helpers against ``glimpse_tpu.helpers``, on the CPU.

Pickles, histogram matching and CLAHE, ray-plane intersections,
Bresenham rasterization, elevation corrections and the GDAL-free GIS
helpers are NumPy in both packages: CDFs, CLAHE and Bresenham are held
bit for bit, the intersections and corrections within 1e-12, and the
CRS strings to equality. One difference is deliberate: ``crs_to_wkt``
passes a compound EPSG designation (``"EPSG:4326+5773"``) through, where
the reference raises (its fault 3).
"""
import datetime

import numpy as np
import pytest

from glimpse_tpu import helpers as ref
from glimpse_tpu_torch import helpers


def test_pickles_round_trip(tmp_path) -> None:
    obj = {"a": np.arange(5), "when": datetime.datetime(2020, 1, 2), "nested": [1, (2, 3)]}
    for gz in (False, True):
        path = tmp_path / f"sub{gz}" / "x.pkl"
        helpers.write_pickle(obj, path, gz=gz)
        back = helpers.read_pickle(path, gz=gz)
        np.testing.assert_array_equal(back["a"], obj["a"])
        assert back["when"] == obj["when"] and back["nested"] == obj["nested"]
        again = ref.read_pickle(path, gz=gz)
        np.testing.assert_array_equal(again["a"], obj["a"])


def test_cdf_and_histogram_matching_equal_the_reference() -> None:
    rng = np.random.default_rng(3)
    a = rng.integers(0, 40, size=(30, 20)).astype(float)
    b = rng.normal(size=500)
    for got, want in zip(helpers.compute_cdf(a, return_inverse=True), ref.compute_cdf(a, return_inverse=True)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(helpers.match_cdf(a, b), ref.match_cdf(a, b))
    np.testing.assert_array_equal(helpers.match_cdf(a, ref.compute_cdf(b)), ref.match_cdf(a, ref.compute_cdf(b)))


@pytest.mark.parametrize("shape, clip, grid", [((64, 80), 40.0, (8, 8)), ((67, 53), 2.0, (4, 6)), ((31, 31), 0, (3, 3))])
def test_clahe_equals_the_reference(shape, clip, grid) -> None:
    rng = np.random.default_rng(4)
    img = np.clip(rng.normal(100, 30, size=shape), 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(helpers.clahe(img, clip, grid), ref.clahe(img, clip, grid))
    with pytest.raises(ValueError):
        helpers.clahe(img.astype(float))


def test_ray_plane_intersections_agree_with_the_reference() -> None:
    rng = np.random.default_rng(5)
    ray = np.concatenate([rng.normal(size=3), rng.normal(size=3)])
    planes = rng.normal(size=(20, 9))
    planes[3, 3:9] = np.tile(ray[3:6], 2)  # parallel: NaN
    np.testing.assert_allclose(helpers.intersect_ray_planes(ray, planes), ref.intersect_ray_planes(ray, planes),
                               rtol=0, atol=1e-12, equal_nan=True)
    rays = rng.normal(size=(25, 6))
    plane = rng.normal(size=9)
    np.testing.assert_allclose(helpers.intersect_rays_plane(rays, plane), ref.intersect_rays_plane(rays, plane),
                               rtol=0, atol=1e-12, equal_nan=True)


def test_bresenham_equals_the_reference() -> None:
    rng = np.random.default_rng(6)
    for start, end in rng.integers(-20, 20, size=(40, 2, 2)):
        np.testing.assert_array_equal(helpers.bresenham_line(start, end), ref.bresenham_line(start, end))
    for radius in (1, 2, 5, 12):
        np.testing.assert_array_equal(helpers.bresenham_circle((3, -4), radius), ref.bresenham_circle((3, -4), radius))


def test_elevation_corrections_agree_with_the_reference() -> None:
    d2 = np.random.default_rng(7).uniform(0, 1e9, size=50)
    np.testing.assert_allclose(helpers.elevation_corrections(d2), ref.elevation_corrections(d2), rtol=0, atol=1e-12)
    np.testing.assert_allclose(helpers.elevation_corrections(d2, radius=6e6, refraction=0.2),
                               ref.elevation_corrections(d2, radius=6e6, refraction=0.2), rtol=0, atol=1e-12)


# The seven cases of tests/test_helpers_gis.py, on both packages.


@pytest.mark.parametrize("module", [helpers, ref], ids=["port", "reference"])
def test_epsg_geographic_wkt(module) -> None:
    wkt = module.crs_to_wkt(4326)
    assert wkt.startswith('GEOGCS["WGS 84"')
    assert 'SPHEROID["WGS 84",6378137,298.257223563' in wkt
    assert 'AUTHORITY["EPSG","4326"]' in wkt
    assert wkt == ref.crs_to_wkt(4326)


@pytest.mark.parametrize("module", [helpers, ref], ids=["port", "reference"])
def test_epsg_utm_wkt(module) -> None:
    wkt = module.crs_to_wkt(32606)
    assert wkt.startswith('PROJCS["WGS 84 / UTM zone 6N"')
    assert 'PROJECTION["Transverse_Mercator"]' in wkt
    assert 'PARAMETER["central_meridian",-147]' in wkt
    assert 'PARAMETER["scale_factor",0.9996]' in wkt
    assert 'AUTHORITY["EPSG","32606"]' in wkt
    south = module.crs_to_wkt(32706)
    assert 'PARAMETER["false_northing",10000000]' in south
    assert (wkt, south) == (ref.crs_to_wkt(32606), ref.crs_to_wkt(32706))
    assert module.crs_to_wkt(26906) == ref.crs_to_wkt(26906) and module.crs_to_wkt(3413) == ref.crs_to_wkt(3413)


@pytest.mark.parametrize("module", [helpers, ref], ids=["port", "reference"])
def test_epsg_alaska_albers_wkt(module) -> None:
    wkt = module.crs_to_wkt(3338)
    assert 'PROJECTION["Albers_Conic_Equal_Area"]' in wkt
    assert 'GEOGCS["NAD83"' in wkt
    assert 'PARAMETER["standard_parallel_2",65]' in wkt
    assert wkt == ref.crs_to_wkt(3338)


@pytest.mark.parametrize("module", [helpers, ref], ids=["port", "reference"])
def test_epsg_string_designation(module) -> None:
    assert module.crs_to_wkt("EPSG:4326") == module.crs_to_wkt(4326) == ref.crs_to_wkt(4326)


@pytest.mark.parametrize("module", [helpers, ref], ids=["port", "reference"])
def test_unknown_epsg_falls_back_to_identifier(module) -> None:
    assert module.crs_to_wkt(2193) == "EPSG:2193"


@pytest.mark.parametrize("module", [helpers, ref], ids=["port", "reference"])
def test_wkt_and_proj4_pass_through(module) -> None:
    wkt = module.crs_to_wkt(32606)
    assert module.crs_to_wkt(wkt) == wkt
    proj4 = "+proj=utm +zone=6 +datum=WGS84"
    assert module.crs_to_wkt(proj4) == proj4


@pytest.mark.parametrize("module", [helpers, ref], ids=["port", "reference"])
def test_malformed_raises(module) -> None:
    with pytest.raises(ValueError):
        module.crs_to_wkt("EPSG:abc")
    with pytest.raises(ValueError):
        module.crs_to_wkt("not a crs")
    with pytest.raises(ValueError):
        module.crs_to_wkt(3.5)


def test_compound_epsg_passes_through_the_port() -> None:
    """Fault 3 of the reference, repaired in the port: a horizontal plus
    vertical designation comes back unchanged; malformed ones still raise."""
    assert helpers.crs_to_wkt("EPSG:4326+5773") == "EPSG:4326+5773"
    assert helpers.crs_to_wkt("EPSG:32606+3855") == "EPSG:32606+3855"
    with pytest.raises(ValueError):
        ref.crs_to_wkt("EPSG:4326+5773")  # the reference's fault, recorded
    for bad in ("EPSG:4326+", "EPSG:4326++5773", "EPSG:4326+abc"):
        with pytest.raises(ValueError):
            helpers.crs_to_wkt(bad)


def test_write_and_average_rasters_round_trip(tmp_path) -> None:
    """``write_raster`` writes what both packages' ``average_rasters`` read
    back; the mean of three float32 rasters equals NumPy's float64 mean of
    them within 1e-12."""
    rng = np.random.default_rng(8)
    arrays = [rng.normal(size=(12, 9)).astype(np.float32) for _ in range(3)]
    paths = [tmp_path / f"r{i}.tif" for i in range(3)]
    for a, path in zip(arrays, paths):
        helpers.write_raster(a, path, crs=32606, transform=(100.0, 2.0, 0.0, 500.0, 0.0, -2.0))
    mean = helpers.average_rasters(paths)
    np.testing.assert_allclose(mean[:, :, 0], np.mean(np.array(arrays, dtype=float), axis=0), rtol=0, atol=1e-12)
    np.testing.assert_array_equal(mean, ref.average_rasters(paths))
    helpers.write_raster(rng.normal(size=(5, 5)), tmp_path / "odd.tif")
    with pytest.raises(ValueError, match="Inconsistent shape"):
        helpers.average_rasters([paths[0], tmp_path / "odd.tif"])


def test_driver_from_path_matches_the_reference() -> None:
    for path in ("a.tif", "b.TIFF", "c.jpg", "d.png", "e.svg", "f.geojson", "g.xyz", "h"):
        for kwargs in ({}, {"raster": False}, {"vector": False}):
            assert helpers.driver_from_path(path, **kwargs) == ref.driver_from_path(path, **kwargs)
    assert helpers.gdal_driver_from_path is helpers.driver_from_path


def test_plot_quivers_under_agg() -> None:
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots()
    x = np.array([[0.0, 0.0], [1.0, 2.0]])
    dx = np.array([[1.0, 0.5], [-0.5, 1.0]])
    q = helpers.plot_quivers(x, dx, c=np.array([1.0, 2.0]), ax=ax)
    np.testing.assert_array_equal(q.U, dx[:, 0])
    assert q.scale == 1 and q.pivot == "tail"
    plt.close(fig)
