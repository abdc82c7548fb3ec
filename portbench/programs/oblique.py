"""The system under test on the oblique scene, driven through the object path
its users call for Welty 2018's 3-D filter.

One host ``CartesianMotion`` a point, on the tracking date's DEM with its
sigma ``Raster``, stacked by ``BatchMotion.from_motions``; an ``Observer`` of
the frames' ``Image`` objects, each with the oblique ``Camera``; and
``BatchTracker.from_observers`` with the DEM's viewshed ``Raster``. A
tracking run is one ``track`` call on the frames held in device memory
(:func:`portbench.program.tracking_run`). Nothing else of the program is used.
"""
from portbench.program import DTYPES, tracking_run  # noqa: F401  (this configuration's tracking_run)
from portbench.reference.oblique import Problem
from portbench.scenes.oblique import DAY, START


def _check(config: dict, traffic: dict) -> None:
    motion = config["motion"]
    stated = (motion["kind"], motion["dem"], motion["dem_sigma"], config["sse_sample_mode"],
              config["resample_method"], config["resample_threshold"], config["dtype"], traffic["entry"],
              len(config["observers"]))
    if stated != ("cartesian", "interpolated", "interpolated", "einsum", "systematic", None, "float32", "track", 1):
        raise ValueError(f"the oblique reference tracks cartesian motion on the interpolated DEM and its sigma, with"
                         f" the exact spline read, systematic resampling every step, in float32, by track, with"
                         f" one observer; the configuration states {stated}")


def problem(config: dict, traffic: dict, scene) -> Problem:
    """The tracking problem as the reference takes it: the same parameters
    and scene the program is built from."""
    _check(config, traffic)
    motion = config["motion"]
    return Problem(
        cameras=scene.cameras, sigmas=[o["sigma"] for o in config["observers"]], points_xy=scene.points_xy,
        xy_sigma=motion["xy_sigma"], v_sigma=motion["vxyz_sigma"], a_sigma=motion["axyz_sigma"],
        n_particles=traffic["particles"], template_size=tuple(config["template_size"]),
        search_size=tuple(config["search_size"]), highpass_size=tuple(config["highpass_size"]),
        n_quantiles=config["n_quantiles"], viewshed=scene.viewshed, dem=scene.dem, dem_sigma=scene.dem_sigma,
    )


def _raster(fields: dict):
    """A host ``Raster`` of raster fields."""
    from glimpse_tpu_torch import Raster

    H, W = fields["array"].shape
    x0, y0 = fields["x0"], fields["y0"]
    return Raster(fields["array"], x=(x0, x0 + W * fields["dx"]), y=(y0, y0 + H * fields["dy"]))


def build_tracker(config: dict, traffic: dict, scene, device):
    """The program's tracker for the scene, built from host objects as a user
    builds it."""
    from glimpse_tpu_torch import Camera, Image
    from glimpse_tpu_torch.track import CartesianMotion, Observer, batch

    _check(config, traffic)
    motion = config["motion"]
    dem, dem_sigma = _raster(scene.dem), _raster(scene.dem_sigma)
    camera = Camera(**config["camera"])
    images = [Image(f"frame{t}.jpg", cam=camera, datetime=START + t * DAY) for t in range(config["images"])]
    motions = [
        CartesianMotion(xy=xy, time_unit=DAY, dem=dem, dem_sigma=dem_sigma, n=traffic["particles"],
                        xy_sigma=motion["xy_sigma"], vxyz_sigma=motion["vxyz_sigma"], axyz_sigma=motion["axyz_sigma"])
        for xy in scene.points_xy
    ]
    settings = batch.BatchConfig(
        n_particles=traffic["particles"], template_size=tuple(config["template_size"]),
        search_size=tuple(config["search_size"]), highpass_size=tuple(config["highpass_size"]),
        n_quantiles=config["n_quantiles"], sse_sample_mode=config["sse_sample_mode"],
        resample_method=config["resample_method"], resample_threshold=config["resample_threshold"],
        dtype=DTYPES[config["dtype"]],
    )
    return batch.BatchTracker.from_observers(
        [Observer(images, sigma=config["observers"][0]["sigma"])], batch.BatchMotion.from_motions(motions, device),
        settings, device=device, viewshed=_raster(scene.viewshed),
    )
