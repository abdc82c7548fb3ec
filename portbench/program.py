"""The system under test, driven through the entry points its users call.

Builds ``glimpse_tpu_torch``'s ``BatchTracker`` from a configuration and a
scene, and runs one tracking run as the cell's traffic says:
``track_stream`` on frames streamed from host memory chunk by chunk, or
``track`` on frames held in device memory. Nothing else of the program is
used here. It drives every configuration that names no ``"program"`` of its
own (:func:`portbench.cells.parts`).
"""
import numpy as np
import torch

from portbench.reference.filter import Problem

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16, "float64": torch.float64}


def problem(config: dict, traffic: dict, scene) -> Problem:
    """The tracking problem as the reference takes it: the same parameters
    and scene the program is built from."""
    motion = config["motion"]
    stated = (motion["kind"], motion["dem"], motion["dem_sigma"], config["sse_sample_mode"], config["resample_method"],
              config["resample_threshold"], config["dtype"])
    if stated != ("cartesian", "flat", None, "einsum", "systematic", None, "float32"):
        raise ValueError(f"the plain reference tracks cartesian motion on a flat DEM without a DEM sigma, with the exact"
                         f" spline read, systematic resampling every step, in float32; the configuration states {stated}")
    return Problem(
        cameras=scene.cameras, sigmas=[o["sigma"] for o in config["observers"]], points_xy=scene.points_xy,
        xy_sigma=motion["xy_sigma"], v_sigma=motion["v_sigma"], a_sigma=motion["a_sigma"],
        n_particles=traffic["particles"], template_size=tuple(config["template_size"]),
        search_size=tuple(config["search_size"]), highpass_size=tuple(config["highpass_size"]),
        n_quantiles=config["n_quantiles"], masks=scene.masks, mask0=scene.mask0, viewshed=scene.viewshed,
    )


def build_tracker(config: dict, traffic: dict, scene, device):
    """The program's tracker for the scene, as a user builds it."""
    from glimpse_tpu_torch.track import batch, convert

    motion = config["motion"]
    n = len(scene.points_xy)
    flat = {"array": [[0.0]], "x0": 0.0, "y0": 0.0, "dx": 1e30, "dy": 1e30}
    model = convert.motion_from_numpy(
        {
            "kind": motion["kind"], "xy": scene.points_xy, "xy_sigma": np.tile(motion["xy_sigma"], (n, 1)),
            "v_mean": np.zeros((n, 3)), "v_sigma": np.tile(motion["v_sigma"], (n, 1)),
            "a_mean": np.zeros((n, 3)), "a_sigma": np.tile(motion["a_sigma"], (n, 1)),
            "slope_sigma": np.zeros(n), "dem": flat, "dem_sigma": flat, "use_dem_sigma": False,
        },
        device,
    )
    settings = batch.BatchConfig(
        n_particles=traffic["particles"], template_size=tuple(config["template_size"]),
        search_size=tuple(config["search_size"]), highpass_size=tuple(config["highpass_size"]),
        n_quantiles=config["n_quantiles"], sse_sample_mode=config["sse_sample_mode"],
        resample_method=config["resample_method"], resample_threshold=config["resample_threshold"],
        dtype=DTYPES[config["dtype"]],
    )
    viewshed = None if scene.viewshed is None else convert.raster_from_numpy(scene.viewshed, device)
    return batch.BatchTracker(
        scene.cameras, [None] * len(scene.cameras), [o["sigma"] for o in config["observers"]], model, settings,
        device=device, viewshed=viewshed,
    )


def tracking_run(tracker, traffic: dict, scene, seed: int, n_steps: int):
    """One tracking run over the scene's first ``n_steps`` + 1 frames with a
    generator seeded with ``seed``: (final state, {"mean", "sigma", "valid"}
    with a leading time axis of ``n_steps``), on the tracker's device."""
    generator = torch.Generator(device=tracker.device).manual_seed(seed)
    dts = np.ones(n_steps, np.float32)
    masks = None if scene.masks is None else scene.masks[:n_steps]
    if traffic["entry"] == "track_stream":
        frames = scene.frames
        state, outputs = tracker.track_stream(
            generator, frames[0], (frames[t] for t in range(1, n_steps + 1)), dts,
            obs_masks=masks, obs_mask0=scene.mask0, chunk=traffic["chunk"],
        )
        return state, {k: torch.cat([o[k] for o in outputs]) for k in outputs[0]}
    if traffic["entry"] == "track":
        return tracker.track(generator, scene.frames[: n_steps + 1], dts, obs_masks=masks, obs_mask0=scene.mask0)
    raise ValueError(f"unknown entry {traffic['entry']!r}")
