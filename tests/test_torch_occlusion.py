"""A viewshed that hides tracked terrain: the port against the JAX package.

``chip_smoke.py`` phase 26 at a small size, on the CPU: the oblique scene of
``examples/oblique_3d_tracking.py`` with a 40 m ridge added to the DEM, so
that the station at (200, -150, 260) cannot see some 60 m of terrain behind
it. Both packages compute the DEM's viewshed (float64, bit-equal), the frames
are rendered from the cells it leaves visible, and both build their tracker
from host objects (``from_motions``, ``from_observers`` with the viewshed).
Half the points start just west of the shadow and move into it, half far
from it. Every step is held from the reference's carried state: means and
sigmas within 1e-3, validity flags identical; ``to_tracks`` then records the
same errors at the same steps in both packages. The reference's ``step``
with a viewshed runs eagerly (its viewshed test reads host arrays).
"""
import dataclasses
import datetime

import numpy as np
import pytest
import scipy.ndimage

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import glimpse_tpu
import glimpse_tpu_torch
from chip_smoke import hidden_at, ridge_heights
from glimpse_tpu.track import batch as jax_batch
from glimpse_tpu_torch.track import batch, convert

T0 = datetime.datetime(2020, 1, 1)
DAY = datetime.timedelta(days=1)
N_PARTICLES, N_FRAMES = 256, 5
VELOCITY = (1.2, 0.8)
SETTINGS = dict(n_particles=N_PARTICLES, search_size=(41, 41))
# chip_smoke.RIDGE on this DEM's 5 m cells: a little wider, so the crest
# spans a few cells.
RIDGE = dict(x=(150.0, 230.0), y=200.0, height=40.0, width=6.0, taper=8.0)
CAM = dict(imgsz=(160, 120), f=200, xyz=(200, -150, 260), viewdir=(0, -35, 0))


@pytest.fixture(scope="module")
def scene():
    """Both packages' objects over one ridge DEM: (sides by package, frames,
    points, the port's viewshed ``Raster``)."""
    rng = np.random.default_rng(7)
    cells = 160
    centres = -200 + 5.0 * (np.arange(cells) + 0.5)
    z = scipy.ndimage.gaussian_filter(rng.normal(size=(cells, cells)), 6.0) * 60
    z = z + ridge_heights(centres[None, :], centres[::-1, None], RIDGE)
    texture = scipy.ndimage.gaussian_filter(rng.normal(size=(cells, cells)), 0.8) * 100
    port_dem = glimpse_tpu_torch.Raster(z, x=(-200, 600), y=(600, -200))
    visible = port_dem.viewshed(CAM["xyz"], device="cpu")
    viewshed = glimpse_tpu_torch.Raster(visible.astype(np.float32), x=port_dem.xlim, y=port_dem.ylim)
    # Eight points 2-5 m west of the shadow, behind the ridge, moving east
    # into it; eight far to the south-east.
    behind = (centres[::-1] > 215) & (centres[::-1] < 245)  # rows of DEM cells 15-45 m behind the crest
    west = centres[np.flatnonzero((~visible[behind]).any(axis=0))].min() - 2.5  # the shadow's west edge there
    near = np.column_stack([west - rng.uniform(2.0, 5.0, 8), rng.uniform(218, 242, 8)])
    far = rng.uniform([250, 150], [270, 165], size=(8, 2))
    points = np.concatenate([near, far])
    frames = []
    for i in range(N_FRAMES):
        shifted = scipy.ndimage.shift(
            texture, (VELOCITY[1] * i / port_dem.d[1], VELOCITY[0] * i / port_dem.d[0]), order=1, mode="nearest")
        img = glimpse_tpu_torch.render.project_dem(
            glimpse_tpu_torch.Camera(**CAM), port_dem, values=shifted[..., None], mask=visible & ~np.isnan(z),
            scale_limits=(1, 8))[..., 0]
        idx = scipy.ndimage.distance_transform_edt(np.isnan(img), return_distances=False, return_indices=True)
        frames.append(img[tuple(idx)].astype(np.float32))
    sides = {}
    for name, pkg, bt in (("ref", glimpse_tpu, jax_batch), ("port", glimpse_tpu_torch, batch)):
        dem = pkg.Raster(z, x=(-200, 600), y=(600, -200))
        images = []
        for i, frame in enumerate(frames):
            image = pkg.Image(f"frame{i}.jpg", cam=pkg.Camera(**CAM), datetime=T0 + i * DAY)
            image.array = frame
            images.append(image)
        device = dict(device="cpu") if pkg is glimpse_tpu_torch else {}
        own = dem.viewshed(CAM["xyz"], **device)
        motions = [
            pkg.track.CartesianMotion(
                xy=p, time_unit=DAY, dem=dem, dem_sigma=0.5, n=N_PARTICLES, xy_sigma=(1.0, 1.0),
                vxyz_sigma=(1.5, 1.5, 0.05), axyz_sigma=(0.1, 0.1, 0.01))
            for p in points
        ]
        sides[name] = dict(
            observer=pkg.track.Observer(images, sigma=0.2), visible=own, motion=bt.BatchMotion.from_motions(motions, **device),
            viewshed=pkg.Raster(own.astype(np.float32), x=dem.xlim, y=dem.ylim))
    return sides, np.stack(frames), points, viewshed


def trackers(sides):
    ref, port = sides["ref"], sides["port"]
    by_objects = jax_batch.BatchTracker.from_observers([ref["observer"]], ref["motion"], config=jax_batch.BatchConfig(**SETTINGS))
    reference = jax_batch.BatchTracker(
        by_objects.camera_vectors, by_objects.corrections, by_objects.sigmas, ref["motion"],
        jax_batch.BatchConfig(**SETTINGS), viewshed=ref["viewshed"])
    tracker = batch.BatchTracker.from_observers(
        [port["observer"]], port["motion"], config=batch.BatchConfig(**SETTINGS), device="cpu", viewshed=port["viewshed"])
    return reference, tracker


def draws(n, seed=26):
    rng = np.random.default_rng(seed)
    return {
        "init": {"xy": rng.normal(size=(n, N_PARTICLES, 2)).astype(np.float32),
                 "z": rng.normal(size=(n, N_PARTICLES)).astype(np.float32),
                 "v": rng.normal(size=(n, N_PARTICLES, 3)).astype(np.float32)},
        "a": rng.normal(size=(N_FRAMES - 1, n, N_PARTICLES, 3)).astype(np.float32),
        "resample_u": rng.random((N_FRAMES - 1, n)).astype(np.float32),
    }


def test_ridge_viewshed_is_bit_equal_and_hides_the_tracked_area(scene) -> None:
    """The float64 viewshed of the ridge DEM is the same array in both
    packages, and the ridge hides terrain the near points move into."""
    sides, _, points, viewshed = scene
    np.testing.assert_array_equal(sides["port"]["visible"], sides["ref"]["visible"])
    assert 0.9 < sides["port"]["visible"].mean() < 1.0
    paths = points[:, None] + np.arange(N_FRAMES)[None, :, None] * np.asarray(VELOCITY)
    assert not hidden_at(viewshed, points).any()
    assert hidden_at(viewshed, paths[:8]).any(axis=1).sum() >= 4
    assert not hidden_at(viewshed, paths[8:]).any()


def test_every_step_from_the_carried_state_loses_the_same_points(scene) -> None:
    """Every step from the reference's carried state: means and sigmas
    within 1e-3 and identical validity flags; ``to_tracks`` of each
    package's outputs gives errors on the same points at the same steps;
    at least one near point is lost and every far point kept."""
    sides, frames, points, _ = scene
    reference, tracker = trackers(sides)
    noise = draws(len(points))
    images = frames[:, None]
    state = reference.initialize(jax.random.PRNGKey(0), images[0], noise=noise["init"])
    ref_outputs, port_outputs = [], []
    for i in range(N_FRAMES - 1):
        step_noise = {"a": noise["a"][i], "resample_u": noise["resample_u"][i]}
        leaves = {f.name: np.array(getattr(state, f.name)) for f in dataclasses.fields(state) if f.name != "key"}
        _, out = tracker.step(convert.state_from_numpy(**leaves, device="cpu"), torch.from_numpy(images[1 + i]),
                              torch.tensor(1.0), noise=step_noise)
        state, ref_out = reference.step(state, images[1 + i], np.float32(1.0), noise=step_noise)
        for k in ("mean", "sigma"):
            np.testing.assert_allclose(out[k].numpy(), np.asarray(ref_out[k]), atol=1e-3, rtol=0, err_msg=f"{k} {i}")
        np.testing.assert_array_equal(out["valid"].numpy(), np.asarray(ref_out["valid"]), err_msg=f"valid {i}")
        ref_outputs.append({k: np.asarray(v) for k, v in ref_out.items()})
        port_outputs.append(out)
    datetimes = list(sides["port"]["observer"].datetimes)
    ref_tracks = jax_batch.to_tracks(datetimes, DAY, {k: np.stack([o[k] for o in ref_outputs]) for k in ref_outputs[0]})
    port_tracks = batch.to_tracks(datetimes, DAY, {k: torch.stack([o[k] for o in port_outputs]) for k in port_outputs[0]})
    port_errors = [None if e is None else str(e) for e in port_tracks.errors]
    assert port_errors == [None if e is None else str(e) for e in ref_tracks.errors]
    np.testing.assert_array_equal(np.isnan(port_tracks.means), np.isnan(ref_tracks.means))
    lost = np.array([e is not None for e in port_errors])
    assert lost[:8].any() and not lost[8:].any(), port_errors
