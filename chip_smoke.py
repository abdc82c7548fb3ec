"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit: ``python3 chip_smoke.py``. It imports no JAX. Phases, one line
each:

1. the card (name and power limit from nvidia-smi) and the torch and CUDA
   versions; no card, no run;
2. build both CUDA kernels from ``glimpse_tpu_torch/csrc`` and, with g++,
   the host feeder library from ``glimpse_tpu_torch/native/src`` (a failed
   build raises; the line says which feeder path runs), and count the 5x5
   high-pass kernel's SASS instructions per output pixel;
3. the median high-pass kernel against its plain version on the card,
   bit for bit, and both times, at the main path's shapes (phase 24's
   (10,240, 31, 31) search tiles among them); then, held with
   rtol = atol = 0 and NaN where the plain version has NaN, tiles of tied
   values with NaN and +-inf pixels, for every compiled separable window and
   four that run the generic kernel, at 31x31, at the smallest tiles the
   TPU kernel allows and on tiles thinner than half the window (whose
   padding reflects more than once), each case named with the kernel
   variant that ran; the
   host tracker's tiles ((1, 15, 15) templates and non-square (1, h, w)
   search tiles) bit for bit and timed; an even and an over-49-tap
   window, which ``kernels.highpass.highpass`` sends to the plain version;
   and tiles that one block's shared memory cannot hold ((1, 300, 300) and
   (1, 1,024, 1,024) 5x5, (4, 400, 173) 3x7, (2, 260, 260) 3x5, a (3, 300,
   300) stack one element past a 16-byte line), which the kernel reads from
   device memory, held the same way with NaN, ties and +-inf and timed
   beside the plain version and the byte bound;
4. the systematic resample kernel against its plain version, bit for bit,
   and both times, at the main paths' shapes (phase 24's 10,240 x 512 among
   them);
5. the tracker at ``bench.py``'s size (1,024 points x 1,024 particles x 50
   steps, 512x512 frames): a warm-up pass, then the best of two timed
   passes, in each of which the three kernels must launch; the means must be
   finite and the recovered velocity right;
6. the tracker at the north-star width, 10,240 points x 2,048 particles,
   for 10 steps (best of two passes after a warm-up);
7. the same small run on the card and on the CPU with the same injected
   draws: each step from a shared state within 1e-3, the free runs within
   the bounds stated there;
8. the Columbia-scale recipe of ``benchmarks/columbia_scale.py`` at full
   width: 10,240 points x 2,048 particles, two observers (the second
   starting late at step 10 and masked on every 7th step after that), a
   viewshed test on every step, 33 frames made on the host as
   ``track_stream(chunk=8)`` consumes them; a warm-up pass, then the best
   of two timed passes, in each of which the high-pass must launch once per
   step plus the templates and the resample once per step; the final RMSE
   against the scene's truth at most 0.5 px;
9. the new paths on the card against the CPU, 16 x 256 x 8: two observers,
   the second late and masked, viewshed, ``resample_threshold=0.5`` and
   covariances, with the same injected draws; bounds as phase 7;
10. a checkpoint on the card: save after step 3, load, run 3 more steps;
    outputs and particles bit-equal to the uninterrupted run;
11. the stabilization recipe of ``benchmarks/columbia_pipeline.py``, cut to
    100 frames (phase 18 runs it at 1,000 from files): frames of 512x512
    rendered on the card (static terrain, a
    moving glacier band, a camera wobbling by (0.1, 0.1, 0.03) deg), 2,048
    keypoints a frame under the terrain mask, matching at offsets (1, 8, 64)
    (ratio 0.75, at most 20 px), the device L-BFGS fit (frame 0 anchored),
    correlation refinement of the matches and a second fit; every view
    direction within 0.01 deg of the truth in both fits;
12. each stabilization module on the card against the CPU at small size:
    inverse projection through the three solvers within 1e-5; matching with
    identical indices and ratios within 1e-5; at least 98 % of keypoints
    within 1e-2 px, their descriptors within 1e-3; refinement within 1e-3
    px; the fit (24 frames, 500 L-BFGS iterations) within 2e-3 deg;
13. terrain on the card: a 2,048 x 2,048 DEM of 10 m cells (relief of a few
    hundred metres, a block of NaN cells) as a ``Raster``;
    ``Raster.viewshed(origin, correction=True)`` on the card in float32
    against the same call on the CPU in float64 (at most 0.5 % of cells may
    differ, and at least 80 % of those, once there are 50 of them, must have
    a neighbour of the other class in the CPU's mask: grazing boundaries); on
    a 256 x 256 crop the
    card's polar viewshed (oversample 4) against ``viewshed_rings`` on at
    least 98 % of cells; ``Raster.horizon(origin, range(360))`` card against
    CPU, elevation angles within 1e-3 rad;
14. objects in, ``Tracks`` out, at full width: the recipe of
    ``examples/oblique_3d_tracking.py``: an oblique ``Camera`` (f = 512,
    pitched 35 deg down) over a DEM ``Raster`` whose texture moves (1.2, 0.8)
    a frame; 10 frames of 512 x 512 rendered by ``render.project_dem`` and
    inpainted, each an ``Image`` with its ``array`` set; one ``Observer``
    (sigma 0.2); the DEM's viewshed from the camera, computed on the card, as
    ``viewshed=``; 10,240 host ``CartesianMotion`` models (DEM prior 0.5)
    stacked by ``BatchMotion.from_motions``; ``BatchTracker.from_observers``
    at 2,048 particles and 41 x 41 search boxes; ``feeder.stream_track``
    forward and backward, ``to_tracks``, ``reverse``,
    ``Tracks.from_multiple``. Both kernels must launch on this path; the
    median velocity of each run within 0.3 of the truth, the fused median
    final position error under 0.5 m, the median |z - DEM| under the 0.5 m
    prior, no point with an error; then one step under ``torch.profiler``;
15. the same object path on the card and on the CPU at 16 points x 256
    particles from shared draws: each step from a shared state within 1e-3;
16. the host ``Tracker`` on phase 14's scene and objects, 64 points x 2,048
    particles x 10 frames, driven with pre-drawn noise as
    ``benchmarks/lockstep.py`` drives the reference's: ``Tracker(device=
    "cuda")`` and ``Tracker(device="cpu")`` through ``Tracker.track`` and
    ``BatchTracker.from_observers`` from the same objects and draws. The
    high-pass kernel must launch once a template and once a (track, step),
    and is held bit for bit to its plain version on a random tile of every
    (h, w) the tracker gave it; no track may end with an error; every step from the batched tracker's
    carried state: card against CPU within 1e-3, the host tracker's
    projected mean within 0.1 px of the batched tracker's; the free runs
    are reported beside that; then 4 points whose first particles spread
    (30, 45) m, so that search tiles outgrow 170 x 170, through
    ``Tracker(cuda)`` and ``Tracker(cpu)`` from the same draws: every track
    finishes, and each step from the CPU's carried particles the card's
    projected mean is within 0.1 px of the CPU's; the kernel is held to its
    plain version, NaN included, on a tile of every shape that run gave
    it, and timed on the largest;
17. calibration: ``benchmarks/ba_autodiff.py``'s three problems at their own
    sizes (4 cameras x 2,000 points; 6 cameras x 4,000 matches with three
    radial coefficients; 3 cameras of 1,200 horizon points against up to
    4,096 candidates) through ``Cameras.fit`` with the exact Jacobian
    (``torch.func.jacfwd``, float64, on the card) and with scipy's finite
    differences: success, the points problem within 1e-6 of its truth, the
    two fits agreeing, the card's Jacobian within 1e-9 of the CPU's; then
    ``ransac`` on the points problem with a tenth of the points moved far
    off recovers the inlier set;
18. stabilization from image files: phase 11's scene at 1,000 frames, each
    written as a JPEG (quality 95) with a datetime and read back as an
    ``Image``; ``ObserverCameras(observer, anchors=[0])``,
    ``build_keypoints(detector="device")`` and ``build_matches(matcher=
    "device", seq=(1, 8, 64), refine=True)`` cached as pickles, ``fit``,
    then ``project_images`` of every frame on the card into GeoTIFFs.
    Every view direction within 0.01 deg; a second pass on fresh objects
    detects nothing and gives identical matches; no break in the match
    chain; frame 0's projection bit-equal card against CPU; the stages'
    seconds by ``profiling.Timer``. The JPEG files are decoded once into a
    host array, and the fitted cameras kept, for phase 24;
19. camera model conversion: each of ``tests/assets``' four calibration
    files (MATLAB, OpenCV, Agisoft, PhotoModeler) to a ``Camera``, then to
    each other format and back by ``convert.Converter`` fits: the default
    fit (the reference's, scipy's 2-point differences on the host), and the
    fit with the exact Jacobian on the card and on the CPU, whose every
    parameter must agree within 1e-9 relative card against CPU;
20. phase 6's tracker with its points cut into four mesh slices on one
    card (``parallel.get_mesh(devices=["cuda"] * 4)``), each slice's state
    and generator its own and nothing joined a step, beside the tracker
    with no mesh, from the same injected draws: four launches of each
    kernel a step, the outputs as phase 7 holds a free run, then one step
    under ``profiling.device_trace`` (a Chrome trace under ``phase20_trace/``);
    a 4-slice ``MeshState`` checkpointed after 2 steps of generator draws
    and resumed for 2 must equal the uninterrupted run bit for bit;
21. one process a slice: phase 6's width (10,240 x 2,048 x 10) and phase
    5's (1,024 x 1,024 x 50) in 1, 2 and 4 processes sharing the card, each
    process joined by ``parallel.initialize_distributed`` (gloo) and
    tracking its ``local_points_slice`` from the same injected draws; the
    means stitched by ``parallel.gather_points`` held to the one-process
    run as phase 7 holds a free run, the ``all_reduce``'d sum equal on
    every rank, the three kernels launched in every process; aggregate
    point-steps/s (points x steps over the slowest rank's seconds) and each
    rank's peak memory;
22. phase 6's tracker in ``sse_sample_mode`` ``'nearest'`` and
    ``'bilinear'`` (``sse_upsample=8``) beside the exact ``'einsum'``, from
    the same injected draws: point-steps/s, peak memory, the median and
    largest |diff| of the means against the exact mode, one profiled step
    of each; then each mode on the card against the CPU at 16 x 256, each
    step from a shared state within 1e-3;
23. precisions: (a) both kernels in bfloat16, float16 and float64 against
    their plain versions on the card, bit for bit, at the main path's
    shapes ((20,480, 31, 31), (10,240, 41, 41), (10,240, 15, 15); 10,240 x
    2,048), timed (CUDA events, the mean of 20 after 3 warm-ups) beside
    their plain versions and their byte bounds, then phase 3's held cases
    (ties, NaN, +-inf, every window, the smallest tiles, a stack one element
    past a 16-byte line), stacks that leave a packed lane of the 16-bit
    kernel without its partner tile (``LANE_CASES``: one tile, odd counts, a
    partial last group, stacks 2 bytes past a 4-byte boundary in 16 bits)
    in every separable window, the resample at N = 37 with thresholds tied
    to slots, and phase 3's large tiles held and timed; (b) phase 6's tracker
    in float32, bfloat16, float16 and float64 from the same generator
    draws: point-steps/s, peak memory, launches of each kernel a step, the
    median and worst point's distance from the float32 run; (c) phase 8's Columbia recipe in bfloat16 beside its
    float32 run: final RMSE against the truth; (d) bfloat16 on the card
    against the CPU at 16 x 256 x 5, each step from a shared state, held by
    the CPU tests' rule (|card - CPU| <= max |CPU bfloat16 - CPU float32| +
    one bfloat16 ulp);
24. stabilize, then track: ``benchmarks/columbia_pipeline.py``'s tracking
    stage, not cut, on phase 18's 1,000 decoded JPEG frames: 10,240 points x
    512 particles (cartesian motion, xy_sigma 1, v_sigma (0.5, 0.5, 0),
    a_sigma (0.05, 0.05, 0), a constant DEM at 0, 15x15 templates, 31x31
    search boxes, sigma 0.3, starts drawn as the reference draws them)
    through ``track_stream`` with phase 8's chunk, three times from one
    generator seed: with the cameras ``ObserverCameras.set_cameras`` gave
    phase 18's images as a (1,000, 1, 20) ``camera_vectors_seq``, with none
    (the nominal camera) and with the true cameras. Each final mean finite,
    the three kernels launched in the stabilized run, its RMSE against the truth
    below the unstabilized one; the three RMSEs (beside the JAX package's
    22.78 on its own run), point-steps/s and peak memory of the stabilized
    run, each run's launches;
25. two observers stabilized, then tracked: ``main_two_observers`` of
    ``benchmarks/columbia_pipeline.py`` at full length. Observer A (phase
    18's camera) fires at even steps and B (west of the scene, looking east)
    at odd ones, 500 frames each, each written as JPEG and stabilized on its
    own through ``ObserverCameras``; then 10,240 points x 512 particles over
    the 1,000-step union timeline through ``track_stream`` with
    ``obs_masks`` and the fitted cameras as a (1,000, 2, 20)
    ``camera_vectors_seq``, and once with none. Each observer's mean view
    direction error at most 0.01 deg, every final mean finite, the
    stabilized RMSE below the unstabilized one, the high-pass launched for
    each observer's templates and once a step, the resample once a step;
    the RMSEs beside the JAX package's 4.14 and 92.0;
26. a viewshed that hides tracked terrain: phase 14's object path over its
    DEM with a 40 m ridge, whose shadow covers part of the tracked area,
    at 10,240 points x 2,048 particles x 20 frames rendered from the
    visible cells; points stratified by their true paths (a fifth entering
    hidden cells, three fifths keeping 20 m from them). Every point on a
    hidden cell lost by that step, every far point kept with the median
    velocity within 0.3 of the truth, ``Tracks`` NaN from each failing step
    with ``errors`` set; then 256 lost points on the card against the CPU,
    each step from the CPU's state within 1e-3, validity flags equal;
27. graphs against eager: ``track`` and ``track_stream`` replay one captured
    CUDA graph a step after the first (``track.batch.StepProgram``); each of
    phase 5's 1,024 x 1,024 x 50, phase 6's 10,240 x 2,048 x 10, phase
    24's 10,240 x 512 x 100 (its fitted cameras, ``track_stream(chunk=8)``)
    and phase 20's four mesh slices on one card (injected draws) runs eager
    (every step through ``step``), graphed, graphed, eager in one process:
    point-steps/s, ms a step and peak memory of each run, every step's means
    and the final particles and weights bit-equal across the four runs
    (eager against eager first: the path is deterministic), each kernel's
    launches equal; then one eager and one replayed step under the
    profiler: idle share, host ``cudaLaunchKernel`` and ``cudaGraphLaunch``
    calls a step, and the four kernels' names among the replay's kernels.

28. calibration and stabilization programs against eager: each runs eager,
    graphed, graphed, eager in one process: (a) phase 18's ``ObserverCameras``
    objective through 200 L-BFGS iterations (``optimize._TensorSteps``
    against ``optimize.LBFGSPrograms``): ms an iteration, evaluations, x,
    value, gradient and iterations bit-equal, and iteration 41 profiled each
    way (idle share, ``cudaLaunchKernel``, ``cudaGraphLaunch``, memory copies
    and all CUDA API calls; a replayed iteration launches at most one graph
    an evaluation plus one for its direction, and no kernel); (b) phase 17's
    three problems' exact Jacobian at the start (``optimize._exact_jacobian``
    against ``Cameras._autodiff_jac``'s program): ms a call, bit-equal,
    beside phase 17's fit seconds exact and 2-point; (c) one detection batch
    of 16 of phase 24's decoded frames (phase 18's mask), one matching batch
    of 32 pairs of their 2,048-slot stacks and one refinement chunk of 8
    pairs x 3,072 matches: ms eager and graphed, bit-equal.
29. the spline read kernel (``kernels/spline.py``) against its plain
    version at the benchmark cells' shapes, (20,480, 17, 17) and (1,024, 27,
    27) x 2,048 particles, in the four dtypes at the tracker's coordinates
    (float32, float64 for float64): bit-equal with NaN where the plain
    version has it (edges, NaN and +-inf coefficients and coordinates), then
    both timed beside the byte bound by ``kernels/bench_spline.measure``
    (:func:`spline_phase`).
30. the observer front-end kernel (``kernels/project.py``) against its
    plain version at the benchmark cells' front ends, (2, 10,240), (1,
    1,024) and (1, 10,240) observers x points x 2,048 particles, in the four
    particle types: tiles, cols and rows bit-equal where the corners agree,
    a corner moved only at a half-pixel tie of the plain mean (particles
    behind the camera and at NaN, corners clamped at all four edges,
    distortion, an elevation correction), then timed beside the byte bound
    by ``kernels/bench_project.measure`` (:func:`project_phase`).
31. the DEM prior kernel (``kernels/prior.py``) against its plain version
    at oblique-3d's 640 x 640 rasters, 10,240 and 1,024 points x 2,048
    particles, in the four particle types: bit-equal, NaN where the plain
    version has NaN, then timed beside the byte bound by
    ``kernels/bench_prior.measure`` (:func:`prior_phase`). It launches on
    the paths whose motion carries a DEM sigma, phases 14, 16 (c) and 26
    (:data:`PRIOR_PATHS`), and on no other.

Every phase that runs ``track`` or ``track_stream`` runs it graphed; every
phase that detects, matches, refines, fits an ``ObserverCameras`` or takes
``Cameras``' exact Jacobian (11, 12, 17, 18, 24, 25) runs their programs.

Any failure raises and the exit code is not 0. The line before the last is
the kernels' JSON record; the last is ``{"ok": true, "device": ...}``.

``python3 chip_smoke.py --scaling`` on a machine with several cards runs
phases 20-21's tracker across 1, 2 and 4 cards instead (see
:func:`scaling`); ``--worker`` is phase 21's process.
"""
import concurrent.futures
import contextlib
import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from typing import List, Tuple

import numpy as np

from portbench.metrics._reader import LAUNCH_CALLS, busy_s, kernel_label, load_chrome

REPO = os.path.dirname(os.path.abspath(__file__))


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _cuda_ms(fn, reps: int = 20) -> float:
    """Mean milliseconds per call, from CUDA events after a warm-up."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# Windows phase 3 holds beyond the main path's 5x5: the other compiled
# separable kernels and four that run the generic one.
# The host tracker's high-pass tiles phase 3 holds and times: its 15x15
# template, its smallest search tile (the template plus the spline support of
# 3, on whole pixels) and non-square ones of the sizes phase 16's search
# boxes take (91 shapes from 19x19 to 31x42 at 64 points x 2,048 particles).
HOST_TRACKER_TILES = ((15, 15), (19, 19), (19, 23), (26, 31), (31, 42))

HIGHPASS_WINDOWS = ((3, 3), (5, 5), (7, 7), (3, 7), (9, 5), (1, 9), (3, 11), (7, 5), (1, 1), (1, 49))
# Tiles thinner than half the window, whose padding reflects more than once
# (a 3x3 template under 7x7 taps): (h, w), window.
THIN_TILES = (((2, 9), (5, 5)), ((1, 9), (5, 5)), ((9, 2), (5, 5)), ((2, 2), (5, 5)), ((3, 3), (7, 7)))


def highpass_tiles(shape, seed: int = 0, specials: bool = True) -> np.ndarray:
    """Tiles (N, h, w) of what ``rng.normal`` never gives: values quantised
    to a 64-value table, as histogram-matched search tiles take theirs from a
    quantile table, so ties are many. With ``specials``, a NaN pixel at a
    corner of tile 0, on an edge of tile 1 and inside tile 2, and +-inf in
    1 % of the pixels of the other tiles."""
    rng = np.random.default_rng(seed)
    table = np.sort(rng.normal(size=64)).astype(np.float32)
    tiles = table[rng.integers(0, 64, size=shape)]
    if specials:
        n, h, w = shape
        for i, (r, c) in enumerate([(0, 0), (0, w // 2), (h // 2, w // 2)][:n]):
            tiles[i, r, c] = np.nan
        flip = rng.random(shape) < 0.01
        flip[:3] = False
        tiles[flip] = np.where(rng.random(int(flip.sum())) < 0.5, np.inf, -np.inf)
    return tiles


def highpass_check_cases():
    """Phase 3's held cases beyond the timed normal tiles: (label, shape,
    window, specials, misaligned). Ties at the main path's shapes; NaN, +-inf
    and ties for every window of HIGHPASS_WINDOWS at 31x31 (N = 37, so the
    last group of tiles a block takes is partial) and at the smallest tiles
    the TPU kernel allows; THIN_TILES; one stack that starts 4 bytes past a
    16-byte line."""
    cases = [
        ("ties", (20480, 31, 31), (5, 5), False, False),
        ("ties+nan+inf", (1024, 41, 41), (5, 5), True, False),
        ("ties+nan+inf", (1024, 15, 15), (5, 5), True, False),
        ("ties+nan+inf, misaligned", (37, 31, 31), (5, 5), True, True),
    ]
    for kh, kw in HIGHPASS_WINDOWS:
        cases.append(("ties+nan+inf", (37, 31, 31), (kh, kw), True, False))
        cases.append(("ties+nan+inf, smallest", (64, kh // 2 + 1, kw // 2 + 1), (kh, kw), True, False))
    for (h, w), size in THIN_TILES:
        cases.append(("ties+nan+inf, thin", (64, h, w), size, True, False))
    return cases


def highpass_case_tiles(shape, specials: bool, misaligned: bool, device, seed: int = 0, dtype=None):
    """A case's tiles on ``device``, of ``dtype`` (float32 by default);
    misaligned ones start one element into their storage (4 bytes past a
    16-byte line in float32, 2 in 16 bits, 8 in float64)."""
    import torch

    dtype = dtype or torch.float32
    tiles = torch.from_numpy(highpass_tiles(shape, seed, specials)).to(dtype)
    if not misaligned:
        return tiles.to(device)
    storage = torch.empty(tiles.numel() + 1, device=device, dtype=dtype)
    return storage[1:].view(shape).copy_(tiles)


def highpass_mismatch(got, want) -> float:
    """Largest |got - want| where the two are not the same value (NaN with
    NaN and inf with inf count as the same); 0 when they agree everywhere."""
    import torch

    same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    return float(torch.where(same, 0.0, (got - want).abs().nan_to_num(float("inf"))).max())


#: The kernels that launch only where the motion's DEM prior weighs (a DEM
#: sigma), and the main paths whose motion carries one: phase 14's, phase 16
#: (c)'s and phase 26's host ``CartesianMotion`` with a 0.5 m sigma.
PRIOR_KERNELS = ("dem_prior",)
PRIOR_PATHS = ("phase 14", "phase 16", "phase 26")


def kernel_wrappers() -> dict:
    """The port's registered kernel wrappers by name, in the registry's
    order, the order of the ``kernels`` JSON line; each counts its launches
    in ``launches``."""
    from glimpse_tpu_torch.kernels import _build

    return {kernel.wrapper.__name__: kernel.wrapper for kernel in _build.KERNELS.values()}


def reset_launches() -> None:
    """Every kernel wrapper's launch count to 0, before a path's own run."""
    for wrapper in kernel_wrappers().values():
        wrapper.launches = 0


def launch_counts() -> dict:
    """Every kernel wrapper's launches since :func:`reset_launches`."""
    return {name: wrapper.launches for name, wrapper in kernel_wrappers().items()}


def spline_case(shape, dtype, coord_dtype, device, seed: int = 0, specials: bool = True):
    """Coefficients (B, h, w) of ``dtype`` and rows and cols (B, P) of
    ``coord_dtype`` on ``device``, for the spline read. Coordinates are
    uniform over [0, n - 1], where the tracker clamps them; the first 18 of
    each surface's rows and cols sit at 0 and n - 1, one step of the type
    inside each, at 1 and one step below, at n - 2 and one step above, half a
    cell and three cells outside, at NaN and +-inf, and on a whole cell and
    half a cell inside (cols in the reverse order, so that rows and cols pair
    differently). With ``specials``, NaN at a corner of surface 0, +inf on an
    edge of surface 1, -inf inside surface 2 and +-inf in 0.1 % of the other
    cells."""
    import torch

    B, h, w, p = shape
    rng = np.random.default_rng(seed)
    coeffs = rng.normal(size=(B, h, w)) * 10.0
    if specials:
        for b, (r, c), value in zip(range(B), [(0, 0), (0, w // 2), (h // 2, w // 2)], [np.nan, np.inf, -np.inf]):
            coeffs[b, r, c] = value
        flip = rng.random(coeffs.shape) < 0.001
        flip[:3] = False
        coeffs[flip] = np.where(rng.random(int(flip.sum())) < 0.5, np.inf, -np.inf)

    def coords(n):
        x = torch.from_numpy(rng.uniform(0.0, n - 1.0, size=(B, p))).to(coord_dtype)

        def at(v):
            return torch.tensor(v, dtype=coord_dtype)

        def step(v, toward):
            return torch.nextafter(at(v), at(toward))

        edges = torch.stack([
            at(0.0), at(n - 1.0), step(0.0, 1.0), step(n - 1.0, 0.0), at(1.0), step(1.0, 0.0),
            at(max(n - 2.0, 0.0)), step(max(n - 2.0, 0.0), n), at(-0.5), at(n - 0.5), at(-3.0), at(n + 2.0),
            at(float("nan")), at(float("inf")), at(float("-inf")), at(float(n // 2)), at(n // 2 + 0.5), at(0.25),
        ])
        k = min(p, len(edges))
        x[:, :k] = edges[:k]
        return x

    rows, cols = coords(h), coords(w)
    cols[:, :min(p, 18)] = cols[:, :min(p, 18)].flip(1)
    return torch.from_numpy(coeffs).to(dtype).to(device), rows.to(device), cols.to(device)


def spline_phase(cuda) -> Tuple[str, list]:
    """Phase 29: the spline read kernel against its plain version on the
    card at ``bench_spline.SHAPES`` in each of ``bench_spline.DTYPES`` at the
    tracker's coordinates, on :func:`spline_case` (edges, NaN and +-inf),
    with rtol = atol = 0 and NaN where the plain version has NaN; then each
    timed beside its byte bound by ``bench_spline.measure``. Returns (the
    line, the timing records, the north star's float32 first)."""
    import torch

    from glimpse_tpu_torch.kernels import bench_spline
    from glimpse_tpu_torch.kernels.spline import bspline_sample, bspline_sample_plain

    held, records = [], []
    for shape in bench_spline.SHAPES:
        for dtype in bench_spline.DTYPES:
            label = f"{'x'.join(map(str, shape))} {str(dtype).removeprefix('torch.')}"
            coeffs, rows, cols = spline_case(shape, dtype, bench_spline.coord_dtype(dtype), cuda,
                                             seed=shape[0] + shape[1])
            before = bspline_sample.launches
            got = bspline_sample(coeffs, rows, cols)
            want = bspline_sample_plain(coeffs, rows, cols)
            if bspline_sample.launches != before + 1 or got.dtype != want.dtype:
                raise AssertionError(f"spline read {label}: {bspline_sample.launches - before} launches,"
                                     f" {got.dtype} against {want.dtype}")
            torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True,
                                       msg=lambda m: f"spline read {label}: {m}")
            if not torch.isnan(want).any():
                raise AssertionError(f"spline read {label}: no NaN to hold")
            held.append(f"{label} ({int(torch.isnan(want).sum())} NaN)")
            del coeffs, rows, cols, got, want
            records.append(bench_spline.measure(shape, dtype))
    return (
        "phase 29 spline read bit-equal to its plain version, rtol=atol=0 with equal NaN: " + ", ".join(held)
        + "; timed: " + "; ".join(
            f"{'x'.join(map(str, r['shape']))} {r['dtype']} {r['route']} {r['ms']:.4f} ms (bound {r['bound_ms']:.4f},"
            f" {100 * r['bound_share']:.1f} %; plain {r['plain_ms']:.3f} ms)" for r in records)
    ), records


def project_phase() -> Tuple[str, list]:
    """Phase 30: the observer front-end kernel against its plain version on
    the card at ``bench_project.SHAPES`` (the benchmark cells' front ends) in
    each of ``bench_project.DTYPES``, on ``bench_project.inputs`` (particles
    behind the camera and at NaN, corners clamped at all four edges,
    distortion and an elevation correction): one launch, tiles, cols and rows
    bit-equal where the corners agree, a corner moved only at a half-pixel
    tie of the plain mean (``bench_project.check``); then the launch alone,
    the wrapper and the plain version timed beside the byte bound
    (``bench_project.measure``). Returns (the line, the records, the north
    star's float32 first)."""
    import torch

    from glimpse_tpu_torch.kernels import bench_project

    records = []
    for shape in bench_project.SHAPES:
        for dtype in bench_project.DTYPES:
            records.append(bench_project.measure(shape, dtype))
            torch.cuda.empty_cache()
    return "phase 30 observer front end against its plain version: " + "; ".join(
        bench_project.describe(r) for r in records), records


def prior_phase() -> Tuple[str, list]:
    """Phase 31: the DEM prior kernel against its plain version on the card
    at ``bench_prior.SHAPES`` (oblique-3d's rasters at 10,240 and 1,024
    points) in each of ``bench_prior.DTYPES``, on ``bench_prior.inputs``
    (points inside and outside the rasters, a NaN DEM cell, sigma cells at
    or below 0 and at NaN, particles at +-inf): one launch,
    bit-equal (``bench_prior.check``); then the launch alone, the wrapper
    and the plain version timed beside the byte bound
    (``bench_prior.measure``). Returns (the line, the records, oblique-3d's
    float32 first)."""
    import torch

    from glimpse_tpu_torch.kernels import bench_prior

    records = []
    for shape in bench_prior.SHAPES:
        for dtype in bench_prior.DTYPES:
            records.append(bench_prior.measure(shape, dtype))
            torch.cuda.empty_cache()
    return "phase 31 DEM prior against its plain version: " + "; ".join(
        bench_prior.describe(r) for r in records), records


# Tiles that one block's shared memory cannot hold in float32, which the
# kernel reads from device memory (phase 3, and phase 23 (a) in the other
# dtypes): (shape, window, misaligned). The host Tracker's search tiles grow
# past 170 x 170 when its particle cloud spans that much of the image.
HIGHPASS_LARGE_TILES = (
    ((1, 300, 300), (5, 5), False), ((1, 1024, 1024), (5, 5), False), ((4, 400, 173), (3, 7), False),
    ((2, 260, 260), (3, 5), False), ((3, 300, 300), (5, 5), True),
)


def large_tiles(device, dtype, hbm_bytes_per_s: float):
    """HIGHPASS_LARGE_TILES in ``dtype``: each held to the plain version with
    rtol = atol = 0 and NaN where it has NaN (ties, NaN at a corner, an edge
    and inside, +-inf), then both timed on those tiles (CUDA events, the
    mean of 20 after 3 warm-ups) beside the byte bound, each input and
    output element once. Returns ([{shape, size, dtype, variant, ms,
    plain_ms, bound_ms}], the largest mismatch)."""
    import torch

    from glimpse_tpu_torch.kernels.highpass import kernel_variant, median_highpass, median_highpass_plain

    records, err = [], 0.0
    for shape, size, misaligned in HIGHPASS_LARGE_TILES:
        tiles = highpass_case_tiles(shape, True, misaligned, device, seed=sum(shape), dtype=dtype)
        got, want = median_highpass(tiles, size), median_highpass_plain(tiles, size)
        variant = kernel_variant(size, dtype, shape)
        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True,
                                   msg=lambda m: f"median_highpass ({variant}) on a large tile {shape} {size}: {m}")
        if not torch.isnan(want).any():
            raise AssertionError(f"the large tile {shape} holds no NaN")
        err = max(err, highpass_mismatch(got, want))
        records.append({
            "shape": list(shape), "size": list(size), "dtype": str(dtype).removeprefix("torch."),
            "misaligned": misaligned, "variant": variant,
            "ms": _cuda_ms(lambda: median_highpass(tiles, size)),
            "plain_ms": _cuda_ms(lambda: median_highpass_plain(tiles, size)),
            "bound_ms": 2 * tiles.numel() * tiles.element_size() / hbm_bytes_per_s * 1e3,
        })
    return records, err


def describe_large_tiles(records) -> str:
    return "; ".join(
        f"{'x'.join(map(str, r['shape']))}{' misaligned' if r['misaligned'] else ''} {r['size'][0]}x{r['size'][1]}"
        f" {r['variant']} {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, bound {r['bound_ms']:.4f})"
        for r in records
    )


def make_scene(n_frames: int, img: int = 512, seed: int = 0):
    """bench.py's scene: a smooth random texture shifted (1, 2) px (rows,
    cols) per frame, seen by a nadir camera at 1 px per world unit."""
    import scipy.ndimage

    rng = np.random.default_rng(seed)
    base = scipy.ndimage.gaussian_filter(rng.normal(size=(img, img)), 0.8) * 100
    frames = np.stack(
        [
            scipy.ndimage.shift(base, (i * 1.0, i * 2.0), order=1, mode="nearest")
            for i in range(n_frames)
        ]
    ).astype(np.float32)
    camera = np.zeros(20, np.float32)
    camera[0:3] = (img / 2, img / 2, img)  # xyz
    camera[3:6] = (0, -90, 0)  # viewdir: looking straight down
    camera[6:8] = (img, img)  # imgsz
    camera[8:10] = (img, img)  # f; c, k and p stay 0
    return frames, camera, rng


COLUMBIA_IMG = 512
COLUMBIA_VELOCITY = (0.06, 0.04)  # px per frame, (cols, rows)
COLUMBIA_OFFSETS = ((0, 0), (5, 3))  # each observer's extra crop offset, (rows, cols)


def columbia_scene(n_frames: int, seed: int = 0):
    """benchmarks/columbia_scale.py's scene with two observers, rebuilt on
    numpy: a smooth random canvas cropped bilinearly, moving 0.06 px right
    and 0.04 px down per frame; observer 2 crops it 5 rows and 3 columns
    further, its principal point c = (-3, -5) absorbing the offset, so both
    see the same world track. Nadir cameras at 1 px per world unit; an
    all-visible 64x64 viewshed over three times the canvas.

    Returns (frame(i) -> (2, 512, 512) float32, camera vectors (2, 20),
    viewshed fields, the generator that drew the canvas)."""
    import scipy.ndimage

    img = COLUMBIA_IMG
    vx, vy = COLUMBIA_VELOCITY
    rng = np.random.default_rng(seed)
    pad = int(np.ceil(max(abs(vx), abs(vy)) * n_frames)) + 8
    canvas = scipy.ndimage.gaussian_filter(rng.normal(size=(img + pad, img + pad)), 0.8).astype(np.float32) * 100

    def crop(r0: float, c0: float) -> np.ndarray:
        ri, ci = int(np.floor(r0)), int(np.floor(c0))
        fr, fc = r0 - ri, c0 - ci
        win = canvas[ri : ri + img + 1, ci : ci + img + 1]
        top = win[:-1, :-1] * (1 - fc) + win[:-1, 1:] * fc
        bot = win[1:, :-1] * (1 - fc) + win[1:, 1:] * fc
        return top * (1 - fr) + bot * fr

    def frame(i: int) -> np.ndarray:
        return np.stack([crop(vy * i + dr, vx * i + dc) for dr, dc in COLUMBIA_OFFSETS]).astype(np.float32)

    cams = np.zeros((len(COLUMBIA_OFFSETS), 20), np.float32)
    for o, (dr, dc) in enumerate(COLUMBIA_OFFSETS):
        cams[o, 0:3] = (img / 2, img / 2, img)  # xyz
        cams[o, 3:6] = (0, -90, 0)  # viewdir: looking straight down
        cams[o, 6:8] = (img, img)  # imgsz
        cams[o, 8:10] = (img, img)  # f
        cams[o, 10:12] = (-dc, -dr)  # c
    side = img + pad
    viewshed = {
        "array": np.ones((64, 64), np.float32), "x0": -side, "y0": 2 * side,
        "dx": 3 * side / 64, "dy": -3 * side / 64,
    }
    return frame, cams, viewshed, rng


def columbia_masks(n_steps: int, first: int, every: int):
    """(obs_masks (n_steps, 2), obs_mask0 (2,)): observer 2 has no image at
    the template frame, fires first at step ``first`` (1-based) and misses
    every ``every``-th step after that."""
    masks = np.ones((n_steps, 2), np.float32)
    masks[: first - 1, 1] = 0.0
    masks[first - 1 + every :: every, 1] = 0.0
    return masks, np.array([1.0, 0.0], np.float32)


def columbia_tracker(cams, viewshed, points_xy, n_particles, device, **settings):
    """columbia_scale.py's tracker, which is columbia_pipeline.py's: cartesian
    motion on a flat DEM (xy_sigma 1, v_sigma (0.5, 0.5, 0), a_sigma (0.05,
    0.05, 0)), 15x15 templates, 31x31 search boxes, sigma 0.3 px per
    observer, the viewshed test on unless ``viewshed`` is None."""
    from glimpse_tpu_torch.track import batch, convert

    motion = cartesian_motion(points_xy, 1.0, (0.5, 0.5, 0.0), (0.05, 0.05, 0.0), device)
    config = batch.BatchConfig(n_particles=n_particles, template_size=(15, 15), search_size=(31, 31), **settings)
    return batch.BatchTracker(
        cams, [None] * len(cams), [0.3] * len(cams), motion, config, device=device,
        viewshed=None if viewshed is None else convert.raster_from_numpy(viewshed, device),
    )


def cartesian_motion(points_xy, xy_sigma, v_sigma, a_sigma, device):
    """Cartesian motion from rest on a flat DEM at z = 0, without a DEM sigma."""
    from glimpse_tpu_torch.track import convert

    n = len(points_xy)
    dem = {"array": [[0.0]], "x0": 0.0, "y0": 0.0, "dx": 1e30, "dy": 1e30}
    return convert.motion_from_numpy(
        {
            "kind": "cartesian",
            "xy": points_xy,
            "xy_sigma": np.full((n, 2), xy_sigma),
            "v_mean": np.zeros((n, 3)),
            "v_sigma": np.tile(v_sigma, (n, 1)),
            "a_mean": np.zeros((n, 3)),
            "a_sigma": np.tile(a_sigma, (n, 1)),
            "slope_sigma": np.zeros(n),
            "dem": dem,
            "dem_sigma": dem,
            "use_dem_sigma": False,
        },
        device,
    )


def make_tracker(camera, points_xy, n_particles, device, mesh=None, **settings):
    from glimpse_tpu_torch.track import batch

    motion = cartesian_motion(points_xy, 1.5, (3.0, 3.0, 0.0), (0.2, 0.2, 0.0), device)
    config = batch.BatchConfig(
        n_particles=n_particles, template_size=(15, 15), search_size=(41, 41), **settings
    )
    return batch.BatchTracker(camera[None], [None], [0.3], motion, config, device=device, mesh=mesh)


def injected_draws(n: int, p: int, t: int, device, seed: int) -> dict:
    """Standard normals and uniforms for ``track(noise=)`` of n points x p
    particles x t steps, drawn on ``device`` from a generator seeded with
    ``seed``: the same numbers in every process on the same card."""
    import torch

    draws = torch.Generator(device=device).manual_seed(seed)
    return {
        "init": {k: torch.randn((n, p, w), generator=draws, device=device) for k, w in (("xy", 2), ("v", 3))},
        "a": torch.randn((t, n, p, 3), generator=draws, device=device),
        "resample_u": torch.rand((t, n), generator=draws, device=device),
    }


def free_run_bounds(got, want):
    """(step 1's, the median point's and the worst point's largest |diff|)
    of two free runs' means (T, N, 6), held as phase 7 holds them: 1e-3,
    1e-2 and 0.5."""
    per_point = np.abs(got - want).max(axis=(0, 2))
    step1 = float(np.abs(got[0] - want[0]).max())
    if step1 > 1e-3 or np.median(per_point) > 1e-2 or per_point.max() > 0.5:
        raise AssertionError(f"free runs part: step 1 {step1}, median point {np.median(per_point)},"
                             f" worst point {per_point.max()}")
    return step1, float(np.median(per_point)), float(per_point.max())


def run_tracker(tracker, frames, seed=0):
    """Track through frames (T, H, W) already on the tracker's device; returns
    (outputs, seconds) with the host clock around a synchronised run."""
    import torch

    generator = torch.Generator(device=tracker.device).manual_seed(seed)
    dts = torch.ones(frames.shape[0] - 1, device=tracker.device)
    start = time.perf_counter()
    _, out = tracker.track(generator, frames[:, None], dts)
    torch.cuda.synchronize()
    return out, time.perf_counter() - start


STAB_IMG = 512
STAB_CAM_XYZ = (256.0, -200.0, 400.0)
STAB_VIEWDIR = (0.0, -35.0, 0.0)
STAB_VELOCITY = (0.06, 0.04)  # the glacier band's motion, world units per frame
STAB_BAND = (180.0, 360.0)  # the glacier band in world y
STAB_JITTER = (0.1, 0.1, 0.03)  # per-frame view direction wobble, deg
STAB_OFFSETS = (1, 8, 64)


def stabilization_scene(n_frames: int, device, seed: int = 0, imgsz: int = STAB_IMG, cam_xyz=STAB_CAM_XYZ,
                        viewdir=STAB_VIEWDIR, jitter_seed: int = 42, steps=None):
    """benchmarks/columbia_pipeline.py's scene, rendered on ``device``: a
    textured plane (terrain) with a glacier band at world y 180-360 moving
    (0.06, 0.04) per step, seen from (256, -200, 400) looking down 35 deg
    through a 512x512 camera with f = 512, whose view direction wobbles from
    frame 1 on (draws from ``jitter_seed``). Frame i shows the glacier at
    step ``steps[i]`` (default i), as the reference's ``steps=`` gives an
    observer that fires on some steps only. ``imgsz`` (f the same),
    ``cam_xyz`` and ``viewdir`` set another camera over the same world.
    Returns (frames (n, imgsz, imgsz) uint8 numpy, the true view directions
    (n, 3), the nominal camera vector (20,), the terrain mask (imgsz, imgsz)
    uint8: 255 off the band, eroded 6 px)."""
    import scipy.ndimage
    import torch

    from glimpse_tpu_torch.ops import projection, sampling

    img, pad = STAB_IMG, 128  # the world: textures over [-pad, img + pad]
    rng = np.random.default_rng(seed)
    textures = [
        torch.from_numpy(scipy.ndimage.gaussian_filter(rng.normal(size=(img + 2 * pad,) * 2), sigma) * 55 + 128).to(device)
        for sigma in (1.2, 0.8)  # terrain, glacier
    ]
    truth = np.tile(viewdir, (n_frames, 1)).astype(float)
    truth[1:] += np.random.default_rng(jitter_seed).normal(0, STAB_JITTER, size=(n_frames - 1, 3))
    base = np.zeros(20)
    base[0:3], base[3:6], base[6:8], base[8:10] = cam_xyz, viewdir, imgsz, imgsz
    u, v = np.meshgrid(np.arange(imgsz) + 0.5, np.arange(imgsz) + 0.5)
    uv = torch.from_numpy(np.column_stack([u.ravel(), v.ravel()])).to(device)
    cam = torch.tensor(cam_xyz, dtype=torch.float64, device=device)

    def ground(vector):
        """World (x, y) where each pixel's ray meets the plane z = 0."""
        rays = projection.unproject(vector, uv)
        down = rays[:, 2] < -1e-6
        t = torch.where(down, -cam[2] / torch.where(down, rays[:, 2], -1.0), 1e6)
        return cam[0] + t * rays[:, 0], cam[1] + t * rays[:, 1]

    def sample(texture, x, y):  # bilinear, edges replicated
        n = texture.shape[0]
        return sampling.bilinear_sample(texture, (y + pad).clamp(0, n - 1), (x + pad).clamp(0, n - 1))

    steps = np.arange(n_frames) if steps is None else np.asarray(steps)
    frames = torch.empty((n_frames, imgsz, imgsz), dtype=torch.uint8, device=device)
    for i, direction in enumerate(truth):
        vector = base.copy()
        vector[3:6] = direction
        wx, wy = (w.clamp(-pad, img + pad) for w in ground(vector))
        terrain = sample(textures[0], wx, wy)
        glacier = sample(textures[1], wx - STAB_VELOCITY[0] * steps[i], wy - STAB_VELOCITY[1] * steps[i])
        value = torch.where((wy >= STAB_BAND[0]) & (wy <= STAB_BAND[1]), glacier, terrain)
        frames[i] = torch.floor(value.clamp(0, 255)).to(torch.uint8).reshape(imgsz, imgsz)
    _, wy = ground(base)
    band = ((wy >= STAB_BAND[0] - 10) & (wy <= STAB_BAND[1] + 10)).reshape(imgsz, imgsz).cpu().numpy()
    mask = (scipy.ndimage.binary_erosion(~band, iterations=6) * 255).astype(np.uint8)
    return frames.cpu().numpy(), truth, base, mask


def join_points(n_points: int, n_frames: int, rng=None):
    """benchmarks/columbia_pipeline.py's ``_tracking_setup`` draws: starts in
    the glacier band (80 from the image's edges in x, 20 inside the band in
    y, room left for the motion) and the truth after ``n_frames - 1``
    frames. With no ``rng``, the reference's own: seed 42, after the view
    directions' wobble was drawn from it."""
    if rng is None:
        rng = np.random.default_rng(42)
        rng.normal(0, STAB_JITTER, size=(n_frames - 1, 3))
    margin = 80
    starts = np.column_stack([
        rng.uniform(margin, STAB_IMG - margin - STAB_VELOCITY[0] * n_frames, n_points),
        rng.uniform(STAB_BAND[0] + 20, STAB_BAND[1] - 20 - STAB_VELOCITY[1] * n_frames, n_points),
    ])
    return starts, starts + np.asarray(STAB_VELOCITY) * (n_frames - 1)


def stabilization_pairs(n_frames: int) -> np.ndarray:
    """(i, j) pairs at STAB_OFFSETS, in the order of KeypointMatcher's windows."""
    return np.array([(i, i + s) for i in range(n_frames) for s in STAB_OFFSETS if i + s < n_frames])


def matched_uvs(keypoints, pairs, found, max_distance=20.0):
    """Matched pixel pairs per image pair, at most ``max_distance`` apart."""
    out = []
    for (i, j), (idx, _) in zip(pairs, found):
        uva = keypoints[i][0][idx[:, 0]].astype(np.float64)
        uvb = keypoints[j][0][idx[:, 1]].astype(np.float64)
        ok = np.linalg.norm(uva - uvb, axis=1) < max_distance
        out.append((uva[ok], uvb[ok]))
    return out


def ratio_tolerance(desc_a, desc_b, matches) -> np.ndarray:
    """How far two float32 evaluations of each match's Lowe ratio may part:
    1e-5, plus how far a rounding of the squared distances a^2 + b^2 - 2 ab
    by 8 ulps of a^2 + b^2 moves d1 / d2 (the card and the CPU sum the 128
    products in other orders, and a near-duplicate descriptor puts d1^2 at
    that floor). ``matches`` (m, 2) indices into the two stacks."""
    a = desc_a[matches[:, 0]].astype(np.float64)
    b = desc_b.astype(np.float64)
    a2, b2 = (a * a).sum(-1), (b * b).sum(-1)
    d2 = np.maximum(a2[:, None] + b2[None, :] - 2 * a @ b.T, 0.0)
    rows = np.arange(len(a))
    first = d2[rows, matches[:, 1]]
    d2[rows, matches[:, 1]] = np.inf
    second = d2.min(axis=1)
    delta = 8 * np.finfo(np.float32).eps * (a2 + b2[matches[:, 1]])
    d1, dn = np.sqrt(first), np.sqrt(second)
    ratio = d1 / dn
    return 1e-5 + (np.sqrt(first + delta) - d1 + ratio * (np.sqrt(second + delta) - dn)) / dn


def observer_matches(uvs, pairs, base, n_frames, device):
    """The matches as a COO matrix of RotationMatchesXYZ, their camera
    coordinates from one image_to_camera call on ``device``."""
    import scipy.sparse
    import torch

    from glimpse_tpu_torch import optimize
    from glimpse_tpu_torch.ops import projection

    sizes = [len(a) for a, _ in uvs]
    stacked = torch.from_numpy(np.concatenate([np.vstack([a, b]) for a, b in uvs])).to(device)
    xy = projection.image_to_camera(stacked, base[6:8], base[8:10], base[10:12], base[12:18], base[18:20])
    pieces = np.split(xy.cpu().numpy(), np.cumsum([2 * n for n in sizes])[:-1])
    objs = [optimize.RotationMatchesXYZ(cams=(base, base), xys=np.split(p, 2)) for p in pieces]
    matches = scipy.sparse.coo_matrix((np.ones(len(objs)), tuple(pairs.T)), shape=(n_frames, n_frames))
    matches.data = np.array(objs, dtype=object)
    return matches


def observer_fit(matches, n_frames, device, **kwargs):
    """ObserverCameras(anchors=[0]) on cameras at the nominal view direction."""
    from types import SimpleNamespace

    from glimpse_tpu_torch import optimize

    observer = SimpleNamespace(images=[SimpleNamespace(cam=SimpleNamespace(viewdir=np.array(STAB_VIEWDIR)))] * n_frames)
    return optimize.ObserverCameras(observer, matches=matches, anchors=[0], device=device).fit(**kwargs)


def rotation_errors(recovered, truth) -> np.ndarray:
    """Angle (deg) of the rotation between each recovered and true view."""
    import torch

    from glimpse_tpu_torch.ops import projection

    R = [projection.rotation_matrix(torch.from_numpy(np.asarray(v, np.float64))).numpy() for v in (recovered, truth)]
    traces = np.trace(np.einsum("nij,nkj->nik", *R), axis1=-2, axis2=-1)
    return np.degrees(np.arccos(np.clip((traces - 1) / 2, -1, 1)))


def stabilize(n_frames: int, device):
    """Phase 11's recipe; returns (stage seconds, counts, fits, errors, the
    scene and the intermediate results phase 12 reuses)."""
    import torch

    from glimpse_tpu_torch.ops import features, matching, refine

    seconds = {}

    def timed(name, fn):
        start = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - start
        return out

    frames, truth, base, mask = timed("render", lambda: stabilization_scene(n_frames, device))
    keypoints = timed("detect", lambda: features.detect_and_describe(
        list(frames), masks=[mask] * n_frames, nfeatures=2048, batch=16, refine="lattice", device=device
    ))
    pairs = stabilization_pairs(n_frames)
    found = timed("match", lambda: matching.DescriptorMatcher(device=device).match_pairs(
        [k[1] for k in keypoints], pairs, max_ratio=0.75, cross_check=False
    ))
    uvs = matched_uvs(keypoints, pairs, found)
    fit1 = timed("fit", lambda: observer_fit(observer_matches(uvs, pairs, base, n_frames, device), n_frames, device,
                                             method="lbfgs-device", maxiter=2000))
    refined = timed("refine", lambda: refine.MatchRefiner(device=device).refine_pairs(
        [tuple(p) for p in pairs], uvs, lambda k: frames[k].astype(np.float32)
    ))
    fit2 = timed("fit_refined", lambda: observer_fit(
        observer_matches(refined, pairs, base, n_frames, device), n_frames, device, method="lbfgs-device", maxiter=2000
    ))
    errors = [rotation_errors(f.x.reshape(-1, 3), truth) for f in (fit1, fit2)]
    return {
        "seconds": seconds, "fits": (fit1, fit2), "errors": errors, "frames": frames, "truth": truth, "base": base,
        "mask": mask, "keypoints": keypoints, "pairs": pairs, "uvs": uvs, "refined": refined,
        "matches": sum(len(a) for a, _ in uvs),
    }


def compare_stabilization(stab, device) -> str:
    """Phase 12: each stabilization module on ``device`` against the CPU on
    the same inputs, at small size. Raises on a disagreement; returns the
    line to print."""
    import torch

    from glimpse_tpu_torch.ops import features, matching, projection, refine

    devices = {"card": device, "cpu": torch.device("cpu")}
    report = []
    # Inverse projection of a distorted camera (k and p nonzero), each
    # solver, the intrinsics as tensors so no solver is skipped.
    rng = np.random.default_rng(5)
    vector = stab["base"].copy()
    vector[12:18] = (-0.08, 0.02, -0.01, 0.01, 0.005, -0.002)
    vector[18:20] = (4e-4, -3e-4)
    uv = np.column_stack([rng.uniform(0, STAB_IMG, 4000), rng.uniform(0, STAB_IMG, 4000)]).astype(np.float32)
    worst = 0.0
    for method in ("k1", "oulu", "regulafalsi"):
        out = {}
        for name, d in devices.items():
            v = torch.from_numpy(vector.astype(np.float32)).to(d)
            u = torch.from_numpy(uv).to(d)
            xy = projection.image_to_camera(u, v[6:8], v[8:10], v[10:12], v[12:18], v[18:20], method=method)
            out[name] = torch.cat([xy, projection.unproject(v, u, method=method)], dim=-1).cpu().numpy()
        worst = max(worst, float(np.abs(out["card"] - out["cpu"]).max()))
    if worst > 1e-5:
        raise AssertionError(f"inverse projection on the card and the CPU differ by {worst}")
    report.append(f"inverse projection (k1, oulu, regulafalsi) max |diff| {worst:.3g} (limit 1e-5)")

    # Matching: the first frames' descriptors at offsets 1 and 8.
    descs = [k[1] for k in stab["keypoints"][:10]]
    pairs = np.array([(0, 1), (1, 2), (0, 8), (2, 9)])
    runs = {name: matching.DescriptorMatcher(device=d).match_pairs(descs, pairs, max_ratio=0.75) for name, d in devices.items()}
    ratio_excess = 0.0
    for (i, j), (gi, gr), (ci, cr) in zip(pairs, runs["card"], runs["cpu"]):
        if not np.array_equal(gi, ci):
            raise AssertionError("matching on the card and the CPU picks other neighbours")
        ratio_excess = max(ratio_excess, float((np.abs(gr - cr) - ratio_tolerance(descs[i], descs[j], ci)).max(initial=0.0)))
    if ratio_excess > 0.0:
        raise AssertionError(f"match ratios on the card and the CPU differ by {ratio_excess} beyond their bound")
    report.append(f"matching: {sum(len(i) for i, _ in runs['cpu'])} matches, indices identical, ratios within"
                  " 1e-5 plus the float32 rounding bound of a^2 + b^2 - 2ab")

    # Features: four frames cut to 256x256, 512 keypoints each.
    crops = [f[128:384, 128:384] for f in stab["frames"][:4]]
    kps = {name: features.detect_and_describe(crops, nfeatures=512, batch=4, device=d) for name, d in devices.items()}
    found = total = 0
    desc_diff = 0.0
    for (gp, gd), (cp, cd) in zip(kps["card"], kps["cpu"]):
        dist = np.linalg.norm(cp[:, None, :] - gp[None, :, :], axis=-1)
        nearest = dist.argmin(axis=1)
        close = dist[np.arange(len(cp)), nearest] < 1e-2
        found += int(close.sum())
        total += len(cp)
        desc_diff = max(desc_diff, float(np.abs(cd[close] - gd[nearest[close]]).max(initial=0.0)))
    if found < 0.98 * total or desc_diff > 1e-3:
        raise AssertionError(f"features: {found} of {total} keypoints within 1e-2 px, descriptors {desc_diff}")
    report.append(f"features: {found} of {total} keypoints within 1e-2 px, descriptors {desc_diff:.3g} (limit 1e-3)")

    # Refinement: phase 11's first 8 pairs.
    k = slice(0, 8)
    pairs8 = [tuple(p) for p in stab["pairs"][k]]
    refined = {
        name: refine.MatchRefiner(device=d).refine_pairs(pairs8, stab["uvs"][k], lambda i: stab["frames"][i].astype(np.float32))
        for name, d in devices.items()
    }
    refine_diff = max(float(np.abs(g[1] - c[1]).max(initial=0.0)) for g, c in zip(refined["card"], refined["cpu"]))
    if refine_diff > 1e-3:
        raise AssertionError(f"refinement on the card and the CPU differs by {refine_diff} px")
    report.append(f"refine: {sum(len(a) for a, _ in stab['uvs'][k])} matches, max |diff| {refine_diff:.3g} px (limit 1e-3)")

    # The fit on the first 24 frames' matches.
    n = 24
    keep = stab["pairs"][:, 1] < n
    pairs_n = stab["pairs"][keep]
    uvs_n = [uv for uv, ok in zip(stab["uvs"], keep) if ok]
    fits = {name: observer_fit(observer_matches(uvs_n, pairs_n, stab["base"], n, d), n, d).x.reshape(-1, 3)
            for name, d in devices.items()}
    fit_diff = float(np.abs(fits["card"] - fits["cpu"]).max())
    if fit_diff > 2e-3:
        raise AssertionError(f"the fit on the card and the CPU differs by {fit_diff} deg")
    report.append(f"fit ({n} frames): max |diff| {fit_diff:.3g} deg (limit 2e-3)")
    return "; ".join(report)


TERRAIN_CELLS, TERRAIN_CELL = 2048, 10.0


def terrain_dem(seed: int = 0):
    """Phase 13's DEM as a ``Raster``: Gaussian-filtered relief with a
    standard deviation of 150 m on 2,048 x 2,048 cells of 10 m, a block of
    NaN cells, and a station 2 m above the highest cell of its south-west
    part. Returns (raster, origin (x, y, z))."""
    import scipy.ndimage

    from glimpse_tpu_torch import Raster

    n, d = TERRAIN_CELLS, TERRAIN_CELL
    z = scipy.ndimage.gaussian_filter(np.random.default_rng(seed).normal(size=(n, n)), 40.0)
    z *= 150.0 / z.std()
    z[n * 300 // 2048 : n * 360 // 2048, n * 1500 // 2048 : n * 1600 // 2048] = np.nan
    dem = Raster(z, x=(0.0, n * d), y=(n * d, 0.0))
    r0, c0 = n * 1400 // 2048, n * 150 // 2048
    window = z[r0 : r0 + n * 500 // 2048, c0 : c0 + n * 500 // 2048]
    row, col = np.unravel_index(np.argmax(window), window.shape)
    row, col = row + r0, col + c0
    return dem, (float(dem.x[col]), float(dem.y[row]), float(z[row, col]) + 2.0)


def boundary_share(differ: np.ndarray, mask: np.ndarray) -> float:
    """Share of the cells in ``differ`` that have a neighbour (8-connected)
    of the other class in ``mask``."""
    import scipy.ndimage

    if not differ.any():
        return 1.0
    on_boundary = scipy.ndimage.maximum_filter(mask, 3) != scipy.ndimage.minimum_filter(mask, 3)
    return float(on_boundary[differ].mean())


def terrain_on_the_card(cuda) -> str:
    """Phase 13; raises on a disagreement and returns the line to print."""
    import torch

    from glimpse_tpu_torch.ops import terrain

    dem, origin = terrain_dem()
    cpu = torch.device("cpu")

    def wall(fn):
        start = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - start

    dem.viewshed(origin, correction=True)  # warm-up: allocator, first launches
    torch.cuda.reset_peak_memory_stats()
    on_card, card_s = wall(lambda: dem.viewshed(origin, correction=True))
    peak = torch.cuda.max_memory_allocated()
    on_cpu, cpu_s = wall(lambda: dem.viewshed(origin, correction=True, device=cpu))
    rowcol = dem.xy_to_rowcol(np.atleast_2d(origin[:2]))[0]
    args = ((float(rowcol[0]), float(rowcol[1])), origin[2], TERRAIN_CELL)
    z_card = torch.from_numpy(dem.array).to(cuda, torch.float32)
    device_ms = _cuda_ms(lambda: terrain.viewshed(z_card, *args, correction=(6.3781e6, 0.13), device=cuda), reps=3)
    differ = on_card != on_cpu
    share, grazing = float(differ.mean()), boundary_share(differ, on_cpu)
    # With under 50 differing cells the boundary share is too coarse to hold.
    if share > 0.005 or (grazing < 0.8 and differ.sum() >= 50) or on_card[np.isnan(dem.array)].any():
        raise AssertionError(
            f"viewshed on the card and the CPU: {share:.6f} of cells differ (limit 0.005),"
            f" {grazing:.3f} of them on a boundary (at least 0.8)"
        )
    # A 256 x 256 crop around the station against the ring sweep.
    r0 = int(np.clip(round(rowcol[0]) - 128, 0, TERRAIN_CELLS - 256))
    c0 = int(np.clip(round(rowcol[1]) - 128, 0, TERRAIN_CELLS - 256))
    crop = dem[r0 : r0 + 256, c0 : c0 + 256]
    polar = crop.viewshed(origin, correction=True, oversample=4.0)
    rings, rings_s = wall(lambda: crop.viewshed(origin, correction=True, method="rings"))
    agree = float((polar == rings).mean())
    if agree < 0.98:
        raise AssertionError(f"polar viewshed agrees with the ring sweep on {agree:.4f} of the crop (at least 0.98)")
    # The horizon, through the raster and through the op.
    dem.horizon(origin, range(360), correction=True)  # warm-up
    segments, horizon_s = wall(lambda: dem.horizon(origin, range(360), correction=True))
    cpu_segments = dem.horizon(origin, range(360), correction=True, device=cpu)
    thetas = np.deg2rad(np.arange(360.0))
    both = {
        name: [t.cpu().numpy() for t in terrain.horizon_angles(
            dem.array, *args, thetas, correction=(6.3781e6, 0.13), device=d)]
        for name, d in (("card", cuda), ("cpu", cpu))
    }
    angle_diff = float(np.abs(both["card"][0] - both["cpu"][0]).max())
    same_valid = int((both["card"][3] == both["cpu"][3]).sum())
    same_radius = int((both["card"][1] == both["cpu"][1]).sum())
    # Float32 resolves a polar position near index 2,000 to 1.2e-4 cell,
    # millimetres of elevation on a steep slope, over a first sample 5 m away.
    if angle_diff > 1e-3 or same_valid < 357:
        raise AssertionError(f"horizon on the card and the CPU: angles differ by {angle_diff}, {same_valid} of 360 flags equal")
    n_radii = int(np.ceil(terrain._max_radius(dem.array.shape, args[0]) * 2.0))
    return (
        f"DEM {TERRAIN_CELLS}x{TERRAIN_CELLS} cells of {TERRAIN_CELL:g} m, relief {np.nanmin(dem.array):.0f} to"
        f" {np.nanmax(dem.array):.0f} m, {int(np.isnan(dem.array).sum())} NaN cells, station at cell"
        f" ({rowcol[0]:.1f}, {rowcol[1]:.1f}), polar grid {terrain.MAX_HEADINGS} x {n_radii};"
        f" Raster.viewshed(correction=True) card float32 {card_s * 1e3:.1f} ms with both copies"
        f" ({device_ms:.1f} ms on the device, CUDA events, peak {peak / 2**30:.2f} GiB),"
        f" CPU float64 {cpu_s * 1e3:.0f} ms; visible share {on_card.mean():.4f} (CPU {on_cpu.mean():.4f});"
        f" {int(differ.sum())} cells differ ({share:.2e}, limit 5e-3), {grazing:.3f} of them on a boundary"
        f" (at least 0.8); 256x256 crop, oversample 4, against viewshed_rings ({rings_s * 1e3:.0f} ms on the host):"
        f" {agree:.4f} agree (at least 0.98); Raster.horizon 360 headings card {horizon_s * 1e3:.1f} ms,"
        f" {len(segments)} segments (CPU {len(cpu_segments)}), angles max |diff| {angle_diff:.3g} rad (limit 1e-3),"
        f" {same_valid} of 360 validity flags and {same_radius} of 360 radii equal"
    )


OBLIQUE_VELOCITY = (1.2, 0.8)  # world units a frame in x, y
OBLIQUE_IMG = 512


# Phase 26's ridge: a crest at y = 200 m, 40 m high with a Gaussian profile
# of 4 m across, flat-topped from x = 150 to 230 m and falling off over 5 m at
# its ends. From phase 14's station, 350 m south and 260 m up, it hides the
# terrain behind it for some 60 m.
RIDGE = dict(x=(150.0, 230.0), y=200.0, height=40.0, width=4.0, taper=5.0)


def ridge_heights(x, y, ridge: dict) -> np.ndarray:
    """The ridge's height above the DEM at world points (x, y)."""
    x0, x1 = ridge["x"]
    outside = np.maximum(np.maximum(x0 - x, x - x1), 0.0)
    return (ridge["height"] * np.exp(-0.5 * ((y - ridge["y"]) / ridge["width"]) ** 2)
            * np.exp(-0.5 * (outside / ridge["taper"]) ** 2))


def oblique_scene(n_frames: int, cuda, seed: int = 7, ridge=None):
    """examples/oblique_3d_tracking.py's scene at 512 x 512: a gently
    undulating DEM of 640 x 640 cells of 1.25 m with a sharp texture that
    moves ``OBLIQUE_VELOCITY`` a frame, seen from (200, -150, 260) pitched 35
    deg down with f = 512. Frames are rendered by ``render.project_dem`` and
    their holes (sky, streaks) filled from the nearest rendered pixel, as
    the example does. With a ``ridge`` (:data:`RIDGE`) added to the DEM, the
    viewshed is computed first and only its visible cells are rendered, so
    the ridge occludes what it hides. Returns a dict: dem, cam, observer
    (``Image`` objects with ``array`` set), viewshed (a ``Raster``, computed
    on ``cuda``), its visible share, and the seconds spent rendering and in
    the viewshed."""
    import datetime

    import scipy.ndimage

    from glimpse_tpu_torch import Camera, Image, Raster, render
    from glimpse_tpu_torch.track import Observer

    rng = np.random.default_rng(seed)
    cells = 640
    z = scipy.ndimage.gaussian_filter(rng.normal(size=(cells, cells)), 24.0) * 120
    if ridge is not None:
        centres = -200 + 1.25 * (np.arange(cells) + 0.5)
        z = z + ridge_heights(centres[None, :], centres[::-1, None], ridge)
    dem = Raster(z, x=(-200, 600), y=(600, -200))
    texture = scipy.ndimage.gaussian_filter(rng.normal(size=(cells, cells)), 0.8) * 100
    cam_args = dict(imgsz=(OBLIQUE_IMG, OBLIQUE_IMG), f=512, xyz=(200, -150, 260), viewdir=(0, -35, 0))
    t0, day = datetime.datetime(2020, 1, 1), datetime.timedelta(days=1)

    def viewshed():
        start = time.perf_counter()
        visible = dem.viewshed(cam_args["xyz"], device=cuda)
        return visible, time.perf_counter() - start

    if ridge is not None:
        visible, viewshed_s = viewshed()
    start = time.perf_counter()
    images = []
    for i in range(n_frames):
        shifted = scipy.ndimage.shift(
            texture, (OBLIQUE_VELOCITY[1] * i / dem.d[1], OBLIQUE_VELOCITY[0] * i / dem.d[0]), order=1, mode="nearest")
        mask = None if ridge is None else visible & ~np.isnan(dem.array)
        img = render.project_dem(Camera(**cam_args), dem, values=shifted[..., None], mask=mask, scale_limits=(1, 8),
                                 parallel=4)[..., 0]
        idx = scipy.ndimage.distance_transform_edt(np.isnan(img), return_distances=False, return_indices=True)
        image = Image(f"frame{i}.jpg", cam=Camera(**cam_args), datetime=t0 + i * day)
        image.array = img[tuple(idx)].astype(np.float32)
        images.append(image)
    render_s = time.perf_counter() - start
    if ridge is None:
        visible, viewshed_s = viewshed()
    return {
        "dem": dem, "cam": images[0].cam, "observer": Observer(images, sigma=0.2), "day": day,
        "viewshed": Raster(visible.astype(np.float32), x=dem.xlim, y=dem.ylim), "visible": float(visible.mean()),
        "render_s": render_s, "viewshed_s": viewshed_s,
    }


def oblique_points(scene, n: int, seed: int = 8) -> np.ndarray:
    """``n`` points on the DEM inside the frame whose surroundings (20 m) are
    visible, so that no particle of a point that tracks starts or drifts onto
    a hidden cell."""
    import scipy.ndimage

    from glimpse_tpu_torch import Raster

    dem, viewshed = scene["dem"], scene["viewshed"]
    margin = int(np.ceil(20.0 / abs(dem.d[0])))
    safe = Raster(
        scipy.ndimage.binary_erosion(viewshed.array > 0, iterations=margin).astype(np.float32),
        x=viewshed.xlim, y=viewshed.ylim,
    )
    xy = np.random.default_rng(seed).uniform([120, 150], [280, 280], size=(2 * n, 2))
    xy = xy[safe.sample(xy, order=0) > 0]
    if len(xy) < n:
        raise AssertionError(f"only {len(xy)} of the {n} points asked for start on visible terrain")
    return xy[:n]


def nearest_cells(raster, xy):
    """The (rows, cols) of the cells of a ``Raster`` under world points (...,
    2), by the tracker's nearest-cell rule (floor of the offset over the
    cell size, clamped to the edge)."""
    H, W = raster.array.shape
    cols = np.clip(np.floor((xy[..., 0] - raster.xlim[0]) / raster.d[0]).astype(int), 0, W - 1)
    rows = np.clip(np.floor((xy[..., 1] - raster.ylim[0]) / raster.d[1]).astype(int), 0, H - 1)
    return rows, cols


def hidden_at(viewshed, xy) -> np.ndarray:
    """Whether world points (..., 2) lie on a hidden cell of the viewshed
    ``Raster``."""
    return viewshed.array[nearest_cells(viewshed, xy)] <= 0


def occlusion_points(scene, n: int, n_frames: int, ridge: dict, seed: int = 26):
    """Phase 26's points, stratified by their true paths (``OBLIQUE_VELOCITY``
    a frame over ``n_frames``) against the viewshed, from candidates drawn
    uniformly over phase 14's tracked area (x 120-280, y 150-280) that start
    on visible terrain at least 5 m from any hidden cell and whose path stays
    off the ridge (under 0.5 m of it, so no point climbs its 40 m wall,
    where the texture stretches out of recognition): a fifth whose path
    enters hidden cells, three fifths whose path keeps 20 m from every hidden
    cell, and a fifth of neither. Distances are between cell centres, less
    a cell's diagonal. Returns (points (n, 2) shuffled, true positions (n,
    n_frames, 2), the category of each point: "enters", "kept", "near")."""
    import scipy.ndimage

    viewshed = scene["viewshed"]
    hidden = viewshed.array <= 0
    cell = abs(viewshed.d[0])
    slack = cell * np.sqrt(2.0)
    distance = scipy.ndimage.distance_transform_edt(~hidden) * cell

    def clearance(xy):
        return distance[nearest_cells(viewshed, xy)] - slack

    rng = np.random.default_rng(seed)
    candidates = rng.uniform([120, 150], [280, 280], size=(40 * n, 2))
    candidates = candidates[clearance(candidates) >= 5.0]
    paths = candidates[:, None] + np.arange(n_frames)[None, :, None] * np.asarray(OBLIQUE_VELOCITY)
    flat = ridge_heights(paths[..., 0], paths[..., 1], ridge).max(axis=1) < 0.5
    candidates, paths = candidates[flat], paths[flat]
    enters = hidden_at(viewshed, paths).any(axis=1)
    kept = clearance(paths).min(axis=1) >= 20.0
    quotas = {"enters": (enters, n // 5), "kept": (kept, 3 * n // 5), "near": (~enters & ~kept, n - n // 5 - 3 * n // 5)}
    picked, labels = [], []
    for label, (where, count) in quotas.items():
        index = np.flatnonzero(where)
        if len(index) < count:
            raise AssertionError(f"phase 26: {len(index)} candidate points of kind {label!r}, {count} wanted")
        picked.append(index[:count])
        labels += [label] * count
    order = rng.permutation(n)
    chosen = np.concatenate(picked)[order]
    return candidates[chosen], paths[chosen], np.asarray(labels)[order]


def oblique_tracker(scene, points_xy, n_particles: int, device):
    """The object path: host ``CartesianMotion`` models stacked by
    ``from_motions``, the tracker from the observer, the viewshed a host
    raster."""
    from glimpse_tpu_torch.track import CartesianMotion, batch

    motions = [
        CartesianMotion(
            xy=xy, time_unit=scene["day"], dem=scene["dem"], dem_sigma=0.5, n=n_particles, xy_sigma=(1.0, 1.0),
            vxyz_sigma=(1.5, 1.5, 0.05), axyz_sigma=(0.1, 0.1, 0.01),
        )
        for xy in points_xy
    ]
    motion = batch.BatchMotion.from_motions(motions, device=device)
    config = batch.BatchConfig(n_particles=n_particles, search_size=(41, 41))
    return batch.BatchTracker.from_observers(
        [scene["observer"]], motion, config, device=device, viewshed=scene["viewshed"])


def stacked(outputs) -> dict:
    """``track_stream``'s per-step outputs as time-major tensors."""
    import torch

    return {k: torch.stack([o[k] for o in outputs]) for k in outputs[0]}


def stacked_chunks(outputs) -> dict:
    """``track_stream(chunk > 1)``'s entries as time-major tensors."""
    import torch

    return {k: torch.cat([o[k] for o in outputs]) for k in outputs[0]}


def profile_step(tracker, state, frame) -> str:
    """One tracker step under ``torch.profiler``: the synchronised window's
    milliseconds, the device's busy milliseconds (kernel times summed), the
    idle share and the number of kernel launches; "not measured" where the
    profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    dt = torch.tensor(1.0, device=tracker.device)
    for _ in range(2):
        tracker.step(state, frame, dt)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        tracker.step(state, frame, dt)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - start) * 1e3
    rows = prof.key_averages()

    def device_us(row):
        return getattr(row, "self_device_time_total", None) or getattr(row, "self_cuda_time_total", 0)

    kernels = [r for r in rows if device_us(r) > 0 and r.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(device_us(r) for r in kernels) / 1e3
    if busy_ms <= 0:
        return f"profile: {window_ms:.3f} ms under the profiler, device time not measured"
    # Device time by the operator that launched it, where the profiler
    # attributes it; else by kernel name.
    ops = [r for r in rows if device_us(r) > 0 and r.device_type == torch.autograd.DeviceType.CPU]
    top = sorted(ops or kernels, key=device_us, reverse=True)[:5]
    return (
        f"profile of one step: {window_ms:.3f} ms under the profiler, device busy {busy_ms:.3f} ms, idle share"
        f" {max(0.0, 1 - busy_ms / window_ms):.3f}, {sum(r.count for r in kernels)} kernel launches; most device time: "
        + ", ".join(f"{r.key[:40]} {device_us(r) / 1e3:.2f} ms" for r in top)
    )


def lockstep_from_shared_state(card, cpu, images, noise, n_steps: int, valid_log=None):
    """Each of ``n_steps`` steps on both trackers from the CPU's state moved
    to the card, with the same injected draws; returns (largest |diff| of
    the outputs "mean" and "sigma", number of validity flags that differ).
    A list ``valid_log`` receives the CPU's validity flags (N,) of each step."""
    import torch

    cuda = card.device
    state = cpu.initialize(torch.Generator().manual_seed(0), torch.from_numpy(images[0]), noise=noise["init"])
    carried, flags = 0.0, 0
    for i in range(n_steps):
        step_noise = {"a": noise["a"][i], "resample_u": noise["resample_u"][i]}
        on_card = dataclasses.replace(
            state, generator=torch.Generator(device=cuda),
            **{k: getattr(state, k).to(cuda) for k in ("particles", "weights", "templates", "template_table", "template_duv", "valid")},
        )
        _, card_out = card.step(on_card, torch.from_numpy(images[i + 1]).to(cuda), torch.tensor(1.0, device=cuda), noise=step_noise)
        state, cpu_out = cpu.step(state, torch.from_numpy(images[i + 1]), torch.tensor(1.0), noise=step_noise)
        carried = max(carried, *(float((card_out[k].cpu() - cpu_out[k]).abs().max()) for k in ("mean", "sigma")))
        flags += int((card_out["valid"].cpu() != cpu_out["valid"]).sum())
        if valid_log is not None:
            valid_log.append(cpu_out["valid"])
    return carried, flags


def objects_to_tracks(cuda, card: str, n14: int = 10240, p14: int = 2048, t14: int = 10):
    """Phase 14 at ``n14`` points x ``p14`` particles x ``t14`` frames;
    raises on a failed check and returns (the line to print, each kernel's
    launches on this path, the scene, the points)."""
    import torch

    from glimpse_tpu_torch.track import Tracks, feeder
    from glimpse_tpu_torch.track import batch as batch_module

    scene = oblique_scene(t14, cuda)
    points14 = oblique_points(scene, n14)
    start = time.perf_counter()
    oblique = oblique_tracker(scene, points14, p14, cuda)
    build_s = time.perf_counter() - start
    images14 = scene["observer"].images
    datetimes14 = list(scene["observer"].datetimes)
    start = time.perf_counter()
    n_fed = sum(1 for _ in feeder.FrameFeeder([images14]))
    feeder_s = time.perf_counter() - start
    dts14 = np.ones(t14 - 1, np.float32)

    def stream14(images, seed):
        generator = torch.Generator(device=cuda).manual_seed(seed)
        start = time.perf_counter()
        _, outputs = feeder.stream_track(oblique, generator, [images], dts14)
        torch.cuda.synchronize()
        return stacked(outputs), time.perf_counter() - start

    stream14(images14, 0)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    runs14, seconds14, velocities14 = [], {}, {}
    for label, images, times in (("forward", images14, datetimes14), ("backward", images14[::-1], datetimes14[::-1])):
        out14, seconds14[label] = stream14(images, 11)
        tracks = batch_module.to_tracks(times, scene["day"], out14)
        if label == "backward":
            tracks.reverse()  # forward temporal order for the fusion; the sign of v stays
        sign, at = (1, -1) if label == "forward" else (-1, 0)
        velocities14[label] = np.median(sign * tracks.vxyz[:, at, 0:2], axis=0)
        failed = [n for n, e in enumerate(tracks.errors) if e is not None]
        if failed:
            raise AssertionError(f"{len(failed)} points of the {label} run left the visible terrain: {failed[:10]}")
        if np.abs(velocities14[label] - OBLIQUE_VELOCITY).max() > 0.3:
            raise AssertionError(f"{label} median velocity {velocities14[label]} is not within 0.3 of {OBLIQUE_VELOCITY}")
        runs14.append(tracks)
    launches14 = launch_counts()
    # Per run: the templates once and the search tiles every step; one
    # resample, one spline read, one front end and one DEM prior a step.
    if launches14 != {"median_highpass": 2 * t14, "systematic_resample": 2 * (t14 - 1),
                      "bspline_sample": 2 * (t14 - 1), "project_extract": 2 * (t14 - 1),
                      "dem_prior": 2 * (t14 - 1)}:
        raise AssertionError(f"the kernels did not carry the object path: launches {launches14}")
    peak14 = torch.cuda.max_memory_allocated()
    fused = Tracks.from_multiple(runs14, ignore_nan=True)
    if fused.means.shape != (n14, t14, 6) or not np.isfinite(fused.means).all():
        raise AssertionError(f"fused tracks: shape {fused.means.shape}, finite {np.isfinite(fused.means).all()}")
    final_xy = fused.xyz[:, -1, 0:2]
    error14 = float(np.nanmedian(np.abs(final_xy - (points14 + np.multiply(OBLIQUE_VELOCITY, t14 - 1)))))
    z_error14 = float(np.nanmedian(np.abs(fused.xyz[:, -1, 2] - scene["dem"].sample(final_xy, bounds_error=False))))
    if error14 > 0.5 or z_error14 > 0.5:
        raise AssertionError(f"fused median final position error {error14} m, median |z - DEM| {z_error14} m (limits 0.5)")
    state14 = oblique.initialize(
        torch.Generator(device=cuda).manual_seed(0), torch.from_numpy(feeder.load_frame(images14[0])[None]).to(cuda))
    profile14 = profile_step(oblique, state14, torch.from_numpy(feeder.load_frame(images14[1])[None]).to(cuda))
    line = (
        f"phase 14 objects in, Tracks out on {card}: {n14}x{p14}, 1 observer of {n_fed} frames of"
        f" {OBLIQUE_IMG}x{OBLIQUE_IMG}, search 41x41, viewshed on ({scene['visible']:.4f} visible,"
        f" {scene['viewshed_s']:.3f} s on the card); render {scene['render_s']:.2f} s (host, project_dem),"
        f" from_motions and from_observers {build_s:.2f} s, feeder {feeder_s:.3f} s for {n_fed} frames;"
        + "".join(
            f" {label} {n14 * (t14 - 1) / seconds14[label]:.1f} point-steps/s ({seconds14[label]:.3f} s),"
            f" median velocity ({v[0]:.3f}, {v[1]:.3f});" for label, v in velocities14.items()
        )
        + f" truth {OBLIQUE_VELOCITY}, limit 0.3; fused median final position error {error14:.4f} m (limit 0.5),"
        f" median |z - DEM| {z_error14:.4f} m (prior 0.5), errors none; launches {launches14};"
        f" peak {peak14 / 2**30:.2f} GiB; {profile14}"
    )
    return line, launches14, scene, points14


def occluding_viewshed(devices, card: str, n26: int = 10240, p26: int = 2048, t26: int = 20, n_check: int = 256):
    """Phase 26: phase 14's object path over a DEM with :data:`RIDGE`, whose
    viewshed hides part of the tracked area, at ``n26`` points x ``p26``
    particles x ``t26`` frames: host objects, ``from_motions``,
    ``from_observers(viewshed=)``, ``feeder.stream_track`` and ``to_tracks``.
    Raises unless every point whose true position lies on a hidden cell at a
    step is lost by that step, every point whose path keeps 20 m from hidden
    cells is kept and their median velocity is within 0.3 of the truth, each
    lost point's means and sigmas are NaN from its failing step on (finite
    before) with ``Tracks.errors`` set, the kernels launched once a step plus
    the templates (high-pass) and once a step (resample, spline read), and, for up to
    ``n_check`` of the lost points, the card follows the CPU at every step
    from the CPU's state within 1e-3 with equal validity flags and loses at
    least one of them. Returns (the line to print, each kernel's launches)."""
    import torch

    from glimpse_tpu_torch.track import batch as batch_module
    from glimpse_tpu_torch.track import feeder

    cuda = devices["card"]
    scene = oblique_scene(t26, cuda, ridge=RIDGE)
    points, paths, labels = occlusion_points(scene, n26, t26, RIDGE)
    tracker = oblique_tracker(scene, points, p26, cuda)
    images = scene["observer"].images
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    _, outputs = feeder.stream_track(tracker, torch.Generator(device=cuda).manual_seed(26), [images],
                                     np.ones(t26 - 1, np.float32))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated()
    launches = launch_counts()
    if launches != {"median_highpass": t26, "systematic_resample": t26 - 1, "bspline_sample": t26 - 1,
                    "project_extract": t26 - 1, "dem_prior": t26 - 1}:
        raise AssertionError(f"phase 26: the kernels did not carry the run: launches {launches}")
    out = stacked(outputs)
    valid = out["valid"].cpu().numpy() > 0  # (t26 - 1, n26): step t at row t - 1
    hidden = hidden_at(scene["viewshed"], paths[:, 1:]).T  # the truth at steps 1..t26 - 1
    missed = hidden & valid
    if missed.any():
        steps, which = np.nonzero(missed)
        raise AssertionError(f"phase 26: {len(set(which))} points on hidden cells still valid, e.g. point {which[0]}"
                             f" ({labels[which[0]]}) at step {steps[0] + 1}")
    kept = labels == "kept"
    if not valid[:, kept].all():
        raise AssertionError(f"phase 26: {int((~valid[:, kept]).any(axis=0).sum())} points 20 m from hidden cells lost")
    tracks = batch_module.to_tracks(list(scene["observer"].datetimes), scene["day"], out)
    lost = ~valid[-1]
    failed = np.array([e is not None for e in tracks.errors])
    if not np.array_equal(failed, lost):
        raise AssertionError(f"phase 26: Tracks.errors on {int(failed.sum())} points, {int(lost.sum())} lost")
    for n in np.flatnonzero(lost):
        t_fail = int(np.argmin(valid[:, n])) + 1  # the first failing step, as a column of Tracks
        for name, value in (("means", tracks.means), ("sigmas", tracks.sigmas)):
            if not (np.isnan(value[n, t_fail:]).all() and np.isfinite(value[n, 1:t_fail]).all()):
                raise AssertionError(f"phase 26: point {n}'s {name} are not NaN from its failing step {t_fail} on")
    velocity = np.median(tracks.vxyz[kept, -1, 0:2], axis=0)
    if np.abs(velocity - OBLIQUE_VELOCITY).max() > 0.3:
        raise AssertionError(f"phase 26: median velocity of the kept points {velocity}, truth {OBLIQUE_VELOCITY}")
    # The card against the CPU on lost points, whose clouds met the shadow's edge.
    check = np.flatnonzero(lost)[:n_check]
    if len(check) < n_check:
        raise AssertionError(f"phase 26: {len(check)} points lost, {n_check} wanted for the card against the CPU")
    draws = np.random.default_rng(27)
    n, p = len(check), p26
    noise = {
        "init": {"xy": draws.normal(size=(n, p, 2)).astype(np.float32), "z": draws.normal(size=(n, p)).astype(np.float32),
                 "v": draws.normal(size=(n, p, 3)).astype(np.float32)},
        "a": draws.normal(size=(t26 - 1, n, p, 3)).astype(np.float32),
        "resample_u": draws.random((t26 - 1, n)).astype(np.float32),
    }
    pair = {k: oblique_tracker(scene, points[check], p, d) for k, d in devices.items()}
    frames = np.stack([f for f in feeder.FrameFeeder([images])])
    cpu_valid = []
    start = time.perf_counter()
    carried, flags = lockstep_from_shared_state(pair["card"], pair["cpu"], frames, noise, t26 - 1, valid_log=cpu_valid)
    lockstep_s = time.perf_counter() - start
    lost_cpu = int((cpu_valid[-1] == 0).sum())
    if carried > 1e-3 or flags or lost_cpu < 1:
        raise AssertionError(f"phase 26 card against CPU: max |diff| {carried} (limit 1e-3), {flags} validity flags"
                             f" differ, {lost_cpu} of {n} points lost on the CPU")
    shares = (~valid).mean(axis=1)
    entering = labels == "enters"
    return (
        f"phase 26 an occluding viewshed on {card}: {n26}x{p26}x{t26} frames of {OBLIQUE_IMG}x{OBLIQUE_IMG}, a ridge"
        f" {RIDGE['height']:.0f} m high at y {RIDGE['y']:.0f}, x {RIDGE['x'][0]:.0f}-{RIDGE['x'][1]:.0f}; DEM"
        f" {scene['visible']:.4f} visible, Raster.viewshed {scene['viewshed_s']:.3f} s on the card, render"
        f" {scene['render_s']:.2f} s; points {int(entering.sum())} whose truth enters hidden cells,"
        f" {int(kept.sum())} keeping 20 m away, {int((labels == 'near').sum())} near; share lost by step: "
        + " ".join(f"{x:.4f}" for x in shares)
        + f"; {int(lost.sum())} lost ({int(lost[entering].sum())} of those entering, {int(lost[labels == 'near'].sum())}"
        f" near, 0 kept), every point on a hidden cell lost by then, means and sigmas NaN from each failing step;"
        f" kept points' median velocity ({velocity[0]:.3f}, {velocity[1]:.3f}), truth {OBLIQUE_VELOCITY}, limit 0.3;"
        f" {n26 * (t26 - 1) / seconds:.1f} point-steps/s ({seconds:.3f} s), peak {peak / 2**30:.2f} GiB; launches"
        f" {launches}; card against CPU on {n} lost points x {p} particles, each step from the CPU's state: max |diff|"
        f" {carried:.3g} (limit 1e-3), validity flags equal, {lost_cpu} lost on the CPU, {lockstep_s:.1f} s"
    ), launches


def object_path_lockstep(scene, points_xy, devices) -> str:
    """Phase 15; ``devices`` maps "card" and "cpu" to their devices. Raises
    on a disagreement and returns the line to print."""
    from glimpse_tpu_torch.track import feeder

    images14, points14 = scene["observer"].images, points_xy
    n15, p15, t15 = 16, 256, 6
    draws15 = np.random.default_rng(15)
    noise15 = {
        "init": {
            "xy": draws15.normal(size=(n15, p15, 2)).astype(np.float32),
            "z": draws15.normal(size=(n15, p15)).astype(np.float32),
            "v": draws15.normal(size=(n15, p15, 3)).astype(np.float32),
        },
        "a": draws15.normal(size=(t15 - 1, n15, p15, 3)).astype(np.float32),
        "resample_u": draws15.random((t15 - 1, n15)).astype(np.float32),
    }
    small15 = {k: oblique_tracker(scene, points14[:n15], p15, d) for k, d in devices.items()}
    frames15 = np.stack([f for f in feeder.FrameFeeder([images14[:t15]])])
    carried15, flags15 = lockstep_from_shared_state(small15["card"], small15["cpu"], frames15, noise15, t15 - 1)
    if carried15 > 1e-3 or flags15:
        raise AssertionError(f"the object path on the card and the CPU parts: {carried15} (limit 1e-3), {flags15} validity flags differ")
    return (
        f"phase 15 lockstep {n15}x{p15}x{t15 - 1}, trackers built from objects on each device, viewshed and DEM"
        f" prior on: each step from a shared state max |diff| {carried15:.3g} (limit 1e-3), validity flags equal"
    )


# ---- Calibration problems (benchmarks/ba_autodiff.py's, on either package) ---- #


def ba_points_problem(Camera, optimize, n_cams=4, n_points=2000, seed=0, **model_args):
    """Cameras sharing f and k1 over common world points, view directions
    per camera. Returns (model, the true parameter vector)."""
    rng = np.random.default_rng(seed)
    xyz = np.column_stack(
        [rng.uniform(-400, 400, n_points), rng.uniform(600, 1200, n_points), rng.uniform(-200, 200, n_points)]
    )
    true_viewdirs = rng.uniform(-6, 6, size=(n_cams, 3))
    true_f, true_k1 = 3000.0, -0.12
    cams_true = [Camera(imgsz=(4288, 2848), f=true_f, viewdir=v, k=(true_k1,)) for v in true_viewdirs]
    uvs = [c.xyz_to_uv(xyz) for c in cams_true]
    cams = [
        Camera(imgsz=(4288, 2848), f=true_f * 0.97, viewdir=v + rng.uniform(-0.5, 0.5, 3), k=(true_k1 * 0.5,))
        for v in true_viewdirs
    ]
    controls = []
    for i in range(n_cams):
        keep = np.isfinite(uvs[i]).all(axis=1) & cams_true[i].inframe(uvs[i])
        controls.append(optimize.Points(cam=cams[i], uv=uvs[i][keep], xyz=xyz[keep]))
    model = optimize.Cameras(
        cams=cams, controls=controls, cam_params=[{"viewdir": True} for _ in range(n_cams)],
        group_indices=[list(range(n_cams))], group_params=[{"f": True, "k": 0}], **model_args,
    )
    return model, np.concatenate([[true_f, true_f, true_k1], true_viewdirs.ravel()])


def ba_matches_problem(Camera, optimize, n_cams=6, n_pts=4000, seed=0, **model_args):
    """A chain of pairwise ``Matches`` with three shared radial coefficients:
    every residual evaluation runs the iterative undistortion."""
    rng = np.random.default_rng(seed)
    k_true = (-0.15, 0.05, -0.01)
    true = [Camera(imgsz=(4288, 2848), f=3000.0, viewdir=rng.uniform(-4, 4, 3), k=k_true) for _ in range(n_cams)]
    cams = [
        Camera(imgsz=(4288, 2848), f=3000.0, viewdir=t.viewdir + rng.uniform(-0.3, 0.3, 3), k=(-0.1, 0.0, 0.0))
        for t in true
    ]
    controls = []
    for i in range(n_cams - 1):
        uv_i = np.column_stack([rng.uniform(200, 4000, n_pts), rng.uniform(200, 2600, n_pts)])
        uv_j = true[i + 1].xyz_to_uv(true[i].uv_to_xyz(uv_i), directions=True)
        ok = np.isfinite(uv_j).all(axis=1) & true[i + 1].inframe(uv_j)
        controls.append(optimize.Matches(cams=[cams[i + 1], cams[i]], uvs=[uv_j[ok], uv_i[ok]]))
    model = optimize.Cameras(
        cams=cams, controls=controls, cam_params=[{"viewdir": True} for _ in range(n_cams)],
        group_indices=[list(range(n_cams))], group_params=[{"k": [0, 1, 2]}], **model_args,
    )
    return model, None


def ba_lines_problem(Camera, optimize, n_cams=3, n_ridge=400, n_obs=1200, seed=0, **model_args):
    """Horizon lines: each camera sees a distant ridge polyline, traced in
    the image from its true orientation; the fit recovers each view
    direction through ``Lines``' budgeted world candidates."""
    rng = np.random.default_rng(seed)
    xs = np.linspace(-3000, 3000, n_ridge)
    ridge = np.column_stack([xs, np.full_like(xs, 6000.0), 150 * np.sin(xs / 400) + 40 * np.sin(xs / 90)])
    cams, controls = [], []
    for _ in range(n_cams):
        true_v = rng.uniform(-2, 2, 3)
        cam_true = Camera(imgsz=(4288, 2848), f=3000.0, viewdir=true_v)
        uv = cam_true.xyz_to_uv(ridge)
        trace = uv[np.isfinite(uv).all(axis=1) & cam_true.inframe(uv)]
        if len(trace) < 8:
            continue
        # Densify the observed trace to n_obs points along the polyline.
        t = np.linspace(0, len(trace) - 1, n_obs)
        i0 = np.clip(np.floor(t).astype(int), 0, len(trace) - 2)
        fr = (t - i0)[:, None]
        cam = Camera(imgsz=(4288, 2848), f=3000.0, viewdir=true_v + rng.uniform(-0.25, 0.25, 3))
        cams.append(cam)
        controls.append(optimize.Lines(cam=cam, uvs=[trace[i0] * (1 - fr) + trace[i0 + 1] * fr], xyzs=[ridge]))
    model = optimize.Cameras(cams=cams, controls=controls, cam_params=[{"viewdir": True} for _ in cams], **model_args)
    return model, None


BA_PROBLEMS = {
    "points": ba_points_problem,
    "matches": ba_matches_problem,
    "lines": ba_lines_problem,
}


# ---- Phase 16: the host Tracker ---- #


class DrivenCartesianMotion:
    """A host ``CartesianMotion`` that consumes pre-drawn standard-normal
    draws, as ``benchmarks/lockstep.py`` drives the reference's: the same
    draws go to the batched tracker through ``noise=``."""

    def __init__(self, base, init_xy, init_z, init_v, accel):
        self._base = base
        self._draws = (init_xy, init_z, init_v, accel)  # (P, 2), (P,), (P, 3), (T - 1, P, 3)
        self._step = 0

    def __getattr__(self, name):
        return getattr(self._base, name)

    def initialize_particles(self):
        m = self._base
        init_xy, init_z, init_v, _ = self._draws
        particles = np.zeros((m.n, 6))
        particles[:, 0:2] = m.xy + np.asarray(m.xy_sigma) * init_xy
        particles[:, 2] = m.dem.sample(particles[:, 0:2]) + m.dem_sigma.sample(particles[:, 0:2]) * init_z
        particles[:, 3:6] = m.vxyz + np.asarray(m.vxyz_sigma) * init_v
        self._step = 0
        return particles

    def evolve_particles(self, particles, dt, step=None):
        m = self._base
        units = dt.total_seconds() / m.time_unit.total_seconds()
        axyz = m.axyz + np.asarray(m.axyz_sigma) * self._draws[3][self._step if step is None else step]
        self._step += 1
        particles[:, 0:3] += units * particles[:, 3:6] + 0.5 * axyz * units ** 2
        particles[:, 3:6] += units * axyz


class DrawnUniforms:
    """Stands in for the tracker's ``numpy.random.Generator``: systematic
    resampling's one uniform a step comes from a pre-drawn table (T - 1, N),
    track n reading column n."""

    def __init__(self, table, column=None):
        self._table, self._column, self._step = table, column, 0

    def spawn(self, n):
        return [DrawnUniforms(self._table, column) for column in range(n)]

    def random(self):
        self._step += 1
        return float(self._table[self._step - 1, self._column])


def host_tracker_objects(scene, points_xy, n_particles: int, noise, device, shapes=None, xy_sigma=(1.0, 1.0)):
    """The host ``Tracker`` on ``device`` over the oblique scene, with its
    driven motion models: the same objects ``oblique_tracker`` stacks. With
    ``shapes`` (a dict) the tracker counts in it the (h, w) of every tile
    it high-passes; ``xy_sigma`` spreads the first particles."""
    from glimpse_tpu_torch import Tracker
    from glimpse_tpu_torch.track import CartesianMotion

    class RecordingTracker(Tracker):
        def _highpass(self, tile, size=(5, 5)):
            if shapes is not None:
                shapes[tuple(tile.shape)] = shapes.get(tuple(tile.shape), 0) + 1
            return super()._highpass(tile, size=size)

    motions = [
        DrivenCartesianMotion(
            CartesianMotion(
                xy=xy, time_unit=scene["day"], dem=scene["dem"], dem_sigma=0.5, n=n_particles, xy_sigma=xy_sigma,
                vxyz_sigma=(1.5, 1.5, 0.05), axyz_sigma=(0.1, 0.1, 0.01),
            ),
            noise["init"]["xy"][n], noise["init"]["z"][n], noise["init"]["v"][n], noise["a"][:, n],
        )
        for n, xy in enumerate(points_xy)
    ]
    tracker = RecordingTracker([scene["observer"]], viewshed=scene["viewshed"], record="posterior", device=device)
    tracker.rng = DrawnUniforms(noise["resample_u"])
    return tracker, motions


WIDE_CLOUD_SIGMA = (30.0, 45.0)  # m: first particles spread over about 250 x 240 px of phase 16's image


def wide_cloud_run(scene, points_xy, noise, devices, n_particles: int, n_points: int = 4, n_frames: int = 4):
    """Phase 16 (f): the host ``Tracker`` with first particles spread
    ``WIDE_CLOUD_SIGMA``, on the ``n_points`` of ``points_xy`` that project
    nearest the image's centre, on the card and on the CPU from the same
    draws (``noise``'s first rows). Its search tiles outgrow one block's
    shared memory, so the card's high-pass takes the kernel's global route.
    Raises unless every track of both free runs finishes without an error
    or a warning, a search tile larger than 170 x 170 was high-passed on the
    card by the kernel, and, each step from the CPU's carried particles,
    the card's weighted mean projects within 0.1 px of the CPU's (a free
    run in float32 against one in float64 takes another particle path once
    a rounding moves a resampling threshold, so it is reported), and
    unless the kernel equals its plain version on the card, NaN included,
    on a tile of every shape the run gave it. Returns (the line's part, the
    largest tile's record: {shape, size, dtype, variant, ms, plain_ms,
    bound_ms}, timed as ``large_tiles`` times)."""
    import torch

    from glimpse_tpu_torch.kernels import highpass as highpass_kernel
    from glimpse_tpu_torch.kernels.bench_highpass import HBM_BYTES_PER_S

    observer = scene["observer"]
    uv = observer.xyz_to_uv(np.column_stack([points_xy, scene["dem"].sample(points_xy)]), img=0)
    chosen = points_xy[np.argsort(np.linalg.norm(uv - OBLIQUE_IMG / 2, axis=1))[:n_points]]
    draws = {"init": {k: v[:n_points] for k, v in noise["init"].items()},
             "a": noise["a"][: n_frames - 1, :n_points], "resample_u": noise["resample_u"][: n_frames - 1, :n_points]}
    datetimes = list(observer.datetimes[:n_frames])
    shapes, runs = {}, {}
    for kind, device in devices.items():
        tracker, motions = host_tracker_objects(scene, chosen, n_particles, draws, device,
                                                shapes if kind == "card" else None, xy_sigma=WIDE_CLOUD_SIGMA)
        launched = highpass_kernel.median_highpass.launches
        runs[kind] = tracker.track(motions, datetimes=datetimes, tile_size=(15, 15))
        if kind == "card":
            launches = highpass_kernel.median_highpass.launches - launched
    for kind, tracks in runs.items():
        if any(e is not None for e in tracks.errors) or any(w is not None for w in tracks.warnings) \
                or not np.isfinite(tracks.means).all():
            raise AssertionError(f"phase 16 (f): the wide cloud's tracks on the {kind}: errors {tracks.errors},"
                                 f" warnings {tracks.warnings}")
    largest = max(shapes, key=lambda hw: hw[0] * hw[1])
    if min(largest) <= 170 or launches != sum(shapes.values()):
        raise AssertionError(f"phase 16 (f): largest search tile {largest}, {launches} launches for"
                             f" {sum(shapes.values())} high-passes")
    # The kernel against its plain version on a tile of every shape the run
    # gave it, with ties and NaN; the largest timed.
    for k, (h, w) in enumerate(sorted(shapes)):
        tiles = highpass_case_tiles((1, h, w), True, False, devices["card"], seed=161 + k)
        want = highpass_kernel.median_highpass_plain(tiles, (5, 5))
        torch.testing.assert_close(highpass_kernel.median_highpass(tiles, (5, 5)), want, rtol=0, atol=0, equal_nan=True,
                                   msg=lambda m: f"phase 16 (f): median_highpass on a (1, {h}, {w}) tile: {m}")
        if (h, w) == largest:
            record = {
                "shape": [1, h, w], "size": [5, 5], "dtype": "float32",
                "variant": highpass_kernel.kernel_variant((5, 5), torch.float32, (1, h, w)),
                "ms": _cuda_ms(lambda: highpass_kernel.median_highpass(tiles, (5, 5))),
                "plain_ms": _cuda_ms(lambda: highpass_kernel.median_highpass_plain(tiles, (5, 5))),
                "bound_ms": 2 * tiles.numel() * tiles.element_size() / HBM_BYTES_PER_S * 1e3,
            }

    def pixels(xyz):
        return observer.xyz_to_uv(xyz, img=0)

    free = np.linalg.norm(pixels(runs["card"].means[..., 0:3].reshape(-1, 3))
                          - pixels(runs["cpu"].means[..., 0:3].reshape(-1, 3)), axis=1).max()
    # Each step from the CPU's carried particles, as Tracker.track steps.
    workers = {kind: host_tracker_objects(scene, chosen, n_particles, draws, device, xy_sigma=WIDE_CLOUD_SIGMA)
               for kind, device in devices.items()}
    carried = 0.0
    for n in range(n_points):
        particles = workers["cpu"][1][n].initialize_particles()
        for tracker, _ in workers.values():
            tracker.reset()
            tracker.particles = particles.copy()
            tracker.test_particles()
            tracker.initialize_weights()
            tracker.initialize_template(obs=0, img=0, tile_size=(15, 15))
        workers["cpu"][0].rng = DrawnUniforms(draws["resample_u"], column=n)
        for t in range(1, n_frames):
            means = {}
            for kind, (tracker, motions) in workers.items():
                tracker.particles = particles.copy()
                motions[n].evolve_particles(tracker.particles, dt=scene["day"], step=t - 1)
                tracker.test_particles()
                tracker.update_weights(imgs=[t], motion_model=motions[n])
                means[kind] = tracker.particle_mean[None, 0:3]
            carried = max(carried, float(np.linalg.norm(pixels(means["card"]) - pixels(means["cpu"]))))
            workers["cpu"][0].resample_particles()
            particles = workers["cpu"][0].particles
    if carried > 0.1:
        raise AssertionError(f"phase 16 (f): the wide cloud's Tracker(cuda) parts from Tracker(cpu) by {carried} px"
                             " from a carried state (limit 0.1)")
    return (
        f"(f) a wide cloud, xy_sigma {WIDE_CLOUD_SIGMA} m: {n_points} points x {n_particles} particles x {n_frames}"
        f" frames, search tiles up to {largest[0]}x{largest[1]} ({record['variant']}: {record['ms']:.4f} ms, plain"
        f" {record['plain_ms']:.4f}, bound {record['bound_ms']:.4f}), {launches} launches, each of {len(shapes)} tile"
        f" shapes held to rtol=atol=0 with equal NaN, every track finished on both devices; Tracker(cuda) vs"
        f" Tracker(cpu) projected means each step from a carried state max {carried:.3g} px (limit 0.1), free runs"
        f" max {free:.3g} px"
    ), record


def host_tracker_phase(scene, points_xy, devices, card: str, n16: int = 64, p16: int = 2048, t16: int = 10):
    """Phase 16; ``devices`` maps "card" and "cpu" to their devices. Raises
    on a failed check and returns (the line to print, each kernel's launches
    on this path, the high-pass tile shapes the host tracker produced, (f)'s
    largest tile's record)."""
    import copy

    import torch

    from glimpse_tpu_torch.kernels import highpass as highpass_kernel
    from glimpse_tpu_torch.track import batch as batch_module
    from glimpse_tpu_torch.track import feeder

    cuda = devices["card"]
    median_highpass = highpass_kernel.median_highpass
    points16 = points_xy[:n16]
    draws = np.random.default_rng(16)
    noise = {
        "init": {
            "xy": draws.normal(size=(n16, p16, 2)).astype(np.float32),
            "z": draws.normal(size=(n16, p16)).astype(np.float32),
            "v": draws.normal(size=(n16, p16, 3)).astype(np.float32),
        },
        "a": draws.normal(size=(t16 - 1, n16, p16, 3)).astype(np.float32),
        "resample_u": draws.random((t16 - 1, n16)).astype(np.float32),
    }
    observer = scene["observer"]
    images, datetimes = observer.images[:t16], list(observer.datetimes[:t16])
    frames = np.stack([f for f in feeder.FrameFeeder([images])])  # (T, 1, H, W)

    shapes = {}  # the (h, w) of every tile the host tracker high-passes on the card

    # (a), (b): the host tracker through Tracker.track, on the card and on the CPU.
    reset_launches()
    runs, seconds = {}, {}
    for kind, device in devices.items():
        tracker, motions = host_tracker_objects(scene, points16, p16, noise, device, shapes if kind == "card" else None)
        start = time.perf_counter()
        runs[kind] = tracker.track(motions, datetimes=datetimes, tile_size=(15, 15))
        if device.type == "cuda":
            torch.cuda.synchronize()
        seconds[kind] = time.perf_counter() - start
        if kind == "card":
            host_launches = median_highpass.launches
    for kind, tracks in runs.items():
        failed = [n for n, e in enumerate(tracks.errors) if e is not None]
        warned = [n for n, w in enumerate(tracks.warnings) if w is not None]
        if failed or warned or tracks.means.shape != (n16, t16, 6) or not np.isfinite(tracks.means).all():
            raise AssertionError(
                f"host Tracker on the {kind}: tracks with errors {failed[:10]}, with warnings {warned[:10]},"
                f" means {tracks.means.shape} finite {np.isfinite(tracks.means).all()}")
    # One template and one search tile a step for every track, and the
    # window inside the kernel's domain: every high-pass is a launch.
    if not highpass_kernel.covers((5, 5)) or host_launches != n16 * t16 or sum(shapes.values()) != host_launches:
        raise AssertionError(
            f"the high-pass kernel did not carry the host tracker: {host_launches} launches for {sum(shapes.values())}"
            f" high-passes of {n16 * t16} expected")
    # The kernel against its plain version, bit for bit, on a random tile of
    # every shape the host tracker gave it.
    held = np.random.default_rng(160)
    for h, w in sorted(shapes):
        tile = torch.from_numpy(held.normal(size=(1, h, w)).astype(np.float32)).to(cuda)
        if not torch.equal(median_highpass(tile, (5, 5)), highpass_kernel.median_highpass_plain(tile, (5, 5))):
            raise AssertionError(f"median_highpass differs from its plain version on a (1, {h}, {w}) tile of phase 16")
    host_routes = {"kernel": host_launches, "plain": sum(shapes.values()) - host_launches}

    # (c): the batched tracker from the same objects and draws.
    batch = oblique_tracker(scene, points16, p16, cuda)
    dts = np.ones(t16 - 1, np.float32)
    on_card = torch.from_numpy(frames).to(cuda)
    batch.track(torch.Generator(device=cuda).manual_seed(0), on_card, dts, noise=noise)  # warm-up
    torch.cuda.synchronize()
    before = launch_counts()
    start = time.perf_counter()
    _, out = batch.track(torch.Generator(device=cuda).manual_seed(0), on_card, dts, noise=noise)
    torch.cuda.synchronize()
    seconds["batched"] = time.perf_counter() - start
    launches16 = {name: count - before[name] for name, count in launch_counts().items()}
    launches16["median_highpass"] += host_launches
    batched = batch_module.to_tracks(datetimes, scene["day"], out)
    if any(e is not None for e in batched.errors):
        raise AssertionError("the batched tracker of phase 16 lost a point")

    def pixels(xyz):
        return observer.xyz_to_uv(xyz, img=0)

    # The free runs beside each other: posterior means projected into the image.
    free = np.linalg.norm(pixels(runs["card"].means[:, 1:, 0:3].reshape(-1, 3)) - pixels(batched.means[:, 1:, 0:3].reshape(-1, 3)), axis=1)
    free_devices = float(np.abs(runs["card"].means - runs["cpu"].means).max())

    # (d), (e): every step of every track from the batched tracker's carried
    # state: the host tracker on the card against itself on the CPU (1e-3)
    # and against the batched tracker's projected mean (0.1 px).
    workers = {}
    for kind, device in devices.items():
        tracker, motions = host_tracker_objects(scene, points16, p16, noise, device)
        workers[kind] = (motions, [copy.copy(tracker) for _ in range(n16)])
    state = batch.initialize(torch.Generator(device=cuda).manual_seed(0), on_card[0], noise=noise["init"])
    for kind, (motions, trackers) in workers.items():
        for n, worker in enumerate(trackers):
            worker.reset()
            worker.particles = state.particles[n].double().cpu().numpy()
            worker.initialize_weights()
            worker.initialize_template(obs=0, img=0, tile_size=(15, 15))
    carried_devices, carried_px = 0.0, []
    for t in range(1, t16):
        carried = state.particles.double().cpu().numpy()
        state, out_t = batch.step(
            state, on_card[t], torch.tensor(1.0, device=cuda), noise={"a": noise["a"][t - 1], "resample_u": noise["resample_u"][t - 1]})
        batch_uv = pixels(out_t["mean"][:, 0:3].double().cpu().numpy())
        moments = {}
        for kind, (motions, trackers) in workers.items():
            rows = []
            for n, worker in enumerate(trackers):
                worker.particles = carried[n].copy()
                motions[n].evolve_particles(worker.particles, dt=scene["day"], step=t - 1)
                worker.test_particles()
                worker.update_weights(imgs=[t], motion_model=motions[n])
                rows.append(np.concatenate([worker.particle_mean, worker.compute_particle_sigma()]))
            moments[kind] = np.stack(rows)
        carried_devices = max(carried_devices, float(np.abs(moments["card"] - moments["cpu"]).max()))
        carried_px.append(np.linalg.norm(pixels(moments["card"][:, 0:3]) - batch_uv, axis=1))
    carried_px = np.concatenate(carried_px)
    if carried_devices > 1e-3:
        raise AssertionError(f"the host tracker on the card and on the CPU part: {carried_devices} from a shared state (limit 1e-3)")
    if carried_px.max() > 0.1:
        raise AssertionError(
            f"the host tracker and the batched tracker part: {carried_px.max()} px from a carried state (limit 0.1),"
            f" {int((carried_px > 0.1).sum())} of {carried_px.size} point-steps")
    wide, wide_record = wide_cloud_run(scene, points16, noise, devices, p16)
    rate = {k: n16 * (t16 - 1) / s for k, s in seconds.items()}
    line = (
        f"phase 16 host Tracker on {card}: {n16} points x {p16} particles x {t16} frames of {OBLIQUE_IMG}x{OBLIQUE_IMG}, DEM prior,"
        f" viewshed, shared draws; Tracker(cuda) {rate['card']:.1f} point-steps/s ({seconds['card']:.3f} s),"
        f" Tracker(cpu) {rate['cpu']:.1f} ({seconds['cpu']:.3f} s), BatchTracker.from_observers {rate['batched']:.1f}"
        f" ({seconds['batched']:.4f} s); median_highpass launches by Tracker(cuda) {host_launches}, routes {host_routes},"
        f" tile shapes {len(shapes)} from {min(shapes)} to {max(shapes)}, each held bit-equal to the plain version; each step from a carried state: card vs CPU"
        f" max |diff| {carried_devices:.3g} (limit 1e-3), Tracker vs batched projected means max {carried_px.max():.4f} px"
        f" rmse {float(np.sqrt((carried_px ** 2).mean())):.4f} px (limit 0.1); free runs: Tracker(cuda) vs Tracker(cpu)"
        f" max |diff| {free_devices:.3g}, Tracker vs batched max {free.max():.4f} px rmse"
        f" {float(np.sqrt((free ** 2).mean())):.4f} px; errors none; launches {launches16}; {wide}"
    )
    return line, launches16, shapes, wide_record


# ---- Phase 17: calibration ---- #


def calibration_phase(devices, card: str, sizes=None) -> Tuple[str, dict]:
    """Phase 17: ``benchmarks/ba_autodiff.py``'s three problems at their own
    sizes through ``Cameras.fit`` with the exact Jacobian on the card (its
    program: an eager first call, then replays) and with scipy's finite
    differences, then one ``ransac`` run. Raises on a failed check; returns
    the line to print and each problem's fit seconds by Jacobian (exact:
    cold, warm). ``sizes`` overrides the problems' sizes (a rehearsal)."""
    import torch

    from glimpse_tpu_torch import Camera, optimize

    cuda, cpu = devices["card"], devices["cpu"]
    sizes = sizes or {}
    parts, seconds = [], {}
    for name, build_problem in BA_PROBLEMS.items():
        model, truth = build_problem(Camera, optimize, device=cuda, **sizes.get(name, {}))
        start_vectors = [cam.to_array() for cam in model.cams]
        evaluations = {"n": 0}
        residuals = model.residuals

        def counted(*args, _residuals=residuals, **kwargs):
            evaluations["n"] += 1
            return _residuals(*args, **kwargs)

        model.residuals = counted
        fits, walls, counts = {}, {}, {}
        if cuda.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        for jac in ("exact", "exact", "2-point"):  # the first exact fit is the cold one
            for cam, vector in zip(model.cams, start_vectors):
                cam._vector = vector.copy()
            model.update_params()
            evaluations["n"] = 0
            start = time.perf_counter()
            fits[jac] = model.fit(full=True, jac=jac)
            walls.setdefault(jac, []).append(time.perf_counter() - start)
            counts[jac] = evaluations["n"]
        peak = torch.cuda.max_memory_allocated() if cuda.type == "cuda" else 0
        seconds[name] = walls
        exact, fd = fits["exact"], fits["2-point"]
        if not (exact.success and fd.success and np.isfinite(exact.x).all()):
            raise AssertionError(f"calibration {name}: success exact {exact.success}, 2-point {fd.success}")
        # The Jacobian at the start, on the card against the CPU.
        x0 = model.values.copy()
        jac_card = model._autodiff_jac()
        J = jac_card(x0)
        twin, _ = build_problem(Camera, optimize, device=cpu, **sizes.get(name, {}))
        J_cpu = twin._autodiff_jac()(x0)
        jac_err = float((np.abs(J - J_cpu) / np.abs(J_cpu).max(axis=0)).max())
        jac_differ = int((J != J_cpu).sum())
        if J.shape != (2 * model.size, len(x0)) or not np.isfinite(J).all() or jac_err > 1e-9:
            raise AssertionError(f"calibration {name}: Jacobian {J.shape}, card vs CPU {jac_err} of each column's largest entry (limit 1e-9)")
        jac_ms = _cuda_ms(lambda: jac_card(x0), reps=5)
        costs = {k: float(np.sum(model.residuals(params=f.x) ** 2)) for k, f in fits.items()}
        if name == "points":
            # The parameters are identified: both fits reach the truth.
            errors = {k: float(np.abs(f.x - truth).max()) for k, f in fits.items()}
            if max(errors.values()) > 1e-6 or float(np.abs(exact.x - fd.x).max()) > 1e-6:
                raise AssertionError(f"calibration points: errors against the truth {errors} (limit 1e-6: px, 1, deg)")
            agree = f"max error against the truth exact {errors['exact']:.3g} 2-point {errors['2-point']:.3g} (limit 1e-6)"
        elif name == "matches":
            # A chain of pairs fixes no common rotation: the optimum is a
            # family, held by its cost (noise-free data: 0) and its worst residual.
            worst = {k: float(model.errors(f.x).max()) for k, f in fits.items()}
            if max(worst.values()) > 1e-5:
                raise AssertionError(f"calibration matches: worst residuals {worst} px (limit 1e-5)")
            agree = f"worst residual exact {worst['exact']:.3g} px 2-point {worst['2-point']:.3g} px (limit 1e-5)"
        else:
            # The candidates' spacing leaves a shallow valley: held by cost
            # and by the view directions (0.02 deg).
            apart = float(np.abs(exact.x - fd.x).max())
            if costs["exact"] > 1.02 * costs["2-point"] or apart > 0.02:
                raise AssertionError(f"calibration lines: costs {costs}, fits {apart} deg apart (limits 1.02 x, 0.02 deg)")
            agree = f"cost exact {costs['exact']:.6g} 2-point {costs['2-point']:.6g} (limit 1.02 x), fits {apart:.3g} deg apart (limit 0.02)"
        parts.append(
            f"{name} {len(model.cams)} cameras, {model.size} control points, {len(x0)} parameters: exact cold {walls['exact'][0]:.3f} s"
            f" warm {walls['exact'][1]:.3f} s nfev {exact.nfev} residual evaluations {counts['exact']}; 2-point {walls['2-point'][0]:.3f} s"
            f" nfev {fd.nfev} residual evaluations {counts['2-point']}; Jacobian {J.shape[0]}x{J.shape[1]} {jac_ms:.2f} ms a call,"
            f" card vs CPU {jac_err:.3g} of each column's largest entry (limit 1e-9; {jac_differ} of {J.size} entries differ),"
            f" peak {peak / 2**20:.0f} MiB; {agree}"
        )

    # RANSAC on the points problem with a tenth of its points moved far off.
    model, truth = BA_PROBLEMS["points"](Camera, optimize, device=cuda, **sizes.get("points", {}))
    rng = np.random.default_rng(17)
    bad = np.sort(rng.choice(model.size, size=model.size // 10, replace=False))
    breaks = np.cumsum([0] + [c.size for c in model.controls])
    for control, lo in zip(model.controls, breaks):
        rows = bad[(bad >= lo) & (bad < lo + control.size)] - lo
        control.uv[rows] += rng.uniform(30, 100, size=(len(rows), 2)) * rng.choice([-1, 1], size=(len(rows), 2))
    start = time.perf_counter()
    params, inliers = optimize.ransac(
        model, n=16, max_error=1.0, min_inliers=model.size * 85 // 100, iterations=40, rng=np.random.default_rng(18), jac="exact")
    ransac_s = time.perf_counter() - start
    good = np.setdiff1d(np.arange(model.size), bad)
    if not np.array_equal(inliers, good) or float(np.abs(params - truth).max()) > 1e-6:
        raise AssertionError(
            f"ransac: {len(inliers)} inliers against {len(good)} true ones, parameters {np.abs(params - truth).max()} from the truth")
    parts.append(
        f"ransac on points with {len(bad)} of {model.size} moved 30-100 px: 40 samples of 16, {ransac_s:.3f} s, the {len(good)} true"
        f" inliers recovered, parameters {float(np.abs(params - truth).max()):.3g} from the truth (limit 1e-6)")
    return (f"phase 17 calibration on {card}, Jacobians by torch.func.jacfwd in float64 on the card: "
            + "; ".join(parts)), seconds


def stabilize_jpegs(frames, truth, nominal: dict, mask, workdir: str, cuda, timer, marker, steps=None,
                    prefix: str = "") -> dict:
    """``frames`` (n, h, w) uint8 written as JPEG files (quality 95) under
    ``workdir``, read back as ``Image`` objects an hour a step apart
    (``steps``, default 0..n-1) with the ``nominal`` camera, and stabilized
    through the user's entry points: ``ObserverCameras(anchors=[0])``,
    ``build_keypoints(detector="device")`` under ``mask``, ``build_matches(
    matcher="device", seq=STAB_OFFSETS, refine=True)`` and ``fit``, each
    stage timed by ``timer`` under ``prefix``. Returns a dict: the model,
    the fit, each frame's view direction error against ``truth`` (deg), the
    JPEG paths, a factory of fresh observers and the detect and match
    settings."""
    import datetime

    import PIL.Image

    from glimpse_tpu_torch import Camera, Image, optimize
    from glimpse_tpu_torch.track import Observer

    n_frames = len(frames)
    steps = np.arange(n_frames) if steps is None else np.asarray(steps)
    folder = os.path.join(workdir, "frames")
    os.makedirs(folder, exist_ok=True)
    paths = [os.path.join(folder, f"frame_{i:04d}.jpg") for i in range(n_frames)]
    with timer(prefix + "write jpeg", sync_value=marker):
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            list(pool.map(lambda i: PIL.Image.fromarray(frames[i]).save(paths[i], quality=95), range(n_frames)))
    t0, hour = datetime.datetime(2020, 1, 1), datetime.timedelta(hours=1)

    def observer():
        return Observer([Image(p, cam=Camera(**nominal), datetime=t0 + int(t) * hour) for p, t in zip(paths, steps)],
                        cache=False)

    detect = dict(detector="device", masks=mask, nfeatures=2048, batch=16, refine="lattice",
                  path=os.path.join(workdir, "keypoints"))
    match = dict(matcher="device", seq=STAB_OFFSETS, max_ratio=0.75, max_distance=20.0, refine=True,
                 path=os.path.join(workdir, "matches"))
    model = optimize.ObserverCameras(observer(), anchors=[0], device=cuda)
    with timer(prefix + "keypoints", sync_value=marker):
        model.build_keypoints(**detect)
    with timer(prefix + "matches and refinement", sync_value=marker):
        model.build_matches(**match)
    with timer(prefix + "fit", sync_value=marker):
        fit = model.fit(maxiter=2000)
    errors = rotation_errors(fit.x.reshape(-1, 3), truth)
    return {"model": model, "fit": fit, "errors": errors, "paths": paths, "observer": observer, "detect": detect,
            "match": match}


def stabilize_from_files(n_frames: int, cuda, workdir: str):
    """Phase 18: phase 11's scene written as JPEG files (quality 95), read
    back as ``Image`` objects and stabilized through the user's entry
    points (:func:`stabilize_jpegs`), then ``project_images`` of every
    frame on the card. A second pass on fresh objects must come from the
    pickle caches with no detection and the same matches. Raises on a
    failed check; returns (the line to print, what phase 24 tracks on: the
    JPEG paths, the ``Image`` objects whose cameras ``set_cameras`` gave the
    fitted view directions, the true view directions and the nominal camera
    vector; and for phase 28 the ``ObserverCameras`` and the terrain mask)."""
    import torch

    from glimpse_tpu_torch import Camera, Image, optimize, profiling
    from glimpse_tpu_torch.io import geotiff

    timer = profiling.Timer()
    marker = torch.zeros(1, device=cuda)  # phases timed by CUDA events on the card's stream
    torch.cuda.reset_peak_memory_stats()
    with timer("render", sync_value=marker):
        frames, truth, base, mask = stabilization_scene(n_frames, cuda)
    nominal = dict(imgsz=STAB_IMG, f=STAB_IMG, xyz=STAB_CAM_XYZ, viewdir=STAB_VIEWDIR)
    stabilized = stabilize_jpegs(frames, truth, nominal, mask, workdir, cuda, timer, marker)
    model, fit, errors, paths, observer, detect, match = (
        stabilized[k] for k in ("model", "fit", "errors", "paths", "observer", "detect", "match"))
    if not np.isfinite(fit.x).all() or errors.max() > 0.01:
        raise AssertionError(f"stabilization from files: max view direction error {errors.max()} deg (limit 0.01)")
    images = model.observer.images
    model.set_cameras(fit.x.reshape(-1, 3))
    target = Camera(**nominal)
    out = os.path.join(workdir, "stabilized")
    outputs = [os.path.join(out, f"frame_{i:04d}.tif") for i in range(n_frames)]
    with timer("project_images", sync_value=marker):
        optimize.project_images(target, images, outputs, device=cuda, parallel=8)
    peak = torch.cuda.max_memory_allocated()
    # Frame 0 again on the CPU: the float64 sampling must give the same bytes.
    cpu_path = os.path.join(workdir, "frame_0000_cpu.tif")
    optimize.project_images(target, images[:1], [cpu_path], device="cpu")
    if not np.array_equal(geotiff.read(cpu_path), geotiff.read(outputs[0])):
        raise AssertionError("project_images of frame 0 differs between the card and the CPU")
    # A second pass on fresh objects: everything from the pickles.
    calls = []
    detect_device = optimize.detect_keypoints_device

    def counted(arrays, **kwargs):
        calls.append(len(arrays))
        return detect_device(arrays, **kwargs)

    optimize.detect_keypoints_device = counted
    try:
        again = optimize.ObserverCameras(observer(), anchors=[0], device=cuda)
        with timer("cached pass", sync_value=marker):
            again.build_keypoints(**detect)
            again.build_matches(**match)
    finally:
        optimize.detect_keypoints_device = detect_device
    if calls:
        raise AssertionError(f"the cached pass detected keypoints in {len(calls)} batches")
    first, second = (m.matches for m in (model, again))
    same = (np.array_equal(first.row, second.row) and np.array_equal(first.col, second.col)
            and all(np.array_equal(a.xys[k], b.xys[k]) for a, b in zip(first.data, second.data) for k in (0, 1)))
    if not same:
        raise AssertionError("the cached pass's matches differ from the first pass's")
    breaks = again.matcher.match_breaks()
    if len(breaks):
        raise AssertionError(f"match chain breaks at images {breaks[:10].tolist()}")
    # Alignment: each frame against the anchor over their common footprint
    # on the terrain (the glacier band moves), stabilized and at the
    # nominal view direction.
    anchor = np.squeeze(geotiff.read(outputs[0])).astype(float)
    picks = sorted({1, n_frames // 2, n_frames - 1})
    nominal_paths = [os.path.join(workdir, f"nominal_{i:04d}.tif") for i in picks]
    optimize.project_images(target, [Image(paths[i], cam=Camera(**nominal)) for i in picks], nominal_paths, device=cuda)
    alignment = []
    for i, nominal_path in zip(picks, nominal_paths):
        pair = []
        for path in (outputs[i], nominal_path):
            a = np.squeeze(geotiff.read(path)).astype(float)
            common = (a > 0) & (anchor > 0) & (mask > 0)
            pair.append(float(np.abs(a - anchor)[common].mean()))
        alignment.append(f"frame {i} {pair[0]:.3f} DN (nominal view direction {pair[1]:.3f})")
    n_matches = sum(m.size for m in first.data)
    joined = {"paths": paths, "images": images, "truth": truth, "base": base, "model": model, "mask": mask}
    return (
        f"{n_frames} JPEG frames of {STAB_IMG}x{STAB_IMG} (quality 95) through ObserverCameras, 2,048 keypoints,"
        f" offsets {STAB_OFFSETS}, refined: "
        + ", ".join(f"{k} {v['total_s']:.2f} s" for k, v in timer.as_dict().items())
        + f"; {len(first.data)} image pairs, {n_matches} matched pairs; fit {fit.nit} iterations, view direction"
        f" error max {errors.max():.5f} mean {errors.mean():.5f} deg (limit 0.01); cached pass: {len(calls)} detector"
        f" batches, matches identical, no chain break; frame 0 projected bit-equal card vs CPU; mean |projected -"
        f" anchor| on the terrain: {', '.join(alignment)}; peak {peak / 2**30:.2f} GiB"
    ), joined


# The JAX package's stabilized RMSE on its own 1,000-frame run of this recipe
# (docs/validation.md:169): an accuracy of the scene and the filter.
REFERENCE_JOIN_RMSE = 22.78


def decode_frames(paths) -> np.ndarray:
    """The JPEG frames as one host array (n, h, w) uint8, decoded in threads."""
    import PIL.Image

    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        return np.stack(list(pool.map(lambda path: np.asarray(PIL.Image.open(path).convert("L")), paths)))


def fitted_vectors(images, base, phase: str) -> np.ndarray:
    """The camera vectors (n, 20) that ``ObserverCameras.set_cameras`` gave
    ``images``; raises if they differ from the nominal ``base`` anywhere but
    the view direction."""
    fitted = np.stack([image.cam.to_array() for image in images])
    others = np.delete(np.tile(base, (len(images), 1)), [3, 4, 5], axis=1)
    if fitted.shape != (len(images), 20) or not np.array_equal(np.delete(fitted, [3, 4, 5], axis=1), others):
        raise AssertionError(f"{phase}: the stabilized cameras differ from the nominal one beyond the view direction")
    return fitted


def streamed_run(tracker, first, frames, n_steps: int, truth_xy, phase: str, **stream) -> dict:
    """One ``track_stream`` of ``frames`` (an iterable of the frames at steps
    1..n_steps - 1) from generator seed 0, timed on the host clock to the
    card's end, each kernel's launches counted from 0. Raises unless it ran
    n_steps - 1 steps to finite final means; returns the final RMSE against
    ``truth_xy``, the seconds, the peak memory and the launches."""
    import torch

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    _, outputs = tracker.track_stream(torch.Generator(device=tracker.device).manual_seed(0), first, frames,
                                      np.ones(n_steps - 1, np.float32), **stream)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    final = outputs[-1]["mean"][-1].double().cpu().numpy()
    steps = sum(len(o["mean"]) for o in outputs)
    if steps != n_steps - 1 or final.shape != (len(truth_xy), 6) or not np.isfinite(final).all():
        raise AssertionError(f"{phase}: {steps} steps, final means {final.shape}, finite {np.isfinite(final).all()}")
    return {
        "rmse": float(np.sqrt(np.mean(np.sum((final[:, 0:2] - truth_xy) ** 2, axis=-1)))), "seconds": seconds,
        "peak": torch.cuda.max_memory_allocated(),
        "launches": launch_counts(),
    }


def tracking_setup(joined, n_frames: int, cuda, n_points: int = 10240, n_particles: int = 512):
    """benchmarks/columbia_pipeline.py's tracking stage on phase 18's fit:
    (the tracker, the fitted and the true camera vectors (n_frames, 20), the
    points' true final positions)."""
    base, truth = joined["base"], joined["truth"]
    fitted = fitted_vectors(joined["images"], base, "phase 24")
    true = np.tile(base, (n_frames, 1))
    true[:, 3:6] = truth[:n_frames]
    starts, truth_xy = join_points(n_points, n_frames)
    return columbia_tracker(base[None], None, starts, n_particles, cuda), fitted[:n_frames], true, truth_xy


def stabilize_then_track(joined, frames, cuda, n_points: int = 10240, n_particles: int = 512, chunk: int = 8):
    """Phase 24: benchmarks/columbia_pipeline.py's tracking stage on phase
    18's JPEG frames (``frames``, decoded once) and fit: 10,240 points x 512
    particles through every frame with ``track_stream``, three times from
    the same generator seed: with the fitted cameras (read from the
    ``Image`` objects' cameras into a (T, 1, 20) ``camera_vectors_seq``), with
    none (the nominal camera: the reference's unstabilized run) and with the
    true cameras. Raises unless every final mean is finite, the three kernels
    launched in the stabilized run and its RMSE is below the unstabilized
    one; returns (the line's part, the stabilized run's launches)."""
    n_frames = len(frames)
    tracker, fitted, true, truth_xy = tracking_setup(joined, n_frames, cuda, n_points, n_particles)
    runs = {
        name: streamed_run(tracker, frames[0][None], (frames[i][None] for i in range(1, n_frames)), n_frames, truth_xy,
                           f"phase 24 {name}", camera_vectors_seq=seq, chunk=chunk)
        for name, seq in (("stabilized", fitted[:, None]), ("unstabilized", None), ("true cameras", true[:, None]))
    }
    stabilized = runs["stabilized"]
    if min(stabilized["launches"].values()) < 1:
        raise AssertionError(f"phase 24: the kernels did not carry the stabilized run: {stabilized['launches']}")
    if not stabilized["rmse"] < runs["unstabilized"]["rmse"]:
        raise AssertionError(f"phase 24: stabilized RMSE {stabilized['rmse']} is not below the unstabilized"
                             f" {runs['unstabilized']['rmse']}")
    line = (
        f"{n_points}x{n_particles}x{n_frames} frames of phase 18's JPEGs, one observer, track_stream(chunk {chunk}),"
        f" the same generator seed: final RMSE against the truth (world units) stabilized {stabilized['rmse']:.4f}"
        f" (the JAX package's own run of this recipe: {REFERENCE_JOIN_RMSE}), unstabilized"
        f" {runs['unstabilized']['rmse']:.4f}, true cameras {runs['true cameras']['rmse']:.4f}; stabilized"
        f" {n_points * (n_frames - 1) / stabilized['seconds']:.1f} point-steps/s ({stabilized['seconds']:.3f} s), peak"
        f" {stabilized['peak'] / 2**30:.2f} GiB; launches "
        + "; ".join(f"{name} {r['launches']}" for name, r in runs.items())
        + "; the other runs " + ", ".join(f"{name} {r['seconds']:.3f} s" for name, r in runs.items() if r is not stabilized)
    )
    return line, stabilized["launches"]


# main_two_observers' second station (benchmarks/columbia_pipeline.py:53-54):
# west of the scene, looking east, the same height and pitch as the first.
CAM_B_XYZ = (-200.0, 270.0, 400.0)
CAM_B_VIEWDIR = (90.0, -35.0, 0.0)
# The JAX package's own run of main_two_observers (docs/validation.md:149,
# host SIFT): the largest view direction error of each observer (deg), and
# the final RMSE stabilized and unstabilized: accuracies of the scene and the
# filter.
REFERENCE_TWO_OBSERVER_ROTATION = (0.0044, 0.0053)
REFERENCE_TWO_OBSERVER_RMSE = {"stabilized": 4.14, "unstabilized": 92.0}


def two_observers(cuda, workdir: str, n_steps: int = 1000, n_points: int = 10240, n_particles: int = 512,
                  chunk: int = 8):
    """Phase 25: benchmarks/columbia_pipeline.py's ``main_two_observers`` at
    full length. Observer A (phase 18's camera) fires at even steps,
    observer B (the west station) at odd ones; each observer's frames show
    the glacier at its own fire steps, wobble from its first fire on, go
    through JPEG files and are stabilized on their own
    (:func:`stabilize_jpegs`, anchored at their first fire). One tracker
    holds both nominal cameras and follows ``join_points``' starts over
    the union timeline with ``track_stream``: each step a (2, 512, 512)
    frame, the firing observer's image and zeros for the other, ``obs_masks``
    A on even steps and B on odd ones, and a (T, 2, 20)
    ``camera_vectors_seq`` of the fitted cameras at each observer's fire
    steps, its nominal camera elsewhere (B's template row is its first
    fire's). Twice from one generator seed: stabilized, and with no
    ``camera_vectors_seq`` (the reference's unstabilized run). Raises unless
    every final mean is finite after T - 1 steps, each observer's mean view
    direction error is at most 0.01 deg, the stabilized RMSE is below the
    unstabilized one and the stabilized run launched the high-pass once for
    each observer's templates and once a step and the resample once a step.
    Returns (the line's part, the stabilized run's launches)."""
    import torch

    from glimpse_tpu_torch import profiling

    fires = [np.arange(0, n_steps, 2), np.arange(1, n_steps, 2)]
    stations = [dict(cam_xyz=STAB_CAM_XYZ, viewdir=STAB_VIEWDIR, jitter_seed=42),
                dict(cam_xyz=CAM_B_XYZ, viewdir=CAM_B_VIEWDIR, jitter_seed=43)]
    timer = profiling.Timer()
    marker = torch.zeros(1, device=cuda)
    observers = []
    for name, steps, station in zip("AB", fires, stations):
        with timer(f"{name} render", sync_value=marker):
            frames, truth, base, mask = stabilization_scene(len(steps), cuda, steps=steps, **station)
        nominal = dict(imgsz=STAB_IMG, f=STAB_IMG, xyz=station["cam_xyz"], viewdir=station["viewdir"])
        done = stabilize_jpegs(frames, truth, nominal, mask, os.path.join(workdir, name), cuda, timer, marker,
                               steps=steps, prefix=f"{name} ")
        done["model"].set_cameras(done["fit"].x.reshape(-1, 3))
        fitted = fitted_vectors(done["model"].observer.images, base, f"phase 25 {name}")
        with timer(f"{name} decode", sync_value=marker):
            decoded = decode_frames(done["paths"])
        errors = done["errors"]
        if not np.isfinite(done["fit"].x).all() or errors.mean() > 0.01:
            raise AssertionError(f"phase 25 {name}: mean view direction error {errors.mean()} deg (limit 0.01)")
        observers.append({"frames": decoded, "base": base, "fitted": fitted, "errors": errors,
                          "pairs": sum(m.size for m in done["model"].matches.data)})
    bases = np.stack([o["base"] for o in observers])
    seq = np.tile(bases, (n_steps, 1, 1))
    for o, steps in enumerate(fires):
        seq[steps, o] = observers[o]["fitted"]
    seq[0, 1] = seq[1, 1]  # B's template frame is its first fire
    steps_1 = np.arange(1, n_steps)
    masks = np.stack([steps_1 % 2 == 0, steps_1 % 2 == 1], axis=1).astype(np.float32)
    zero = np.zeros((STAB_IMG, STAB_IMG), np.uint8)

    def frame_at(t):
        image = observers[t % 2]["frames"][t // 2]
        return np.stack([image, zero] if t % 2 == 0 else [zero, image])

    first = np.stack([observers[0]["frames"][0], observers[1]["frames"][0]])
    starts, truth_xy = join_points(n_points, n_steps)
    tracker = columbia_tracker(bases, None, starts, n_particles, cuda)
    runs = {
        name: streamed_run(tracker, first, (frame_at(t) for t in range(1, n_steps)), n_steps, truth_xy,
                           f"phase 25 {name}", camera_vectors_seq=cameras, obs_masks=masks, chunk=chunk)
        for name, cameras in (("stabilized", seq), ("unstabilized", None))
    }
    stabilized = runs["stabilized"]
    # Each observer's templates once, then one launch a step on the 2 x
    # 10,240 stacked search tiles (both observers are scored every step and
    # the log likelihood masked); one resample and one spline read of the
    # stacked surfaces a step, and one front end for both observers; a flat
    # DEM without a sigma, so no DEM prior.
    expected = {"median_highpass": 2 + (n_steps - 1), "systematic_resample": n_steps - 1,
                "bspline_sample": n_steps - 1, "project_extract": n_steps - 1, "dem_prior": 0}
    if stabilized["launches"] != expected:
        raise AssertionError(f"phase 25: the kernels did not carry the stabilized run: {stabilized['launches']},"
                             f" expected {expected}")
    if not stabilized["rmse"] < runs["unstabilized"]["rmse"]:
        raise AssertionError(f"phase 25: stabilized RMSE {stabilized['rmse']} is not below the unstabilized"
                             f" {runs['unstabilized']['rmse']}")
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    np.save(os.path.join(REPO, "chiprun_out", "phase25_cameras.npy"), seq)
    line = (
        f"{n_points}x{n_particles}x{n_steps} union steps, A ({len(fires[0])} frames, even steps) and B"
        f" ({len(fires[1])} frames, odd steps) each stabilized from its JPEGs: view direction error max "
        + ", ".join(f"{n} {o['errors'].max():.5f}" for n, o in zip("AB", observers))
        + ", mean " + ", ".join(f"{n} {o['errors'].mean():.5f}" for n, o in zip("AB", observers))
        + f" deg (limit 0.01 on the mean; the JAX package's max {REFERENCE_TWO_OBSERVER_ROTATION[0]},"
        f" {REFERENCE_TWO_OBSERVER_ROTATION[1]} with host SIFT); matched pairs "
        + ", ".join(f"{n} {o['pairs']}" for n, o in zip("AB", observers))
        + "; " + ", ".join(f"{k} {v['total_s']:.2f} s" for k, v in timer.as_dict().items())
        + f"; track_stream(chunk {chunk}), obs_masks, the same generator seed: final RMSE (world units) stabilized"
        f" {stabilized['rmse']:.4f} (the JAX package's own run: {REFERENCE_TWO_OBSERVER_RMSE['stabilized']}),"
        f" unstabilized {runs['unstabilized']['rmse']:.4f} ({REFERENCE_TWO_OBSERVER_RMSE['unstabilized']});"
        f" stabilized {n_points * (n_steps - 1) / stabilized['seconds']:.1f} point-steps/s"
        f" ({stabilized['seconds']:.3f} s), peak {stabilized['peak'] / 2**30:.2f} GiB; launches "
        + "; ".join(f"{name} {r['launches']}" for name, r in runs.items())
        + f"; unstabilized {runs['unstabilized']['seconds']:.3f} s"
    )
    return line, stabilized["launches"]


CALIBRATION_FILES = {
    "Matlab": ("Calib_Results.m", "from_report"),
    "OpenCV": ("opencv.xml", "from_xml"),
    "Agisoft": ("agisoft.xml", "from_xml"),
    "PhotoModeler": ("CalibrationReport.txt", "from_report"),
}
CALIBRATION_IMGSZ = (4288, 2848)
CALIBRATION_SENSORSZ = (23.6, 15.8)  # mm; PhotoModeler's model needs a sensor size


def conversion_phase(devices) -> str:
    """Phase 19: each of ``tests/assets``' four calibration files read,
    turned into a ``Camera`` (fit where the models differ), that camera
    into each of the other three formats and back. Every fit runs twice
    over: by default (the reference's algorithm: scipy's 2-point differences
    of the host residual; no device), and with the exact Jacobian on the
    card and on the CPU. The host residuals are the same NumPy on both and
    the exact Jacobians agree bit for bit, so card and CPU must give
    parameters within 1e-9 relative, even along a direction the residuals
    barely see (PhotoModeler's focal length, sensor size and principal
    point share one scale). Returns the line to print."""
    from glimpse_tpu_torch import convert

    assets = os.path.join(REPO, "tests", "assets")

    def flat(xcam) -> np.ndarray:
        return np.concatenate([np.atleast_1d(np.asarray(v, dtype=float)) for v in vars(xcam).values()])

    def read(name):
        filename, reader = CALIBRATION_FILES[name]
        kwargs = {} if name in ("Matlab", "Agisoft") else {"imgsz": CALIBRATION_IMGSZ}
        return getattr(getattr(convert, name), reader)(os.path.join(assets, filename), **kwargs)

    runs = {}
    fits = {"default": (devices["cpu"], {}), "card": (devices["card"], {"jac": "exact"}),
            "cpu": (devices["cpu"], {"jac": "exact"})}
    for kind, (device, fit) in fits.items():
        rows = []
        for source in CALIBRATION_FILES:
            xcam = read(source)
            start = time.perf_counter()
            cam = xcam.to_camera(device=device, **fit)
            seconds = time.perf_counter() - start
            residual = convert.Converter(xcam, cam, device=device).residuals()
            rows.append((f"{source}->Camera", cam.to_array(), residual, seconds))
            if cam.sensorsz is None:
                cam.sensorsz = CALIBRATION_SENSORSZ
            for target in CALIBRATION_FILES:
                if target == source:
                    continue
                fmt = getattr(convert, target)
                start = time.perf_counter()
                out = fmt.from_camera(cam) if target == "OpenCV" else fmt.from_camera(cam, device=device, **fit)
                back = out.to_camera(device=device, **fit)
                seconds = time.perf_counter() - start
                residual = np.concatenate([convert.Converter(out, c, device=device).residuals() for c in (cam, back)])
                rows.append((f"{source}->{target}->Camera", np.concatenate([flat(out), back.to_array()]), residual,
                             seconds))
        runs[kind] = rows
    worst = 0.0
    for (label, a, res_a, _), (_, b, res_b, _) in zip(runs["card"], runs["cpu"]):
        relative = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))
        if not relative <= 1e-9:
            raise AssertionError(f"conversion {label}: card and CPU parameters differ by {relative} relative (limit"
                                 f" 1e-9), residuals by {np.abs(res_a - res_b).max()} px")
        worst = max(worst, relative)
    apart = max(float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))
                for (_, a, _, _), (_, b, _, _) in zip(runs["default"], runs["card"]))
    return (
        f"{len(runs['card'])} conversions of 4 files (residual max px of the default fit / the exact fit on the card;"
        " s default / exact on the card / exact on the CPU): "
        + "; ".join(f"{label} {np.abs(res).max():.3g}/{np.abs(card[2]).max():.3g} px"
                    f" {sec:.2f}/{card[3]:.2f}/{cpu[3]:.2f} s"
                    for (label, _, res, sec), card, cpu in zip(runs["default"], runs["card"], runs["cpu"]))
        + f"; exact fits card against CPU: every conversion's parameters within {worst:.3g} relative (limit 1e-9);"
        f" default against exact fits at most {apart:.3g} relative apart"
    )


def mesh_phase(camera, frames, points_xy, cuda, trace_dir: str, n_slices: int = 4, n_particles: int = 2048,
               n_steps: int = 10):
    """Phase 20: phase 6's tracker with its points cut into ``n_slices``
    mesh slices on one card, beside the tracker with no mesh, from the same
    injected draws; then one mesh step under ``profiling.device_trace``.
    Returns (the line to print, each kernel's launches in the mesh run)."""
    import torch

    from glimpse_tpu_torch import parallel, profiling

    n = len(points_xy)
    noise = injected_draws(n, n_particles, n_steps, cuda, seed=20)
    images = frames[: n_steps + 1, None]
    dts = torch.ones(n_steps, device=cuda)
    trackers = {
        "mesh": make_tracker(camera, points_xy, n_particles, cuda, mesh=parallel.get_mesh(devices=[cuda] * n_slices)),
        "none": make_tracker(camera, points_xy, n_particles, cuda),
    }

    def run(tracker):
        generator = torch.Generator(device=cuda).manual_seed(0)
        start = time.perf_counter()
        _, out = tracker.track(generator, images, dts, noise=noise)
        torch.cuda.synchronize()
        return out, time.perf_counter() - start

    for tracker in trackers.values():
        run(tracker)  # warm-up
    reset_launches()
    out_mesh, seconds_mesh = run(trackers["mesh"])
    launches = launch_counts()
    # One template high-pass a slice, then each step one high-pass, one
    # resample, one spline read and one front end a slice; no DEM prior.
    if launches != {"median_highpass": n_slices * (n_steps + 1), "systematic_resample": n_slices * n_steps,
                    "bspline_sample": n_slices * n_steps, "project_extract": n_slices * n_steps,
                    "dem_prior": 0}:
        raise AssertionError(f"the mesh run launched {launches}, not {n_slices} of each kernel a step")
    out_none, seconds_none = run(trackers["none"])
    diffs = {k: float((out_mesh[k] - out_none[k]).abs().max()) for k in out_none}
    step1, median_point, worst_point = free_run_bounds(*(o["mean"].cpu().numpy() for o in (out_mesh, out_none)))
    mesh = trackers["mesh"]
    state = mesh.initialize(torch.Generator(device=cuda).manual_seed(0), images[0])
    frame = images[1]
    mesh.step(state, frame, dts[0])
    torch.cuda.synchronize()
    with profiling.device_trace(trace_dir) as prof:
        start = time.perf_counter()
        mesh.step(state, frame, dts[0])
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - start) * 1e3

    def device_us(row):
        return getattr(row, "self_device_time_total", None) or getattr(row, "self_cuda_time_total", 0)

    kernels = sorted((r for r in prof.key_averages() if r.device_type == torch.autograd.DeviceType.CUDA
                      and device_us(r) > 0), key=device_us, reverse=True)
    busy_ms = sum(device_us(r) for r in kernels) / 1e3
    top = (
        f"{window_ms:.3f} ms under the profiler, device busy {busy_ms:.3f} ms, {sum(r.count for r in kernels)} kernel"
        " launches; longest kernels: "
        + ", ".join(f"{kernel_label(r.key)} {device_us(r) / 1e3:.2f} ms ({r.count})" for r in kernels[:5])
        if kernels else "device time not measured"
    )
    line = (
        f"{n}x{n_particles}x{n_steps} steps in {n_slices} mesh slices on one card against no mesh, same draws:"
        f" max |diff| " + ", ".join(f"{k} {v:.3g}" for k, v in diffs.items())
        + f" (step 1 {step1:.3g}, limit 1e-3; median point {median_point:.3g}, limit 1e-2; worst point"
        f" {worst_point:.3g}, limit 0.5); launches {launches}, {n_slices} of each kernel a step;"
        f" mesh {n * n_steps / seconds_mesh:.1f} point-steps/s ({seconds_mesh:.3f} s), no mesh"
        f" {n * n_steps / seconds_none:.1f} ({seconds_none:.3f} s); one mesh step traced to"
        f" {os.path.relpath(trace_dir, REPO)}/trace.json: {top}"
    )
    return line, launches


def mesh_checkpoint(camera, frames, points_xy, cuda, path: str, n_slices: int = 4, n_particles: int = 1024) -> str:
    """Phase 20's checkpoint: a ``MeshState`` of ``n_slices`` slices on the
    card, each drawing from its own generator, saved after 2 steps and
    resumed for 2 more, against the 4 uninterrupted steps: outputs and every
    slice's particles bit-equal. Returns the line's part."""
    import torch

    from glimpse_tpu_torch import parallel
    from glimpse_tpu_torch.track import checkpoint

    tracker = make_tracker(camera, points_xy, n_particles, cuda, mesh=parallel.get_mesh(devices=[cuda] * n_slices))
    dt = torch.tensor(1.0, device=cuda)

    def run(state, lo, hi):
        outs = []
        for t in range(lo, hi):
            state, out = tracker.step(state, frames[1 + t][None], dt)
            outs.append(out)
        return state, outs

    def fresh():
        return tracker.initialize(torch.Generator(device=cuda).manual_seed(11), frames[0][None])

    whole, whole_outs = run(fresh(), 0, 4)
    half, _ = run(fresh(), 0, 2)
    start = time.perf_counter()
    checkpoint.save_state(half, path)
    restored = checkpoint.load_state(path)
    seconds = time.perf_counter() - start
    resumed, resumed_outs = run(restored, 2, 4)
    equal = all(torch.equal(a.particles, b.particles) for a, b in zip(resumed.parts, whole.parts)) and all(
        torch.equal(a[k], b[k]) for a, b in zip(resumed_outs, whole_outs[2:]) for k in a
    )
    if not equal:
        raise AssertionError("the mesh run resumed from its checkpoint differs from the uninterrupted run")
    devices = sorted({str(p.generator.device) for p in restored.parts})
    return (
        f"{len(points_xy)}x{n_particles} in {n_slices} slices, each drawing from its own generator on {devices}:"
        f" saved after step 2 and resumed for 2 ({seconds:.2f} s to save and load), outputs and particles bit-equal"
        " to the uninterrupted run"
    )


PROCESS_WIDTHS = {"phase 6": (10240, 2048, 10), "phase 5": (1024, 1024, 50)}


def process_problem(width: str, device):
    """Phase 6's or phase 5's tracking problem, the same in every process:
    (frames (T, H, W) on ``device``, camera vector, points (N, 2), injected
    draws on ``device``)."""
    import torch

    n, p, t = PROCESS_WIDTHS[width]
    frames_np, camera, scene_rng = make_scene(t + 1)
    if width == "phase 5":
        points_xy = scene_rng.uniform(128, 384, size=(n, 2))
    else:
        points_xy = np.random.default_rng(2).uniform(128, 384, size=(n, 2))
    return torch.from_numpy(frames_np).to(device), camera, points_xy, injected_draws(n, p, t, device, seed=21)


def process_worker(spec: dict) -> None:
    """One process of phase 21: join the group over gloo, track this
    process's ``local_points_slice`` of each width (a warm-up pass, then two
    passes, each started at a barrier), stitch the means with
    ``gather_points`` and sum them with one ``all_reduce``; the results go
    to ``spec["outdir"]`` as JSON, and rank 0's stitched means as .npy."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    from glimpse_tpu_torch import parallel

    cuda = torch.device(spec["device"])
    if cuda.index is not None:
        torch.cuda.set_device(cuda)
    rank, world = spec["rank"], spec["world"]
    parallel.initialize_distributed(f"localhost:{spec['port']}", num_processes=world, process_id=rank)
    results = {}
    for width in spec["widths"]:
        n, p, t = PROCESS_WIDTHS[width]
        frames, camera, points_xy, noise = process_problem(width, cuda)
        local = parallel.local_points_slice(n)
        # Copies of this process's rows, so the whole draw is freed.
        noise = {"init": {k: v[local].clone() for k, v in noise["init"].items()}, "a": noise["a"][:, local].clone(),
                 "resample_u": noise["resample_u"][:, local].clone()}
        tracker = make_tracker(camera, points_xy[local], p, cuda)
        dts = torch.ones(t, device=cuda)

        def run():
            dist.barrier()
            start = time.perf_counter()
            _, out = tracker.track(torch.Generator(device=cuda).manual_seed(0), frames[:, None], dts, noise=noise)
            torch.cuda.synchronize()
            return out, time.perf_counter() - start

        run()
        torch.cuda.reset_peak_memory_stats(cuda)
        reset_launches()
        out, first = run()
        launches = launch_counts()
        out, second = run()
        peak = torch.cuda.max_memory_allocated(cuda)
        means = parallel.gather_points(out["mean"], n, axis=1)
        total = out["mean"].double().sum(dim=(0, 1)).cpu()
        dist.all_reduce(total)
        if rank == 0:
            np.save(os.path.join(spec["outdir"], f"{width.replace(' ', '')}_{world}.npy"), means.cpu().numpy())
        results[width] = {"seconds": [first, second], "peak": peak, "launches": launches, "total": total.tolist(),
                          "points": [local.start, local.stop]}
    with open(os.path.join(spec["outdir"], f"rank{rank}_{world}.json"), "w") as f:
        json.dump(results, f)
    dist.destroy_process_group()


def run_processes(devices, outdir: str, widths) -> list:
    """One :func:`process_worker` a device of ``devices`` (a device may
    repeat), joined over gloo on a free localhost port; waits for all of
    them (400 s at most) and returns each rank's results."""
    import socket

    world = len(devices)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker",
             json.dumps({"rank": rank, "world": world, "port": port, "outdir": outdir, "widths": list(widths),
                         "device": str(device)})],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for rank, device in enumerate(devices)
    ]
    try:
        outs = [proc.communicate(timeout=400) for proc in procs]
    finally:
        for proc in procs:
            proc.kill()
            proc.wait()
    for rank, (proc, (_, err)) in enumerate(zip(procs, outs)):
        if proc.returncode != 0:
            raise AssertionError(f"process {rank} of {world} exited {proc.returncode}: {err[-3000:]}")
    ranks = []
    for rank in range(world):
        with open(os.path.join(outdir, f"rank{rank}_{world}.json")) as f:
            ranks.append(json.load(f))
    return ranks


def process_phase(cuda, outdir: str, worlds=(1, 2, 4), widths=tuple(PROCESS_WIDTHS)):
    """Phase 21: ``worlds`` processes on the one card, each tracking its
    slice of each width (:func:`process_worker`); the stitched means of
    every world held to the one-process run's as phase 7 holds a free run,
    the collective's sum equal on every rank, the three kernels launched in
    every process. Returns (the line, each kernel's launches summed over the
    processes of the largest world's first timed pass of the first width)."""
    import torch

    torch.cuda.empty_cache()
    found = {}
    parts = []
    for world in worlds:
        start = time.perf_counter()
        ranks = run_processes([cuda] * world, outdir, widths)
        wall = time.perf_counter() - start
        found[world] = ranks
        for width in widths:
            n, p, t = PROCESS_WIDTHS[width]
            totals = [r[width]["total"] for r in ranks]
            if any(total != totals[0] for total in totals):
                raise AssertionError(f"phase 21 {world} processes, {width}: the all_reduce differs by rank: {totals}")
            for rank, r in enumerate(ranks):
                counted = r[width]["launches"]
                if (counted["median_highpass"] < t + 1 or counted["systematic_resample"] != t
                        or counted["bspline_sample"] != t or counted["project_extract"] != t):
                    raise AssertionError(f"phase 21 process {rank} of {world}, {width}: launches {r[width]['launches']}")
            means = np.load(os.path.join(outdir, f"{width.replace(' ', '')}_{world}.npy"))
            if means.shape != (t, n, 6) or not np.isfinite(means).all():
                raise AssertionError(f"phase 21 {world} processes, {width}: means {means.shape}")
            one = np.load(os.path.join(outdir, f"{width.replace(' ', '')}_1.npy"))
            bounds = free_run_bounds(means, one)
            parting = int((np.abs(means - one).max(axis=(0, 2)) > 1e-3).sum())
            # Each pass starts at a barrier: the slowest rank's seconds are the pass's.
            seconds = min(max(r[width]["seconds"][i] for r in ranks) for i in range(2))
            peaks = "/".join(f"{r[width]['peak'] / 2**30:.2f}" for r in ranks)
            counts = "/".join("{median_highpass}+{systematic_resample}+{bspline_sample}+{project_extract}".format(
                **r[width]["launches"]) for r in ranks)
            parts.append(
                f"{world} process{'es' if world > 1 else ''} at {width}'s {n}x{p}x{t}:"
                f" {n * t / seconds:.1f} point-steps/s ({seconds:.3f} s, the slowest rank of the better pass),"
                f" peak {peaks} GiB a rank, launches (high-pass+resample+spline+front end) a rank {counts},"
                f" against 1 process step 1 {bounds[0]:.3g}, median point {bounds[1]:.3g}, worst point {bounds[2]:.3g},"
                f" {parting} points apart by over 1e-3"
            )
        parts[-len(widths)] += f" [{wall:.1f} s with the processes' start]"
    largest = found[max(worlds)]
    launches = {k: sum(r[widths[0]]["launches"][k] for r in largest) for k in kernel_wrappers()}
    return "; ".join(parts) + "; the all_reduce'd sum equal on every rank", launches


def sse_modes_phase(camera, frames, points_xy, cuda, noise, devices, n_particles: int = 2048, n_steps: int = 10,
                    small=(16, 256, 6)):
    """Phase 22: phase 6's tracker in each ``sse_sample_mode`` from the same
    injected draws: point-steps/s (best of two passes after a warm-up), peak
    memory, |diff| of the means against the exact mode, one profiled step;
    then each mode on the card against the CPU at ``small`` = (points,
    particles, frames), each step from a shared state within 1e-3. Returns
    (the line, each kernel's launches in the timed passes of every mode)."""
    import torch

    modes = {"einsum": {}, "nearest": {"sse_sample_mode": "nearest", "sse_upsample": 8},
             "bilinear": {"sse_sample_mode": "bilinear", "sse_upsample": 8}}
    n = len(points_xy)
    images = frames[: n_steps + 1, None]
    dts = torch.ones(n_steps, device=cuda)
    means, parts = {}, []
    launches = dict.fromkeys(kernel_wrappers(), 0)
    for mode, settings in modes.items():
        tracker = make_tracker(camera, points_xy, n_particles, cuda, **settings)

        def run():
            start = time.perf_counter()
            _, out = tracker.track(torch.Generator(device=cuda).manual_seed(0), images, dts, noise=noise)
            torch.cuda.synchronize()
            return out, time.perf_counter() - start

        run()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        timed = [run() for _ in range(2)]
        for name, count in launch_counts().items():
            launches[name] += count
        peak = torch.cuda.max_memory_allocated()
        means[mode] = timed[-1][0]["mean"].cpu().numpy()
        if not np.isfinite(means[mode]).all():
            raise AssertionError(f"phase 22 {mode}: non-finite means")
        seconds = min(r[1] for r in timed)
        state = tracker.initialize(torch.Generator(device=cuda).manual_seed(0), images[0])
        per_point = np.abs(means[mode] - means["einsum"]).max(axis=(0, 2))
        parts.append(
            f"{mode}{' x' + str(settings['sse_upsample']) if settings else ''}: {n * n_steps / seconds:.1f}"
            f" point-steps/s ({seconds:.3f} s), peak {peak / 2**30:.2f} GiB, |diff| of the means against einsum"
            f" median point {np.median(per_point):.3g} worst {per_point.max():.3g}; "
            + profile_step(tracker, state, images[1])
        )
    n22, p22, t22 = small
    draws = np.random.default_rng(22)
    small_noise = {
        "init": {"xy": draws.normal(size=(n22, p22, 2)).astype(np.float32),
                 "v": draws.normal(size=(n22, p22, 3)).astype(np.float32)},
        "a": draws.normal(size=(t22 - 1, n22, p22, 3)).astype(np.float32),
        "resample_u": draws.random((t22 - 1, n22)).astype(np.float32),
    }
    host_images = frames[:t22, None].cpu().numpy()
    carried = {}
    for mode, settings in modes.items():
        pair = {k: make_tracker(camera, points_xy[:n22], p22, d, **settings) for k, d in devices.items()}
        carried[mode], flags = lockstep_from_shared_state(pair["card"], pair["cpu"], host_images, small_noise, t22 - 1)
        if carried[mode] > 1e-3 or flags:
            raise AssertionError(f"phase 22 {mode}: card and CPU part by {carried[mode]} from a shared state,"
                                 f" {flags} validity flags differ")
    return (
        f"{n}x{n_particles}x{n_steps}, 41x41 search boxes, 15x15 templates: " + "; ".join(parts)
        + f"; card against CPU at {n22}x{p22}x{t22 - 1}, each step from a shared state: "
        + ", ".join(f"{mode} {v:.3g}" for mode, v in carried.items()) + " (limit 1e-3)"
    ), launches


# Phase 23's element types: every dtype the tracker takes, float32 first.
PRECISIONS = ("float32", "bfloat16", "float16", "float64")
# The main path's high-pass stacks, 5x5 taps: phase 8's search tiles, phase
# 14's search tiles and templates.
PRECISION_TILES = ((20480, 31, 31), (10240, 41, 41), (10240, 15, 15))


# Stacks whose tiles the staged 16-bit kernel cannot all pair (it packs
# two tiles of a block's group into one register, lane by lane): one tile,
# odd counts, N = 37 (a partial last group at every width), and stacks that
# start one element into their storage (2 bytes past a 4-byte boundary in
# 16 bits); (shape, misaligned), each held in every separable window in
# bfloat16, float16 and float64 (phase 23 (a), tests/test_torch_cuda.py).
LANE_CASES = (
    ((1, 31, 31), False), ((1, 15, 15), False), ((3, 41, 41), False), ((37, 31, 31), False),
    ((37, 15, 15), True), ((37, 41, 41), True), ((131, 31, 31), True),
)


def dtype_ulp(dtype, magnitude: float) -> float:
    """The spacing of ``dtype`` at ``magnitude``."""
    import torch

    finfo = torch.finfo(dtype)
    return finfo.eps * 2.0 ** np.floor(np.log2(max(magnitude, finfo.tiny)))


def precision_tiles(shape, dtype, device, seed: int):
    """Normal tiles (N, h, w) of ``dtype`` on ``device``; float64 ones hold
    values float32 cannot."""
    import torch

    rng = np.random.default_rng(seed)
    tiles = rng.normal(size=shape)
    if dtype != torch.float64:
        tiles = tiles.astype(np.float32)
    return torch.from_numpy(tiles).to(device, dtype)


def precision_kernels(cuda, hbm_bytes_per_s: float):
    """Phase 23 (a): both kernels in bfloat16, float16 and float64 against
    their plain versions on the card, bit for bit, at the main path's
    shapes, then on phase 3's held cases (ties, NaN, +-inf, every window,
    the smallest tiles, one stack one element past a 16-byte line), on
    LANE_CASES in every separable window, phase 3's large tiles, held and
    timed, and the resample at N = 37 with
    thresholds tied to slots. Returns (the line, {kernel: [one record a
    dtype and shape], "large_tiles": [...]}, the largest mismatch)."""
    import torch

    from glimpse_tpu_torch.kernels.highpass import SEPARABLE, kernel_variant, median_highpass, median_highpass_plain
    from glimpse_tpu_torch.kernels.resample import systematic_resample, systematic_resample_plain
    from glimpse_tpu_torch.ops.resampling import systematic_thresholds

    records = {"median_highpass": [], "systematic_resample": [], "large_tiles": []}
    parts, err = [], 0.0
    for name in PRECISIONS[1:]:
        dtype = getattr(torch, name)
        size = torch.finfo(dtype).bits // 8
        for k, shape in enumerate(PRECISION_TILES):
            tiles = precision_tiles(shape, dtype, cuda, seed=230 + k)
            got, want = median_highpass(tiles, (5, 5)), median_highpass_plain(tiles, (5, 5))
            if got.dtype != dtype or not torch.equal(got, want):
                raise AssertionError(f"phase 23 median_highpass {name} {shape} differs from its plain version")
            ms = _cuda_ms(lambda: median_highpass(tiles, (5, 5)))
            plain_ms = _cuda_ms(lambda: median_highpass_plain(tiles, (5, 5)))
            bound = 2 * int(np.prod(shape)) * size / hbm_bytes_per_s * 1e3
            records["median_highpass"].append({"dtype": name, "shape": list(shape), "ms": ms, "plain_ms": plain_ms,
                                               "bound_ms": bound, "bound_share": bound / ms,
                                               "variant": kernel_variant((5, 5), dtype, shape)})
            del tiles, got, want
        held = 0
        for label, shape, window, specials, misaligned in highpass_check_cases():
            tiles = highpass_case_tiles(shape, specials, misaligned, cuda, dtype=dtype)
            got, want = median_highpass(tiles, window), median_highpass_plain(tiles, window)
            torch.testing.assert_close(
                got, want, rtol=0, atol=0, equal_nan=True,
                msg=lambda m: f"phase 23 median_highpass ({kernel_variant(window, dtype, shape)}) on {label} {shape}: {m}",
            )
            err = max(err, highpass_mismatch(got, want))
            held += 1
        for shape, misaligned in LANE_CASES:
            for window in sorted(SEPARABLE):
                tiles = highpass_case_tiles(shape, True, misaligned, cuda, seed=shape[0], dtype=dtype)
                got, want = median_highpass(tiles, window), median_highpass_plain(tiles, window)
                torch.testing.assert_close(
                    got, want, rtol=0, atol=0, equal_nan=True,
                    msg=lambda m: f"phase 23 median_highpass ({kernel_variant(window, dtype, shape)}) on lanes {shape}: {m}",
                )
                err = max(err, highpass_mismatch(got, want))
                held += 1
        rng = np.random.default_rng(231)
        for n, p in ((10240, 2048), (37, 1024)):
            weights = torch.from_numpy(np.exp(3 * rng.normal(size=(n, p))).astype(np.float32)).to(cuda, dtype)
            u = torch.from_numpy(rng.random(n).astype(np.float32)).to(cuda)
            t = systematic_thresholds(weights, u)
            if n == 37:
                t[::2] = torch.round(t[::2] * 4) / 4  # thresholds tied with slots
            particles = precision_tiles((n, p, 6), dtype, cuda, seed=232)
            got, want = systematic_resample(t, particles, weights), systematic_resample_plain(t, particles, weights)
            if got[0].dtype != dtype or not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                raise AssertionError(f"phase 23 systematic_resample {name} {n}x{p} differs from its plain version")
            if n == 37:
                continue
            ms = _cuda_ms(lambda: systematic_resample(t, particles, weights))
            plain_ms = _cuda_ms(lambda: systematic_resample_plain(t, particles, weights))
            bound = n * p * (4 + 14 * size) / hbm_bytes_per_s * 1e3
            records["systematic_resample"].append({"dtype": name, "shape": [n, p], "ms": ms, "plain_ms": plain_ms,
                                                   "bound_ms": bound, "bound_share": bound / ms})
        large, large_err = large_tiles(cuda, dtype, hbm_bytes_per_s)
        records["large_tiles"] += large
        err = max(err, large_err)
        hp = [r for r in records["median_highpass"] if r["dtype"] == name]
        rs = records["systematic_resample"][-1]
        parts.append(
            f"{name}: high-pass 5x5 ({kernel_variant((5, 5), dtype, PRECISION_TILES[0])}) "
            + ", ".join(f"{r['shape'][1]}x{r['shape'][2]}x{r['shape'][0]} {r['ms']:.4f} ms (plain {r['plain_ms']:.4f},"
                        f" bound {r['bound_ms']:.4f}, {100 * r['bound_share']:.1f} %)" for r in hp)
            + f", {held} held cases (lanes without a partner among them), large tiles {describe_large_tiles(large)}; resample 10240x2048 {rs['ms']:.4f} ms"
            f" (plain {rs['plain_ms']:.4f}, bound {rs['bound_ms']:.4f}, {100 * rs['bound_share']:.1f} %), N = 37 with"
            " tied thresholds bit-equal"
        )
    return "; ".join(parts), records, err


def precision_trackers(camera, frames, points_xy, cuda, n_particles: int = 2048, n_steps: int = 10):
    """Phase 23 (b): phase 6's tracker in each dtype from the same generator
    draws (a warm-up pass, then one timed pass with the launch counts set
    to 0 just before it): point-steps/s, peak memory, each kernel's launches
    a step, and the median and worst point's distance at the last step from
    the float32 run. Returns (the line, {dtype: launches})."""
    import torch


    n = len(points_xy)
    parts, launches, last = [], {}, {}
    for name in PRECISIONS:
        dtype = getattr(torch, name)
        tracker = make_tracker(camera, points_xy, n_particles, cuda, dtype=dtype)
        run_tracker(tracker, frames[: n_steps + 1], seed=0)
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        out, seconds = run_tracker(tracker, frames[: n_steps + 1], seed=2)
        launches[name] = launch_counts()
        if (launches[name]["median_highpass"] < n_steps + 1 or launches[name]["systematic_resample"] != n_steps
                or launches[name]["bspline_sample"] != n_steps or launches[name]["project_extract"] != n_steps):
            raise AssertionError(f"phase 23 {name}: the kernels did not carry the run: {launches[name]}")
        peak = torch.cuda.max_memory_allocated()
        if out["mean"].dtype != dtype or not torch.isfinite(out["mean"]).all():
            raise AssertionError(f"phase 23 {name}: means of {out['mean'].dtype}, finite {torch.isfinite(out['mean']).all()}")
        last[name] = out["mean"][-1, :, 0:2].double().cpu().numpy()
        distance = np.linalg.norm(last[name] - last["float32"], axis=-1)
        parts.append(
            f"{name} {n * n_steps / seconds:.1f} point-steps/s ({seconds:.3f} s), peak {peak / 2**30:.2f} GiB,"
            f" launches {launches[name]['median_highpass']} high-pass (one a step and the templates'),"
            f" {launches[name]['systematic_resample']} resample and {launches[name]['bspline_sample']} spline read"
            f" in {n_steps} steps, distance from float32 at step"
            f" {n_steps} median {np.median(distance):.4g} worst {distance.max():.4g}"
        )
        del tracker, out
    return f"{n}x{n_particles}x{n_steps}: " + "; ".join(parts), launches


def precision_lockstep(camera, frames_np, points_xy, devices, dtype, small=(16, 256, 6)):
    """Phase 23 (d): the tracker in ``dtype`` on the card and on the CPU,
    each step from the CPU's carried state, held by the CPU tests' rule:
    |card - CPU| <= max |CPU in dtype - CPU in float32| + one ulp of the
    dtype at the means' magnitude. Returns (largest |card - CPU|, its
    budget)."""
    import torch

    n, p, t = small
    draws = np.random.default_rng(23)
    noise = {
        "init": {"xy": draws.normal(size=(n, p, 2)).astype(np.float32),
                 "v": draws.normal(size=(n, p, 3)).astype(np.float32)},
        "a": draws.normal(size=(t - 1, n, p, 3)).astype(np.float32),
        "resample_u": draws.random((t - 1, n)).astype(np.float32),
    }
    cpu, cuda = devices["cpu"], devices["card"]
    card = make_tracker(camera, points_xy[:n], p, cuda, dtype=dtype)
    host = make_tracker(camera, points_xy[:n], p, cpu, dtype=dtype)
    wide = make_tracker(camera, points_xy[:n], p, cpu)
    images = torch.from_numpy(frames_np[:t, None])
    state = host.initialize(torch.Generator().manual_seed(0), images[0], noise=noise["init"])
    state32 = wide.initialize(torch.Generator().manual_seed(0), images[0], noise=noise["init"])
    error, budget = 0.0, 0.0
    for i in range(t - 1):
        step_noise = {"a": noise["a"][i], "resample_u": noise["resample_u"][i]}
        on_card = dataclasses.replace(
            state, generator=torch.Generator(device=cuda),
            **{k: getattr(state, k).to(cuda) for k in ("particles", "weights", "templates", "template_table",
                                                        "template_duv", "valid")},
        )
        _, card_out = card.step(on_card, images[i + 1].to(cuda), torch.tensor(1.0, device=cuda), noise=step_noise)
        state, host_out = host.step(state, images[i + 1], torch.tensor(1.0), noise=step_noise)
        state32, wide_out = wide.step(state32, images[i + 1], torch.tensor(1.0), noise=step_noise)
        got, want, ref32 = (x["mean"].double().cpu() for x in (card_out, host_out, wide_out))
        step_error = float((got - want).abs().max())
        step_budget = float((want - ref32).abs().max()) + dtype_ulp(dtype, float(want.abs().max()))
        if step_error > step_budget:
            raise AssertionError(f"phase 23 {dtype} step {i + 1}: |card - CPU| {step_error} > {step_budget}")
        error, budget = max(error, step_error), max(budget, step_budget)
    return error, budget


@contextlib.contextmanager
def eager_steps(tracker):
    """``tracker``'s ``track`` and ``track_stream`` with every step through
    the eager ``step``, as they ran before step programs: each slice's
    ``_advance`` is its ``step`` while the block runs."""
    parts = getattr(tracker, "parts", [tracker])
    for part in parts:
        part._advance = part.step
    try:
        yield
    finally:
        for part in parts:
            del part._advance


#: Seconds a profiled step waits after the profiler starts (:func:`profile_graphed_step`).
PROFILE_LEAD_S = 0.2


def profile_graphed_step(tracker, first, frame, dt, init=None, **kwargs) -> dict:
    """One eager ``step`` and one replayed step (``_advance`` after its
    warm-up step and capture) from ``first``'s state under the profiler:
    for each, the window's ms, the device's busy ms, the idle share, the
    host's kernel launch and ``cudaGraphLaunch`` calls, all CUDA API calls,
    and the kernels' names; busy None where the profiler saw no device
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def profiled(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            # A profile opened late in a process that has profiled before can
            # miss the records of the first kernels it sees, more of them the
            # longer the process has run; with this lead, every profiled replay
            # of phase 27 kept all of its kernels (PERF.md, sections 6 and 7).
            time.sleep(PROFILE_LEAD_S)
            start = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            window_ms = (time.perf_counter() - start) * 1e3
        return profile_window(prof, window_ms)

    state = tracker.initialize(torch.Generator(device=dt.device).manual_seed(0), first, **(init or {}))
    for _ in range(2):
        tracker.step(state, frame, dt, **kwargs)
    eager = profiled(lambda: tracker.step(state, frame, dt, **kwargs))
    try:
        warm, _ = tracker._advance(state, frame, dt, **kwargs)  # the key's eager first step
        captured, _ = tracker._advance(warm, frame, dt, **kwargs)  # capture, then the first replay
        graphed = profiled(lambda: tracker._advance(captured, frame, dt, **kwargs))
    finally:
        tracker._release()
    return {"eager": eager, "graphed": graphed}


def graphs_phase(shapes: dict) -> Tuple[List[str], dict]:
    """Phase 27: each shape's run eager (:func:`eager_steps`) and graphed in
    turns in this process, eager first, then graphed first (E, G, G, E),
    each from the same generator seed; then one eager and one replayed step
    under the profiler (:func:`profile_graphed_step`).

    ``shapes`` maps a name to ``run`` (the tracker and a function that runs
    one pass, returning (final state, time-major outputs)), the points and
    steps a pass, and ``profile`` (the arguments of
    :func:`profile_graphed_step`). Raises unless the two eager runs are
    bit-equal to each other and each graphed run to them (every step's
    means, sigmas and validity, the final particles and weights), each
    kernel's launches are equal across the four, and the replay's profile
    shows the four kernels' names where the profiler sees the card. Returns
    (one line a shape, each kernel's launches in each shape's first graphed
    run)."""
    import torch

    from glimpse_tpu_torch.track.batch import StepProgram

    captures = []
    build = StepProgram.__init__

    def timed_build(self, *args):
        start = time.perf_counter()
        build(self, *args)
        captures.append(time.perf_counter() - start)

    lines, launches = [], {name: {} for name in kernel_wrappers()}
    StepProgram.__init__ = timed_build
    try:
        for name, spec in shapes.items():
            lines.append(_graphs_shape(name, spec, captures, launches))
    finally:
        StepProgram.__init__ = build
    return lines, launches


def _graphs_shape(name: str, spec: dict, captures: list, launches: dict) -> str:
    """One shape of :func:`graphs_phase`: its line; each kernel's launches
    in its first graphed run go into ``launches``."""
    import torch

    tracker, run = spec["run"]
    records = []
    for kind in ("eager", "graphed", "graphed", "eager"):
        reset_launches()
        captures.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        start = time.perf_counter()
        with eager_steps(tracker) if kind == "eager" else contextlib.nullcontext():
            state, out = run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        parts = getattr(state, "parts", [state])
        records.append({
            "kind": kind, "seconds": seconds, "peak": torch.cuda.max_memory_allocated() - base, "out": out,
            "captures": list(captures),
            "final": {f: torch.cat([getattr(p, f) for p in parts]) for f in ("particles", "weights")},
            "launches": tuple(launch_counts().values()),
        })
    for kernel, count in zip(kernel_wrappers(), records[1]["launches"]):
        launches[kernel][name] = count

    def same(a, b):
        return all(torch.equal(a["out"][k], b["out"][k]) for k in a["out"]) and all(
            torch.equal(a["final"][f], b["final"][f]) for f in a["final"])

    def spread(a, b):
        return max([float((a["out"][k].double() - b["out"][k].double()).abs().max()) for k in a["out"]]
                   + [float((a["final"][f].double() - b["final"][f].double()).abs().max()) for f in a["final"]])

    if not same(records[0], records[3]):
        raise AssertionError(f"phase 27 {name}: two eager runs from one seed part by {spread(records[0], records[3])}")
    for graphed in (records[1], records[2]):
        if not same(graphed, records[0]):
            raise AssertionError(f"phase 27 {name}: a graphed run parts from the eager runs by"
                                 f" {spread(graphed, records[0])}")
    engaged = [n for kernel, n in zip(kernel_wrappers(), records[0]["launches"]) if kernel not in PRIOR_KERNELS]
    if len({r["launches"] for r in records}) != 1 or min(engaged) < 1:
        raise AssertionError(f"phase 27 {name}: launches {[r['launches'] for r in records]}")
    profiles = profile_graphed_step(tracker, *spec["profile"][0], **spec["profile"][1])
    replay = profiles["graphed"]
    if replay["graph_launches"] < 1:
        raise AssertionError(f"phase 27 {name}: no cudaGraphLaunch in a replayed step: {replay}")
    if replay["busy_ms"] is not None:
        names = " ".join(replay["kernels"])
        missing = [k for k in (r"project_extract_kernel", r"systematic_resample_kernel", r"spline_sample_kernel",
                               r"(separable|generic)\w*_kernel") if not re.search(k, names)]
        if missing:
            raise AssertionError(f"phase 27 {name}: {missing} not among the replay's {len(replay['kernels'])} kernels:"
                                 f" {[kernel_label(k) for k in replay['kernels']]}")

    n, steps = spec["points"], spec["steps"]

    def described(r):
        capture = (f", {len(r['captures'])} captures of {sum(r['captures']) * 1e3:.1f} ms on the host"
                   if r["captures"] else "")
        return (f"{r['kind']} {n * steps / r['seconds']:.1f} point-steps/s ({r['seconds'] / steps * 1e3:.3f} ms a"
                f" step, peak {r['peak'] / 2**30:.2f} GiB above the run's start{capture})")

    return (
        f"phase 27 graphs against eager, {name}: " + ", ".join(described(r) for r in records)
        + f"; every step's means, sigmas, validity and the final particles and weights bit-equal in all four"
        f" runs (eager against eager too); launches {records[0]['launches']} in each; one eager step:"
        f" {describe_profile(profiles['eager'])}; one replayed step: {describe_profile(replay)}"
        + ("" if replay["busy_ms"] is None else ", the four kernels among its kernels")
    )


# ---- Phase 28: the calibration and stabilization programs ---- #


class OneIterationProfile:
    """L-BFGS steps (``optimize._TensorSteps`` or ``optimize.LBFGSPrograms``)
    whose iteration ``at`` (1-based) runs under ``torch.profiler``: from its
    direction to the next one, so the window holds one direction, its line
    search's evaluations, the step's acceptance, the stopping test and the
    next history push. :attr:`profile` is :func:`profile_window`'s dict plus
    the evaluations in the window."""

    def __init__(self, steps, at: int, evaluations) -> None:
        self.steps, self.at, self.count = steps, at, evaluations
        self.directions = 0
        self.profile = None

    def __getattr__(self, name):
        return getattr(self.steps, name)

    def direction(self, gamma, rho):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.directions += 1
        if self.directions == self.at:
            torch.cuda.synchronize()
            self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self._prof.__enter__()
            self._start, self._evals = time.perf_counter(), self.count()
        elif self.directions == self.at + 1:
            torch.cuda.synchronize()
            window_ms = (time.perf_counter() - self._start) * 1e3
            self._prof.__exit__(None, None, None)
            self.profile = dict(profile_window(self._prof, window_ms), evaluations=self.count() - self._evals)
        return self.steps.direction(gamma, rho)


def profile_window(prof, window_ms: float) -> dict:
    """A finished profile's window: ms, the device's busy ms (the union of
    its kernels', copies' and sets' intervals in the exported trace, so
    overlapping kernels count once) and idle share (busy None where the
    profiler saw no device time), the host's kernel launch,
    ``cudaGraphLaunch`` and memory copy calls, all CUDA API calls, and the
    kernels' count and names."""
    import torch

    def device_us(row):
        return getattr(row, "self_device_time_total", None) or getattr(row, "self_cuda_time_total", 0)

    rows = prof.key_averages()
    kernels = [r for r in rows if r.device_type == torch.autograd.DeviceType.CUDA and device_us(r) > 0]
    api = {r.key: r.count for r in rows if r.device_type == torch.autograd.DeviceType.CPU and r.key.startswith("cu")}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        busy_ms = busy_s(load_chrome(path, 1, {}, "").device_ops) * 1e3 or None
    return {
        "window_ms": window_ms, "busy_ms": busy_ms,
        "idle": None if busy_ms is None else max(0.0, 1 - busy_ms / window_ms),
        "launch_calls": sum(api.get(k, 0) for k in LAUNCH_CALLS), "graph_launches": api.get("cudaGraphLaunch", 0),
        "copies": sum(v for k, v in api.items() if k.startswith("cudaMemcpy")), "api_calls": sum(api.values()),
        "kernel_launches": sum(r.count for r in kernels), "kernels": [r.key for r in kernels],
    }


def describe_profile(p: dict) -> str:
    measured = ("device time not measured" if p["busy_ms"] is None else
                f"device busy {p['busy_ms']:.3f} ms, idle share {p['idle']:.3f}")
    return (f"{p['window_ms']:.3f} ms under the profiler, {measured}, {p['kernel_launches']} kernels; host calls"
            f" {p['launch_calls']} cudaLaunchKernel, {p['graph_launches']} cudaGraphLaunch, {p['copies']} memory"
            f" copies, {p['api_calls']} CUDA API calls in all")


def fit_programs(model, cuda, iterations: int = 200, memory: int = 30, profile_at: int = 41) -> str:
    """Phase 28 (a): ``model``'s fit objective (``ObserverCameras``) through
    ``iterations`` L-BFGS iterations eager (``optimize._TensorSteps``) and
    through its programs (``optimize.LBFGSPrograms``) in turns (E, G, G, E)
    from the same start: x, value, gradient and iterations bit-equal across
    the four, the same evaluations; then iteration ``profile_at`` (the
    history full, each program replaying) under the profiler each way.
    Raises on a failed check; returns the line."""
    import torch

    from glimpse_tpu_torch import optimize

    free = np.setdiff1d(np.arange(len(model.viewdirs)), np.asarray(model.anchors, dtype=int))
    value = model.objective(free)
    x0 = torch.as_tensor(np.asarray(model.initialize(), dtype=np.float32)[free].ravel(), device=cuda)
    counted = {"n": 0}

    def value_and_grad(flat):  # as ObserverCameras._fit_lbfgs_device's
        counted["n"] += 1
        flat = flat.detach().requires_grad_(True)
        v = value(flat)
        (g,) = torch.autograd.grad(v, flat)
        return v.detach(), g

    def steps_of(kind):
        if kind == "eager":
            return optimize._TensorSteps(value_and_grad, x0), lambda: counted["n"] - 1
        steps = optimize.LBFGSPrograms(value_and_grad, x0, memory)
        return steps, lambda: steps.evaluations

    runs = []
    for kind in ("eager", "graphed", "graphed", "eager"):
        steps, evaluations = steps_of(kind)
        counted["n"] = 0
        torch.cuda.synchronize()
        start = time.perf_counter()
        x, fval, grad, n_iter = optimize._lbfgs_loop(steps, iterations, 1e-7, memory)
        torch.cuda.synchronize()
        runs.append({"kind": kind, "seconds": time.perf_counter() - start, "x": x, "value": fval, "grad": grad,
                     "n_iter": n_iter, "evaluations": evaluations()})
    first = runs[0]
    for run in runs[1:]:
        if not (torch.equal(run["x"], first["x"]) and run["value"] == first["value"]
                and torch.equal(run["grad"], first["grad"]) and run["n_iter"] == first["n_iter"]
                and run["evaluations"] == first["evaluations"]):
            raise AssertionError(
                f"phase 28 (a): the {run['kind']} fit parts from the eager one: max |dx|"
                f" {float((run['x'] - first['x']).abs().max())}, values {run['value']} and {first['value']},"
                f" iterations {run['n_iter']} and {first['n_iter']}, evaluations {run['evaluations']} and"
                f" {first['evaluations']}")
    profiles = {}
    for kind in ("eager", "graphed"):
        steps, evaluations = steps_of(kind)
        probe = OneIterationProfile(steps, profile_at, evaluations)
        optimize._lbfgs_loop(probe, profile_at + 1, 1e-7, memory)
        profiles[kind] = probe.profile
    graphed = profiles["graphed"]
    if graphed["graph_launches"] > graphed["evaluations"] + 1 or graphed["launch_calls"]:
        raise AssertionError(f"phase 28 (a): a replayed iteration launched more than its programs: {graphed}")
    described = ", ".join(f"{r['kind']} {r['seconds'] / r['n_iter'] * 1e3:.3f} ms an iteration" for r in runs)
    return (
        f"phase 28 (a) the fit: {len(model.viewdirs)} frames, {len(x0)} free parameters, {iterations} iterations"
        f" (memory {memory}): {described}; {first['evaluations']} evaluations in each; x, value, gradient and"
        f" iterations bit-equal in all four runs (eager against eager too); iteration {profile_at} eager"
        f" ({profiles['eager']['evaluations']} evaluations): {describe_profile(profiles['eager'])}; replayed"
        f" ({graphed['evaluations']} evaluations): {describe_profile(graphed)}"
    )


def jacobian_programs(cuda, fits17: dict, sizes=None) -> str:
    """Phase 28 (b): each of phase 17's problems' exact Jacobian at its
    start, eager (``optimize._exact_jacobian`` on fresh tensors) and through
    the model's program (``Cameras._autodiff_jac``, after its eager first
    call and its capture) in turns (E, G, G, E): ms a call (CUDA events,
    copies to and from the host included), the four bit-equal; beside each,
    phase 17's fit seconds with the exact Jacobian (graphed) and with
    2-point differences. Raises on a failed check; returns the line."""
    import torch

    from glimpse_tpu_torch import Camera, optimize

    parts = []
    for name, build_problem in BA_PROBLEMS.items():
        model, _ = build_problem(Camera, optimize, device=cuda, **(sizes or {}).get(name, {}))
        x0 = model.values.copy()
        scatter, assign, residual_array, fixed = model._build_autodiff_residual()
        base = torch.as_tensor(np.stack([c.to_array() for c in model.cams + fixed]), dtype=torch.float64, device=cuda)

        def eager():
            params = torch.as_tensor(x0, dtype=torch.float64, device=cuda)
            return optimize._exact_jacobian(scatter, assign, residual_array, params, base).cpu().numpy()

        jac = model._autodiff_jac()

        def graphed():
            return jac(x0)

        for _ in range(2):  # the eager first call, then the capture
            graphed()
        times, values = [], []
        for fn in (eager, graphed, graphed, eager):
            values.append(fn())
            times.append(_cuda_ms(fn, reps=5))
        if not all(np.array_equal(v, values[0]) for v in values[1:]):
            raise AssertionError(f"phase 28 (b) {name}: the Jacobians part by"
                                 f" {max(float(np.abs(v - values[0]).max()) for v in values[1:])}")
        walls = fits17.get(name, {})
        fits = (f"; phase 17's fits: exact {'/'.join(f'{w:.3f}' for w in walls.get('exact', []))} s (cold/warm),"
                f" 2-point {'/'.join(f'{w:.3f}' for w in walls.get('2-point', []))} s" if walls else "")
        parts.append(f"{name} {values[0].shape[0]}x{values[0].shape[1]}: eager {times[0]:.3f} / {times[3]:.3f} ms a"
                     f" call, graphed {times[1]:.3f} / {times[2]:.3f} ms, bit-equal{fits}")
    return "phase 28 (b) the exact Jacobian: " + "; ".join(parts)


def chunk_programs(frames: np.ndarray, mask: np.ndarray, cuda, batch: int = 16) -> str:
    """Phase 28 (c): one chunk of each stabilization stage at phase 18's
    shapes, eager and through its program in turns (E, G, G, E), ms a call
    (CUDA events, the program after its eager first call and its capture;
    copies in and out included both ways), outputs bit-equal: detection of
    ``batch`` frames (with ``mask``, 2,048 keypoints), matching of 32 pairs
    of their padded descriptor stacks (2,048 x 2,048 x 128, ratio 0.75), and
    refinement of 8 pairs x 3,072 matches (template 11, search 25, 4
    Newton steps). Raises on a failed check; returns the line."""
    import torch

    from glimpse_tpu_torch.ops import features, matching, refine

    images = np.ascontiguousarray(frames[:batch], dtype=np.uint8)
    masks = np.broadcast_to(np.asarray(mask) > 0, images.shape).astype(np.uint8)
    settings = dict(nfeatures=2048, refine="lattice")
    detect = features.BatchProgram(images.shape, True, cuda, **settings)

    def detect_eager():
        return features.detect_batch(torch.from_numpy(images).to(cuda), torch.from_numpy(masks).to(cuda), **settings)

    found = [t.cpu() for t in detect_eager()]
    pairs = sorted((i, j) for i in range(batch) for j in (i + 1, i + 2, i + 8) if j < batch)[:32]
    descs = [found[3][i][found[4][i]].numpy() for i in range(batch)]
    matcher = matching.DescriptorMatcher(device=cuda)
    n_pad = 2048
    stacks = [matcher._device_stack(d, n_pad) for d in descs]
    da, db = [stacks[i] for i, _ in pairs], [stacks[j] for _, j in pairs]
    na, nb = [len(descs[i]) for i, _ in pairs], [len(descs[j]) for _, j in pairs]
    match = matching.BatchProgram(len(pairs), n_pad, n_pad, 128, False, cuda)

    def match_eager():
        return [t.cpu().numpy() for t in matching.match_batch(
            torch.stack(da), torch.stack(db), torch.tensor(na, device=cuda), torch.tensor(nb, device=cuda),
            float(np.float32(0.75)), False)]

    rng = np.random.default_rng(28)
    tiles = [torch.from_numpy(f.astype(np.float32)).to(cuda) for f in images[:9]]
    H, W = images.shape[1:]
    ca = np.stack([np.column_stack([rng.integers(0, H - 11, 3072), rng.integers(0, W - 11, 3072)]) for _ in range(8)])
    cb = np.clip(ca - 7 + rng.integers(-3, 4, size=ca.shape), 0, [H - 25, W - 25])
    chunk = refine.ChunkProgram(8, 3072, H, W, 11, 25, 4, cuda)

    def refine_eager():
        return [t.cpu().numpy() for t in refine.refine_chunk(
            torch.stack(tiles[:8]), torch.stack(tiles[1:]), torch.from_numpy(ca).to(cuda), torch.from_numpy(cb).to(cuda),
            11, 25, 4)]

    stages = {
        f"detection of {batch} frames of {H}x{W}": (lambda: [t.cpu().numpy() for t in detect_eager()],
                                                    lambda: [t.cpu().numpy() for t in detect(images, masks)]),
        f"matching of {len(pairs)} pairs of {n_pad}x{n_pad}x128": (match_eager, lambda: match(da, db, na, nb, 0.75)),
        "refinement of 8 pairs x 3,072 matches": (refine_eager, lambda: chunk(tiles[:8], tiles[1:], ca, cb)),
    }
    parts = []
    for name, (eager, graphed) in stages.items():
        for _ in range(2):  # the eager first call, then the capture
            graphed()
        times, values = [], []
        for fn in (eager, graphed, graphed, eager):
            values.append(fn())
            times.append(_cuda_ms(fn, reps=5))
        if not all(all(np.array_equal(a, b) for a, b in zip(v, values[0])) for v in values[1:]):
            raise AssertionError(f"phase 28 (c) {name}: a graphed call parts from the eager one")
        parts.append(f"{name}: eager {times[0]:.3f} / {times[3]:.3f} ms, graphed {times[1]:.3f} / {times[2]:.3f} ms,"
                     f" bit-equal")
    return "phase 28 (c) the chunk programs: " + "; ".join(parts)


def scaling() -> None:
    """``python3 chip_smoke.py --scaling`` on a machine with several cards:
    phase 6's and phase 5's widths on 1, 2 and 4 cards (as many as there
    are), three ways: a ``MeshTracker`` over the cards with one thread
    issuing every slice (the package's design), the same with a thread a
    slice, and one process a card (:func:`process_worker`); each the better
    of two passes after a warm-up, generator draws for the meshes, the
    injected draws of phase 21 for the processes. Then each way on the most
    cards against one card from injected draws, held as phase 7 holds a free
    run, and one mesh step under the profiler: device-busy milliseconds by
    card beside the step's."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, REPO)
    from glimpse_tpu_torch import parallel
    from glimpse_tpu_torch.kernels import _build
    from glimpse_tpu_torch.parallel.tracker import MeshState, MeshTracker, _noise_slice, _to

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        raise SystemExit("chip_smoke.py --scaling needs two CUDA cards or more")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        list(pool.map(_build.load, ("highpass", "resample")))
    count = torch.cuda.device_count()
    cards = [k for k in (1, 2, 4) if k <= count]
    first = torch.device("cuda", 0)

    class Threaded(MeshTracker):
        """A thread a slice issues that slice's launches."""

        def _advance(self, state, images, dt, noise=None, **kwargs):
            def one(i):
                part = self.parts[i]
                with torch.cuda.device(part.device):
                    return part.step(state.parts[i], _to(images, part.device), _to(dt, part.device),
                                     noise=_noise_slice(noise, self.slices[i]), **kwargs)

            steps = list(self.pool.map(one, range(len(self.parts))))
            return MeshState([s for s, _ in steps]), [o for _, o in steps]

    def sync():
        for d in range(count):
            torch.cuda.synchronize(d)

    def tracker(way, width, k):
        n, p, t = PROCESS_WIDTHS[width]
        frames, camera, points_xy, _ = process_problem(width, first)
        built = make_tracker(camera, points_xy, p, first,
                             mesh=parallel.get_mesh(devices=[torch.device("cuda", i) for i in range(k)]))
        if way == "mesh, a thread a slice":
            # The same tracker, each slice's step issued from a thread of its own.
            built.__class__ = Threaded
            built.pool = concurrent.futures.ThreadPoolExecutor(k)
        return built, frames

    for width in PROCESS_WIDTHS:
        n, p, t = PROCESS_WIDTHS[width]
        for k in cards:
            for way in ("mesh, one thread", "mesh, a thread a slice"):
                built, frames = tracker(way, width, k)
                dts = torch.ones(t, device=first)

                def run(seed):
                    sync()
                    start = time.perf_counter()
                    built.track(torch.Generator(device=first).manual_seed(seed), frames[:, None], dts)
                    sync()
                    return time.perf_counter() - start

                run(0)
                seconds = min(run(seed) for seed in (1, 2))
                line = f"{width}'s {n}x{p}x{t} on {k} card{'s' if k > 1 else ''}, {way}: {n * t / seconds:.1f} point-steps/s"
                if width == "phase 6":
                    state = built.initialize(torch.Generator(device=first).manual_seed(0), frames[0][None])
                    built.step(state, frames[1][None], dts[0])
                    sync()
                    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                        start = time.perf_counter()
                        built.step(state, frames[1][None], dts[0])
                        sync()
                        window = (time.perf_counter() - start) * 1e3
                    busy = {}
                    for event in prof.events():
                        if event.device_type == torch.autograd.DeviceType.CUDA:
                            us = getattr(event, "device_time_total", None) or getattr(event, "cuda_time_total", 0)
                            busy[event.device_index] = busy.get(event.device_index, 0.0) + us / 1e3
                    line += (f"; one step under the profiler {window:.3f} ms, device busy ms by card "
                             + ", ".join(f"{d}: {ms:.3f}" for d, ms in sorted(busy.items())))
                print(line, flush=True)
                del built, frames
                torch.cuda.empty_cache()
    n, p, t = PROCESS_WIDTHS["phase 6"]
    frames, camera, points_xy, noise = process_problem("phase 6", first)
    dts = torch.ones(t, device=first)
    _, want = make_tracker(camera, points_xy, p, first).track(
        torch.Generator(device=first).manual_seed(0), frames[:, None], dts, noise=noise)
    for way in ("mesh, one thread", "mesh, a thread a slice"):
        built, _ = tracker(way, "phase 6", cards[-1])
        _, out = built.track(torch.Generator(device=first).manual_seed(0), frames[:, None], dts, noise=noise)
        bounds = free_run_bounds(out["mean"].cpu().numpy(), want["mean"].cpu().numpy())
        print(f"{way} on {cards[-1]} cards against one card, injected draws: step 1 {bounds[0]:.3g}, median point"
              f" {bounds[1]:.3g}, worst point {bounds[2]:.3g}", flush=True)
    del noise, frames, want
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="scaling_", dir=os.path.join(REPO, "build")) as outdir:
        for k in cards:
            ranks = run_processes([torch.device("cuda", r) for r in range(k)], outdir, PROCESS_WIDTHS)
            for width, (n, p, t) in PROCESS_WIDTHS.items():
                seconds = min(max(r[width]["seconds"][i] for r in ranks) for i in range(2))
                means = np.load(os.path.join(outdir, f"{width.replace(' ', '')}_{k}.npy"))
                bounds = free_run_bounds(means, np.load(os.path.join(outdir, f"{width.replace(' ', '')}_1.npy")))
                print(f"{width}'s {n}x{p}x{t} on {k} card{'s' if k > 1 else ''}, a process a card:"
                      f" {n * t / seconds:.1f} point-steps/s, peak "
                      + "/".join(f"{r[width]['peak'] / 2**30:.2f}" for r in ranks)
                      + f" GiB a rank; against one process step 1 {bounds[0]:.3g}, median point {bounds[1]:.3g},"
                      f" worst point {bounds[2]:.3g}", flush=True)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card: torch.cuda.is_available() is false")
    sys.path.insert(0, REPO)
    from glimpse_tpu_torch.kernels import _build, sass
    from glimpse_tpu_torch.kernels.bench_highpass import HBM_BYTES_PER_S
    from glimpse_tpu_torch.kernels.highpass import covers as highpass_covers
    from glimpse_tpu_torch.kernels.highpass import highpass as routed_highpass
    from glimpse_tpu_torch.kernels.highpass import kernel_variant, median_highpass, median_highpass_plain
    from glimpse_tpu_torch.kernels.resample import (
        systematic_resample,
        systematic_resample_plain,
    )
    from glimpse_tpu_torch.ops.resampling import systematic_thresholds

    cuda = torch.device("cuda")
    started = time.perf_counter()

    def say(line: str, flush: bool = True) -> None:
        """A phase's line, with the seconds since the script's start."""
        print(f"{line} [{time.perf_counter() - started:.1f} s]", flush=flush)

    card = _card()
    print(card)
    say(
        f"phase 1 card: {torch.cuda.get_device_name(0)}; torch {torch.__version__},"
        f" CUDA {torch.version.cuda}, numpy {np.__version__}; TF32 matmul {torch.backends.cuda.matmul.allow_tf32}",
        flush=True,
    )

    # Phase 2: build from the checkout's sources, one nvcc per source, all at once.
    def build(name):
        start = time.perf_counter()
        _build.load(name)
        seconds = time.perf_counter() - start
        log = _build.library_path(name).with_suffix(".log")
        text = log.read_text() if log.exists() else ""
        registers = re.findall(r"Used (\d+) registers", text)
        spills = [int(v) for v in re.findall(r"(\d+) bytes spill stores", text)]
        return (f"{seconds:.1f} s, registers {'/'.join(registers) or 'cached'},"
                f" largest spill {max(spills, default=0)} bytes")

    def build_feeder():
        from glimpse_tpu_torch import native

        start = time.perf_counter()
        native.load(required=True)  # a failed g++ build raises here
        return f"{native.backend()} ({native.library_path().name}, g++, {time.perf_counter() - start:.1f} s)"

    names = ("highpass", "resample")
    with concurrent.futures.ThreadPoolExecutor(len(names) + 1) as pool:
        feeder_built = pool.submit(build_feeder)
        built = dict(zip(names, pool.map(build, names)))
        built["host feeder"] = feeder_built.result()
    main_kernels = [r for r in sass.count_built("highpass") if r[0].startswith("separable_kernel<5,5,")]
    say(
        "phase 2 build: " + "; ".join(f"{k} {v}" for k, v in built.items())
        + f"; SASS of the 5x5 high-pass in each type: {'; '.join(sass.describe(r) for r in main_kernels)}",
        flush=True,
    )

    # Phase 3: the high-pass kernel at the main path's shapes (search tiles
    # every step, templates once), plus 3x3 and 7x7 taps, timed; then ties,
    # NaN, +-inf, other windows and the smallest tiles, each held exactly
    # (NaN where the plain version has NaN).
    rng = np.random.default_rng(1)
    cases = [
        ((1024, 41, 41), (5, 5)), ((1024, 15, 15), (5, 5)), ((1024, 41, 41), (3, 3)), ((1024, 41, 41), (7, 7)),
        ((20480, 31, 31), (5, 5)),  # phase 8's stacked search tiles: 2 observers x 10,240 points
        ((10240, 31, 31), (5, 5)),  # phase 24's search tiles: 1 observer x 10,240 points
        ((10240, 41, 41), (5, 5)), ((10240, 15, 15), (5, 5)),  # phase 14's search tiles and templates
        ((2560, 41, 41), (5, 5)), ((2560, 15, 15), (5, 5)),  # phase 20's: one of four mesh slices
        ((256, 41, 41), (5, 5)), ((256, 15, 15), (5, 5)),  # phase 26's card against CPU on 256 points
        # phase 16: the host tracker's template, its smallest search tile (the
        # template plus the spline support) and non-square ones
        *(((1, h, w), (5, 5)) for h, w in HOST_TRACKER_TILES),
    ]
    hp_err = 0.0
    hp_times = {}
    for shape, size in cases:
        tiles = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda)
        got = median_highpass(tiles, size)
        want = median_highpass_plain(tiles, size)
        if not torch.equal(got, want):
            raise AssertionError(f"median_highpass differs from its plain version at {shape} {size}")
        hp_err = max(hp_err, float((got - want).abs().max()))
        hp_times[(shape, size)] = (
            _cuda_ms(lambda: median_highpass(tiles, size)),
            _cuda_ms(lambda: median_highpass_plain(tiles, size)),
        )
    held = []
    for label, shape, size, specials, misaligned in highpass_check_cases():
        tiles = highpass_case_tiles(shape, specials, misaligned, cuda)
        got = median_highpass(tiles, size)
        want = median_highpass_plain(tiles, size)
        variant = kernel_variant(size, torch.float32, shape)
        torch.testing.assert_close(
            got, want, rtol=0, atol=0, equal_nan=True,
            msg=lambda m: f"median_highpass ({variant}) on {label} {shape} {size}: {m}",
        )
        hp_err = max(hp_err, highpass_mismatch(got, want))
        held.append(f"{label} {shape[1]}x{shape[2]} {size[0]}x{size[1]} {variant} ({int(torch.isnan(want).sum())} NaN)")
    # Windows outside the kernel's domain take the plain route, by the
    # domain's predicate and before any launch.
    routes = []
    for size in ((5, 5), (4, 4), (2, 3), (9, 9)):
        tiles = torch.from_numpy(rng.normal(size=(64, 31, 31)).astype(np.float32)).to(cuda)
        launched = median_highpass.launches
        got = routed_highpass(tiles, size)
        route = "kernel" if median_highpass.launches == launched + 1 else "plain"
        if route != ("kernel" if highpass_covers(size) else "plain"):
            raise AssertionError(f"highpass {size}: route {route}, covers {highpass_covers(size)}")
        if not torch.equal(got, median_highpass_plain(tiles, size)):
            raise AssertionError(f"highpass {size} by the {route} route differs from the plain version")
        routes.append(f"{size[0]}x{size[1]} {route}")
    # Tiles that one block's shared memory cannot hold: the kernel reads
    # them from device memory, held and timed the same way.
    large_records, large_err = large_tiles(cuda, torch.float32, HBM_BYTES_PER_S)
    hp_err = max(hp_err, large_err)
    say(
        "phase 3 median_highpass bit-equal: "
        + "; ".join(
            f"{s[1]}x{s[2]} {k[0]}x{k[1]} kernel {a:.4f} ms plain {b:.4f} ms"
            for (s, k), (a, b) in hp_times.items()
        )
        + f"; held to rtol=atol=0 with equal NaN: {'; '.join(held)}; routes by window at 31x31: {', '.join(routes)};"
        f" large tiles held to rtol=atol=0 with equal NaN and timed: {describe_large_tiles(large_records)}",
        flush=True,
    )

    # Phase 4: the resample kernel on skewed weights, thresholds built as
    # the tracker builds them, at phase 5's, phase 8's, one of phase 20's
    # four mesh slices', phase 24's and phase 26's card-against-CPU shapes;
    # N = 37 divides no block size.
    rs_err = 0.0
    rs_times = {}
    for n, p in [(1024, 1024), (10240, 2048), (2560, 2048), (10240, 512), (256, 2048), (37, 1024)]:
        weights = torch.from_numpy(np.exp(3 * rng.normal(size=(n, p))).astype(np.float32)).to(cuda)
        u = torch.from_numpy(rng.random(n).astype(np.float32)).to(cuda)
        particles = torch.from_numpy(rng.normal(size=(n, p, 6)).astype(np.float32)).to(cuda)
        t = systematic_thresholds(weights, u)
        got = systematic_resample(t, particles, weights)
        want = systematic_resample_plain(t, particles, weights)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"systematic_resample differs from its plain version at {n}x{p}")
        rs_err = max(rs_err, float((got[0] - want[0]).abs().max()), float((got[1] - want[1]).abs().max()))
        rs_times[(n, p)] = (
            _cuda_ms(lambda: systematic_resample(t, particles, weights)),
            _cuda_ms(lambda: systematic_resample_plain(t, particles, weights)),
        )
    say(
        "phase 4 systematic_resample bit-equal: "
        + "; ".join(f"{n}x{p} kernel {a:.4f} ms plain {b:.4f} ms" for (n, p), (a, b) in rs_times.items()),
        flush=True,
    )

    # Phase 5: bench.py's workload through BatchTracker.track.
    n_points, n_particles, n_steps = 1024, 1024, 50
    frames_np, camera, scene_rng = make_scene(n_steps + 1)
    points_xy = scene_rng.uniform(128, 384, size=(n_points, 2))
    frames = torch.from_numpy(frames_np).to(cuda)
    tracker = make_tracker(camera, points_xy, n_particles, cuda)
    run_tracker(tracker, frames, seed=0)
    torch.cuda.reset_peak_memory_stats()
    # Best of two timed passes, as bench.py takes; each must launch the three kernels.
    seconds = float("inf")
    for seed in (1, 2):
        reset_launches()
        out, elapsed = run_tracker(tracker, frames, seed=seed)
        launches = launch_counts()
        if (launches["median_highpass"] < n_steps + 1 or launches["systematic_resample"] != n_steps
                or launches["bspline_sample"] != n_steps or launches["project_extract"] != n_steps):
            raise AssertionError(f"the kernels did not carry the main path: launches {launches}")
        seconds = min(seconds, elapsed)
    peak = torch.cuda.max_memory_allocated()
    mean = out["mean"].cpu().numpy()
    if not np.isfinite(mean).all():
        raise AssertionError("non-finite means at 1,024 x 1,024")
    velocity = np.median(mean[-1, :, 3:5], axis=0)
    if np.abs(velocity - (2.0, -1.0)).max() > 0.5:
        raise AssertionError(f"recovered velocity {velocity} is not within 0.5 of (2, -1)")
    say(
        f"phase 5 track {n_points}x{n_particles}x{n_steps}: {n_points * n_steps / seconds:.1f} point-steps/s"
        f" ({seconds:.3f} s), median velocity ({velocity[0]:.3f}, {velocity[1]:.3f}),"
        f" launches {launches}, peak {peak / 2**30:.2f} GiB",
        flush=True,
    )

    # Phase 6: the north-star width.
    n_big, p_big, steps_big = 10240, 2048, 10
    big_xy = np.random.default_rng(2).uniform(128, 384, size=(n_big, 2))
    big = make_tracker(camera, big_xy, p_big, cuda)
    run_tracker(big, frames[: steps_big + 1], seed=0)
    torch.cuda.reset_peak_memory_stats()
    runs = [run_tracker(big, frames[: steps_big + 1], seed=seed) for seed in (1, 2)]
    out_big = runs[-1][0]
    seconds_big = min(r[1] for r in runs)
    if not torch.isfinite(out_big["mean"]).all():
        raise AssertionError("non-finite means at 10,240 x 2,048")
    say(
        f"phase 6 track {n_big}x{p_big}x{steps_big}: {n_big * steps_big / seconds_big:.1f} point-steps/s"
        f" ({seconds_big:.3f} s), peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
        flush=True,
    )

    # Phase 7: card against CPU, same injected draws; the CPU tracker runs
    # the plain versions because its tensors lie on the CPU. Each step is
    # held tightly from a shared state: the CPU's state, moved to the card.
    # A free-running filter amplifies rounding: the likelihood is steep, so
    # a rounding-level change moves the systematic thresholds across slots
    # and a point then follows another, equally likely particle path. The
    # port and the JAX reference, both on the CPU, part by 0.149 on one
    # point of this scene by step 5 (6e-5 at step 1), from a 3e-5 px
    # difference in one template's subpixel offset, the order of a sum. So
    # the free runs are held to 1e-3 at step 1, 1e-2 for the median point
    # and half a pixel (0.5 world units here) for every point.
    n_small, p_small, t_small = 16, 256, 6
    noise_rng = np.random.default_rng(3)
    noise = {
        "init": {
            "xy": noise_rng.normal(size=(n_small, p_small, 2)).astype(np.float32),
            "v": noise_rng.normal(size=(n_small, p_small, 3)).astype(np.float32),
        },
        "a": noise_rng.normal(size=(t_small - 1, n_small, p_small, 3)).astype(np.float32),
        "resample_u": noise_rng.random((t_small - 1, n_small)).astype(np.float32),
    }
    cpu = torch.device("cpu")
    devices = {"card": cuda, "cpu": cpu}
    small = {k: make_tracker(camera, points_xy[:n_small], p_small, d) for k, d in devices.items()}
    images = {k: torch.from_numpy(frames_np[:t_small, None]).to(d) for k, d in devices.items()}
    free = {}
    for kind, tracker_ in small.items():
        generator = torch.Generator(device=tracker_.device).manual_seed(0)
        dts = torch.ones(t_small - 1, device=tracker_.device)
        free[kind] = tracker_.track(generator, images[kind], dts, noise=noise)[1]["mean"].cpu().numpy()
    state = small["cpu"].initialize(torch.Generator().manual_seed(0), images["cpu"][0], noise=noise["init"])
    carried, flips = 0.0, 0
    for i in range(t_small - 1):
        step_noise = {"a": noise["a"][i], "resample_u": noise["resample_u"][i]}
        on_card = dataclasses.replace(
            state, generator=torch.Generator(device=cuda),
            **{k: getattr(state, k).to(cuda) for k in ("particles", "weights", "templates", "template_table", "template_duv", "valid")},
        )
        card_next, card_out = small["card"].step(on_card, images["card"][i + 1], torch.tensor(1.0, device=cuda), noise=step_noise)
        state, cpu_out = small["cpu"].step(state, images["cpu"][i + 1], torch.tensor(1.0), noise=step_noise)
        carried = max(carried, float((card_out["mean"].cpu() - cpu_out["mean"]).abs().max()))
        flips += int(((card_next.particles.cpu() - state.particles).abs().amax(-1) > 1e-3).sum())
    per_point = np.abs(free["card"] - free["cpu"]).max(axis=(0, 2))
    step1 = float(np.abs(free["card"][0] - free["cpu"][0]).max())
    if carried > 1e-3 or step1 > 1e-3 or np.median(per_point) > 1e-2 or per_point.max() > 0.5:
        raise AssertionError(
            f"card and CPU runs part: carried steps {carried}, free step 1 {step1},"
            f" per point {per_point.tolist()}"
        )
    say(
        f"phase 7 lockstep {n_small}x{p_small}x{t_small - 1} card vs CPU: each step from a shared state"
        f" max |diff| {carried:.3g} (limit 1e-3), resampled rows differing {flips} of"
        f" {n_small * p_small * (t_small - 1)}; free runs step 1 {step1:.3g} (limit 1e-3), median point"
        f" {np.median(per_point):.3g} (limit 1e-2), worst point {per_point.max():.3g} (limit 0.5)",
        flush=True,
    )

    # Phase 8: the Columbia-scale recipe at full width, frames made on the
    # host while the card steps.
    from glimpse_tpu_torch.track import checkpoint

    n8, p8, t8, chunk = 10240, 2048, 33, 8
    frame, cams, viewshed, columbia_rng = columbia_scene(t8)
    starts = columbia_rng.uniform(COLUMBIA_IMG // 4, COLUMBIA_IMG - COLUMBIA_IMG // 4, size=(n8, 2))
    masks8, mask0 = columbia_masks(t8 - 1, first=10, every=7)
    columbia = columbia_tracker(cams, viewshed, starts, p8, cuda)

    def stream(seed):
        generator = torch.Generator(device=cuda).manual_seed(seed)
        start = time.perf_counter()
        state, outputs = columbia.track_stream(
            generator, frame(0), (frame(i) for i in range(1, t8)), np.ones(t8 - 1, np.float32),
            obs_masks=masks8, obs_mask0=mask0, chunk=chunk,
        )
        torch.cuda.synchronize()
        return outputs, time.perf_counter() - start

    stream(0)
    torch.cuda.reset_peak_memory_stats()
    seconds8 = float("inf")
    for seed in (1, 2):
        reset_launches()
        outputs8, elapsed = stream(seed)
        launches8 = launch_counts()
        # One high-pass per step for both observers' stacked tiles, plus
        # observer 1's templates at the start and observer 2's at step 10;
        # one resample and one spline read of the stacked surfaces a step.
        if (launches8["median_highpass"] < t8 - 1 + 2 or launches8["systematic_resample"] != t8 - 1
                or launches8["bspline_sample"] != t8 - 1 or launches8["project_extract"] != t8 - 1):
            raise AssertionError(f"the kernels did not carry the Columbia run: launches {launches8}")
        seconds8 = min(seconds8, elapsed)
    peak8 = torch.cuda.max_memory_allocated()
    mean8 = torch.cat([o["mean"] for o in outputs8]).cpu().numpy()
    valid8 = torch.cat([o["valid"] for o in outputs8]).cpu().numpy()
    if mean8.shape != (t8 - 1, n8, 6) or not np.isfinite(mean8).all():
        raise AssertionError(f"Columbia means: shape {mean8.shape}, finite {np.isfinite(mean8).all()}")
    if not (valid8 == 1).all():
        raise AssertionError("a point left the all-visible viewshed")
    # The canvas moves +v in the crop, so features move -vx in x and, with
    # image rows running against world y, +vy in y.
    truth = starts + np.array([-COLUMBIA_VELOCITY[0], COLUMBIA_VELOCITY[1]]) * (t8 - 1)
    rmse8 = float(np.sqrt(np.mean(np.sum((mean8[-1, :, 0:2] - truth) ** 2, axis=-1))))
    if rmse8 > 0.5:
        raise AssertionError(f"Columbia final RMSE {rmse8} px is above 0.5 px")
    say(
        f"phase 8 columbia {n8}x{p8}x2 observers x{t8 - 1} steps streamed (chunk {chunk}, viewshed on):"
        f" {n8 * (t8 - 1) / seconds8:.1f} point-steps/s ({seconds8:.3f} s), peak {peak8 / 2**30:.2f} GiB,"
        f" final RMSE {rmse8:.4f} px, launches {launches8}, {len(outputs8)} output entries",
        flush=True,
    )

    # Phase 9: the new paths, card against CPU with the same injected draws.
    n9, p9, t9 = 16, 256, 9
    frames9 = np.stack([frame(i) for i in range(t9)])
    masks9, mask0_9 = columbia_masks(t9 - 1, first=3, every=3)
    draws = np.random.default_rng(4)
    noise9 = {
        "init": {
            "xy": draws.normal(size=(n9, p9, 2)).astype(np.float32),
            "v": draws.normal(size=(n9, p9, 3)).astype(np.float32),
        },
        "a": draws.normal(size=(t9 - 1, n9, p9, 3)).astype(np.float32),
        "resample_u": draws.random((t9 - 1, n9)).astype(np.float32),
    }
    settings9 = dict(resample_threshold=0.5, return_covariances=True)
    small9 = {k: columbia_tracker(cams, viewshed, starts[:n9], p9, d, **settings9) for k, d in devices.items()}
    images9 = {k: torch.from_numpy(frames9).to(d) for k, d in devices.items()}
    free9 = {}
    for kind, tracker_ in small9.items():
        generator = torch.Generator(device=tracker_.device).manual_seed(0)
        dts = torch.ones(t9 - 1, device=tracker_.device)
        out9 = tracker_.track(generator, images9[kind], dts, noise=noise9, obs_masks=masks9, obs_mask0=mask0_9)[1]
        free9[kind] = {k: v.cpu().numpy() for k, v in out9.items()}
    _, plan9 = small9["cpu"]._template_plan(masks9, mask0_9)
    state = small9["cpu"].initialize(torch.Generator().manual_seed(0), images9["cpu"][0], noise=noise9["init"], obs_mask0=mask0_9)
    carried9 = 0.0
    for i in range(t9 - 1):
        kwargs = dict(
            noise={"a": noise9["a"][i], "resample_u": noise9["resample_u"][i]}, obs_mask=masks9[i],
            init_template_for=plan9.get(i + 1, ()),
        )
        on_card = dataclasses.replace(
            state, generator=torch.Generator(device=cuda),
            **{k: getattr(state, k).to(cuda) for k in ("particles", "weights", "templates", "template_table", "template_duv", "valid")},
        )
        _, card_out = small9["card"].step(on_card, images9["card"][i + 1], torch.tensor(1.0, device=cuda), **kwargs)
        state, cpu_out = small9["cpu"].step(state, images9["cpu"][i + 1], torch.tensor(1.0), **kwargs)
        if not torch.equal(card_out["valid"].cpu(), cpu_out["valid"]):
            raise AssertionError(f"card and CPU validity differ at step {i + 1}")
        carried9 = max(carried9, *(float((card_out[k].cpu() - cpu_out[k]).abs().max()) for k in ("mean", "sigma", "covariance")))
    per_point9 = np.abs(free9["card"]["mean"] - free9["cpu"]["mean"]).max(axis=(0, 2))
    step1_9 = float(np.abs(free9["card"]["mean"][0] - free9["cpu"]["mean"][0]).max())
    if carried9 > 1e-3 or step1_9 > 1e-3 or np.median(per_point9) > 1e-2 or per_point9.max() > 0.5:
        raise AssertionError(
            f"card and CPU part on the new paths: carried steps {carried9}, free step 1 {step1_9},"
            f" per point {per_point9.tolist()}"
        )
    say(
        f"phase 9 lockstep {n9}x{p9}x{t9 - 1}, 2 observers (the second from step 3, masked at step 6),"
        f" viewshed, resample_threshold 0.5, covariances: each step from a shared state max |diff| {carried9:.3g}"
        f" (limit 1e-3); free runs step 1 {step1_9:.3g} (limit 1e-3), median point {np.median(per_point9):.3g}"
        f" (limit 1e-2), worst point {per_point9.max():.3g} (limit 0.5)",
        flush=True,
    )

    # Phase 10: checkpoint on the card, generator draws, resumed bit for bit.
    card9 = small9["card"]

    def steps(state, lo, hi):
        outs = []
        for i in range(lo, hi):
            state, out = card9.step(
                state, images9["card"][i + 1], torch.tensor(1.0, device=cuda), obs_mask=masks9[i],
                init_template_for=plan9.get(i + 1, ()),
            )
            outs.append(out)
        return state, outs

    def fresh():
        return card9.initialize(torch.Generator(device=cuda).manual_seed(7), images9["card"][0], obs_mask0=mask0_9)

    whole, whole_outs = steps(fresh(), 0, 6)
    half, _ = steps(fresh(), 0, 3)
    path = os.path.join(REPO, "build", "chip_smoke", "state.npz")
    checkpoint.save_state(half, path)
    resumed, resumed_outs = steps(checkpoint.load_state(path), 3, 6)
    equal = torch.equal(resumed.particles, whole.particles) and all(
        torch.equal(a[k], b[k]) for a, b in zip(resumed_outs, whole_outs[3:]) for k in a
    )
    if not equal:
        raise AssertionError("the run resumed from the checkpoint differs from the uninterrupted run")
    say(
        f"phase 10 checkpoint on {resumed.generator.device}: saved after step 3, resumed for 3 steps,"
        " outputs and particles bit-equal to the uninterrupted run",
        flush=True,
    )

    # Phase 11: stabilization at full width.
    torch.cuda.reset_peak_memory_stats()
    n11 = 100  # phase 18 runs the recipe at 1,000 frames from files
    stab = stabilize(n11, cuda)
    peak11 = torch.cuda.max_memory_allocated()
    worst11 = [float(e.max()) for e in stab["errors"]]
    if not all(np.isfinite(f.x).all() for f in stab["fits"]) or max(worst11) > 0.01:
        raise AssertionError(f"stabilization: max view direction errors {worst11} deg (limit 0.01)")
    times11 = ", ".join(f"{k} {v:.2f} s" for k, v in stab["seconds"].items())
    fits11 = "; ".join(
        f"{name}: {f.nit} iterations, |g| {f.grad_norm:.3g}, error max {e.max():.5f} mean {e.mean():.5f} deg"
        for name, f, e in zip(("fit", "refined fit"), stab["fits"], stab["errors"])
    )
    say(
        f"phase 11 stabilization {n11} frames of {STAB_IMG}x{STAB_IMG}, 2,048 keypoints, offsets {STAB_OFFSETS}:"
        f" {times11}; {len(stab['pairs'])} image pairs, {stab['matches']} matched pairs;"
        f" {fits11}; peak {peak11 / 2**30:.2f} GiB",
        flush=True,
    )

    # Phase 12: the stabilization modules, card against CPU.
    say("phase 12 card vs CPU: " + compare_stabilization(stab, cuda), flush=True)

    # Phase 13: terrain on the card.
    say(f"phase 13 terrain on {card}: " + terrain_on_the_card(cuda), flush=True)

    # Phase 14: objects in, Tracks out, at full width.
    line14, launches14, scene, points14 = objects_to_tracks(cuda, card)
    say(line14, flush=True)

    # Phase 15: the object path on the card against the CPU, from shared draws.
    say(object_path_lockstep(scene, points14, devices), flush=True)

    # Phase 16: the host Tracker on the card, on the CPU, and the batched
    # tracker from the same objects and draws.
    line16, launches16, shapes16, wide16 = host_tracker_phase(scene, points14, devices, card)
    say(line16, flush=True)

    # Phase 17: calibration, the exact Jacobian on the card.
    line17, fits17 = calibration_phase(devices, card)
    say(line17, flush=True)

    # Phase 18: stabilization from image files at full size.
    with tempfile.TemporaryDirectory(prefix="phase18_", dir=os.path.join(REPO, "build")) as workdir:
        line18, joined = stabilize_from_files(1000, cuda, workdir)
        say("phase 18 stabilization from files: " + line18, flush=True)
        start24 = time.perf_counter()
        frames24 = decode_frames(joined["paths"])  # phase 24's frames, as a user has them
        decode24 = time.perf_counter() - start24

    # Phase 19: camera model conversion, card against CPU.
    say("phase 19 conversion: " + conversion_phase(devices), flush=True)

    # Phase 20: the north-star width in four mesh slices on one card, and a
    # mesh checkpoint resumed.
    line20, launches20 = mesh_phase(camera, frames, big_xy, cuda, os.path.join(REPO, "chiprun_out", "phase20_trace"))
    line20 += "; checkpoint: " + mesh_checkpoint(
        camera, frames, points_xy, cuda, os.path.join(REPO, "build", "chip_smoke", "mesh_state.npz"))
    say("phase 20 mesh: " + line20, flush=True)

    # Phase 21: one process a slice, 1, 2 and 4 processes on the card.
    with tempfile.TemporaryDirectory(prefix="phase21_", dir=os.path.join(REPO, "build")) as workdir:
        line21, launches21 = process_phase(cuda, workdir)
    say("phase 21 processes: " + line21, flush=True)

    # Phase 22: the SSE sampling modes at the north-star width.
    line22, launches22 = sse_modes_phase(camera, frames, big_xy, cuda,
                                         injected_draws(n_big, p_big, steps_big, cuda, seed=20), devices)
    say("phase 22 SSE modes: " + line22, flush=True)

    # Phase 23: precisions. (a) both kernels in 16 and 64 bits; (b) phase
    # 6's tracker in each dtype; (c) phase 8's Columbia recipe in bfloat16
    # beside its float32 run, from the same generator seed; (d) bfloat16 on
    # the card against the CPU from a shared state.
    line23a, records23, err23 = precision_kernels(cuda, HBM_BYTES_PER_S)
    hp_err = max(hp_err, err23)
    say("phase 23 (a) kernels in 16 and 64 bits, bit-equal to their plain versions: " + line23a, flush=True)
    line23b, launches23 = precision_trackers(camera, frames, big_xy, cuda)
    say("phase 23 (b) phase 6's tracker in each dtype: " + line23b, flush=True)
    columbia16 = columbia_tracker(cams, viewshed, starts, p8, cuda, dtype=torch.bfloat16)
    reset_launches()
    start23 = time.perf_counter()
    _, outputs23 = columbia16.track_stream(
        torch.Generator(device=cuda).manual_seed(2), frame(0), (frame(i) for i in range(1, t8)),
        np.ones(t8 - 1, np.float32), obs_masks=masks8, obs_mask0=mask0, chunk=chunk,
    )
    torch.cuda.synchronize()
    seconds23 = time.perf_counter() - start23
    launches23["columbia bfloat16"] = launch_counts()
    mean23 = torch.cat([o["mean"] for o in outputs23])
    if mean23.dtype != torch.bfloat16 or not torch.isfinite(mean23).all():
        raise AssertionError(f"phase 23 Columbia in bfloat16: means of {mean23.dtype}, finite {torch.isfinite(mean23).all()}")
    rmse23 = float(np.sqrt(np.mean(np.sum((mean23[-1, :, 0:2].double().cpu().numpy() - truth) ** 2, axis=-1))))
    say(
        f"phase 23 (c) columbia {n8}x{p8}x2 observers x{t8 - 1} steps in bfloat16 (chunk {chunk}, one pass,"
        f" {n8 * (t8 - 1) / seconds23:.1f} point-steps/s): final RMSE {rmse23:.4f} px against float32's"
        f" {rmse8:.4f} px (phase 8, the same seed), ratio {rmse23 / rmse8:.3f};"
        f" launches {launches23['columbia bfloat16']}",
        flush=True,
    )
    error23, budget23 = precision_lockstep(camera, frames_np, points_xy, devices, torch.bfloat16)
    say(
        f"phase 23 (d) bfloat16 card against CPU at 16x256x5, each step from a shared state: max |diff| of the"
        f" means {error23:.4g}, within max |CPU bfloat16 - CPU float32| + 1 ulp = {budget23:.4g}",
        flush=True,
    )

    # Phase 24: stabilize, then track: phase 18's fit and frames through the
    # tracker at the reference's full recipe.
    line24, launches24 = stabilize_then_track(joined, frames24, cuda, chunk=chunk)
    say(f"phase 24 stabilize, then track: {len(frames24)} frames decoded in {decode24:.2f} s; " + line24, flush=True)
    frames27 = frames24[:101].copy()  # phase 27's 100 steps of phase 24's setup
    del frames24

    # Phase 25: two observers with disjoint fire times, each sequence
    # stabilized on its own, then one masked, streamed filter over the union
    # timeline.
    with tempfile.TemporaryDirectory(prefix="phase25_", dir=os.path.join(REPO, "build")) as workdir:
        line25, launches25 = two_observers(cuda, workdir, chunk=chunk)
    say("phase 25 two observers, stabilized, then tracked: " + line25, flush=True)

    # Phase 26: a viewshed that hides tracked terrain, at full width.
    line26, launches26 = occluding_viewshed(devices, card)
    say(line26, flush=True)

    # Phase 27: graphs against eager, in turns, at phase 5's, phase 6's,
    # phase 24's and phase 20's shapes.
    from glimpse_tpu_torch import parallel

    tracker24, fitted27, _, _ = tracking_setup(joined, len(frames27), cuda)
    cams27 = torch.as_tensor(fitted27[:, None], device=cuda)
    first27 = torch.from_numpy(frames27[:2, None]).to(cuda, torch.float32)
    mesh27 = make_tracker(camera, big_xy, p_big, cuda, mesh=parallel.get_mesh(devices=[cuda] * 4))
    noise27 = injected_draws(n_big, p_big, steps_big, cuda, seed=20)
    one = torch.ones((), device=cuda)

    def seeded():
        return torch.Generator(device=cuda).manual_seed(27)

    def stream27():
        state, outputs = tracker24.track_stream(
            seeded(), frames27[0][None], (f[None] for f in frames27[1:]), np.ones(len(frames27) - 1, np.float32),
            camera_vectors_seq=fitted27[:, None], chunk=chunk)
        return state, stacked_chunks(outputs)

    shapes27 = {
        f"phase 5's {n_points}x{n_particles}x{n_steps}": {
            "run": (tracker, lambda: tracker.track(seeded(), frames[:, None], torch.ones(n_steps, device=cuda))),
            "points": n_points, "steps": n_steps, "profile": ((frames[0][None], frames[1][None], one), {}),
        },
        f"phase 6's {n_big}x{p_big}x{steps_big}": {
            "run": (big, lambda: big.track(seeded(), frames[: steps_big + 1, None],
                                           torch.ones(steps_big, device=cuda))),
            "points": n_big, "steps": steps_big, "profile": ((frames[0][None], frames[1][None], one), {}),
        },
        f"phase 24's 10240x512x{len(frames27) - 1}, track_stream(chunk {chunk}), fitted cameras": {
            "run": (tracker24, stream27),
            "points": 10240, "steps": len(frames27) - 1,
            "profile": ((first27[0], first27[1], one, {"camera_vectors": cams27[0]}), {"camera_vectors": cams27[1]}),
        },
        f"phase 20's {n_big}x{p_big}x{steps_big} in 4 mesh slices on one card, injected draws": {
            "run": (mesh27, lambda: mesh27.track(seeded(), frames[: steps_big + 1, None],
                                                 torch.ones(steps_big, device=cuda), noise=noise27)),
            "points": n_big, "steps": steps_big, "profile": ((frames[0][None], frames[1][None], one), {}),
        },
    }
    lines27, launches27 = graphs_phase(shapes27)
    for line in lines27:
        say(line, flush=True)

    # Phase 28: the calibration and stabilization programs against their
    # eager code, in turns: phase 18's fit, phase 17's Jacobians, and one
    # detection, matching and refinement chunk at phase 18's shapes.
    say(fit_programs(joined["model"], cuda), flush=True)
    say(jacobian_programs(cuda, fits17), flush=True)
    say(chunk_programs(frames27, joined["mask"], cuda), flush=True)

    # Phase 29: the spline read kernel at the benchmark cells' shapes.
    line29, records29 = spline_phase(cuda)
    say(line29, flush=True)

    # Phase 30: the observer front-end kernel at the benchmark cells' shapes.
    line30, records30 = project_phase()
    say(line30, flush=True)

    # Phase 31: the DEM prior kernel at oblique-3d's shapes.
    line31, records31 = prior_phase()
    say(line31, flush=True)

    # The kernels at phase 8's shapes; ``launches`` are phase 20's (the
    # tracker in four mesh slices; phases 18-19 launch neither; the DEM
    # prior's phase 14's, the first path whose motion carries a sigma), and
    # ``launches_by_path`` every main path's, each counted from 0 just before
    # its run (phase 5's and phase 8's counts are one timed pass's; phase
    # 21's the four processes' first timed pass at phase 6's width, summed;
    # phase 22's the timed passes of the three SSE modes; phase 24's the
    # stabilized run's; phase 27's each shape's first graphed run, whose
    # launches the replays count). ``large_tile_shapes`` are phases 3 and 23 (a)'s
    # tiles past one block's shared memory, bound by their dtype's bytes.
    # Each bound is the bytes the function must move (every input read
    # once, every output written once) over the device memory rate: the
    # high-pass reads and writes 4 bytes a pixel; the resample reads a
    # float32 threshold and 7 float32 columns and writes 7 columns, 60 bytes
    # a particle; the spline read reads float32 rows and cols and writes a
    # float32 output, 12 bytes a particle, and reads each coefficient once
    # (``bench_spline.spline_bytes``). Their arithmetic is a subtraction a
    # pixel, none, and some 60 operations a particle, so bytes bind. No
    # single PyTorch call computes a median filter, this gather or a spline
    # at scattered points: library_ms null. The spline kernel replaces no
    # Pallas kernel (the reference reads the spline by XLA ops). The front
    # end reads x, y, z and the weight, writes each observer's cols, rows
    # and tiles and reads each frame once (``bench_project.project_bytes``);
    # some 100 instructions a particle and observer, under the bytes; no PyTorch
    # call computes it; it replaces no Pallas kernel either. Nor does the DEM
    # prior, which reads x, y and z, writes the prior and reads both rasters
    # once (``bench_prior.prior_bytes``), some 150 instructions a particle;
    # no PyTorch call computes it, and it launches only on PRIOR_PATHS.
    main_hp = hp_times[((20480, 31, 31), (5, 5))]
    main_rs = rs_times[(10240, 2048)]
    main_sp = next(r for r in records29 if r["shape"] == [20480, 17, 17, 2048] and r["dtype"] == "float32")
    main_pe = records30[0]
    main_pr = records31[0]
    bound_hp = 2 * 20480 * 31 * 31 * 4 / HBM_BYTES_PER_S * 1e3
    bound_rs = 10240 * 2048 * 60 / HBM_BYTES_PER_S * 1e3
    by_path = {
        name: {"phase 5": launches[name], "phase 8": launches8[name], "phase 14": launches14[name],
               "phase 16": launches16[name], "phase 20": launches20[name], "phase 21": launches21[name],
               "phase 22": launches22[name], **{f"phase 23 {k}": v[name] for k, v in launches23.items()},
               "phase 24": launches24[name], "phase 25": launches25[name], "phase 26": launches26[name],
               **{f"phase 27 {k}": v for k, v in launches27[name].items()}}
        for name in kernel_wrappers()
    }
    engaged = {name: {path: count for path, count in counts.items()
                      if name not in PRIOR_KERNELS or path in PRIOR_PATHS}
               for name, counts in by_path.items()}
    if any(count < 1 for counts in engaged.values() for count in counts.values()):
        raise AssertionError(f"a kernel did not launch on a main path: {by_path}")
    if any(count != 0 for name in PRIOR_KERNELS for path, count in by_path[name].items() if path not in PRIOR_PATHS):
        raise AssertionError(f"a DEM prior launched on a path without a DEM sigma: {by_path}")
    hp14 = [
        {"shape": list(shape), "ms": hp_times[(shape, (5, 5))][0], "plain_ms": hp_times[(shape, (5, 5))][1],
         "bound_ms": 2 * int(np.prod(shape)) * 4 / HBM_BYTES_PER_S * 1e3}
        for shape in ((10240, 41, 41), (10240, 15, 15))
    ]
    # The host tracker's tiles: one launch each, so launch latency binds the
    # time and the byte bound is nanoseconds.
    hp16 = [
        {"shape": [1, h, w], "ms": hp_times[((1, h, w), (5, 5))][0], "plain_ms": hp_times[((1, h, w), (5, 5))][1],
         "bound_ms": 2 * h * w * 4 / HBM_BYTES_PER_S * 1e3}
        for h, w in HOST_TRACKER_TILES
    ]
    hp20 = [
        {"shape": list(shape), "ms": hp_times[(shape, (5, 5))][0], "plain_ms": hp_times[(shape, (5, 5))][1],
         "bound_ms": 2 * int(np.prod(shape)) * 4 / HBM_BYTES_PER_S * 1e3}
        for shape in ((2560, 41, 41), (2560, 15, 15))
    ]
    rs20 = [{"shape": [2560, 2048], "ms": rs_times[(2560, 2048)][0], "plain_ms": rs_times[(2560, 2048)][1],
             "bound_ms": 2560 * 2048 * 60 / HBM_BYTES_PER_S * 1e3}]
    # Phase 24's: its search tiles every step, its templates once (phase
    # 14's shape), one resample a step at 10,240 x 512.
    hp24 = [
        {"shape": list(shape), "ms": hp_times[(shape, (5, 5))][0], "plain_ms": hp_times[(shape, (5, 5))][1],
         "bound_ms": 2 * int(np.prod(shape)) * 4 / HBM_BYTES_PER_S * 1e3}
        for shape in ((10240, 31, 31), (10240, 15, 15))
    ]
    rs24 = [{"shape": [10240, 512], "ms": rs_times[(10240, 512)][0], "plain_ms": rs_times[(10240, 512)][1],
             "bound_ms": 10240 * 512 * 60 / HBM_BYTES_PER_S * 1e3}]
    # Phase 26's card-against-CPU run on 256 points: search tiles every
    # step, templates once, one resample a step.
    hp26 = [
        {"shape": list(shape), "ms": hp_times[(shape, (5, 5))][0], "plain_ms": hp_times[(shape, (5, 5))][1],
         "bound_ms": 2 * int(np.prod(shape)) * 4 / HBM_BYTES_PER_S * 1e3}
        for shape in ((256, 41, 41), (256, 15, 15))
    ]
    rs26 = [{"shape": [256, 2048], "ms": rs_times[(256, 2048)][0], "plain_ms": rs_times[(256, 2048)][1],
             "bound_ms": 256 * 2048 * 60 / HBM_BYTES_PER_S * 1e3}]
    # Each dtype's times at the main path's shapes: float32 from phases 3
    # and 4, the others from phase 23 (a). The bound counts the dtype's
    # bytes: 2 E a pixel for the high-pass, 4 + 14 E a particle for the
    # resample, with E-byte elements.
    hp_dtypes = [
        {"dtype": "float32", "shape": list(shape), "ms": hp_times[(shape, (5, 5))][0],
         "plain_ms": hp_times[(shape, (5, 5))][1], "bound_ms": 2 * int(np.prod(shape)) * 4 / HBM_BYTES_PER_S * 1e3}
        for shape in PRECISION_TILES
    ]
    rs_dtypes = [{"dtype": "float32", "shape": [10240, 2048], "ms": main_rs[0], "plain_ms": main_rs[1],
                  "bound_ms": bound_rs}]
    for record in hp_dtypes + rs_dtypes:
        record["bound_share"] = record["bound_ms"] / record["ms"]
    hp_dtypes += records23["median_highpass"]
    rs_dtypes += records23["systematic_resample"]
    print(json.dumps({"kernels": [
        {
            "name": "median_highpass", "route": "cuda",
            "source": "glimpse_tpu_torch/csrc/highpass.cu",
            "replaces": "glimpse_tpu/kernels/highpass_pallas.py:95",
            "launches": launches20["median_highpass"], "max_abs_err": hp_err,
            "ms": main_hp[0], "plain_ms": main_hp[1], "bound_ms": bound_hp, "bound_by": "bytes",
            "bound_share": bound_hp / main_hp[0], "library_ms": None, "shape": [20480, 31, 31],
            "launches_by_path": by_path["median_highpass"], "phase_14_shapes": hp14, "phase_16_shapes": hp16,
            "phase_16_tile_shapes": len(shapes16), "phase_16_wide_tile": wide16, "phase_20_shapes": hp20,
            "phase_24_shapes": hp24, "phase_26_lockstep_shapes": hp26, "dtypes": hp_dtypes, "large_tile_shapes": large_records + records23["large_tiles"],
        },
        {
            "name": "systematic_resample", "route": "cuda",
            "source": "glimpse_tpu_torch/csrc/resample.cu",
            "replaces": "glimpse_tpu/kernels/resample_pallas.py:556",
            "launches": launches20["systematic_resample"], "max_abs_err": rs_err,
            "ms": main_rs[0], "plain_ms": main_rs[1], "bound_ms": bound_rs, "bound_by": "bytes",
            "bound_share": bound_rs / main_rs[0], "library_ms": None, "shape": [10240, 2048],
            "launches_by_path": by_path["systematic_resample"], "phase_20_shapes": rs20, "phase_24_shapes": rs24,
            "phase_26_lockstep_shapes": rs26,
            "dtypes": rs_dtypes,
        },
        {
            "name": "bspline_sample", "route": "cuda",
            "source": "glimpse_tpu_torch/csrc/spline.cu", "replaces": None,
            "launches": launches20["bspline_sample"], "max_abs_err": 0.0,
            "ms": main_sp["ms"], "plain_ms": main_sp["plain_ms"], "bound_ms": main_sp["bound_ms"],
            "bound_by": "bytes", "bound_share": main_sp["bound_share"], "library_ms": None,
            "shape": main_sp["shape"], "launches_by_path": by_path["bspline_sample"], "dtypes": records29,
        },
        {
            "name": "project_extract", "route": "cuda",
            "source": "glimpse_tpu_torch/csrc/project.cu", "replaces": None,
            "launches": launches20["project_extract"],
            "max_abs_err": max(r["max_abs_err"] for r in records30), "ties": sum(r["ties"] for r in records30),
            "points": sum(r["points"] for r in records30),
            "ms": main_pe["ms"], "plain_ms": main_pe["plain_ms"], "bound_ms": main_pe["bound_ms"],
            "bound_by": "bytes", "bound_share": main_pe["bound_share"], "library_ms": None,
            "shape": main_pe["shape"], "launches_by_path": by_path["project_extract"], "dtypes": records30,
        },
        {
            "name": "dem_prior", "route": "cuda",
            "source": "glimpse_tpu_torch/csrc/prior.cu", "replaces": None,
            "launches": launches14["dem_prior"], "max_abs_err": max(r["max_abs_err"] for r in records31),
            "ms": main_pr["ms"], "plain_ms": main_pr["plain_ms"], "bound_ms": main_pr["bound_ms"],
            "bound_by": "bytes", "bound_share": main_pr["bound_share"], "library_ms": None,
            "shape": main_pr["shape"], "launches_by_path": engaged["dem_prior"], "dtypes": records31,
        },
    ]}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        process_worker(json.loads(sys.argv[2]))
    elif sys.argv[1:2] == ["--scaling"]:
        scaling()
    else:
        main()
