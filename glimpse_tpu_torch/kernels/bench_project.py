"""Time the observer front-end kernel and its plain version on the same card,
and hold the kernel to the plain version.

Run on a machine with a CUDA card and the toolkit, from the root of a
checkout: ``python -m glimpse_tpu_torch.kernels.bench_project [--dtype
NAME[,NAME...]]`` (default float32). At each of SHAPES, the benchmark cells'
front ends, :func:`measure` checks the kernel against the plain version
(:func:`check`), then times the kernel's launch alone, the wrapper (its
checks and allocations around the launch) and the plain version with CUDA events
(the mean of 20 launches, 5 plain calls, after 3 warm-ups), beside the byte
bound (:func:`project_bytes` over 3.35 TB/s); one line each. chip_smoke
phase 30 runs :func:`measure` through the same code.
"""
import argparse

import numpy as np
import torch

from ..ops import projection
from . import _build, project
from .bench_highpass import HBM_BYTES_PER_S, _time_launch

#: The benchmark cells' front ends, (O, N, P, H, W, th, tw, sh, sw):
#: columbia-2obs.north-star (two observers, 512 x 512 frames, 31 x 31 search
#: tiles), nadir-1obs.rung4 (1,024 x 1,024 frames, 41 x 41) and
#: oblique-3d.north-star (512 x 512, 41 x 41), each at 2,048 particles.
SHAPES = (
    (2, 10240, 2048, 512, 512, 15, 15, 31, 31),
    (1, 1024, 2048, 1024, 1024, 15, 15, 41, 41),
    (1, 10240, 2048, 512, 512, 15, 15, 41, 41),
)
#: The particle types, float32 first.
DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64)
#: How near a half-pixel tie, in units of the computing type's epsilon times
#: the mean's magnitude, the plain version's weighted mean may lie where the
#: kernel's corner differs: the two sum 2,048 products in other orders, each
#: within some 30 roundings of the exact sum.
TIE_EPSILONS = 64


def shape_label(shape) -> str:
    O, N, P, H, W, th, tw, sh, sw = shape
    return f"{O}x{N}x{P} {H}x{W} {sh}x{sw}"


def inputs(shape, dtype: torch.dtype, device, seed: int = 0, duv_dtype=None) -> dict:
    """The front end's arguments at ``shape`` (O, N, P, H, W, th, tw, sh,
    sw): particles of ``dtype`` around points spread 15 % past every edge of
    the frame (so corners clamp on all four sides), nadir cameras with radial
    and tangential distortion, every odd observer with an elevation
    correction. Point n % 97 == 0 has every particle above the camera
    (behind its image plane), n % 89 == 1 half of them, n % 83 == 2 one
    particle at NaN; weights are positive with a zero in every 7th point.
    Template offsets are of ``duv_dtype``, by default of the computing type,
    as the tracker makes them."""
    O, N, P, H, W, th, tw, sh, sw = shape
    rng = np.random.default_rng(seed)
    cams = np.zeros((O, 20))
    for o in range(O):
        cams[o, 0:6] = [W / 2 + 3 * o, H / 2 - 2 * o, 1000 + 50 * o, 0.5 * o, -90 + o, 0.3 * o]
        cams[o, 6:12] = [W, H, 1000, 1000 + 5 * o, 1.5, -2.0]
        cams[o, 12:18] = rng.uniform(-0.02, 0.02, 6)
        cams[o, 18:20] = rng.uniform(-1e-3, 1e-3, 2)
    corrections = [(projection.EARTH_RADIUS, projection.REFRACTION) if o % 2 else None for o in range(O)]
    centers = np.stack([rng.uniform(-0.15 * W, 1.15 * W, N), rng.uniform(-0.15 * H, 1.15 * H, N),
                        rng.normal(0.0, 5.0, N)], axis=-1)
    particles = rng.normal(0.0, 1.0, (N, P, 6))
    particles[..., 0:3] = centers[:, None, :] + rng.normal(0.0, 3.0, (N, P, 3))
    n = np.arange(N)
    particles[n % 97 == 0, :, 2] = 5000.0
    particles[n % 89 == 1, : P // 2, 2] = 5000.0
    particles[n % 83 == 2, 0, 0] = np.nan
    weights = rng.exponential(1.0, (N, P))
    weights[n % 7 == 3, 0] = 0.0
    compute = project.compute_dtype(dtype)
    duv = rng.uniform(-0.5, 0.5, (O, N, 2))
    return {
        "images": torch.from_numpy(rng.normal(0.0, 10.0, (O, H, W))).to(device, dtype),
        "camera_vectors": torch.from_numpy(cams).to(device, torch.float32),
        "corrections": corrections,
        "particles": torch.from_numpy(particles).to(device, dtype),
        "weights": torch.from_numpy(weights).to(device, dtype),
        "template_duv": torch.from_numpy(duv).to(device, duv_dtype or compute),
        "template_size": (th, tw),
        "search_size": (sh, sw),
    }


def project_bytes(shape, dtype: torch.dtype) -> int:
    """The bytes one front end of ``shape`` with particles of ``dtype`` must
    move: x, y, z and the weight read once (4 elements a particle), cols and
    rows written once (float32, float64 for float64 particles), each tile
    written once and each image read once."""
    O, N, P, H, W, th, tw, sh, sw = shape
    item = dtype.itemsize
    coord = project.compute_dtype(dtype).itemsize
    return N * P * 4 * item + O * N * P * 2 * coord + O * N * sh * sw * item + O * H * W * item


def plain_means(images, camera_vectors, corrections, particles, weights, template_duv, template_size,
                search_size) -> torch.Tensor:
    """The plain version's weighted-mean projections (O N, 2), (u, v), in
    the computing type."""
    w_norm = weights / torch.sum(weights, dim=-1, keepdim=True)
    means = []
    for o in range(images.shape[0]):
        u, v = project.projections(camera_vectors[o], corrections[o], particles)
        means.append(torch.stack([torch.sum(u * w_norm, dim=1), torch.sum(v * w_norm, dim=1)], dim=-1))
    return torch.cat(means)


def check(got, want, means, search_size) -> dict:
    """Hold the kernel's (tiles, cols, rows) to the plain version's: where a
    point's corner is the plain version's (its cols and rows sit whole
    pixels away otherwise), tiles, cols and rows bit-equal; a corner one
    pixel off only where the plain mean lies within TIE_EPSILONS epsilons
    of its magnitude from a half-pixel tie. Returns {"points": O N,
    "ties": the points whose corner moved, "max_abs_err": the largest
    |kernel - plain| of tiles, cols and rows over the points whose corners
    agree}; raises AssertionError."""
    tiles, cols, rows = got
    want_tiles, want_cols, want_rows = want
    if tiles.dtype != want_tiles.dtype or cols.dtype != want_cols.dtype or rows.dtype != want_rows.dtype:
        raise AssertionError(f"types {tiles.dtype}, {cols.dtype}, {rows.dtype} against {want_tiles.dtype},"
                             f" {want_cols.dtype}, {want_rows.dtype}")
    if tiles.shape != want_tiles.shape or cols.shape != want_cols.shape or rows.shape != want_rows.shape:
        raise AssertionError(f"shapes {tiles.shape}, {cols.shape} against {want_tiles.shape}, {want_cols.shape}")
    # The kernel's corner less the plain version's, from a particle's index.
    moved = torch.stack([torch.round((want_cols[:, 0] - cols[:, 0]).double()),
                         torch.round((want_rows[:, 0] - rows[:, 0]).double())], dim=-1).cpu()
    same = (moved == 0).all(dim=-1)
    max_abs_err = 0.0
    for name, a, b in (("tiles", tiles, want_tiles), ("cols", cols, want_cols), ("rows", rows, want_rows)):
        a, b = a.view(a.shape[0], -1), b.view(b.shape[0], -1)
        # Equal NaNs count as equal.
        equal = (a == b) | (torch.isnan(a) & torch.isnan(b))
        err = torch.where(equal, 0.0, (a.double() - b.double()).abs().nan_to_num(nan=float("inf")))
        kept = same.to(err.device)
        max_abs_err = max(max_abs_err, float(err[kept].max()) if bool(kept.any()) else 0.0)
        equal = equal.all(dim=-1).cpu()
        if not equal[same].all():
            first = int(torch.nonzero(same & ~equal)[0])
            raise AssertionError(f"{name} of point {first} differ where the corners agree (largest |kernel -"
                                 f" plain| there {max_abs_err!r})")
    means = means.double().cpu()
    offset = means - torch.tensor([search_size[1] * 0.5, search_size[0] * 0.5], dtype=torch.float64)
    tie = (offset - torch.floor(offset) - 0.5).abs()
    allowed = TIE_EPSILONS * torch.finfo(cols.dtype).eps * torch.clamp(means.abs(), min=1.0)
    off = moved != 0
    if (moved.abs() > 1).any() or (off & (tie > allowed)).any():
        bad = torch.nonzero(off & ((tie > allowed) | (moved.abs() > 1)))[:5].tolist()
        raise AssertionError(f"corners moved away from a tie at (point, axis) {bad}: moved"
                             f" {[moved[p, a].item() for p, a in bad]}, plain means"
                             f" {[means[p, a].item() for p, a in bad]}")
    return {"points": int(cols.shape[0]), "ties": int((~same).sum()), "max_abs_err": max_abs_err}


def _launcher(args: dict, outputs):
    """A call of the kernel's C entry on the arguments
    :func:`project.project_extract` launches it with, writing ``outputs``:
    its launch alone."""
    fn = _build.entry("project")
    launch_args = project.launch_args(outputs, **args)
    stream = torch.cuda.current_stream().cuda_stream
    return lambda: fn(*_build.c_arguments(launch_args), stream)


def measure(shape, dtype: torch.dtype) -> dict:
    """On the card at ``shape`` with particles of ``dtype``: one wrapper call
    (one launch) held to the plain version by :func:`check`, then the
    kernel's launch alone, the wrapper and the plain version timed. A
    record of the shape, dtype, ms (launch alone), wrapper_ms, plain_ms,
    bound_ms, bound_share, the points whose corner a tie moved and the
    largest |kernel - plain| where the corners agree (:func:`check`)."""
    args = inputs(shape, dtype, "cuda", seed=sum(shape))
    before = project.project_extract.launches
    got = project.project_extract(**args)
    if project.project_extract.launches != before + 1:
        raise AssertionError(f"front end {shape_label(shape)}: {project.project_extract.launches - before} launches")
    want = project.project_extract_plain(**args)
    held = check(got, want, plain_means(**args), args["search_size"])
    del want
    ms = _time_launch(_launcher(args, got))
    wrapper_ms = _time_launch(lambda: (project.project_extract(**args), 0)[1])
    plain_ms = _time_launch(lambda: (project.project_extract_plain(**args), 0)[1], reps=5)
    bound_ms = project_bytes(shape, dtype) / HBM_BYTES_PER_S * 1e3
    return {"dtype": str(dtype).removeprefix("torch."), "shape": list(shape), "ms": ms, "wrapper_ms": wrapper_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_share": bound_ms / ms, "ties": held["ties"],
            "points": held["points"], "max_abs_err": held["max_abs_err"]}


def describe(record: dict) -> str:
    return (f"{shape_label(record['shape'])} {record['dtype']}: kernel {record['ms']:.4f} ms (bound"
            f" {record['bound_ms']:.4f}, {100 * record['bound_share']:.1f} %), wrapper {record['wrapper_ms']:.4f},"
            f" plain {record['plain_ms']:.3f}; {record['ties']} of {record['points']} corners moved by a tie,"
            f" largest |kernel - plain| {record['max_abs_err']!r} where they agree")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--dtype", default="float32", help="comma-separated: float32,bfloat16,float16,float64")
    args = parser.parse_args(argv)
    print(torch.cuda.get_device_name(0), flush=True)
    for dtype in (getattr(torch, name) for name in args.dtype.split(",")):
        for shape in SHAPES:
            print(describe(measure(shape, dtype)), flush=True)
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
