"""Time the DEM prior kernel and its plain version on the same card, and hold
the kernel to the plain version.

Run on a machine with a CUDA card and the toolkit, from the root of a
checkout: ``python -m glimpse_tpu_torch.kernels.bench_prior [--dtype
NAME[,NAME...]]`` (default float32). At each of SHAPES, :func:`measure`
checks the kernel against the plain version (:func:`check`), then times the
kernel's launch alone, the wrapper and the plain version with CUDA events
(the mean of 20 launches, 5 plain calls, after 3 warm-ups), beside the byte
bound (:func:`prior_bytes` over 3.35 TB/s); one line each. chip_smoke phase
31 runs :func:`measure` through the same code.
"""
import argparse

import numpy as np
import torch

from ..track.batch import DeviceRaster
from . import _build, prior
from .bench_highpass import HBM_BYTES_PER_S, _time_launch

#: (N, P, H, W): oblique-3d.north-star's prior (10,240 points x 2,048
#: particles on its 640 x 640 DEM and sigma raster) and the same rasters at
#: rung 4's width, 1,024 points.
SHAPES = ((10240, 2048, 640, 640), (1024, 2048, 640, 640))
#: The particle types, float32 first.
DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64)
#: The rasters' layouts :func:`inputs` makes: a DEM and a sigma raster on one
#: grid (the tracker's, from one interpolant), the sigma on a grid of its own,
#: a 1 x 1 DEM, a 1 x 1 sigma of 0.5 m (a host motion's constant sigma), one
#: of 0, and a DEM one cell high with a sigma one cell wide.
CASES = ("grid", "grids", "single_dem", "single_sigma", "zero_sigma", "thin")
#: The world the rasters cover: oblique-3d's x -200..600, y 600..-200.
EXTENT = (-200.0, 600.0, 600.0, -200.0)


def _raster(values: np.ndarray, device, extent=EXTENT) -> DeviceRaster:
    """A raster of ``values`` (H, W) over ``extent`` (x0, x1, y0, y1); a 1 x 1
    raster has the infinite extent of ``DeviceRaster.constant``."""
    H, W = values.shape
    x0, x1, y0, y1 = extent
    grid = (0.0, 0.0, 1e30, 1e30) if (H, W) == (1, 1) else (x0, y0, (x1 - x0) / W, (y1 - y0) / H)
    return DeviceRaster(torch.from_numpy(values.astype(np.float32)).to(device),
                        *(torch.tensor(v, dtype=torch.float32, device=device) for v in grid))


def _cell(raster: DeviceRaster, xy) -> tuple:
    """The (row, col) of the cell that holds world ``xy``."""
    H, W = raster.array.shape
    col = int(np.clip(np.floor((xy[0] - float(raster.x0)) / float(raster.dx)), 0, W - 1))
    row = int(np.clip(np.floor((xy[1] - float(raster.y0)) / float(raster.dy)), 0, H - 1))
    return row, col


def inputs(shape, dtype: torch.dtype, device, seed: int = 0, case: str = "grid") -> dict:
    """The prior's arguments at ``shape`` (N, P, H, W): particles (N, P, 6)
    of ``dtype`` about points spread 5 % past every edge of the rasters (so
    samples extrapolate on all four sides), 3 m apart, z within a few metres
    of the surface; and the rasters of ``case`` (one of CASES). A DEM of
    (H, W) cells has NaN in the cell under point 3, a sigma raster cells of
    0 and -0.5 around point 4 and NaN under point 5; point 6's first three
    particles sit at y +inf, x -inf and x 1e7. No coordinate is NaN: the
    plain version cannot index one (``long()`` of NaN is the most negative
    int64, on the card and on the CPU)."""
    if case not in CASES:
        raise ValueError(f"case must be one of {CASES}, got {case!r}")
    N, P, H, W = shape
    rng = np.random.default_rng(seed)
    x0, x1, y0, y1 = EXTENT
    span = np.array([x1 - x0, y0 - y1])
    centers = np.array([x0, y1]) - 0.05 * span + rng.uniform(0.0, 1.1, (N, 2)) * span
    for n, xy in zip(range(3, N), ((100.0, 200.0), (300.0, 100.0), (400.0, 400.0))):
        centers[n] = xy
    yy, xx = np.meshgrid(np.linspace(y0, y1, H), np.linspace(x0, x1, W), indexing="ij")
    surface = 100.0 + 5.0 * np.sin(xx / 40.0) + 3.0 * np.cos(yy / 25.0) + rng.normal(0.0, 0.2, (H, W))
    sigma = rng.uniform(0.3, 1.5, (H, W))
    dem = _raster(surface, device)
    dem_sigma = _raster(sigma, device)
    if case == "grids":
        h, w = H // 2 + 1, W // 2 + 3
        dem_sigma = _raster(rng.uniform(0.3, 1.5, (h, w)), device, (x0 - 7.0, x1 + 9.0, y0 + 5.0, y1 - 11.0))
    elif case == "single_dem":
        dem = _raster(np.full((1, 1), 101.5), device)
    elif case in ("single_sigma", "zero_sigma"):
        dem_sigma = _raster(np.full((1, 1), 0.5 if case == "single_sigma" else 0.0), device)
    elif case == "thin":
        dem = _raster(surface[H // 2: H // 2 + 1], device)
        dem_sigma = _raster(sigma[:, W // 3: W // 3 + 1], device)
    for raster, value, at in ((dem, float("nan"), [3]), (dem_sigma, 0.0, [4]), (dem_sigma, float("nan"), [5])):
        H_r, W_r = raster.array.shape
        for n in (n for n in at if n < N and H_r * W_r > 1):
            row, col = _cell(raster, centers[n])
            raster.array[row, col] = value
            if value == 0.0:
                raster.array[max(row - 1, 0): row + 2, max(col - 1, 0): col + 2] = -0.5
                raster.array[row, col] = 0.0
    particles = rng.normal(0.0, 1.0, (N, P, 6))
    particles[..., 0:2] = centers[:, None, :] + rng.normal(0.0, 3.0, (N, P, 2))
    particles[..., 2] = 100.0 + rng.normal(0.0, 4.0, (N, P))
    if N > 6 and P >= 3:
        particles[6, 0, 1], particles[6, 1, 0], particles[6, 2, 0] = np.inf, -np.inf, 1e7
    return {"particles": torch.from_numpy(particles).to(device, dtype), "dem": dem, "dem_sigma": dem_sigma}


def prior_bytes(shape, dtype: torch.dtype) -> int:
    """The bytes one prior of ``shape`` (N, P, H, W) with particles of
    ``dtype`` must move: x, y and z read once, the prior written once
    (float32, float64 for float64 particles), both rasters read once."""
    N, P, H, W = shape
    return N * P * (3 * dtype.itemsize + prior.compute_dtype(dtype).itemsize) + 2 * H * W * 4


def check(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest |kernel - plain| of two priors (NaN equal to NaN), which
    must be 0: AssertionError on another type or shape, or any difference."""
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"prior {got.dtype} {tuple(got.shape)} against {want.dtype} {tuple(want.shape)}")
    same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    err = float(torch.where(same, 0.0, (got.double() - want.double()).abs().nan_to_num(nan=float("inf"))).max())
    if err != 0.0:
        first = np.unravel_index(int(torch.argmin(same.flatten().int())), tuple(got.shape))
        raise AssertionError(f"prior differs from the plain version, first at {first}: largest |kernel - plain|"
                             f" {err!r}")
    return err


def _launcher(args: dict, out: torch.Tensor):
    """A call of the kernel's C entry on the arguments :func:`prior.dem_prior`
    launches it with, writing ``out``: its launch alone."""
    fn = _build.entry("prior")
    launch_args = _build.c_arguments(prior.launch_args(out, **args))
    stream = torch.cuda.current_stream().cuda_stream
    return lambda: fn(*launch_args, stream)


def measure(shape, dtype: torch.dtype) -> dict:
    """On the card at ``shape`` with particles of ``dtype`` and the rasters on
    one grid: one wrapper call (one launch) held to the plain version by
    :func:`check`, then the kernel's launch alone, the wrapper and the plain
    version timed. A record of the shape, dtype, ms (launch alone),
    wrapper_ms, plain_ms, bound_ms, bound_share and max_abs_err."""
    args = inputs(shape, dtype, "cuda", seed=sum(shape))
    before = prior.dem_prior.launches
    got = prior.dem_prior(**args)
    if prior.dem_prior.launches != before + 1:
        raise AssertionError(f"prior {shape}: {prior.dem_prior.launches - before} launches")
    max_abs_err = check(got, prior.dem_prior_plain(**args))
    ms = _time_launch(_launcher(args, got))
    wrapper_ms = _time_launch(lambda: (prior.dem_prior(**args), 0)[1])
    plain_ms = _time_launch(lambda: (prior.dem_prior_plain(**args), 0)[1], reps=5)
    bound_ms = prior_bytes(shape, dtype) / HBM_BYTES_PER_S * 1e3
    return {"dtype": str(dtype).removeprefix("torch."), "shape": list(shape), "ms": ms, "wrapper_ms": wrapper_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_share": bound_ms / ms, "max_abs_err": max_abs_err}


def describe(record: dict) -> str:
    N, P, H, W = record["shape"]
    return (f"{N}x{P} on {H}x{W} {record['dtype']}: kernel {record['ms']:.4f} ms (bound {record['bound_ms']:.4f},"
            f" {100 * record['bound_share']:.1f} %), wrapper {record['wrapper_ms']:.4f}, plain"
            f" {record['plain_ms']:.3f}; largest |kernel - plain| {record['max_abs_err']!r}")


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
