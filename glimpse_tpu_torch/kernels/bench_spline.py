"""Time the spline read kernel, built from one or more sources, and its plain
version on the same card.

Run on a machine with a CUDA card and the toolkit, from the root of a
checkout: ``python -m glimpse_tpu_torch.kernels.bench_spline [--dtype
NAME[,NAME...]] [A.cu B.cu ...]`` (default: the checkout's
``csrc/spline.cu``, float32). Each source must export
``glimpse_spline_sample`` with the signature the wrapper calls; the
checkout's own source is the library itself, others build with the
library's nvcc flags into ``build/glimpse_tpu_torch/bench`` (to time a
variant beside the checkout's, write it under the ignored ``build/``). For
each coefficient dtype, at each of SHAPES, the coordinates in the type the
tracker gives them (:func:`coord_dtype`), the sources are timed in turns,
A B ... B A, with CUDA events (mean of 20 launches after 3 warm-ups), the
plain version once (5 calls), and every output is held to the plain
version's with rtol = atol = 0 and equal NaN. One line per dtype and shape
gives each source's times in order beside the bound
(:func:`spline_bytes` over 3.35 TB/s). :func:`measure` times the
checkout's kernel through its wrapper alone (chip_smoke phase 29).
"""
import argparse
from pathlib import Path

import numpy as np
import torch

from . import _build, spline
from .bench_highpass import HBM_BYTES_PER_S, _time_launch

# The benchmark cells' spline reads (B, oh, ow, P): the north star's two
# observers' 17x17 SSE surfaces, rung 4's 27x27, each at 2,048 particles.
SHAPES = ((20480, 17, 17, 2048), (1024, 27, 27, 2048))
#: The coefficient types, float32 first.
DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64)


def coord_dtype(dtype: torch.dtype) -> torch.dtype:
    """The type of the coordinates the tracker reads surfaces of ``dtype``
    at: its float32 cameras' projections, float64 for float64 particles."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def spline_bytes(shape, dtype: torch.dtype) -> int:
    """The bytes a read of (B, h, w) surfaces of ``dtype`` at P particles
    each must move: rows and cols read once and the output written once, in
    the coordinates' type (the output's too: float32, float64 for float64),
    and each coefficient read once."""
    B, h, w, p = shape
    return B * p * 3 * coord_dtype(dtype).itemsize + B * h * w * dtype.itemsize


def inputs(shape, dtype, device, seed: int = 0):
    """Coefficients (B, h, w) of ``dtype`` and rows and cols (B, P) of
    :func:`coord_dtype` uniform over the surface."""
    B, h, w, p = shape
    rng = np.random.default_rng(seed)
    coeffs = torch.from_numpy(rng.normal(size=(B, h, w)) * 10.0).to(device, dtype)
    rows = torch.from_numpy(rng.uniform(0.0, h - 1.0, size=(B, p))).to(device, coord_dtype(dtype))
    cols = torch.from_numpy(rng.uniform(0.0, w - 1.0, size=(B, p))).to(device, coord_dtype(dtype))
    return coeffs, rows, cols


def _time_call(fn, reps: int = 20) -> float:
    """Mean ms of ``fn()``, a call that launches on the current stream."""
    return _time_launch(lambda: (fn(), 0)[1], reps=reps)


def measure(shape, dtype: torch.dtype) -> dict:
    """The checkout's kernel through its wrapper and the plain version on
    :func:`inputs` of ``shape`` and ``dtype`` on the card, each output held
    to the plain version's: a record of the shape, dtype, route, ms,
    plain_ms, bound_ms and bound_share."""
    B, h, w, p = shape
    coeffs, rows, cols = inputs(shape, dtype, "cuda")
    torch.testing.assert_close(spline.bspline_sample(coeffs, rows, cols),
                               spline.bspline_sample_plain(coeffs, rows, cols), rtol=0, atol=0, equal_nan=True,
                               msg=lambda m: f"spline read {shape} {dtype}: {m}")
    ms = _time_call(lambda: spline.bspline_sample(coeffs, rows, cols))
    plain_ms = _time_call(lambda: spline.bspline_sample_plain(coeffs, rows, cols), reps=5)
    bound_ms = spline_bytes(shape, dtype) / HBM_BYTES_PER_S * 1e3
    return {"dtype": str(dtype).removeprefix("torch."), "shape": list(shape), "route": spline.route((h, w), dtype),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_share": bound_ms / ms}


def bench(sources, dtypes) -> None:
    entries = [_build.entry("spline", source=Path(s)) for s in sources]
    print(torch.cuda.get_device_name(0), flush=True)
    for dtype in dtypes:
        for shape in SHAPES:
            B, h, w, p = shape
            coeffs, rows, cols = inputs(shape, dtype, "cuda")
            want = spline.bspline_sample_plain(coeffs, rows, cols)
            outs = [torch.empty_like(want) for _ in entries]
            stream = torch.cuda.current_stream().cuda_stream
            codes = _build.DTYPE_CODES[coeffs.dtype], _build.DTYPE_CODES[rows.dtype]

            def launcher(fn, out):
                return lambda: fn(coeffs.data_ptr(), rows.data_ptr(), cols.data_ptr(), out.data_ptr(), B, h, w, p,
                                  *codes, stream)

            order = list(range(len(entries))) + list(reversed(range(len(entries))))
            times = {i: [] for i in range(len(entries))}
            for i in order:
                times[i].append(_time_launch(launcher(entries[i], outs[i])))
            for source, out in zip(sources, outs):
                torch.testing.assert_close(out, want, rtol=0, atol=0, equal_nan=True,
                                           msg=lambda m: f"{source} at {shape} {dtype}: {m}")
            plain_ms = _time_call(lambda: spline.bspline_sample_plain(coeffs, rows, cols), reps=5)
            moved = spline_bytes(shape, dtype)
            bound_ms = moved / HBM_BYTES_PER_S * 1e3
            described = "; ".join(
                f"{Path(s).name} {' / '.join(f'{t:.4f}' for t in times[i])} ms"
                f" ({100 * bound_ms / min(times[i]):.1f} % of bound)"
                for i, s in enumerate(sources)
            )
            print(f"{str(dtype).removeprefix('torch.')} {B}x{h}x{w}x{p} ({spline.route((h, w), dtype)}): bound"
                  f" {bound_ms:.4f} ms ({moved / 1e6:.1f} MB); {described}; plain {plain_ms:.3f} ms", flush=True)
            del coeffs, rows, cols, want, outs


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("sources", nargs="*", default=[str(_build.SOURCE_DIR / "spline.cu")])
    parser.add_argument("--dtype", default="float32", help="comma-separated: float32,bfloat16,float16,float64")
    args = parser.parse_args(argv)
    bench(args.sources, [getattr(torch, name) for name in args.dtype.split(",")])


if __name__ == "__main__":
    main()
