"""Time high-pass kernels built from several sources on the same card.

Run on a machine with a CUDA card and the toolkit, from the root of a
checkout: ``python -m glimpse_tpu_torch.kernels.bench_highpass [--dtype
NAME[,NAME...]] A.cu B.cu`` (default: the checkout's ``csrc/highpass.cu``,
float32). Each source must export ``glimpse_median_highpass_typed`` with the
signature the wrapper calls; each is built with the library's nvcc flags
(the checkout's own source as the library itself, others into
``build/glimpse_tpu_torch/bench``). To time the parent commit's kernel
beside the checkout's, write its source under the ignored ``build/``
(``git show HEAD~1:glimpse_tpu_torch/csrc/highpass.cu >
build/parent.cu``) and pass it first. For each dtype, at each shape of
SHAPES (5x5 taps), the sources are timed in turns, A B ... B A, with CUDA
events (mean of 20 launches after 3 warm-ups), and every output is checked
against the plain version bit for bit. One line per dtype and shape gives
each source's times, in order, beside the bound: each input and output
element once over 3.35 TB/s. A line before them gives the card's issue rate,
per clock per SM, of each of _PIPE_KINDS, from clock64() in a kernel that
runs each in 8 independent chains per thread, and the SM clock during each.

``python -m glimpse_tpu_torch.kernels.bench_highpass --routes`` times the
checkout's two routes instead, the staged one (tiles in shared memory) and
the global one (tiles read from device memory), in turns, staged global
global staged, on the same tiles of each of ROUTE_CASES, each output checked
against the plain version; one line per case.
"""
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from . import _build, highpass
from .highpass import median_highpass_plain

# The main paths' stacks (phase 8's search tiles, phase 14's search tiles and
# templates, chip_smoke's PRECISION_TILES), then two small ones.
SHAPES = ((20480, 31, 31), (10240, 41, 41), (10240, 15, 15), (1024, 41, 41), (1024, 15, 15))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA's data sheet)


def _time(fn, tiles, out, reps: int = 20) -> float:
    n, h, w = tiles.shape
    stream = torch.cuda.current_stream().cuda_stream
    code = _build.DTYPE_CODES[tiles.dtype]
    return _time_launch(lambda: fn(tiles.data_ptr(), out.data_ptr(), n, h, w, 5, 5, code, stream), reps)


def _time_launch(launch_code, reps: int = 20) -> float:
    """Mean ms of ``launch_code()``, a launch that returns a CUDA error code,
    from CUDA events over ``reps`` launches after 3 warm-ups."""

    def launch():
        code = launch_code()
        if code != 0:
            raise RuntimeError(f"CUDA error {code}")

    for _ in range(3):
        launch()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        launch()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# Issue rate of one instruction: a kernel of 1,024 threads on every SM runs
# it in 8 independent chains; instructions per clock per SM, from clock64().
# The float64 compare and select runs as the network's compare-exchange,
# the min and max of one pair, and counts two: with NaN tests, as the
# generic and global float64 kernels run it, and without, as the staged
# float64 kernel does (its NaN goes in a flag).
_PIPE_SOURCE = r"""
#include <cuda_runtime.h>
#include <math.h>
#define CHAIN(NAME, T, STEP)                                                     \
  __global__ void NAME(void* raw, long long* cycles, int iters) {               \
    T* data = static_cast<T*>(raw);                                             \
    T a[8], b[8];                                                               \
    for (int i = 0; i < 8; ++i) { a[i] = data[i]; b[i] = data[8 + i]; }         \
    __syncthreads();                                                            \
    const long long start = clock64();                                          \
    for (int k = 0; k < iters; ++k) {                                           \
      _Pragma("unroll") for (int i = 0; i < 8; ++i) { STEP; }                   \
    }                                                                           \
    __syncthreads();                                                            \
    if (threadIdx.x == 0) cycles[blockIdx.x] = clock64() - start;               \
    bool keep = false;                                                          \
    for (int i = 0; i < 8; ++i) keep |= a[i] == b[(i + 1) & 7];                 \
    if (keep) data[16 + threadIdx.x] = a[0];                                    \
  }
#define ASM(OP, C) asm volatile(OP " %0, %0, %1;" : "+" C(a[i]) : C(b[i]))
CHAIN(chain_min_nan, float, ASM("min.NaN.f32", "f"))
CHAIN(chain_min, float, ASM("min.f32", "f"))
CHAIN(chain_add, float, ASM("add.f32", "f"))
CHAIN(chain_min_nan_bf16x2, unsigned, ASM("min.NaN.bf16x2", "r"))
CHAIN(chain_min_nan_f16x2, unsigned, ASM("min.NaN.f16x2", "r"))
CHAIN(chain_min_f64, double, ASM("min.f64", "d"))
CHAIN(chain_select_f64, double,
      const double x = a[i]; const double y = b[i]; const bool nan = x != x || y != y;
      a[i] = nan ? static_cast<double>(NAN) : (y < x ? y : x); b[i] = nan ? static_cast<double>(NAN) : (x < y ? y : x))
CHAIN(chain_exchange_f64, double,
      const double x = a[i]; const double y = b[i]; const bool p = y < x; a[i] = p ? y : x; b[i] = p ? x : y)

extern "C" int pipe_run(int kind, void* data, long long* cycles, int iters, int blocks) {
  void (*kernels[])(void*, long long*, int) = {chain_min_nan, chain_min, chain_add, chain_min_nan_bf16x2,
                                               chain_min_nan_f16x2, chain_min_f64, chain_select_f64, chain_exchange_f64};
  kernels[kind]<<<blocks, 1024>>>(data, cycles, iters);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  return static_cast<int>(err);
}
"""
# (name, instructions a chain step), in pipe_run's order.
_PIPE_KINDS = (("min.NaN.f32", 1), ("min.f32", 1), ("add.f32", 1), ("min.NaN.bf16x2", 1), ("min.NaN.f16x2", 1),
               ("min.f64", 1), ("float64 compare-and-select min/max", 2),
               ("float64 compare-exchange without NaN tests min/max", 2))


def pipe_rates(iters: int = 4096) -> dict:
    """Instructions per clock per SM of each of _PIPE_KINDS, one block of
    1,024 threads on every SM, the median over the SMs; and the SM clock
    during each, the median block's cycles over the launch's event time (a
    lower bound: the launch's own time is in the denominator)."""
    source = _build.BUILD_DIR / "bench" / "pipe.cu"
    source.parent.mkdir(parents=True, exist_ok=True)
    source.write_text(_PIPE_SOURCE)
    run = _build.load("pipe", source).pipe_run  # int pipe_run(int, void*, long long*, int, int)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    data = torch.rand(2 * (16 + 1024), device="cuda").view(torch.float64).abs()  # finite doubles in (0, 1)
    cycles = torch.zeros(sms, dtype=torch.int64, device="cuda")
    rates = {}
    for kind, (name, per_step) in enumerate(_PIPE_KINDS):
        for _ in range(2):  # the first launch warms up
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            code = run(kind, ctypes.c_void_p(data.data_ptr()), ctypes.c_void_p(cycles.data_ptr()), iters, sms)
            end.record()
            if code != 0:
                raise RuntimeError(f"pipe_run({name}) failed: CUDA error {code}")
        end.synchronize()
        median = float(cycles.double().median())
        rates[name] = 1024 * 8 * per_step * iters / median
        rates[f"SM GHz during {name}"] = median / (start.elapsed_time(end) * 1e6)
    return rates


# (shape, window, dtype) of each case --routes times: the main paths'
# stacks, phase 24's tile at fewer tiles a stack, single tiles of the host
# Tracker's sizes, generic windows, and the main paths' stacks (SHAPES[:3])
# in each of the 16- and 64-bit types.
ROUTE_CASES = (
    *(((n, 31, 31), (5, 5), torch.float32) for n in (20480, 10240, 2048, 512, 128, 64, 8, 1)),
    ((10240, 41, 41), (5, 5), torch.float32), ((10240, 15, 15), (5, 5), torch.float32),
    ((2560, 41, 41), (5, 5), torch.float32), ((64, 41, 41), (5, 5), torch.float32),
    *(((1, h, w), (5, 5), torch.float32) for h, w in ((15, 15), (31, 42), (100, 100), (160, 160))),
    ((1024, 31, 31), (7, 5), torch.float32), ((37, 31, 31), (3, 5), torch.float32),
    ((1, 200, 200), (3, 5), torch.float32), ((2, 260, 260), (3, 5), torch.bfloat16),
    *((shape, (5, 5), dtype) for dtype in (torch.bfloat16, torch.float16, torch.float64) for shape in SHAPES[:3]),
    ((1, 110, 110), (5, 5), torch.float64),
)
STAGED, GLOBAL = 1, 2  # csrc/highpass.cu's Route


def time_routes(cases=ROUTE_CASES) -> None:
    """One line per case: both routes' ms in turns, each output held to the
    plain version bit for bit, beside the byte bound."""
    fn = _build.entry("highpass", "glimpse_median_highpass_route")
    rng = np.random.default_rng(0)
    stream = torch.cuda.current_stream().cuda_stream
    for shape, size, dtype in cases:
        tiles = torch.from_numpy(rng.normal(size=shape)).to("cuda", dtype)
        want = median_highpass_plain(tiles, size)
        times = {STAGED: [], GLOBAL: []}
        for route in (STAGED, GLOBAL, GLOBAL, STAGED):
            out = torch.empty_like(tiles)
            times[route].append(_time_launch(
                lambda: fn(tiles.data_ptr(), out.data_ptr(), *shape, *size, _build.DTYPE_CODES[dtype], route, stream)))
            if not torch.equal(out, want):
                raise AssertionError(f"route {route} differs from the plain version at {shape} {size} {dtype}")
        bound = 2 * tiles.numel() * tiles.element_size() / HBM_BYTES_PER_S * 1e3
        print(
            f"{shape} {size[0]}x{size[1]} {str(dtype).removeprefix('torch.')}"
            f" ({highpass.kernel_variant(size, dtype, shape)} by the launcher's choice): bound {bound:.4f} ms;"
            f" staged {' '.join(f'{t:.4f}' for t in times[STAGED])} ms;"
            f" global {' '.join(f'{t:.4f}' for t in times[GLOBAL])} ms",
            flush=True,
        )


def _tiles(rng, shape, dtype):
    """Normal tiles of ``dtype`` on the card; float64 ones hold values
    float32 cannot."""
    tiles = rng.normal(size=shape)
    return torch.from_numpy(tiles if dtype == torch.float64 else tiles.astype(np.float32)).to("cuda", dtype)


def main(argv) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("bench_highpass needs a CUDA card")
    dtypes = [torch.float32]
    if argv[:1] == ["--dtype"]:
        dtypes = [getattr(torch, name) for name in argv[1].split(",")]
        argv = argv[2:]
    if argv == ["--routes"]:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True).stdout.strip()
        print(f"{card}; the checkout's csrc/highpass.cu, staged route against global route", flush=True)
        time_routes()
        return
    sources = [Path(a) for a in argv] or [_build.SOURCE_DIR / "highpass.cu"]
    fns = [_build.entry("highpass", source=s) for s in sources]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"{card}; sources in order: {', '.join(map(str, sources))}", flush=True)
    rates = pipe_rates()
    print("issue rate, instructions per clock per SM: " + ", ".join(f"{k} {v:.2f}" for k, v in rates.items()), flush=True)
    rng = np.random.default_rng(0)
    for dtype in dtypes:
        for shape in SHAPES:
            tiles = _tiles(rng, shape, dtype)
            want = median_highpass_plain(tiles, (5, 5))
            order = list(range(len(fns))) + list(reversed(range(len(fns))))
            times = [[] for _ in fns]
            for i in order:
                out = torch.empty_like(tiles)
                times[i].append(_time(fns[i], tiles, out))
                if not torch.equal(out, want):
                    raise AssertionError(f"{sources[i]} differs from the plain version at {shape} {dtype}")
            bound = 2 * tiles.numel() * tiles.element_size() / HBM_BYTES_PER_S * 1e3
            print(
                f"{shape} 5x5 {str(dtype).removeprefix('torch.')} ({highpass.kernel_variant((5, 5), dtype, shape)}"
                f" in the checkout): bound {bound:.4f} ms; "
                + "; ".join(f"source {i + 1} {' '.join(f'{t:.4f}' for t in ts)} ms ({bound / min(ts):.3f} of bound)"
                            for i, ts in enumerate(times)),
                flush=True,
            )


if __name__ == "__main__":
    main(sys.argv[1:])
