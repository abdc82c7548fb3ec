"""The benchmark of glimpse_tpu_torch, one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell asks
for. ``--trace 0`` measures the cell's end-to-end metrics over a window of
whole tracking runs; ``--trace 1`` profiles one tracking run and reports the
per-layer metrics. Either way the run's outputs are then checked against
the plain reference (``portbench/reference``), each compared number is
printed beside its limit on standard error, and the last line of standard
output is the result, one JSON object. Without a CUDA card, or with fewer
than the cell asks for, the run prints no result and exits with 2.
"""
import os
import time

_STARTED = time.perf_counter()


def process_age() -> float:
    """Seconds since this process started (Linux), or 0."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        return time.clock_gettime(time.CLOCK_BOOTTIME) - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, AttributeError):
        return 0.0


_STARTED -= process_age()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]
CACHE = CHECKOUT / "build" / "portbench"
# Every cache of a build or compiler at a fixed path inside the checkout.
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "nv")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(CHECKOUT))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args()

    import torch

    from portbench import harness

    spec = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    chips = next(w["chips"] for w in spec["workloads"] if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {chips} CUDA card(s), this machine has {count}", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0", chips=chips,
                         started=_STARTED)
    found = harness.loaded()
    if found:
        print(f"portbench: forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
