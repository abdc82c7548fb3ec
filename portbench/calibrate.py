"""Readings that the check's limits are set from, at a cell's own size.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... [--controls bfloat16 --control-seeds 7,8,9]

For each seed of ``--seeds``, one tracking run of the program as a run of
the benchmark makes it (the scene, the tracker and the run's generator drawn
from that seed) and its compared numbers against the plain reference. For
each seed of ``--control-seeds``, each control: the reference computed in a
lower precision put in the program's place, held to the reference by the
same numbers. One JSON line a reading on standard output, with the
program's gap to the reference step by step (its ``quantile`` and median
over the sampled points) for the first steps. The program module, the
reference and the compared numbers are the configuration's
(:func:`portbench.cells.parts`). The benchmark's own runs never run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from portbench import cells, harness  # noqa: E402


def program_reading(cell: dict, seed: int, device) -> dict:
    """The compared numbers of one tracking run of the program, as a run of
    the benchmark with ``seed`` makes it, with its lost point-steps, its
    seconds and the gap curve of its first steps."""
    traffic, config = cell["traffic"], cell["config"]
    parts = cells.parts(config)
    spec = traffic["check"]
    steps = config["images"] - 1
    start = time.perf_counter()
    scene = cells.build_scene(cell, harness.derived_seed(seed, harness.SCENE), device)
    tracker = parts.program.build_tracker(config, traffic, scene, device)
    run_seed = harness.derived_seed(seed, 3, 0)
    _, out = parts.program.tracking_run(tracker, traffic, scene, run_seed, steps)
    lost = harness.lost([out])
    _, rows = harness.sample(spec, 1, len(scene.points_xy), seed)
    want = harness.reference_run(cell, scene, run_seed, steps, rows, device)
    got = {"mean": out["mean"][:, torch.as_tensor(rows, device=device)]}
    readings = parts.numbers(got, want, scene.truth[1: steps + 1, rows], spec["early_steps"], spec["quantile"])
    gap = (got["mean"][:24, :, 0:2] - want["mean"][:24, :, 0:2]).abs().amax(dim=-1).double().cpu()
    curve = {f"q{spec['quantile']}": torch.quantile(gap, spec["quantile"], dim=1).tolist(),
             "median": gap.median(dim=1).values.tolist()}
    return {"lost": lost, "seconds": time.perf_counter() - start, **readings, "curve": curve}


def control_readings(cell: dict, seed: int, precisions, device) -> dict:
    """{precision: the compared numbers of the reference computed in that
    precision, in the program's place} on the run a benchmark run with
    ``seed`` checks."""
    numbers = cells.parts(cell["config"]).numbers
    spec = cell["traffic"]["check"]
    steps = cell["config"]["images"] - 1
    scene = cells.build_scene(cell, harness.derived_seed(seed, harness.SCENE), device)
    _, rows = harness.sample(spec, 1, len(scene.points_xy), seed)
    run_seed = harness.derived_seed(seed, 3, 0)
    want = harness.reference_run(cell, scene, run_seed, steps, rows, device)
    readings = {}
    for precision in precisions:
        got = harness.reference_run(cell, scene, run_seed, steps, rows, device, precision)
        readings[precision] = numbers(got, want, scene.truth[1: steps + 1, rows], spec["early_steps"],
                                      spec["quantile"])
    return readings


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--controls", default="")
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--device", default="cuda:0")
    args = parser.parse_args()

    device = torch.device(args.device)
    cell = cells.load_cell(args.workload)
    cells.parts(cell["config"])

    def emit(**fields):
        print(json.dumps(fields), flush=True)

    for seed in (int(s) for s in args.seeds.split(",") if s):
        emit(kind="program", seed=seed, **program_reading(cell, seed, device))
    precisions = [p for p in args.controls.split(",") if p]
    for seed in (int(s) for s in args.control_seeds.split(",") if s):
        for precision, readings in control_readings(cell, seed, precisions, device).items():
            emit(kind=precision, seed=seed, **readings)
    return 0


if __name__ == "__main__":
    sys.exit(main())
