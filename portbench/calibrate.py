"""Readings that the check's limits are set from, at a cell's own size.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... [--controls bfloat16 --control-seeds 7,8,9]

For each seed of ``--seeds``, one tracking run of the program as a run of
the benchmark makes it (the scene, the tracker and the run's generator drawn
from that seed) and its compared numbers against the plain reference. For
each seed of ``--control-seeds``, each control: the reference computed in a
lower precision put in the program's place, held to the reference by the
same numbers. One JSON line a reading on standard output, with the
program's gap to the reference step by step (its ``quantile`` and median
over the sampled points) for the first steps. The benchmark's own runs
never run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--controls", default="")
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--device", default="cuda:0")
    args = parser.parse_args()

    import torch

    from portbench import cells, harness, program
    from portbench.reference import compare

    device = torch.device(args.device)
    cell = cells.load_cell(args.workload)
    traffic, config = cell["traffic"], cell["config"]
    spec = traffic["check"]
    steps = config["images"] - 1

    def emit(**fields):
        print(json.dumps(fields), flush=True)

    for seed in (int(s) for s in args.seeds.split(",") if s):
        start = time.perf_counter()
        scene = cells.build_scene(cell, harness.derived_seed(seed, harness.SCENE), device)
        tracker = program.build_tracker(config, traffic, scene, device)
        run_seed = harness.derived_seed(seed, 3, 0)
        _, out = program.tracking_run(tracker, traffic, scene, run_seed, steps)
        lost = harness.lost([out])
        _, rows = harness.sample(spec, 1, len(scene.points_xy), seed)
        want = harness.reference_run(cell, scene, run_seed, steps, rows, device)
        got = {"mean": out["mean"][:, torch.as_tensor(rows, device=device)]}
        readings = compare.numbers(got, want, scene.truth[1: steps + 1, rows], spec["early_steps"],
                                   spec["quantile"])
        gap = (got["mean"][:24, :, 0:2] - want["mean"][:24, :, 0:2]).abs().amax(dim=-1).double().cpu()
        curve = {f"q{spec['quantile']}": torch.quantile(gap, spec["quantile"], dim=1).tolist(),
                 "median": gap.median(dim=1).values.tolist()}
        emit(kind="program", seed=seed, lost=lost, seconds=time.perf_counter() - start, **readings, curve=curve)
        del tracker, out
    for seed in (int(s) for s in args.control_seeds.split(",") if s):
        scene = cells.build_scene(cell, harness.derived_seed(seed, harness.SCENE), device)
        _, rows = harness.sample(spec, 1, len(scene.points_xy), seed)
        run_seed = harness.derived_seed(seed, 3, 0)
        want = harness.reference_run(cell, scene, run_seed, steps, rows, device)
        for precision in (p for p in args.controls.split(",") if p):
            got = harness.reference_run(cell, scene, run_seed, steps, rows, device, precision)
            readings = compare.numbers(got, want, scene.truth[1: steps + 1, rows], spec["early_steps"],
                                       spec["quantile"])
            emit(kind=precision, seed=seed, **readings)
    return 0


if __name__ == "__main__":
    sys.exit(main())
