#!/usr/bin/env python3
"""Read the compared numbers of the program and of the control on many
seeds, in one process, for setting a cell's limits:

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3

For each seed: the cell's inputs, one warm and one measured analysis of
the program as a run makes them (`harness.execute` with no window), the
reference's values, then the control: the reference put in the
program's place and computed a precision lower than the configuration
states (every step of the order chain after the integers in bfloat16,
`reference/order.py`), its YAML the values printed to four decimals.
One line per seed, then the largest program readings and the smallest
control readings as a JSON line.
"""

import os
import sys

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control_numbers(run, seed, device):
    """The compared numbers of the control on the run's seed."""
    import torch

    from benchmark import checks, harness

    frames = run.cell.traffic["frames"]
    control = harness.reference_values(run, run.system, seed, frames,
                                       device, False, torch.bfloat16)
    printed = {k: checks.fmt4(v) for k, v in control.items()}
    return {"order_gap": checks.order_gap(run.expected, control),
            "yaml_excess": checks.yaml_excess(run.expected, printed),
            "frames_short": 0.0}


def main(argv=None):
    import argparse
    import json
    import time

    import torch

    from benchmark import cells, checks, harness

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    cell = cells.load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    device = torch.device(args.device)
    program, controls = [], []
    for seed in seeds:
        t0 = time.perf_counter()
        run = harness.execute(cell, seed, 0.0, False, device=device,
                              log=lambda msg: None)
        t1 = time.perf_counter()
        ctrl = control_numbers(run, seed, device)
        program.append(run.numbers)
        controls.append(ctrl)
        print(f"seed {seed}: program " + " ".join(
            f"{k} {run.numbers[k]!r}" for k in checks.NAMES)
            + " | control " + " ".join(f"{k} {ctrl[k]!r}"
                                       for k in checks.NAMES)
            + f" | wire {dict(run.analyses[0].wires)} | "
            f"{t1 - t0:.1f} s + control {time.perf_counter() - t1:.1f} s",
            flush=True)
    print(json.dumps({
        "workload": cell.name, "seeds": seeds,
        "program_max": {k: max(p[k] for p in program) for k in checks.NAMES},
        "control_min": {k: min(c[k] for c in controls)
                        for k in checks.NAMES}}), flush=True)
    return 0


if __name__ == "__main__":
    from benchmark import use_checkout_caches

    use_checkout_caches()
    sys.exit(main())
