"""The readings a cell's limits are set from, at the cell's own size, in one
process: the comparison's numbers for the port over many seeds (each after
a short window at the cell's load), and for the control, the reference in
TF32 put in the port's place, over a few; in a train cell also each fault
of ``train_faults.py`` planted in the port, on the control's seeds.  The
benchmark's own runs do not run this.

    python3 -m portbench.calibrate --workload <name> --seeds <n> ... \\
        --control-seeds <n> ... [--faults <name> ...] [--seconds 1] [--out <file.json>]
"""
from __future__ import annotations

import argparse
import json
import sys

from . import check, harness, train_faults


def readings(workload: str, seeds, control: bool, seconds: float, device_name: str = "cuda", **cell_options):
    """{seed: the worst of each number over the cell's batches}.  The
    control also follows a window: in a train cell it makes each step of
    the window's last pass from the state the port had before it."""
    out = {}
    for seed in seeds:
        cell = harness.make_cell(workload, seed, device_name, **cell_options)
        cell.window(seconds)
        out[seed] = check.worst(cell.judge(control=control), cell.names)
        cell.log(f"{workload} seed {seed} {'control' if control else 'program'}: {out[seed]}")
        del cell
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python3 -m portbench.calibrate", description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="*", default=[])
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--faults", nargs="*", default=[], choices=sorted(train_faults.FAULTS))
    parser.add_argument("--seconds", type=float, default=1.0)
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    harness.set_cache_dirs()
    report = {
        "workload": args.workload,
        "program": readings(args.workload, args.seeds, False, args.seconds),
        "control": readings(args.workload, args.control_seeds, True, args.seconds),
    }
    for fault in args.faults:
        report["fault." + fault] = readings(args.workload, args.control_seeds, False, args.seconds,
                                            wrap_step=train_faults.FAULTS[fault])
    for side in [k for k, v in report.items() if k != "workload" and v]:
        names = next(iter(report[side].values()))
        report[side + "_range"] = {name: [min(r[name] for r in report[side].values()),
                                          max(r[name] for r in report[side].values())] for name in names}
    text = json.dumps(report)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
