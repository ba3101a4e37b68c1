"""Readings that the output check's limits are set from, on the chip.

    python3 -m benchmark.calibrate --workload <name> --seeds 1 2 3 ... \
        [--control-seeds 3] [--out chiprun_out/calib.jsonl]

For each seed, in one process: the program's readings (a run of the cell
with a window of no length: set-up, then the output check), and on the
first ``--control-seeds`` seeds the control's (the plain reference
computed in the next lower precision in the program's place, held
against the reference) and each planted fault's (the ``FAULTS`` of the
cell's kind, a run with the fault under the timed path). One JSON line
per seed and side.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

from benchmark import harness


def fault(name, kind):
    """A context that plants fault ``name`` of the traffic kind ``kind``
    under the timed path."""
    return harness.kind(kind).fault(name)


def readings(workload, seed, side, device="cuda", config_override=None):
    """The numbers the check compares, for one seed and side (``program``,
    ``control`` or a fault's name)."""
    _, config, traffic, _ = harness.cell(harness.load_spec(), workload)
    config, traffic = harness.overridden(config, traffic, config_override)
    if side == "control":
        return harness.kind(traffic["kind"]).control_readings(
            config, traffic, seed, device)
    cm = (contextlib.nullcontext() if side == "program"
          else fault(side, traffic["kind"]))
    with cm:
        res = harness.run_cell(workload, seed, 0, 0, device=device,
                               config_override=config_override)
    return {k: c["value"] for k, c in res["checks"].items()}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    spec = harness.load_spec()
    _, _, traffic, limits = harness.cell(spec, args.workload)
    faults = harness.kind(traffic["kind"]).FAULTS
    out = open(args.out, "a") if args.out else None
    for n, seed in enumerate(args.seeds):
        sides = ["program"] + (["control", *faults]
                               if n < args.control_seeds else [])
        for side in sides:
            r = readings(args.workload, seed, side, args.device)
            line = json.dumps({"workload": args.workload, "seed": seed,
                               "side": side, "readings": r,
                               "limits": {k: v for k, v in limits.items()
                                          if not k.startswith("_")}})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
