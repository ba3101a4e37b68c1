"""Readings that the output check's limits are set from, on the chip.

    python3 -m benchmark.calibrate --workload <name> --seeds 1 2 3 ... \
        [--control-seeds 3] [--out chiprun_out/calib.jsonl]

For each seed, in one process: the program's readings (a run of the cell
with a window of no length: set-up, then the output check), and on the
first ``--control-seeds`` seeds the control's (the plain reference
computed in the next lower precision in the program's place, held
against the reference) and each planted fault's (:data:`FAULTS`, a run
with the fault under the timed path). One JSON line per seed and side.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import sys

import torch

from benchmark import harness

# the faults each kind of cell can have (the exchange between chips is
# absent from every one-chip cell)
FAULTS = {"train": ["state_unchanged", "half_batch"]}


@contextlib.contextmanager
def _patched(owner, name, make):
    orig = getattr(owner, name)
    setattr(owner, name, make(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


def fault(name):
    """A context that plants fault ``name`` under the timed path."""
    from vae_npvc_tpu_torch.train.trainer import Trainer

    if name == "state_unchanged":
        def make(orig):
            def frozen(self, flat_g, new_ema, detail):
                flat, opt = self.flat.clone(), self.opt_state
                ema = {n: tuple(t.clone() for t in q.state())
                       for n, q in self.ema.items()}
                out = orig(self, flat_g, new_ema, detail)
                with torch.no_grad():
                    self.flat.copy_(flat)
                self.opt_state = opt
                for n, s in ema.items():
                    self.ema[n].set_state(s)
                return out
            return frozen
        return _patched(Trainer, "_finish_step", make)
    if name == "half_batch":
        def make(orig):
            def half(self, idx, starts):
                x, s = orig(self, idx, starts)
                return x[:x.shape[0] // 2], s[:s.shape[0] // 2]
            return half
        return _patched(Trainer, "_gather", make)
    raise ValueError(f"unknown fault {name!r}")


def readings(workload, seed, side, device="cuda", config_override=None):
    """The numbers the check compares, for one seed and side (``program``,
    ``control`` or a fault's name)."""
    if side == "control":
        spec = harness.load_spec()
        _, config, traffic, _ = harness.cell(spec, workload)
        over = config_override or {}
        config = {k: (dict(v, **over.get(k, {})) if isinstance(v, dict)
                      else v) for k, v in config.items()}
        traffic = dict(traffic, **over.get("traffic", {}))
        kind = importlib.import_module(f"benchmark.kinds.{traffic['kind']}")
        return kind.control_readings(config, traffic, seed, device)
    cm = contextlib.nullcontext() if side == "program" else fault(side)
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
    out = open(args.out, "a") if args.out else None
    for n, seed in enumerate(args.seeds):
        sides = ["program"] + (["control", *FAULTS[traffic["kind"]]]
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
