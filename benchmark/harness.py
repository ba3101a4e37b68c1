"""One run of one cell: find its files by name, run the kind's driver, read
the per-layer metrics, check the output and build the result's line.

Everything that belongs to one cell lives in files of its own, found by
the names in ``BENCHMARK.json``, so that a cell, of a kind the benchmark
has or of a new one, is new files and new entries only:

- ``configs/<config>.json``: the recipe as it is run (``recipe``), its
  source, the keys cut from it and the sizes assumed;
- ``traffic/<traffic>.json``: the mix's parameters, with ``kind`` naming
  the driver (``kinds/<kind>.py``) that generates and runs it;
- ``kinds/<kind>.py``, once for each kind: ``run`` (one run of a cell),
  ``control_readings`` (the control's readings), ``FAULTS`` (the names of
  the faults a cell of the kind can have) and ``fault(name)`` (a context
  that plants one under the timed path);
- ``metrics/<metric>.py``: a ``read(rec)`` that returns the metric from
  the run's records, or None where the cell has nothing to read;
- ``limits/<workload>.json``: the limit of each number the output check
  compares;
- ``tests/tiny/<config>.json``: the configuration at tiny widths, for the
  CPU tests: ``recipe`` and ``traffic`` overrides, and under ``sound``
  further overrides under which a run on the CPU with no fault is held
  to the cell's limits (the train kind's: float32).
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import math
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level module names that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "vae_npvc_tpu")


def load_spec(root=ROOT):
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(spec, workload):
    """(workload entry, config file's dict, traffic dict, limits dict)."""
    by_name = {w["name"]: w for w in spec["workloads"]}
    if workload not in by_name:
        raise SystemExit(f"unknown workload {workload!r}; known: "
                         f"{sorted(by_name)}")
    w = by_name[workload]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    limits = json.loads((BENCH / "limits" / f"{workload}.json").read_text())
    return w, config, traffic, limits


def overridden(config, traffic, over=None):
    """``config`` and ``traffic`` with the keys of ``over`` (which maps
    ``recipe``, ``vocoder`` or ``traffic`` to keys that replace the
    file's) in place."""
    over = over or {}
    config = {k: (dict(v, **over.get(k, {})) if isinstance(v, dict) else v)
              for k, v in config.items()}
    return config, dict(traffic, **over.get("traffic", {}))


def kind(name):
    """The module of the traffic kind ``name`` (``kinds/<name>.py``)."""
    return importlib.import_module(f"benchmark.kinds.{name}")


@contextlib.contextmanager
def patched(owner, name, make):
    """``owner.name`` replaced by ``make(owner.name)`` inside the block."""
    orig = getattr(owner, name)
    setattr(owner, name, make(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


def metrics_of(spec, workload, trace):
    """The cell's metric entries: end-to-end ones for an untraced run,
    per-layer ones for a traced run."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in spec[key]
            if workload in m.get("workloads", [workload])]


def read_metric(name, rec):
    """The number ``metrics/<name>.py`` reads from ``rec``, or None."""
    path = BENCH / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    value = mod.read(rec)
    return None if value is None else float(value)


def forbidden_modules():
    """Loaded modules whose top-level name, compared whole, is JAX's,
    jaxlib's, flax's or the JAX package's."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


def judge(readings, limits):
    """``(correct, checks)``: every reading finite and within its limit.
    A reading the run could not take is None and fails."""
    checks, ok = {}, True
    for name, limit in limits.items():
        if name.startswith("_"):
            continue
        value = readings.get(name)
        good = (value is not None and math.isfinite(value)
                and value <= limit)
        ok = ok and good
        checks[name] = {"value": value, "limit": limit}
    return ok, checks


def run_cell(workload, seed, seconds, trace, *, device="cuda", spec=None,
             config_override=None, started=None):
    """Run one cell and return the result's dict (not yet printed).

    ``config_override`` goes to :func:`overridden` (tests run tiny models
    on the CPU through it); ``started`` is the process's start on the
    host's ``time.time()`` clock, which ``setup_s`` counts from."""
    spec = spec or load_spec()
    w, config, traffic, limits = cell(spec, workload)
    config, traffic = overridden(config, traffic, config_override)
    out = kind(traffic["kind"]).run(
        config=config, traffic=traffic, seed=int(seed),
        seconds=float(seconds), trace=bool(trace), device=device,
        started=started, chips=w["chips"])
    metrics = {}
    for m in metrics_of(spec, workload, trace):
        if trace:
            value = read_metric(m["name"], out["rec"])
        else:
            value = out["end_to_end"].get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    print("log " + json.dumps(out["log"]), file=sys.stderr)
    correct, checks = judge(out["readings"], limits)
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics,
              "device": out["device"]}
    if trace:
        result["breakdown"] = out["rec"]["slice"].breakdown()
    result["checks"] = checks
    return result
