#!/usr/bin/env python3
"""The training cell's step, broken down by the port's own spans.

    python3 tools/torch_span_breakdown.py [--seed N] [--seconds 51] \
        [--out chiprun_out/span_breakdown.json]

Runs the benchmark's ``vqvae-train-b128`` set-up (``benchmark/kinds/
train.py``: the recipe, the seeded weights and corpus, the checked calls
that warm every shape) and then a window of ``--seconds`` of 8-step
chunks with the span recorder (``vae_npvc_tpu_torch/utils/spans.py``) on,
K1's CUDA-event spans included. A slice of one chunk, 40 % into the
window, runs under ``torch.profiler`` with the device's activity only, as
the benchmark's traced slice does, with the host spans on and K1's events
off. It prints one JSON object (and writes it to ``--out``):

- ``idle``: the slice's idle gaps by owner, as the benchmark charges them
  (``benchmark/trace.py``: the CUDA runtime call running at a gap's
  midpoint, else "host outside CUDA calls") and with the spans (a gap in
  no runtime call goes to the innermost span covering it);
- ``host_step_ms`` (median ``train.step`` outside the slice), each span
  name's median ms and self ms a step, K1's per-call device ms
  (``dev.vq``: median, p99, largest) and the re-scored rows of its
  slowest calls beside the median call's, the drop count;
- ``launches``: of the slice's launch calls whose kernel is a ``gn_*`` or
  ``vq_*`` kernel, how many lie inside an ``op.gn_*`` or ``op.vq`` span of
  their thread;
- ``cost``: the recorder's host cost (a step's spans off, one span and one
  ``dev.vq`` event pair on), and chunk times with the recorder off and on
  in turns; ``mfu_on`` the window's share of the bf16 peak outside the
  slice, as ``mfu.train`` reads it.

Needs CUDA; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import sys
import threading
import time
from collections import Counter, defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CELL = "vqvae-train-b128"
OUTSIDE = "host outside CUDA calls"
MASK = 0xFFFFFFFF
LAUNCH = re.compile(r"LaunchKernel|^cuLaunchKernel")
OWNED = re.compile(r"\b(gn|vq)_")


# ------------------------------------------------------------ the readings
def host_step_ms(rec):
    """The median host wall time (ms) of the ``train.step`` spans in
    ``rec["spans"]``, or None."""
    ms = [(s.end_ns - s.start_ns) / 1e6 for s in rec.get("spans") or ()
          if s.name == "train.step"]
    return statistics.median(ms) if ms else None


def vq_call_p99_ms(rec):
    """The 99th percentile of K1's per-call device ms in
    ``rec["vq_calls"]`` (``(ms, re-scored)`` pairs), or None."""
    import numpy as np

    ms = [c[0] for c in rec.get("vq_calls") or ()]
    return float(np.percentile(ms, 99)) if ms else None


def _innermost(intervals, mids):
    """For each sorted midpoint, the name of the latest-starting interval
    ``(name, start, end)`` covering it, or None."""
    intervals = sorted(intervals, key=lambda e: e[1])
    out, j, open_ = [], 0, []
    for mid in mids:
        while j < len(intervals) and intervals[j][1] <= mid:
            open_.append(intervals[j])
            j += 1
        open_ = [e for e in open_ if e[2] >= mid]
        out.append(open_[-1][0] if open_ else None)
    return out


def owners(sl, spans):
    """The slice's idle seconds by owner: the CUDA runtime call at a gap's
    midpoint, else the innermost span covering it, else
    :data:`OUTSIDE`."""
    gaps = sorted(((a + b) // 2, (b - a) / 1e9) for a, b in sl.gaps)
    mids = [m for m, _ in gaps]
    calls = _innermost(sl.host_ops, mids)
    held = _innermost([(s.name, s.start_ns, s.end_ns) for s in spans], mids)
    out = Counter()
    for (_, sec), call, span in zip(gaps, calls, held):
        out[(call or span or OUTSIDE)[:120]] += sec
    return out


def self_times(spans):
    """``{id: ns}``: each span's duration less the union of what its
    children (spans naming it as parent, on any thread) cover of it."""
    kids = {}
    for s in spans:
        kids.setdefault(s.parent, []).append(s)
    out = {}
    for s in spans:
        covered, end = 0, s.start_ns
        for k in sorted(kids.get(s.id, ()), key=lambda k: k.start_ns):
            a, b = max(k.start_ns, end), min(k.end_ns, s.end_ns)
            if b > a:
                covered += b - a
                end = b
        out[s.id] = s.end_ns - s.start_ns - covered
    return out


def phases(spans):
    """``{name: (median ms a step, median self ms a step)}`` of every
    ``train.*``, ``step.*`` and ``op.*`` span. A span within a
    ``train.step`` counts to that step; one outside (``train.call``,
    ``train.stack``) is spread over the steps of its call."""
    by_id = {s.id: s for s in spans}
    own = self_times(spans)
    steps_in = Counter(s.parent for s in spans if s.name == "train.step")

    def home(s):
        """(the train.step or train.call span it counts to, its steps)."""
        p = s
        while p is not None:
            if p.name == "train.step":
                return p.id, 1
            if p.name == "train.call":
                return p.id, max(steps_in[p.id], 1)
            p = by_id.get(p.parent)
        return None, 1

    total, selfs = defaultdict(Counter), defaultdict(Counter)
    for s in spans:
        if not s.name.startswith(("train.", "step.", "op.")):
            continue
        h, n = home(s)
        if h is None:
            continue
        total[s.name][h] += (s.end_ns - s.start_ns) / 1e6 / n
        selfs[s.name][h] += own[s.id] / 1e6 / n
    return {name: (statistics.median(total[name].values()),
                   statistics.median(selfs[name].values()))
            for name in sorted(total)}


def launches_in_ops(launches, spans):
    """``(checked, inside, on any thread)``: of the ``(start, end, thread,
    kernel)`` launch calls whose kernel is a ``gn_*``/``vq_*`` kernel, how
    many lie inside an ``op.gn_*``/``op.vq`` span of their thread, and of
    any thread."""
    ops = [s for s in spans if s.name.startswith(("op.gn_", "op.vq"))]
    owned = [x for x in launches if OWNED.search(x[3])]

    def inside(x, same):
        return any((not same or s.thread == x[2]) and s.start_ns <= x[0]
                   and x[1] <= s.end_ns for s in ops)

    return (len(owned), sum(inside(x, True) for x in owned),
            sum(inside(x, False) for x in owned))


# ------------------------------------------------------------- on the chip
def traced(fn):
    """``benchmark/trace.py``'s ``traced``, also returning each kernel
    launch call as ``(start_ns, end_ns, thread, kernel name)``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark import trace as bt

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(bt.PAD):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    # a runtime call's resource id is the low 32 bits of its thread's
    # pthread id (Python's thread ident); spans name native thread ids
    native = {t.ident & MASK: t.native_id for t in threading.enumerate()}
    device_ops, host_ops, calls, kernels = [], [], [], {}
    for e in prof.profiler.kineto_results.events():
        name, start, dur = e.name(), e.start_ns(), e.duration_ns()
        if e.device_type() == cuda:
            if bt.SPIN in name or bt._is_span(e):
                continue
            kernel = bt._is_kernel(e)
            device_ops.append((name, start, dur, kernel))
            if kernel:
                kernels[e.correlation_id()] = name
        else:
            host_ops.append((name, start, start + dur))
            if LAUNCH.search(name):
                calls.append((start, start + dur,
                              native.get(e.device_resource_id() & MASK),
                              e.correlation_id()))
    calls = sorted(calls)[bt.PAD:]
    lost = sum(c[3] not in kernels for c in calls)
    sl = bt.Slice(seconds, device_ops, host_ops, len(calls), lost)
    return sl, [(a, b, t, kernels.get(c, "")) for a, b, t, c in calls]


def _per_span_costs(spans, torch):
    """Host µs of a step's spans with the recorder off, of one span on
    and of one ``dev.vq`` event pair on."""
    rec = spans.Recorder()
    n = 20000

    def per(fn):
        """The least of five passes (timeit's convention); the recorder
        drained after each, which returns its timing events to the pool."""
        best = float("inf")
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
            torch.cuda.synchronize()
            rec.drain()
        return best / n * 1e6

    def loop():
        for _ in range(n):
            with rec.span("op.gn_fwd"):
                pass

    off = per(loop)
    rec.enable(True)
    on = per(loop)
    keep = torch.zeros(2, 8, dtype=torch.int32, device="cuda")
    rec.enable(True, device=True)

    def pairs():
        for _ in range(n):
            with rec.device_span("dev.vq", keep):
                pass

    dev = per(pairs)
    rec.enable(False)
    return {"off_us_a_span": off, "on_us_a_span": on,
            "on_us_a_dev_vq_pair": dev}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=5300000001)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--turns", type=int, default=12,
                    help="chunks with the recorder off, and as many on")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"
                                         / "span_breakdown.json"))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("torch_span_breakdown: no CUDA device", file=sys.stderr)
        return 2
    from benchmark import device_info, harness, yardstick
    from benchmark import trace as bt
    from benchmark.kinds import train as kind
    from vae_npvc_tpu_torch.ops import _build
    from vae_npvc_tpu_torch.utils import spans

    _, config, traffic, _ = harness.cell(harness.load_spec(ROOT), CELL)
    recipe = config["recipe"]
    B, T = recipe["batch_size"], recipe["crop_length"]
    K = recipe.get("steps_per_call", 1)
    _build.build_all()
    weights, corpus, plan, chunks = kind.make_inputs(recipe, traffic,
                                                     args.seed, "cuda")
    tr, _ = kind.program_side(recipe, weights, corpus, plan, args.seed,
                              "cuda")
    bt.warm()
    costs = _per_span_costs(spans, torch)
    i = 0

    def chunk():
        nonlocal i
        tr.train_steps_indices(*chunks[i % len(chunks)])
        i += 1

    # the window, the recorder on; one traced chunk 40 % in
    outside, sliced, tries = [], None, []
    spans.enable(True, device=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n_out, s_out = 0, 0.0
    while time.perf_counter() - t0 < args.seconds:
        if sliced is None and len(tries) < traffic["trace_tries"] and \
                time.perf_counter() - t0 >= traffic["trace_at"] * args.seconds:
            torch.cuda.synchronize()
            outside.append(spans.drain())
            spans.enable(True, device=False)
            calls0 = kind._launches()
            sl, launches = traced(lambda: [chunk() for _ in range(
                traffic["trace_chunks"])])
            inside = spans.drain()
            spans.enable(True, device=True)
            calls = {k: v - calls0[k] for k, v in kind._launches().items()}
            why = kind.shortfall(sl, calls)
            tries.append(why)
            if why is None:
                sliced = (sl, launches, inside)
            continue
        c0 = time.perf_counter()
        chunk()
        n_out += K
        s_out += time.perf_counter() - c0
    torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    outside.append(spans.drain())
    spans.enable(False)
    if sliced is None:
        print(f"no complete traced slice: {tries}", file=sys.stderr)
        return 1

    # chunk times with the recorder off and on, in turns
    turns = {"off": [], "on": []}
    for t in range(2 * args.turns):
        mode = ("off", "on")[t % 2]
        spans.enable(mode == "on", device=True)
        torch.cuda.synchronize()
        c0 = time.perf_counter()
        chunk()
        torch.cuda.synchronize()
        turns[mode].append(time.perf_counter() - c0)
        spans.enable(False)
        spans.drain()

    sl, launches, inside = sliced
    host = [s for d in outside for s in d["spans"]]
    vq = [(ms, v) for d in outside for n, ms, v in d["device"]
          if n == "dev.vq"]
    drops = sum(d["drops"] for d in outside) + inside["drops"]
    rec = {"spans": host, "vq_calls": vq}
    idle = sl.seconds - sl.busy_s
    charged = owners(sl, inside["spans"])
    plain = sl._gap_owners()
    steps_in_slice = sum(s.name == "train.step" for s in inside["spans"])
    checked, n_in, n_any = launches_in_ops(launches, inside["spans"])
    ms = sorted(vq)
    med_ms = statistics.median(m for m, _ in vq)
    step = yardstick.vqvae_step(recipe, B, T)
    # as mfu.train: the steps outside the traced slice over their seconds
    mfu_on = 100.0 * step.train_flops() * n_out / (
        s_out * yardstick.BF16_OPS_PER_S)
    out = {
        "device": device_info.describe("cuda", 1, 0), "seed": args.seed,
        "window_s": window_s, "steps_outside": n_out,
        "frames_per_s_outside": B * T * n_out / s_out,
        "mfu_on": mfu_on, "tries": tries,
        "slice": {"seconds": sl.seconds, "busy_s": sl.busy_s,
                  "idle_s": idle, "steps": steps_in_slice,
                  "launched": sl.launched, "lost": sl.lost,
                  "device_ms_a_step": 1e3 * sl.busy_s / max(steps_in_slice,
                                                           1)},
        "idle": {"with_spans": [[n, s, s / idle] for n, s in
                                charged.most_common(16)],
                 "benchmark": [[n, s, s / idle] for n, s in
                               plain.most_common(8)],
                 "outside_share": charged[OUTSIDE] / idle,
                 "call_step_self_share": (charged["train.call"]
                                          + charged["train.step"]) / idle},
        "host_step_ms": host_step_ms(rec),
        "host_step_ms_slice": host_step_ms({"spans": inside["spans"]}),
        "phases_ms_a_step": phases(host),
        "vq": {"calls": len(vq), "p99_ms": vq_call_p99_ms(rec),
               "median_ms": med_ms, "max_ms": ms[-1][0] if ms else None,
               "over_2x_median": sum(m > 2 * med_ms for m, _ in vq),
               "slowest": [list(x) for x in ms[-5:]],
               "median_rescored": statistics.median(v for _, v in vq),
               "rescored_max": max(v for _, v in vq),
               "all": [list(x) for x in vq]},
        "span_drops": drops,
        "launches": {"checked": checked, "inside": n_in,
                     "inside_any_thread": n_any,
                     "launch_threads": sorted({str(x[2])
                                               for x in launches}),
                     "span_threads": sorted({s.thread
                                             for s in inside["spans"]})},
        "cost": dict(costs, turns_s=turns,
                     turn_median_off=statistics.median(turns["off"]),
                     turn_median_on=statistics.median(turns["on"]),
                     spans_a_step=len(host) / max(n_out, 1)),
        "breakdown": sl.breakdown(),
    }
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    short = {k: v for k, v in out.items() if k not in ("breakdown",)}
    short["vq"] = {k: v for k, v in out["vq"].items() if k != "all"}
    print(json.dumps(short, default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main())
