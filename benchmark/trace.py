"""A traced slice of a run: ``torch.profiler`` (the device's activity) over a
steady stretch of the measured window, reduced to device operations, busy
time and idle gaps.

The slice starts and ends with a ``torch.cuda.synchronize()``, so every
device operation it launches falls inside it; its length is the host's
clock over it. ``busy_s`` is the union of the device operations'
intervals (kernels, copies and fills, which one stream runs one at a time).
Each idle gap is charged to the innermost host event the trace holds (a
CUDA runtime call) that was running at its midpoint.

The profiler can lose events: late in a process it has dropped a window's
first kernels, and in a long window some of the rest. So every window
starts with :data:`PAD` spin kernels, left out of the events, and
:attr:`Slice.lost` counts the kernel launches of the slice (the host's
launch calls) whose kernel the trace does not hold. A slice with a loss
reads low device time and is taken again by its caller.
"""

from __future__ import annotations

import time
from collections import Counter

import torch

# spin kernels at the start of every profiler window
PAD = 64
SPIN = "spin_kernel"


class Slice:
    """What one traced slice recorded."""

    def __init__(self, seconds, device_ops, host_ops, launched, lost):
        self.seconds = seconds
        # (name, start_ns, duration_ns, is_kernel), by start
        self.device_ops = sorted(device_ops, key=lambda e: e[1])
        self.host_ops = host_ops        # (name, start_ns, end_ns)
        self.launched = launched        # kernel launches the host made
        self.lost = lost                # of them, with no kernel traced
        self.busy_s, self.gaps = self._union()

    def _union(self):
        busy, gaps, end = 0, [], None
        for _, start, dur, _ in self.device_ops:
            stop = start + dur
            if end is None or start > end:
                if end is not None:
                    gaps.append((end, start))
                busy += dur
                end = stop
            elif stop > end:
                busy += stop - end
                end = stop
        return busy / 1e9, gaps

    def kernels(self, pattern=None):
        """(name, seconds) of every kernel, or of those ``pattern``
        (a compiled regular expression) finds in the name."""
        return [(n, d / 1e9) for n, _, d, k in self.device_ops
                if k and (pattern is None or pattern.search(n))]

    def breakdown(self, top=10):
        by_op = Counter()
        for name, _, dur, _ in self.device_ops:
            by_op[name[:120]] += dur / 1e9
        return {"device_ops": [[n, s] for n, s in by_op.most_common(top)],
                "idle_gaps": [[n, s] for n, s in
                              self._gap_owners().most_common(top)]}

    def _gap_owners(self):
        owners = Counter()
        if not self.gaps:
            return owners
        hosts = sorted(self.host_ops, key=lambda e: e[1])
        mids = sorted(((a + b) // 2, (b - a) / 1e9) for a, b in self.gaps)
        # innermost event covering each midpoint: the latest-starting one
        # among those that started before it and end after it
        j, open_ = 0, []
        for mid, sec in mids:
            while j < len(hosts) and hosts[j][1] <= mid:
                open_.append(hosts[j])
                j += 1
            open_ = [h for h in open_ if h[2] >= mid]
            owner = open_[-1][0] if open_ else "host outside CUDA calls"
            owners[owner[:120]] += sec
        return owners


def warm():
    """Start and stop the profiler once on a trivial kernel, so that the
    tracer's own start-up falls into set-up and not into the slice."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(1, device="cuda")
    with profile(activities=[ProfilerActivity.CUDA]):
        (x + 1).sum().item()


def traced(fn):
    """Run ``fn()`` under the profiler between two synchronizations;
    returns a :class:`Slice`."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    # the device's activity only (kernels, copies and the runtime calls that
    # launched them): recording every host operator as well slows a
    # host-paced step by half and more
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PAD):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    device_ops, host_ops, launches, kernels = [], [], [], set()
    for e in prof.profiler.kineto_results.events():
        name, start, dur = e.name(), e.start_ns(), e.duration_ns()
        if e.device_type() == cuda:
            if SPIN in name or _is_span(e):
                continue
            kernel = _is_kernel(e)
            device_ops.append((name, start, dur, kernel))
            if kernel:
                kernels.add(e.correlation_id())
        else:
            host_ops.append((name, start, start + dur))
            if "LaunchKernel" in name or name.startswith("cuLaunch"):
                launches.append((start, e.correlation_id()))
    # the pad's launches come first
    launches = [c for _, c in sorted(launches)[PAD:]]
    lost = sum(c not in kernels for c in launches)
    return Slice(seconds, device_ops, host_ops, len(launches), lost)


def _is_span(e):
    """Whether a profiler event is a ``record_function`` span (the method
    is missing from some PyTorch releases' events)."""
    test = getattr(e, "is_user_annotation", None)
    if test is not None:
        return bool(test())
    kind = getattr(e, "activity_type", None)
    return kind is not None and "annotation" in kind()


def _is_kernel(e):
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return kind() == "kernel"
    return not e.name().startswith(("Memcpy", "Memset"))
