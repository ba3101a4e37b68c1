"""The readings of ``tools/torch_span_breakdown.py`` on hand-made records
(CPU): the two span metrics, idle gaps charged to spans beside
``benchmark/trace.py``'s own charging, and the launch check.

    python -m pytest tools/test_torch_span_breakdown.py

It uses the benchmark's private ``Slice``; the tool and this file go once
the benchmark reads the port's spans itself.
"""

import statistics

import numpy as np
import pytest

from benchmark import trace as btrace
from tools import torch_span_breakdown as breakdown
from vae_npvc_tpu_torch.utils import spans


def _span(name, sid, parent, start, end, thread=1):
    return spans.Span(name, sid, parent, thread, start, end)


def test_readings_of_a_hand_made_record():
    steps = [_span("train.step", i + 1, 0, 0, ms * 1_000_000)
             for i, ms in enumerate([70.0, 90.0, 75.0, 80.0])]
    rec = {"spans": steps + [_span("step.forward", 9, 1, 0, 5)],
           "vq_calls": [(float(i), 0) for i in range(1, 101)]}
    assert breakdown.host_step_ms(rec) == 77.5
    assert breakdown.vq_call_p99_ms(rec) == pytest.approx(
        float(np.percentile(np.arange(1, 101), 99)))
    assert breakdown.host_step_ms({"spans": []}) is None
    assert breakdown.vq_call_p99_ms({"vq_calls": []}) is None
    assert breakdown.host_step_ms({}) is None


def test_idle_gaps_charged_to_spans():
    # device ops at [0, 10), [20, 30), [40, 50), [60, 70) ns: gaps with
    # midpoints 15 (a runtime call), 35 (a span only) and 55 (nothing)
    ops = [("k", t, 10, True) for t in (0, 20, 40, 60)]
    sl = btrace.Slice(1.0, ops, [("cudaLaunchKernel", 12, 18)], 4, 0)
    held = [_span("train.step", 1, 0, 0, 45),
            _span("step.forward", 2, 1, 30, 38)]
    got = breakdown.owners(sl, held)
    assert got == {"cudaLaunchKernel": 10e-9, "step.forward": 10e-9,
                   breakdown.OUTSIDE: 10e-9}
    # the benchmark's own charging, for comparison, names no span
    assert set(sl._gap_owners()) == {"cudaLaunchKernel", breakdown.OUTSIDE}
    per = breakdown.phases([_span("train.call", 1, 0, 0, 100),
                            _span("train.step", 2, 1, 0, 40),
                            _span("step.forward", 3, 2, 10, 30),
                            _span("train.step", 4, 1, 50, 90),
                            _span("step.forward", 5, 4, 60, 70)])
    assert per["step.forward"] == (statistics.median([20e-6, 10e-6]),) * 2
    assert per["train.step"] == (40e-6, statistics.median([20e-6, 30e-6]))
    assert per["train.call"] == (50e-6, 10e-6)


def test_launch_calls_inside_op_spans_of_their_thread():
    ops = [_span("op.gn_fwd", 1, 0, 10, 50, thread=7),
           _span("op.vq", 2, 0, 60, 90, thread=8)]
    launches = [(20, 30, 7, "void gn_fwd_cluster<float, 8>"),
                (70, 80, 7, "void vq_cluster<true, 8>"),     # other thread
                (95, 99, 8, "void vq_stats"),                # outside
                (20, 30, 7, "elementwise_kernel")]           # not owned
    assert breakdown.launches_in_ops(launches, ops) == (3, 1, 2)
