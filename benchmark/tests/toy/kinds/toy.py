"""The ``toy`` kind: rows multiplied by a matrix drawn from the seed, in
plain PyTorch, on whatever device the run names.

The program (:class:`Program`) answers one block of ``rows`` rows a call
in float32. Set-up draws the blocks and the matrix, answers the first
block (the checked call) and the window answers the blocks in turn until
``--seconds`` have passed. The plain reference answers in float64 and the
control in bfloat16; ``answer_gap`` is the worst gap of the checked
call's and the window's last call's answers over the reference's largest.
"""

from __future__ import annotations

import time

import torch

from .. import device_info, harness

FAULTS = ("answer_altered",)


class Program:
    def __init__(self, w):
        self.w = w

    def answer(self, x):
        return x @ self.w


def fault(name):
    """``answer_altered``: one answer of every call altered."""
    if name == "answer_altered":
        def make(orig):
            def altered(self, x):
                y = orig(self, x).clone()
                y[0, 0] += 1.0
                return y
            return altered
        return harness.patched(Program, "answer", make)
    raise ValueError(f"unknown fault {name!r}")


def _inputs(recipe, traffic, seed, device):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    width = recipe["width"]
    w = torch.randn(width, width, generator=gen, device=device)
    xs = torch.randn(traffic["blocks"], traffic["rows"], width,
                     generator=gen, device=device)
    return w, xs


def _gap(got, x, w):
    want = x.double() @ w.double()
    return float((got.double() - want).abs().max() / want.abs().max())


class _Slice:
    """A traced slice with nothing traced."""

    def breakdown(self):
        return {"device_ops": [], "idle_gaps": []}


def control_readings(config, traffic, seed, device):
    w, xs = _inputs(config["recipe"], traffic, seed, device)
    got = (xs[0].bfloat16() @ w.bfloat16()).float()
    return {"answer_gap": _gap(got, xs[0], w)}


def run(*, config, traffic, seed, seconds, trace, device, started, chips):
    w, xs = _inputs(config["recipe"], traffic, seed, device)
    prog = Program(w)
    checked = [(xs[0], prog.answer(xs[0]))]
    setup_s = time.time() - (started or time.time())
    calls, t0 = 0, time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        x = xs[calls % len(xs)]
        last = (x, prog.answer(x))
        calls += 1
    window_s = time.perf_counter() - t0
    if calls:
        checked.append(last)
    rows = traffic["rows"]
    return {"end_to_end": {"toy_rows_per_s": rows * calls / window_s,
                           "setup_s": setup_s},
            "attempted": calls, "failed": 0,
            "device": device_info.describe(device, chips, 0),
            "rec": ({"slice": _Slice(), "calls": calls, "rows": rows}
                    if trace else None),
            "readings": {"answer_gap": max(_gap(y, x, w)
                                           for x, y in checked)},
            "log": {"window_s": window_s, "calls": calls}}
