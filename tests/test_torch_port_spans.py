"""The port's span recorder (``utils/spans.py``) on the CPU: off and on,
threads, drops, the profiler's clock, the trainer's phases, the Chrome
trace of ``bin/train --profile_dir``, and the serving engine's latency
histograms."""

import json
import threading
import time

import numpy as np
import pytest
import torch

from tests.toy_config import toy_config
from vae_npvc_tpu_torch.serve.engine import LogHistogram, _InferBatcher
from vae_npvc_tpu_torch.train import build_trainer
from vae_npvc_tpu_torch.utils import spans

torch.set_num_threads(1)


@pytest.fixture
def rec():
    r = spans.Recorder()
    yield r
    r.enable(False)


@pytest.fixture
def on():
    """The process's recorder, on for one test and drained after it."""
    spans.drain()
    spans.enable(True)
    try:
        yield spans.recorder
    finally:
        spans.enable(False)
        spans.drain()


def test_off_records_nothing(rec):
    assert not spans.recorder.on
    assert spans.span("a") is spans.OFF and rec.span("b") is spans.OFF
    assert rec.device_span("dev.vq", torch.zeros(2)) is spans.OFF
    rec.enable(True, device=True)
    # a CPU tensor has no device time to record
    assert rec.device_span("dev.vq", torch.zeros(2)) is spans.OFF
    rec.enable(False)
    with rec.span("a"), rec.span("b"):
        pass
    assert rec.drain() == {"spans": [], "device": [], "drops": 0}


def test_nesting_and_threads(rec):
    rec.enable(True)
    seen = {}

    def worker():
        with rec.span("t"):
            seen["tid"] = threading.get_native_id()

    with rec.span("a"):
        with rec.span("b"):
            pass
        th = threading.Thread(target=worker)
        th.start()
        th.join(10)
        assert not th.is_alive()
    got = {s.name: s for s in rec.drain()["spans"]}
    a, b, t = got["a"], got["b"], got["t"]
    assert a.parent == 0 and b.parent == a.id
    assert a.start_ns <= b.start_ns <= b.end_ns <= a.end_ns
    # another thread keeps its own id; with none open there, the enabling
    # thread's innermost open span is its parent
    assert t.thread == seen["tid"] != a.thread == threading.get_native_id()
    assert t.parent == a.id
    assert rec.drain()["spans"] == []


def test_full_buffer_counts_drops(rec):
    small = spans.Recorder(capacity=3)
    small.enable(True)
    for i in range(5):
        with small.span(f"s{i}"):
            pass
    out = small.drain()
    assert [s.name for s in out["spans"]] == ["s0", "s1", "s2"]
    assert out["drops"] == 2
    assert small.drain()["drops"] == 0


def test_spans_share_the_profilers_clock(rec):
    from torch.profiler import ProfilerActivity, profile, record_function

    rec.enable(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with rec.span("outer"):
            with record_function("mark"):
                torch.ones(64).sum()
    (s,) = rec.drain()["spans"]
    (e,) = [e for e in prof.profiler.kineto_results.events()
            if e.name() == "mark"]
    slack = 1_000_000        # 1 ms
    assert s.start_ns - slack <= e.start_ns() <= s.end_ns
    assert s.start_ns <= e.end_ns() <= s.end_ns + slack


def _staged_trainer():
    cfg = dict(toy_config(), compute_dtype="float32", crop_length=16)
    tr = build_trainer(cfg, device="cpu")
    tr.init_state()
    g = torch.Generator().manual_seed(0)

    class Corpus:
        crop_length = 16

        def padded_arrays(self):
            return (torch.randn(4, 24, 10, generator=g),
                    torch.tensor([24, 20, 18, 24], dtype=torch.int32),
                    torch.tensor([0, 1, 2, 0], dtype=torch.int32))

    tr.stage_dataset(Corpus(), 2)
    return tr


def test_trainer_step_spans(on):
    tr = _staged_trainer()
    spans.drain()
    tr.train_steps_indices(np.array([[0, 1]]), np.array([[0, 3]]))
    got = spans.drain()["spans"]
    assert [s.name for s in got] == [
        "train.call", "train.step", "step.gather", "step.forward",
        "step.backward", "step.update", "train.stack"]
    by = {s.name: s for s in got}
    call, step = by["train.call"], by["train.step"]
    assert step.parent == call.id and by["train.stack"].parent == call.id
    for name in ("step.gather", "step.forward", "step.backward",
                 "step.update"):
        s = by[name]
        assert s.parent == step.id
        assert step.start_ns <= s.start_ns <= s.end_ns <= step.end_ns


def test_profile_dir_trace_holds_the_spans(tmp_path):
    from vae_npvc_tpu_torch.bin import train as train_cli

    tr = _staged_trainer()
    prof = train_cli.start_profiler(tr.device)
    tr.train_steps_indices(np.array([[0, 1]]), np.array([[0, 3]]))
    path = train_cli.stop_profiler(prof, tr.device, tmp_path, 1)
    assert not spans.recorder.on
    events = json.loads(path.read_text())["traceEvents"]
    step = [e for e in events if e.get("name") == "train.step"]
    assert len(step) == 1 and step[0]["ph"] == "X"
    # on the profiler's timeline: the step's convolutions lie inside it
    convs = [e for e in events
             if e.get("name", "").startswith("aten::convolution")]
    assert convs and all(
        step[0]["ts"] - 1e3 <= c["ts"] <= step[0]["ts"] + step[0]["dur"]
        for c in convs)


def test_histogram_quantiles_within_a_bucket():
    rng = np.random.default_rng(3)
    values = np.exp(rng.normal(np.log(40.0), 1.0, 2000))
    h = LogHistogram()
    for v in values:
        h.add(v)
    width = 10 ** (1 / h.PER_DECADE)
    for q in (0.5, 0.99):
        want = float(np.percentile(values, 100 * q))
        got = h.quantile(q)
        assert want / width <= got <= want * width
    assert h.count == 2000 and h.max == values.max()
    lines = h.prometheus("x_ms")
    assert lines[0] == "# TYPE x_ms histogram"
    assert 'x_ms_bucket{le="+Inf"} 2000' in lines and "x_ms_count 2000" in \
        lines
    h.clear()
    assert h.quantile(0.5) is None


@pytest.mark.parametrize("values", [[1e-4, 2e-3, 5e-3], [2e6, 5e6, 9e6]],
                         ids=["below", "above"])
def test_histogram_outside_its_range(values):
    h = LogHistogram()
    for v in values:
        h.add(v)
    # the end buckets are bounded by the smallest and largest value seen
    for q in (0.0, 0.5, 1.0):
        assert values[0] <= h.quantile(q) <= values[-1]
    assert (h.min, h.max, h.count) == (values[0], values[-1], 3)


def test_batcher_counts_queue_wait():
    def runner(feats, tgts, lengths):
        time.sleep(0.05)
        return feats

    # one item a call: the second waits for one call, the third for two
    b = _InferBatcher(runner, max_batch=1, window_ms=1.0)
    try:
        futs = [b.submit(np.full((8, 2), i, np.float32), 8, 0)
                for i in range(3)]
        for i, f in enumerate(futs):
            assert f.result(10)[0, 0] == i
    finally:
        b.close()
    wait = b.queue_wait
    assert wait.count == 3 and b.calls == 3
    assert wait.min < 50 <= wait.quantile(0.5) and wait.max >= 100
    assert wait.sum >= 150
