"""CPU tests of what the ``train`` kind (``kinds/train.py``) has of its
own: inputs that follow the seed, the yardstick's counts, the layer walk,
the traced slice's completeness, the plain reference against the port and
the frozen state of the ``state_unchanged`` fault.

    python -m pytest benchmark/tests -q

Tests marked ``cuda`` need the card and skip elsewhere.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import harness, yardstick
from benchmark.kinds import train as K
from benchmark.reference import vqvae as ref
from benchmark.tests import tiny

BENCH = Path(__file__).resolve().parents[1]
SPEC = harness.load_spec()
TRAFFIC = json.loads((BENCH / "traffic" / "train.json").read_text())
# the configurations of the training cells, and those kept for a training
# cell to come
CONFIGS = sorted({w["config"] for w in SPEC["workloads"]
                  if harness.cell(SPEC, w["name"])[2]["kind"] == "train"}
                 | {"vcc20_vqvae2"})


def _recipe(config):
    return json.loads((BENCH / "configs" / f"{config}.json")
                      .read_text())["recipe"]


def _tiny(config, **extra):
    """A configuration's recipe at tiny widths, and the training traffic
    with the tiny file's overrides."""
    t = tiny(config)
    return (dict(_recipe(config), **t["recipe"], **extra),
            dict(TRAFFIC, **t.get("traffic", {})))


# ------------------------------------------------------------------- inputs
@pytest.mark.parametrize("config", CONFIGS)
def test_inputs_follow_the_seed(config):
    recipe, traffic = _tiny(config)

    def draw(seed):
        w, corpus, plan, chunks = K.make_inputs(recipe, traffic, seed,
                                                "cpu")
        return (w, corpus.padded_arrays(),
                np.stack(plan["calls"] + chunks), plan["steps"])

    a, b, c = draw(2 ** 31 + 7), draw(2 ** 31 + 7), draw(5)
    for x, y, z in ((a[0], b[0], c[0]),):
        for n in x:
            assert torch.equal(x[n], y[n])
        assert any(not torch.equal(x[n], z[n]) for n in x)
    for x, y, z in zip(a[1], b[1], c[1]):
        assert torch.equal(x, y) and not torch.equal(x, z)
    for x, y, z in zip([a[2], *a[3]], [b[2], *b[3]], [c[2], *c[3]]):
        assert np.array_equal(x, y) and not np.array_equal(x, z)
    # the same shapes whatever the seed, and distinct rows in every step
    assert [t.shape for t in a[1]] == [t.shape for t in c[1]]
    assert a[2].shape == (traffic["checked_calls"]
                          + traffic["window_chunks"], 2,
                          recipe["steps_per_call"], recipe["batch_size"])
    for step in a[2][:, 0].reshape(-1, recipe["batch_size"]):
        assert len(set(step.tolist())) == len(step)
    assert len(a[3][0]) == traffic["checked_steps"]


# --------------------------------------------------------------- yardstick
def test_flops_and_bounds_against_hand_counts():
    recipe, _ = _tiny("vcc20_vqvae")
    B, T = 4, 32
    step = yardstick.vqvae_step(recipe, B, T)
    # encoder: 80->32 k3, 2 x (32->32 k3 + 32->32 k1), 32->16 k1;
    # decoder: 16->32 k3, 2 x (32->64 k3, cond 8->64 on one frame,
    # 32->48 k1), 16->16 k1, 16->80 k1
    per_frame = (80 * 32 * 3 * 2 + 2 * (32 * 32 * 3 + 32 * 32) * 3
                 + 32 * 16 * 3 + 16 * 32 * 3 * 3
                 + 2 * (32 * 64 * 3 + 32 * 48) * 3
                 + (16 * 16 + 16 * 80) * 3)
    cond = 2 * (2 * 8 * 64 * 3)       # two stacks
    vq = 2 * B * T * 32 * 16
    assert step.train_flops() == 2 * B * T * per_frame + B * cond + vq
    assert [g for g in step.gns] == [(B, T, 32, False)] * 2 + \
        [(B, T, 64, True)] * 2
    assert step.vqs == [(B * T, 32, 16, True)]
    # GroupNorm forward, bf16, no GLU: read x, write y, 8 ops an element
    n = B * T * 32
    ms, what = yardstick.gn_bound_ms(B, T, 32, 2, False)
    assert what == "bytes"
    assert ms == pytest.approx((2 * n + 2 * n + 8 * 32 + 4 * B)
                               / yardstick.HBM_BYTES_PER_S * 1e3)
    # backward with the gate: x and half-width cotangent read, dx written
    ms, _ = yardstick.gnb_bound_ms(B, T, 64, 2, True)
    m = B * T * 64
    assert ms == pytest.approx(max((2 * m + m + 2 * m + 16 * 64)
                                   / yardstick.HBM_BYTES_PER_S,
                                   20 * m / yardstick.FP32_OPS_PER_S) * 1e3)
    # VQ statistics mode: 6 TF32 operations a product term
    ms, what = yardstick.vq_bound_ms(32768, 512, 128, stats=True)
    assert what == "operations"
    assert ms == pytest.approx(6 * 32768 * 512 * 128
                               / yardstick.TF32_OPS_PER_S * 1e3)


def test_hierarchy_layer_walk():
    recipe = _recipe("vcc20_vqvae2")
    step = yardstick.vqvae_step(recipe, 96, 256)
    assert len(step.gns) == 40
    assert sorted({t for _, t, _, _ in step.gns}) == [4, 16, 64, 128, 256]
    assert step.vqs == [(96 * 64, 512, 128, False),
                        (96 * 256, 512, 128, False)]
    assert sum(math.prod(s) for s in
               ref.parameter_shapes(recipe).values()) == 72447200


# -------------------------------------------------------------------- trace
class _Slice:
    def __init__(self, launched, lost, names):
        self.launched, self.lost, self.names = launched, lost, names

    def kernels(self, pattern):
        return [(n, 1e-6) for n in self.names if pattern.search(n)]


@pytest.mark.parametrize("launched,lost,names,expected,short", [
    (10, 0, ["gn_fwd_cluster", "gn_bwd_cluster", "vq_cluster"],
     {"gn": 2, "vq": 1}, False),
    (10, 1, ["gn_fwd_cluster", "gn_bwd_cluster", "vq_cluster"],
     {"gn": 2, "vq": 1}, True),
    # a GroupNorm kernel the trace dropped
    (10, 0, ["gn_fwd_cluster", "vq_cluster"], {"gn": 2, "vq": 1}, True),
    # kernels renamed by the program: the eager step counts none either,
    # the reader finds nothing, no retake
    (10, 0, ["elementwise"], {"gn": 0, "vq": 0}, False),
])
def test_traced_slice_shortfall(launched, lost, names, expected, short):
    assert (K.shortfall(_Slice(launched, lost, names), expected)
            is not None) is short


# an eager step's K1 (2), K2 (20) and K3 (40) kernels
EAGER = ["vq_cluster", "vq_stats"] + ["gn_fwd_cluster"] * 20 + \
    ["gn_bwd_cluster", "gn_bwd_param"] * 20 + ["elementwise"] * 9


@pytest.mark.parametrize("drop,short", [
    (None, False), ("vq_stats", True), ("vq_cluster", True),
    ("gn_bwd_param", True), ("elementwise", False)])
def test_replayed_slice_against_the_eager_step(drop, short):
    """A replayed slice calls no kernel wrapper; its kernels are held to
    the eager step's count times its steps. A slice of 8 steps that lost
    one kernel of a name is retaken; a whole one is not."""
    per_step = K.kernel_counts(_Slice(0, 0, EAGER))
    assert per_step == {"gn": 60, "vq": 2}
    names = EAGER * 8
    if drop:
        names.remove(drop)
    # a replay launches its kernels from the graph: no launch to lose
    sl = _Slice(0, 0, names)
    expected = {k: v * 8 for k, v in per_step.items()}
    assert (K.shortfall(sl, expected) is not None) is short


# --------------------------------------------------------------- reference
@pytest.mark.parametrize("config", CONFIGS)
def test_reference_follows_the_port_in_fp32(config):
    """The plain reference and the port's CPU path agree to fp32 rounding
    over the checked steps, at a tiny width, computing in float32."""
    recipe, traffic = _tiny(config, compute_dtype="float32")
    seed = 987654321
    weights, corpus, plan, _ = K.make_inputs(recipe, traffic, seed, "cpu")
    _, got = K.program_side(recipe, weights, corpus, plan, seed, "cpu")
    want = K.reference_side(recipe, weights, corpus, plan, seed,
                            got["calls"])
    assert len(got["loss"]) == traffic["checked_steps"]
    assert [len(c["loss"]) for c in got["calls"]] == \
        [traffic["followed_steps"]] * traffic["checked_calls"]
    r = K.compare(got, want)
    assert r["loss_gap"] < 1e-6
    assert r["grad1_gap"] < 1e-5
    assert r["call_grad_gap"] < 1e-5
    assert r["change_gap"] < 1e-4


# ------------------------------------------------------------------ faults
@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_state_unchanged_freezes_the_state(device):
    """Under ``state_unchanged`` a step leaves the parameters, Adam's
    moments and count and the EMA codebook as they were, in an eager step
    and, on the card, in steps replayed from a graph captured under the
    fault; without it the same steps move each of them."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from vae_npvc_tpu_torch.train import build_trainer
    from vae_npvc_tpu_torch.train.trainer import Trainer

    recipe, traffic = _tiny("vcc20_vqvae")
    seed = 2 ** 31 + 11
    _, corpus, _, chunks = K.make_inputs(recipe, traffic, seed, device)
    tr = build_trainer(recipe, device=device, seed=seed)
    tr.init_state()
    tr.stage_dataset(corpus, recipe["batch_size"])
    # Adam's moments and the codebook away from their start
    with Trainer.eager_steps():
        tr.train_steps_indices(*chunks[0])

    def state():
        return [t.detach().clone() for t in K._state(tr)]

    before, replays = state(), Trainer.graph_replays
    with K.fault("state_unchanged"):
        d = tr.train_steps_indices(*chunks[1])
    assert torch.isfinite(d["Total"]).all()
    for a, b in zip(before, state()):
        assert torch.equal(a, b)
    if device == "cuda":
        # the shape's first step ran eager, the second was captured under
        # the fault and replayed, as was every later one
        assert Trainer.graph_replays - replays == len(chunks[1][0]) - 1
    with Trainer.eager_steps():
        tr.train_steps_indices(*chunks[2])
    moved = [not torch.equal(a, b) for a, b in zip(before, state())]
    names = ["flat", "count", "mu", "nu", "sched_count", "initted", "emb",
             "emb_sum", "emb_elem"]
    assert len(moved) == len(names)
    assert dict(zip(names, moved)) == dict.fromkeys(names, True) | \
        {"initted": False}
