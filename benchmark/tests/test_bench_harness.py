"""CPU tests of the benchmark's harness: imports, seeded inputs, the
yardstick's counts, the plain reference against the port, the output
check's control and planted faults, and the refusal to run without a card.

    python -m pytest benchmark/tests -q

Tests marked ``cuda`` need the card and skip elsewhere.
"""

from __future__ import annotations

import ast
import contextlib
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import calibrate, harness, yardstick
from benchmark.kinds import train as K
from benchmark.reference import vqvae as ref
from benchmark.tests.tiny import TINY

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
SPEC = harness.load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]
# every configuration file, a cell's or one kept for a cell to come
CONFIGS = sorted(TINY)


def _recipe(config):
    return json.loads((BENCH / "configs" / f"{config}.json")
                      .read_text())["recipe"]


def _tiny(config, **extra):
    """A configuration's recipe at tiny widths, and the training traffic."""
    traffic = json.loads((BENCH / "traffic" / "train.json").read_text())
    return dict(_recipe(config), **TINY[config]["recipe"], **extra), traffic


def _over(workload):
    """The tiny overrides of a cell."""
    w = {w["name"]: w for w in SPEC["workloads"]}[workload]
    return {k: dict(v) for k, v in TINY[w["config"]].items()}


def _kind(workload):
    return harness.cell(SPEC, workload)[2]["kind"]


# ------------------------------------------------------------------ imports
def test_forbidden_names_compare_whole_top_level():
    names = ["vae_npvc_tpu_torch", "vae_npvc_tpu_torch.ops", "jaxtyping",
             "flaxen.x"]
    bad = ["jax", "jax.numpy", "jaxlib.xla", "flax.linen", "vae_npvc_tpu",
           "vae_npvc_tpu.models"]
    saved = {n: sys.modules.get(n) for n in names + bad}
    try:
        for n in names + bad:
            sys.modules[n] = type(sys)(n)
        assert set(bad) <= set(harness.forbidden_modules())
        assert not set(names) & set(harness.forbidden_modules())
    finally:
        for n, m in saved.items():
            if m is None:
                sys.modules.pop(n, None)
            else:
                sys.modules[n] = m


def test_harness_imports_no_jax():
    """Every module of the harness, with the program's modules that a run
    loads, leaves no JAX name in a fresh process."""
    mods = sorted("benchmark." + ".".join(p.relative_to(BENCH)
                                          .with_suffix("").parts)
                  for p in BENCH.rglob("*.py")
                  if "tests" not in p.parts and "metrics" not in p.parts
                  and p.name != "__init__.py")
    code = ("import sys, importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "import vae_npvc_tpu_torch.train, vae_npvc_tpu_torch.ops._build\n"
            "from benchmark import harness\n"
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for n in names:
                assert n.split(".")[0] not in (
                    "vae_npvc_tpu_torch", *harness.FORBIDDEN), (path, n)


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


@pytest.mark.parametrize("launched,lost,names,calls,short", [
    (10, 0, ["gn_fwd_cluster", "gn_bwd_cluster", "vq_cluster"],
     {"gn": 2, "vq": 1}, False),
    (10, 1, ["gn_fwd_cluster", "gn_bwd_cluster", "vq_cluster"],
     {"gn": 2, "vq": 1}, True),
    # a GroupNorm call whose kernel the trace dropped
    (10, 0, ["gn_fwd_cluster", "vq_cluster"], {"gn": 2, "vq": 1}, True),
    # kernels renamed by the program: the reader finds nothing, no retake
    (10, 0, ["elementwise"], {"gn": 2, "vq": 1}, False),
])
def test_traced_slice_shortfall(launched, lost, names, calls, short):
    assert (K.shortfall(_Slice(launched, lost, names), calls)
            is not None) is short


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


# ------------------------------------------------ control and planted faults
@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    """The plain reference in the next lower precision in the program's
    place fails the cell's limits."""
    limits = harness.cell(SPEC, workload)[3]
    for seed in (11, 12, 13):
        r = calibrate.readings(workload, seed, "control", "cpu",
                               _over(workload))
        assert not harness.judge(r, limits)[0], r


@pytest.mark.parametrize("workload,fault", [
    (w, f) for w in CELLS
    for f in calibrate.FAULTS[_kind(w)] + [None]])
def test_planted_faults_are_not_correct(workload, fault):
    """A whole run on the CPU with a fault under the timed path comes out
    not correct; without one (in float32) it comes out correct."""
    cm = calibrate.fault(fault) if fault else contextlib.nullcontext()
    over = _over(workload)
    if fault is None:
        over["recipe"]["compute_dtype"] = "float32"
    with cm:
        res = harness.run_cell(workload, 31, 0.5, 0, device="cpu",
                               config_override=over)
    assert res["correct"] is (fault is None), res["checks"]
    assert list(res)[-1] == "checks"
    json.dumps(res)


# ------------------------------------------------------------------ no card
def test_no_card_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "vqvae-train-b128", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


# -------------------------------------------------------------- on the card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_short_run_on_the_card(card, workload):
    """A traced run with a short window: correct, and the trace read."""
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", workload,
         "--seed", "424242", "--seconds", "12", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["busy_s"] > 0
