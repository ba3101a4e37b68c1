"""CPU tests that hold for every cell of ``BENCHMARK.json``, of whatever
kind: imports, the control and the kind's planted faults, the refusal to
run without a card and the short run on the card. Each cell runs at the
tiny widths of its configuration's ``tiny/<config>.json``, with its own
traffic and its kind's module, faults and control.

    python -m pytest benchmark/tests -q

Tests marked ``cuda`` need the card and skip elsewhere.
"""

from __future__ import annotations

import ast
import contextlib
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import calibrate, harness
from benchmark.tests import TINY, overrides

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
SPEC = harness.load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]


def _config(workload):
    return {w["name"]: w for w in SPEC["workloads"]}[workload]["config"]


def _kind(workload):
    return harness.cell(SPEC, workload)[2]["kind"]


def _over(workload, sound=False):
    """The tiny overrides of a cell; a cell with no tiny file fails
    :func:`test_every_cell_has_a_tiny_file` and is run by no other test."""
    config = _config(workload)
    if not (TINY / f"{config}.json").exists():
        pytest.skip(f"no tiny/{config}.json "
                    "(test_every_cell_has_a_tiny_file fails)")
    return overrides(config, sound)


@pytest.mark.parametrize("workload", CELLS)
def test_every_cell_has_a_tiny_file(workload):
    assert (TINY / f"{_config(workload)}.json").exists()
    assert set(overrides(_config(workload))) <= {"recipe", "vocoder",
                                                  "traffic"}


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


# ------------------------------------------------ control and planted faults
@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    """The plain reference in the next lower precision in the program's
    place fails the cell's limits."""
    limits = harness.cell(SPEC, workload)[3]
    over = _over(workload)
    for seed in (11, 12, 13):
        r = calibrate.readings(workload, seed, "control", "cpu", over)
        assert not harness.judge(r, limits)[0], r


@pytest.mark.parametrize("workload,fault", [
    (w, f) for w in CELLS
    for f in [*harness.kind(_kind(w)).FAULTS, None]])
def test_planted_faults_are_not_correct(workload, fault):
    """A whole run on the CPU with each of the kind's faults under the
    timed path comes out not correct; without one (under the tiny file's
    ``sound`` overrides) it comes out correct."""
    cm = (calibrate.fault(fault, _kind(workload)) if fault
          else contextlib.nullcontext())
    over = _over(workload, sound=fault is None)
    with cm:
        res = harness.run_cell(workload, 31, 0.5, 0, device="cpu",
                               config_override=over)
    assert res["correct"] is (fault is None), res["checks"]
    assert list(res)[-1] == "checks"
    json.dumps(res)


# ------------------------------------------------------------------ no card
@pytest.mark.parametrize("workload", CELLS)
def test_no_card_exits_nonzero(workload):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", workload,
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
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
