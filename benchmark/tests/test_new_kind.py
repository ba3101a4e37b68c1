"""A cell of a new kind is new files and new entries only.

The test copies ``benchmark/`` and ``BENCHMARK.json`` to a temporary
directory and adds there, from ``toy/``, a kind in plain PyTorch on the
CPU (``kinds/toy.py``: ``run``, ``control_readings``, ``FAULTS``,
``fault``) with its traffic, configuration, limits, tiny file and one
metric reader, and the entries of ``toy/BENCHMARK.add.json``. In that copy
it runs the cell, its calibration's sides and the tests that hold for
every cell, and finds every file that was there before unchanged.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
TOY = Path(__file__).resolve().parent / "toy"
CELL = "toy-matmul-b64"
IGNORE = shutil.ignore_patterns("__pycache__", "*.pyc")

RUN = f"""
import json
from benchmark import calibrate, harness
from benchmark.kinds import toy
from benchmark.tests import overrides

over = overrides("toy_matmul")
out = {{"runs": [harness.run_cell({CELL!r}, 2 ** 31 + 3, 0.2, trace,
                                  device="cpu", config_override=over)
                 for trace in (0, 1)],
       "sides": {{side: calibrate.readings({CELL!r}, 2 ** 31 + 5, side,
                                           "cpu", over)
                 for side in ("program", "control", *toy.FAULTS)}},
       "limits": harness.cell(harness.load_spec(), {CELL!r})[3]}}
print(json.dumps(out))
"""


def _files(root):
    return {p.relative_to(root): p.read_bytes()
            for p in root.rglob("*") if p.is_file()
            and "__pycache__" not in p.parts and p.suffix != ".pyc"}


def test_a_cell_of_a_new_kind_is_new_files_only(tmp_path):
    copy = tmp_path / "checkout"
    shutil.copytree(BENCH, copy / "benchmark", ignore=IGNORE)
    shutil.copy(ROOT / "BENCHMARK.json", copy)
    before = _files(copy)
    added = [p for p in TOY.rglob("*") if p.is_file()
             and "__pycache__" not in p.parts and p.suffix != ".pyc"
             and p.name != "BENCHMARK.add.json"]
    for src in added:
        dst = copy / "benchmark" / src.relative_to(TOY)
        assert not dst.exists(), dst
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(src, dst)
    old = json.loads((ROOT / "BENCHMARK.json").read_text())
    add = json.loads((TOY / "BENCHMARK.add.json").read_text())
    spec = {k: v + add[k] if k in add else v for k, v in old.items()}
    (copy / "BENCHMARK.json").write_text(json.dumps(spec, indent=1) + "\n")

    # the copy's own package first, the program's from this checkout
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(copy), str(ROOT), os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, "-c", RUN], cwd=copy, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    untraced, traced = got["runs"]
    assert untraced["correct"] and traced["correct"]
    assert set(untraced["metrics"]) == {"toy_rows_per_s", "setup_s"}
    assert set(traced["metrics"]) == {"toy_rows_per_call.toy"}
    assert list(untraced["checks"]) == ["answer_gap"]
    limit = got["limits"]["answer_gap"]
    for side, r in got["sides"].items():
        assert (r["answer_gap"] <= limit) is (side == "program"), (side, r)

    tests = subprocess.run(
        [sys.executable, "-m", "pytest", "-v", "-p", "no:cacheprovider",
         "benchmark/tests/test_bench_harness.py"],
        cwd=copy, env=env, capture_output=True, text=True, timeout=600)
    assert tests.returncode == 0, tests.stdout[-4000:]
    passed = [line for line in tests.stdout.splitlines()
              if CELL in line and "PASSED" in line]
    # a tiny file; the control; the fault and a sound run; no card
    assert len(passed) == 5, tests.stdout[-4000:]

    after = _files(copy)
    assert set(after) == set(before) | {
        Path("benchmark") / p.relative_to(TOY) for p in added}
    for path in before:
        if path != Path("BENCHMARK.json"):
            assert after[path] == (ROOT / path).read_bytes(), path
    assert json.loads(after[Path("BENCHMARK.json")]) == spec
