"""L2-cold timing check of the port's kernels on one GPU.

Builds the kernels, runs ``chip_smoke.py``'s ``kernels`` phase and then
K2's split cases (the sequence-parallel GroupNorm's entry points at a
rank's row) ``--repeats`` times, and prints each case's L2-hot and
L2-cold time beside its bound, so that the spread between repeats and any
time below its bound can be read off. Run from the repository's root:

    python3 tools/torch_cold_timing.py [--repeats 3]
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as S  # noqa: E402

SPLIT_CASES = ((512, 1, False, "float32"), (1024, 2, True, "float32"),
               (1024, 2, True, "bfloat16"))


def _cold_rows(obj, path, rows):
    """(path, hot ms, L2-cold ms, bound ms) of every case in ``obj``."""
    if isinstance(obj, dict):
        for pre in ("", "bwd_"):
            if obj.get(f"{pre}ms_l2_cold") is not None:
                rows.append((path + pre, obj.get(f"{pre}ms"),
                             obj[f"{pre}ms_l2_cold"], obj[f"{pre}bound_ms"]))
        for k, v in obj.items():
            _cold_rows(v, f"{path}.{k}", rows)
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            _cold_rows(v, f"{path}[{i}]", rows)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args(argv)
    import torch

    t0 = time.perf_counter()
    S.phase_build(torch)
    rows = _cold_rows(list(S.phase_kernels(torch)), "kernels", [])
    for rep in range(args.repeats):
        rng = np.random.default_rng(61)
        for C, G, glu, dtype in SPLIT_CASES:
            case = S._gn_split_case(torch, C, G, glu, getattr(torch, dtype),
                                    rng)
            for part in ("stats", "apply"):
                rows.append((f"split[{rep}] C={C} glu={glu} {dtype} {part}",
                             case[f"{part}_ms"], case[f"{part}_ms_l2_cold"],
                             case[f"{part}_bound_ms"]))
    for row in rows:
        print(json.dumps(dict(zip(("case", "ms", "ms_l2_cold", "bound_ms"),
                                  row))), flush=True)
    below = [r[0] for r in rows if r[2] < r[3]]
    print(json.dumps({"cases": len(rows), "below_bound": below,
                      "seconds": time.perf_counter() - t0}))
    return 1 if below else 0


if __name__ == "__main__":
    sys.exit(main())
