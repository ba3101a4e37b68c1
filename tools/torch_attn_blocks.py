#!/usr/bin/env python3
"""Queries per forward block of the port's attention kernel on small grids,
timed on the card.

    python3 tools/torch_attn_blocks.py [--out FILE]

``forward()`` in ``vae_npvc_tpu_torch/csrc/attention.cu`` launches
``attn_fwd_kernel`` with 4 warps of 16 query rows, 64 queries a block (fp32
also has a 128-query block for large grids). Where B*H*ceil(T/64) blocks
leave SMs idle (one decoded utterance: 48 blocks on 132 SMs), blocks of 32 or
16 queries (2 or 1 warps) would fill more of them. This script builds the
source as it is ("q64") and two copies whose 64-query launch is replaced by
a 32- or 16-query one, holds each copy's forward against the plain version,
and times the three on the same inputs, in the order q64, q32, q16, q16,
q32, q64, at small-grid shapes: one decoded utterance's encoder and decoder
and a three-row batch, in fp32 and bf16. Times are ``chip_smoke.timed``'s
device ms (kernel durations from torch.profiler) with L2-cold inputs. Needs
one CUDA GPU and nvcc; prints one JSON object per case, then the card's
``nvidia-smi`` line, and writes them all to ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

LAUNCH = "  return forward_rows<DP, 4, 1, BF16>(p, s);\n"
FIXED = "  return forward_rows<DP, {warps}, 1, BF16>(p, s);\n"
VARIANTS = {"q64": None, "q32": 2, "q16": 1}   # name: warps of 16 queries
ORDER = ["q64", "q32", "q16", "q16", "q32", "q64"]
# (B, H, T, d, lengths): one decoded utterance's decoder and encoder (12 and
# 4 blocks of 64 a head), and a three-row batch (72 blocks of 64)
CASES = [(1, 4, 768, 96, None), (1, 4, 192, 96, [150]),
         (3, 4, 384, 64, [384, 200, 1])]


def build(out_dir: Path):
    """``{variant: library path}``, one nvcc per variant, run together."""
    from vae_npvc_tpu_torch.ops import _build

    src = (_build.CSRC / "attention.cu").read_text()
    if src.count(LAUNCH) != 1:
        raise RuntimeError("forward()'s 64-query launch in attention.cu is "
                           "not the one this script patches")
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, warps in VARIANTS.items():
        cu = out_dir / f"attention_{name}.cu"
        cu.write_text(src if warps is None
                      else src.replace(LAUNCH, FIXED.format(warps=warps)))
        so = out_dir / f"attention_{name}.so"
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    paths = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log.decode()}")
        paths[name] = so
    return paths


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"
                                         / "attn_blocks.json"))
    args = ap.parse_args()
    import torch

    import chip_smoke
    from vae_npvc_tpu_torch.ops import _build, attention

    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: this needs a GPU")
    libs = {name: ctypes.CDLL(str(path)) for name, path
            in build(_build.BUILD_DIR / "attn_blocks").items()}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    results = []
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for B, H, T, d, lengths in CASES:
            q, k, v = (torch.tensor(rng.normal(size=(B, T, H * d)),
                                    dtype=torch.float32, device=dev)
                       .to(dtype).reshape(B, T, H, d).transpose(1, 2)
                       for _ in range(3))
            n = (torch.tensor(lengths, dtype=torch.int32, device=dev)
                 if lengths else None)
            scale = 1.0 / math.sqrt(d)
            ref, _ = attention.attention_plain(q, k, v, n, scale)
            peak = float(ref.float().abs().max())
            fwd_args = chip_smoke.l2_cold((q, k, v, n))
            case = {"B": B, "H": H, "T": T, "d": d, "lengths": lengths,
                    "dtype": name, "sms": sms,
                    "blocks_of_64": B * H * -(-T // 64),
                    "err_over_peak": {}, "ms": {v: [] for v in VARIANTS}}
            for variant in ORDER:
                _build._libs["attention"] = libs[variant]
                o, _ = attention._forward(q, k, v, n, scale)
                err = float((o.float() - ref.float()).abs().max()) / peak
                case["err_over_peak"][variant] = err
                tol = chip_smoke.K4_TOL if dtype == torch.float32 else \
                    chip_smoke.ATTN_TOL_BF16[0] + chip_smoke.ATTN_TOL_BF16[1]
                chip_smoke.check(err <= tol, f"{variant} {case}: error {err}")
                ms, _ = chip_smoke.timed(
                    torch, lambda q, k, v, n: attention._forward(
                        q, k, v, n, scale), fwd_args, iters=100)
                case["ms"][variant].append(ms)
            case["mean_ms"] = {v: sum(t) / len(t)
                               for v, t in case["ms"].items()}
            results.append(case)
            print(json.dumps(case), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip(), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"gpu": smi.strip(),
                                          "cases": results}, indent=1))


if __name__ == "__main__":
    main()
