#!/usr/bin/env python3
"""The attention kernels' fp32 error against float64, beside the plain
fp32 version's, and the kernels' times (GPU).

    python3 tools/torch_attn_f64.py [--root TREE] [--time]

For each case, q, k, v and the cotangent are (B, H, T, d) views of
(B, T, H*d) normal draws (as ``chip_smoke._attn_case`` makes them), and
o, dq, dk and dv come from the kernels (``fused_attention`` and its
backward), from the plain fp32 versions (``attention_plain``,
``attention_backward_plain``) and from the same formulas in float64. Each
line is one JSON object: per output, the largest error over the float64
output's peak of the kernel and of the plain version, and the kernel's
against the plain version. A sum over many queries (dk, dv) or keys (o,
dq) grows its rounding with its length; this shows whether the kernel
stays within the plain version's own distance from the exact value.
Prints the card's name and power limit first.

``--time`` also times the forward kernel (``fused_attention``) and the
backward kernels (``fused_attention_backward``, one call = the dq and the
dk/dv kernel) at the shapes of PERF.md's kernel table in fp32 and bf16, as
CUDA-event ms per call over 50 back-to-back calls on L2-hot inputs.
``--root`` imports the port from another checkout (an unpacked older
tree), so two versions are timed on one card by running the script once
per tree in one call.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

CASES = [
    # B, H, T, d, lengths (None: all keys valid; "ragged": T/3..T)
    (16, 4, 600, 48, "ragged"),
    (16, 4, 1536, 48, [1496] + [1] * 15),
    (16, 4, 1536, 48, "ragged"),
    (32, 4, 768, 96, "ragged"),
    (4, 4, 1536, 96, None),
    (4, 4, 3072, 48, None),
    (4, 4, 3072, 96, None),
]
# the timed shapes (B, H, T, d, lengths, dtype): a synthesizer
# training batch's decoder and encoder, one decoded utterance, the decoder
# in bf16, the recognizer's training batch
TIMED = [
    (32, 4, 768, 96, "ragged", "float32"),
    (32, 4, 192, 96, "ragged", "float32"),
    (1, 4, 768, 96, None, "float32"),
    (32, 4, 768, 96, "ragged", "bfloat16"),
    (16, 4, 600, 48, "ragged", "float32"),
]


def reference64(q, k, v, do, lengths, scale):
    """o, dq, dk, dv in float64 (keys at or past a row's length masked)."""
    q, k, v, do = (t.double() for t in (q, k, v, do))
    s = (q @ k.transpose(-1, -2)) * scale
    if lengths is not None:
        T = q.shape[2]
        n = lengths.clamp(1, T)
        keep = (torch.arange(T, device=q.device)[None] < n[:, None])[
            :, None, None, :]
        s = s.masked_fill(~keep, -math.inf)
    p = torch.softmax(s, dim=-1)
    o = p @ v
    dp = do @ v.transpose(-1, -2)
    ds = p * (dp - (do * o).sum(-1, keepdim=True))
    return o, ds @ k * scale, ds.transpose(-1, -2) @ q * scale, \
        p.transpose(-1, -2) @ do


def case(B, H, T, d, lengths, rng):
    from vae_npvc_tpu_torch.ops.attention import (attention_backward_plain,
                                                  attention_plain,
                                                  fused_attention)

    dev = torch.device("cuda")
    q, k, v, do = (torch.tensor(rng.normal(size=(B, T, H * d)),
                                dtype=torch.float32, device=dev)
                   .reshape(B, T, H, d).transpose(1, 2) for _ in range(4))
    if lengths == "ragged":
        lengths = [T] + rng.integers(T // 3, T + 1, size=B - 1).tolist()
    n = (torch.tensor(lengths, dtype=torch.int32, device=dev)
         if lengths else None)
    scale = 1.0 / math.sqrt(d)
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
    o = fused_attention(qg, kg, vg, n)
    kern = (o.detach(),) + torch.autograd.grad(o, (qg, kg, vg), do)
    ref_o, lse = attention_plain(q, k, v, n, scale)
    plain = (ref_o,) + attention_backward_plain(q, k, v, ref_o, lse, do, n,
                                                scale)
    exact = reference64(q, k, v, do, n, scale)
    torch.cuda.synchronize()
    out = {"B": B, "H": H, "T": T, "d": d,
           "valid_keys": sum(min(max(x, 1), T) for x in lengths)
           if lengths else B * T}
    for name, a, b, e in zip(("o", "dq", "dk", "dv"), kern, plain, exact):
        peak = float(e.abs().max())
        out[name] = {
            "kernel_vs_f64": float((a.double() - e).abs().max()) / peak,
            "plain_vs_f64": float((b.double() - e).abs().max()) / peak,
            "kernel_vs_plain": float((a - b).abs().max()) / peak}
    return out


def timed(B, H, T, d, lengths, dtype, rng, iters=50):
    """CUDA-event ms per ``fused_attention`` forward (no autograd) and per
    ``fused_attention_backward`` call on the same inputs."""
    from vae_npvc_tpu_torch.ops.attention import (attention_plain,
                                                  fused_attention,
                                                  fused_attention_backward)

    dev = torch.device("cuda")
    dt = getattr(torch, dtype)
    q, k, v, do = (torch.tensor(rng.normal(size=(B, T, H * d)),
                                dtype=torch.float32, device=dev)
                   .to(dt).reshape(B, T, H, d).transpose(1, 2)
                   for _ in range(4))
    if lengths == "ragged":
        lengths = [T] + rng.integers(T // 3, T + 1, size=B - 1).tolist()
    n = (torch.tensor(lengths, dtype=torch.int32, device=dev)
         if lengths else None)
    scale = 1.0 / math.sqrt(d)
    o, lse = attention_plain(q.float(), k.float(), v.float(), n, scale)
    o = o.to(dt)
    out = {"B": B, "H": H, "T": T, "d": d, "dtype": dtype}
    calls = {"fwd_ms": lambda: fused_attention(q, k, v, n),
             "bwd_ms": lambda: fused_attention_backward(q, k, v, o, lse, do,
                                                        n, scale=scale)}
    with torch.no_grad():
        for key, fn in calls.items():
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            torch.cuda.synchronize()
            out[key] = start.elapsed_time(end) / iters
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent
                                          .parent),
                    help="checkout whose vae_npvc_tpu_torch is measured")
    ap.add_argument("--time", action="store_true",
                    help="also time the kernels at PERF.md's shapes")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    from vae_npvc_tpu_torch.utils.device import resolve_device

    resolve_device("cuda")
    print(json.dumps({"root": str(Path(args.root).resolve())}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    rng = np.random.default_rng(0)
    for c in CASES:
        print(json.dumps(case(*c, rng)), flush=True)
    if args.time:
        for c in TIMED:
            print(json.dumps(timed(*c, rng)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
