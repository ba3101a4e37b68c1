#!/usr/bin/env python3
"""Hold every fused-VQ (K1) call of the smoke's training run against fp64.

    python3 tools/torch_vq_train_calls.py [--root DIR]

Runs ``chip_smoke.py``'s ``train`` phase (the flagship flat VQ-VAE, bf16,
B = 128, T = 256, 20 steps on a synthetic corpus) with the port imported
from ``--root`` (default: this checkout), and wraps ``vq_fused`` as the
model calls it, every step eager (no CUDA graph). For each call it prints
one JSON line: the mode, the rows
the kernel re-scored in exact fp32 and of those the rows re-scored over
every code (where the tree's kernel reports them), the rows whose two best
fp64 distances lie within the kernel's margin, the largest fp64 distance a
chosen code loses against the best, whether counts are exact, z_q equals
the chosen codes and the sums lie within 1e-5 of sum|z|. Then the train
phase's fixed-batch ``X like`` after the first chunk and the last (or its
failure), and the card's name and power limit. Needs CUDA; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(ROOT))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    import vae_npvc_tpu_torch.ops.vq as vq_mod
    from vae_npvc_tpu_torch.ops.vq_fused import vq_fused

    if not torch.cuda.is_available():
        print("torch_vq_train_calls: no CUDA GPU available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False

    def checked(z, emb, *, stats=True):
        out = vq_fused(z, emb, stats=stats)
        N, D = z.shape
        K = emb.shape[0]
        z64, e64 = z.double(), emb.double()
        d64 = (e64 ** 2).sum(1)[None] - 2 * z64 @ e64.T
        top2 = torch.topk(d64, min(2, K), dim=1, largest=False).values
        emax = float(e64.norm(dim=1).max())
        margin = 2.0 ** -20 * ((D + 8) * z64.norm(dim=1) * emax + emax ** 2)
        ids = out.idx.long()
        lost = d64[torch.arange(N, device=z.device), ids] - top2[:, 0]
        res = getattr(vq_fused, "rescored", None)
        rec = {"stats": stats, "N": N,
               "rescored": None if res is None else res.sum(1).tolist(),
               "within_margin": int(((top2[:, -1] - top2[:, 0])
                                     <= margin).sum()),
               "max_loss_vs_fp64": float(lost.max())}
        if stats:
            exact = torch.zeros((K, D), dtype=torch.float64,
                                device=z.device).index_add_(0, ids, z64)
            scale = torch.zeros_like(exact).index_add_(0, ids, z64.abs())
            rec["counts_exact"] = bool(torch.equal(
                out.batch_elem, torch.bincount(ids, minlength=K).float()))
            rec["z_q_exact"] = bool(torch.equal(out.z_q, emb[ids]))
            rec["sums_within_1e-5"] = bool(
                ((out.batch_sum.double() - exact).abs()
                 <= 1e-5 * scale + 1e-6).all())
        print(json.dumps(rec), flush=True)
        return out

    vq_mod.vq_fused = checked
    from vae_npvc_tpu_torch.train.trainer import Trainer

    cs.emit = lambda obj: print(json.dumps({
        "held_batch_x_like_after_first_chunk_and_last":
            obj.get("held_batch_x_like_after_first_chunk_and_last")}),
        flush=True)
    try:
        # every step eager: a step replayed from a CUDA graph calls no
        # wrapper, and a captured one cannot read its tensors on the host
        with tempfile.TemporaryDirectory() as tmp, Trainer.eager_steps():
            cs.phase_train(torch, Path(tmp) / "trained.msgpack")
    except RuntimeError as e:
        print(json.dumps({"train_failed": str(e)}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
