#!/usr/bin/env python3
"""Time the port's fused VQ kernel (K1) on one GPU, by kernel.

    python3 tools/torch_vq_time.py [--root DIR] [--iters 50]

Imports ``vae_npvc_tpu_torch`` from ``--root`` (default: this checkout;
give an unpacked older tree to time its kernels on the same card in the
same call), builds its ``csrc/vq.cu`` and prints one JSON line per case:
L2-hot and L2-cold device ms of one ``vq_fused`` call (torch.profiler;
cold: inputs cycled through 100 MiB), the cold time by kernel name, the
plain version's time, the 3xTF32 tensor-core bound and the fp32 FMA bound,
and a yardstick that is not a library call of the same function (it takes
two calls and no statistics): ``torch.argmin(torch.addmm(e2, z, emb.T,
alpha=-2), 1)`` in fp32 with TF32 off, i.e. cuBLAS's SGEMM plus an argmin.
Also the rows the kernel re-scored in exact fp32, where the tree's kernel
reports them, and the card's name and power limit. ``--no-rescore`` also
builds a copy of this checkout's ``vq.cu`` whose margin is negative, so it
re-scores no row, and times it on the same inputs
(``ms_l2_cold_no_rescore``): its ids may be wrong near ties, its time says
what the re-scoring costs. ``--phases`` builds a copy with
``-DVQ_PHASE_CLOCKS`` and prints, per case, thread 0's clock64() cycles per
phase of the ids kernel (set-up, tile wait, the quads' merge and the
stores to the merging ranks, cluster barrier, the next tile's loads issued,
merge, end, codebook share, products, each thread's best four), the mean
and the largest over the blocks of one call, beside the SM clock
nvidia-smi reads.
Needs CUDA; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent

# (N, K, D, stats): serving's ids at B = 8 x 256 frames, the training
# step's statistics at B = 128 x 256 with the flagship codebook, and the
# recipes' other codebooks at the training shape
CASES = [(2048, 512, 128, False), (32768, 512, 128, True),
         (32768, 128, 128, True), (32768, 64, 32, True)]


# what turns vq.cu into the copy that re-scores no row
NO_RESCORE = ("const float margin = ldexpf(",
              "const float margin = -1.f * ldexpf(")


PHASES = ("setup", "tile_wait", "push", "cluster_barrier", "prefetch",
          "merge", "end", "codebook", "products", "best_four")
N_SLOTS = 12   # kPhases of csrc/vq.cu


def _variant_library(name, replace=None, flags=()):
    """A copy of vq.cu (with one text replacement, extra nvcc flags), built
    into the build directory and loaded."""
    import ctypes

    from vae_npvc_tpu_torch.ops import _build

    src = (_build.CSRC / "vq.cu").read_text()
    if replace is not None:
        if replace[0] not in src:
            raise RuntimeError(f"vq.cu no longer holds {replace[0]!r}")
        src = src.replace(*replace)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = _build.BUILD_DIR / f"vq_{name}.cu"
    so = cu.with_suffix(".so")
    cu.write_text(src)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o",
                    str(so), str(cu)], check=True, capture_output=True)
    return ctypes.CDLL(str(so))


def _phases(torch, lib, kernel, z, emb):
    """Cycles per phase of one call (mean and max over its blocks)."""
    import ctypes

    from vae_npvc_tpu_torch.ops import _build
    from vae_npvc_tpu_torch.ops.vq_fused import vq_fused

    main_lib = _build.library("vq")
    _build._libs["vq"] = lib
    kernel(z, emb)
    kernel(z, emb)
    torch.cuda.synchronize()
    n = vq_fused.rescored.shape[1]
    buf = (ctypes.c_longlong * (N_SLOTS * n))()
    lib.vq_phase_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    if lib.vq_phase_clocks(buf, n):
        raise RuntimeError("vq_phase_clocks failed")
    _build._libs["vq"] = main_lib
    cyc = np.array(buf, dtype=np.float64).reshape(n, N_SLOTS)[:, :len(PHASES)]
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    return {"blocks": n, "clocks_sm": clock,
            "mean_cycles": dict(zip(PHASES, cyc.mean(0).round().tolist())),
            "max_cycles": dict(zip(PHASES, cyc.max(0).tolist()))}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--no-rescore", action="store_true")
    ap.add_argument("--phases", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    from vae_npvc_tpu_torch.ops.vq_fused import vq_fused, vq_fused_plain

    if not torch.cuda.is_available():
        print("torch_vq_time: no CUDA GPU available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    from vae_npvc_tpu_torch.ops import _build

    main_lib = _build.library("vq") if args.root == str(ROOT) else None
    variant = (_variant_library("no_rescore", NO_RESCORE)
               if args.no_rescore else None)
    clocks = (_variant_library("phases", flags=("-DVQ_PHASE_CLOCKS",))
              if args.phases else None)
    for N, K, D, stats in CASES:
        z = torch.tensor(rng.normal(size=(N, D)), dtype=torch.float32,
                         device=dev)
        emb = torch.tensor(rng.normal(size=(K, D)), dtype=torch.float32,
                           device=dev)

        def kernel(z, e):
            return vq_fused(z, e, stats=stats)

        def yardstick(z, e, e2):
            return torch.argmin(torch.addmm(e2, z, e.T, alpha=-2), 1)

        cold = cs.l2_cold((z, emb))
        by_kernel = {}
        case = {"N": N, "K": K, "D": D, "mode": "stats" if stats else "ids",
                "root": str(Path(args.root).resolve().relative_to(ROOT))
                if Path(args.root).resolve() != ROOT else ".", "gpu": smi}
        case["ms"], _ = cs.timed(torch, kernel, [(z, emb)], args.iters)
        case["ms_l2_cold"], _ = cs.timed(torch, kernel, cold, args.iters,
                                         by_name=by_kernel)
        case["ms_l2_cold_by_kernel"] = by_kernel
        case["plain_ms"], _ = cs.timed(
            torch, lambda z, e: vq_fused_plain(z, e, stats=stats),
            [(z, emb)], args.iters)
        e2 = (emb * emb).sum(1)
        case["sgemm_argmin_ms"], _ = cs.timed(
            torch, yardstick, [(a, b, (b * b).sum(1)) for a, b in cold],
            args.iters)
        if variant is not None:
            _build._libs["vq"] = variant
            case["ms_l2_cold_no_rescore"], _ = cs.timed(torch, kernel, cold,
                                                       args.iters)
            _build._libs["vq"] = main_lib
        if clocks is not None:
            case["phases"] = _phases(torch, clocks, kernel, z, emb)
        case["bound_ms"], case["bound_by"] = cs.vq_bound_ms(N, K, D, stats)
        case["fma_bound_ms"], _ = cs.vq_bound_ms(N, K, D, stats, fma=True)
        got = kernel(z, emb)
        ref = yardstick(z, emb, e2)
        torch.cuda.synchronize()
        case["ids_differ_from_sgemm"] = int((got.idx.long() != ref).sum())
        res = getattr(vq_fused, "rescored", None)
        case["rescored_rows"], case["rescored_all_codes"] = (
            (None, None) if res is None else res.sum(1).tolist())
        print(json.dumps(case), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
