#!/usr/bin/env python3
"""Time the port's GroupNorm(+GLU) kernels (K2 forward, K3 backward) at the
flat model's shapes on one GPU.

    python3 tools/torch_gn_time.py [--iters 20] [--layout last]
                                   [--without-barriers]

Builds ``vae_npvc_tpu_torch/csrc/groupnorm.cu`` as ``chip_smoke.py`` does
and prints one JSON line per case: L2-cold device ms of the kernel call
(torch.profiler, inputs cycled through 100 MiB), its byte bound, the
library call's time where one computes the same function (``F.group_norm``
and autograd's backward of it, on contiguous channels-first tensors), the
cluster size the launch took (0: streaming), and the card's name and
power limit, and the backward's device ms by kernel (L2-hot). x (and the
cotangent) are channels-first views, as the convolutions hand them over,
or contiguous with ``--layout last``. ``--without-barriers`` also builds
a copy of the source whose cluster kernels skip their cluster barriers
and read only their own block's partial sums, and times it on the same
inputs (``*_no_barrier_ms``): its results are wrong, its time says what
the barriers cost. Needs CUDA; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# (B, T, C, G, glu): the training step's encoder and decoder norms, the
# serving batch's decoder norm
SHAPES = [(128, 256, 512, 1, False), (128, 256, 1024, 2, True),
          (8, 256, 1024, 2, True)]


# what turns groupnorm.cu into the copy without cluster barriers
NO_BARRIER = [("cl.sync();", "__syncthreads();"),
              ("cl.map_shared_rank(v, q)[g]", "v[g]"),
              ('asm volatile("barrier.cluster.arrive.release;\\n" ::: '
               '"memory");', ""),
              ('asm volatile("barrier.cluster.wait.acquire;\\n" ::: '
               '"memory");', "")]


def _no_barrier_library():
    """The copy of groupnorm.cu without cluster barriers, built into the
    build directory and loaded."""
    import ctypes

    from vae_npvc_tpu_torch.ops import _build

    src = (_build.CSRC / "groupnorm.cu").read_text()
    for old, new in NO_BARRIER:
        if old not in src:
            raise RuntimeError(f"groupnorm.cu no longer holds {old!r}")
        src = src.replace(old, new)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = _build.BUILD_DIR / "groupnorm_no_barrier.cu"
    so = cu.with_suffix(".so")
    cu.write_text(src)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                    str(cu)], check=True, capture_output=True)
    return ctypes.CDLL(str(so))


def _by_kernel(torch, fn, iters):
    """Device ms per call of each kernel ``fn`` launches (L2-hot)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = re.search(r"gn_\w+", e.name)
            name = name.group(0) if name else e.name[:60]
            out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
    return {k: v / iters for k, v in out.items()}


def main(argv=None):
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from vae_npvc_tpu_torch.ops.groupnorm import (fused_group_norm,
                                                  fused_group_norm_backward,
                                                  plan)

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--layout", choices=("first", "last"), default="first")
    ap.add_argument("--without-barriers", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_gn_time: no CUDA GPU available", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    from vae_npvc_tpu_torch.ops import _build

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    libs = {"": _build.library("groupnorm")}
    if args.without_barriers:
        libs["_no_barrier"] = _no_barrier_library()
    for dtype in (torch.bfloat16, torch.float32):
        for B, T, C, G, glu in SHAPES:
            Cout = C // 2 if glu else C
            x = torch.tensor(rng.normal(0.5, 2.0, size=(B, T, C)),
                             device=dev).to(dtype)
            g = torch.tensor(rng.normal(size=(B, T, Cout)),
                             device=dev).to(dtype)
            if args.layout == "first":
                x, g = cs._channels_first(x), cs._channels_first(g)
            s = torch.tensor(rng.normal(1.0, 0.2, size=C),
                             dtype=torch.float32, device=dev)
            b = torch.zeros(C, device=dev)

            def fwd(x, s, b):
                return fused_group_norm(x, s, b, G, glu=glu)

            def bwd(x, s, b, g):
                return fused_group_norm_backward(x, s, b, g, G, glu=glu)

            case = {"B": B, "T": T, "C": C, "G": G, "glu": glu,
                    "dtype": str(dtype).split(".")[-1],
                    "layout": cs._layout(x), "gpu": smi,
                    "plan_fwd": plan(x, glu),
                    "plan_bwd": plan(x, glu, backward=True)}
            for tag, lib in libs.items():
                _build._libs["groupnorm"] = lib
                case[f"fwd{tag}_ms"], _ = cs.timed(
                    torch, fwd, cs.l2_cold((x, s, b)), args.iters)
                case[f"bwd{tag}_ms"], _ = cs.timed(
                    torch, bwd, cs.l2_cold((x, s, b, g)), args.iters)
            _build._libs["groupnorm"] = libs[""]
            case["fwd_bound_ms"], _ = cs.gn_bound_ms(B, T, C,
                                                     x.element_size(), glu)
            case["bwd_bound_ms"], _ = cs.gnb_bound_ms(B, T, C,
                                                      x.element_size(), glu)
            case["bwd_ms_by_kernel"] = _by_kernel(
                torch, lambda: bwd(x, s, b, g), args.iters)
            if not glu:
                xt = x.transpose(1, 2).contiguous()
                sl, bl = s.to(dtype), b.to(dtype)
                case["fwd_library_ms"], _ = cs.timed(
                    torch, lambda x: F.group_norm(x, G, sl, bl, 1e-5),
                    cs.l2_cold((xt,)), args.iters)
                xl = xt.requires_grad_(True)
                sg, bg = (sl.clone().requires_grad_(True),
                          bl.clone().requires_grad_(True))
                y = F.group_norm(xl, G, sg, bg, 1e-5)
                gt = g.transpose(1, 2).contiguous()
                case["bwd_library_ms"], _ = cs.timed(
                    torch, lambda: torch.autograd.grad(y, (xl, sg, bg), gt,
                                                       retain_graph=True),
                    [()], args.iters)
            print(json.dumps(case), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
