"""Fused vector-quantization pass: nearest code ids, gathered code rows and
EMA cluster statistics.

Replaces the TPU kernel ``vae_npvc_tpu/ops/vq_pallas.py`` ``vq_fused``
(``_vq_kernel``): ``dist = ||e||^2 - 2 z.e^T`` in fp32, argmin with ties to
the lowest index, ``z_q = emb[idx]``, and per-code ``batch_sum (K, D)`` /
``batch_elem (K,)`` over the N rows.

- :func:`vq_fused_plain` is the plain PyTorch version (the CPU path and the
  kernel's oracle).
- :func:`vq_fused` is the wrapper: a CPU tensor takes the plain version; a
  CUDA tensor launches the kernel of ``csrc/vq.cu`` or raises.
  ``vq_fused.launches`` counts wrapper calls that launched it. With the
  span recorder on (``utils/spans.py``) a call is an ``op.vq`` span, and
  with its device spans on the launch is a ``dev.vq`` CUDA-event span
  that keeps the call's ``rescored`` buffer.
- :func:`nearest_code` is the ids mode behind the same rule, registered as
  the operator ``vae_npvc_torch::nearest_code`` (``torch.library``): its
  CPU implementation is the plain version, its CUDA implementation the
  kernel's ids mode (one launch, counted in ``vq_fused.launches``), and a
  fake implementation gives ``torch.export`` its shape, so an exported
  graph holds the operator and launches the kernel on the card. Every
  inference search of ``ops/vq.py`` (plain and EMA codebooks) goes
  through it.

``stats=False`` is the ids-only mode of inference (no z_q, no statistics);
its fields come back as ``None``. On the H100 the kernel takes the
distances on the tensor cores (3xTF32) and re-scores near ties in exact
fp32, so its ids are those of fp32 FMA distances; the source note in
``csrc/vq.cu`` gives the design and the margin. Ids mode is one kernel
launch; statistics mode adds a second, which sums in v1's order.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from ..utils import spans
from . import _build


class VqOut(NamedTuple):
    idx: torch.Tensor                      # (N,) int32
    z_q: Optional[torch.Tensor]            # (N, D) fp32
    batch_sum: Optional[torch.Tensor]      # (K, D) fp32
    batch_elem: Optional[torch.Tensor]     # (K,) fp32


def nearest_code_plain(z_flat, emb):
    """(N, D), (K, D) fp32 -> (N,) int32 nearest-code ids (first on ties)."""
    dots = z_flat @ emb.T
    dist = (emb * emb).sum(dim=1)[None, :] - 2.0 * dots
    return torch.argmin(dist, dim=1).to(torch.int32)


@torch.library.custom_op("vae_npvc_torch::nearest_code", mutates_args=(),
                         device_types="cpu")
def _nearest_code_op(z_flat: torch.Tensor, emb: torch.Tensor) \
        -> torch.Tensor:
    return nearest_code_plain(z_flat, emb)


@_nearest_code_op.register_kernel("cuda")
def _nearest_code_cuda(z_flat, emb):
    return vq_fused(z_flat, emb, stats=False).idx


@_nearest_code_op.register_fake
def _nearest_code_fake(z_flat, emb):
    return z_flat.new_empty((z_flat.shape[0],), dtype=torch.int32)


def nearest_code(z_flat, emb):
    """Nearest-code ids (the JAX package's ``ops/vq.py`` ``nearest_code``)
    of (N, D) fp32 rows against a (K, D) fp32 codebook, through the
    registered operator: :func:`nearest_code_plain` for a CPU tensor, the
    kernel's ids mode (one launch) for a CUDA tensor."""
    return torch.ops.vae_npvc_torch.nearest_code(z_flat.detach(),
                                                 emb.detach())


def vq_fused_plain(z_flat, emb, *, stats=True):
    idx = nearest_code_plain(z_flat, emb)
    if not stats:
        return VqOut(idx, None, None, None)
    K = emb.shape[0]
    z_q = emb[idx.long()]
    one_hot = torch.nn.functional.one_hot(idx.long(), K).to(z_flat.dtype)
    return VqOut(idx, z_q, one_hot.T @ z_flat, one_hot.sum(dim=0))


def _lib():
    lib = _build.library("vq")
    if not getattr(lib, "_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.vq_fused_launch.argtypes = [P, P, I, I, I, P, P, P, P, P, I, P]
        lib.vq_fused_launch.restype = I
        lib.vq_plan.argtypes = [I, I, I, I, P]
        lib.vq_plan.restype = I
        lib._typed = True
    return lib


_plans: dict = {}


def _plan(lib, N, K, D, device):
    """``(cluster size, clusters, re-scored counters)`` of a launch, asked
    of the library once per (device, N, K, D)."""
    key = (device, N, K, D)
    plan = _plans.get(key)
    if plan is None:
        out = (ctypes.c_int * 3)()
        code = lib.vq_plan(N, K, D, device, out)
        _build.check(code, lib, "vq_error_string", "vq_fused")
        plan = _plans[key] = tuple(out)
    return plan


def vq_fused(z_flat, emb, *, stats=True):
    """Fused VQ of ``z_flat`` (N, D) against ``emb`` (K, D), both fp32.

    Returns :class:`VqOut`; with ``stats=False`` only ``idx`` is computed.
    CPU tensors take :func:`vq_fused_plain`; CUDA tensors the kernels, which
    leave in ``vq_fused.rescored`` (an int32 CUDA tensor, 2 x blocks) each
    block's rows re-scored in exact fp32 and, of those, the rows re-scored
    over every code; ``.sum(1)`` gives the call's.
    """
    if not z_flat.is_cuda:
        return vq_fused_plain(z_flat, emb, stats=stats)
    with spans.span("op.vq"):
        if z_flat.dtype != torch.float32 or emb.dtype != torch.float32:
            raise TypeError("vq_fused takes fp32 z and codebook, got "
                            f"{z_flat.dtype} and {emb.dtype}")
        N, D = z_flat.shape
        K = emb.shape[0]
        if emb.shape != (K, D) or not emb.is_cuda:
            raise ValueError(f"codebook must be a CUDA ({K}, {D}) tensor")
        if N < 1 or K < 1:
            raise ValueError(f"empty input: N={N}, K={K}")
        lib = _lib()
        dev = z_flat.device
        cr, _, n_res = _plan(lib, N, K, D, dev.index or 0)
        if cr == 0:
            raise ValueError(f"a ({K}, {D}) codebook does not fit the "
                             "kernel's shared memory")
        z_flat = z_flat.contiguous()
        emb = emb.contiguous()
        idx = torch.empty((N,), dtype=torch.int32, device=dev)
        rescored = torch.empty((2, n_res // 2), dtype=torch.int32, device=dev)
        z_q = bsum = belem = None
        if stats:
            z_q = torch.empty((N, D), dtype=torch.float32, device=dev)
            bsum = torch.empty((K, D), dtype=torch.float32, device=dev)
            belem = torch.empty((K,), dtype=torch.float32, device=dev)

        def ptr(t):
            return None if t is None else t.data_ptr()

        # the call's device time and, summed when drained, its re-scored rows
        with spans.device_span("dev.vq", rescored):
            code = lib.vq_fused_launch(
                z_flat.data_ptr(), emb.data_ptr(), N, K, D, idx.data_ptr(),
                ptr(z_q), ptr(bsum), ptr(belem), rescored.data_ptr(),
                dev.index or 0, _build.stream_of(z_flat))
        _build.check(code, lib, "vq_error_string", "vq_fused")
        vq_fused.launches += 1
        vq_fused.rescored = rescored
        return VqOut(idx, z_q, bsum, belem)


vq_fused.launches = 0
vq_fused.rescored = None
