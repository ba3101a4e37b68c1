"""Masked multi-head self-attention: ``softmax(q k^T * scale + key-padding
mask) v`` with a flash-style backward.

Replaces the TPU kernels of ``vae_npvc_tpu/ops/attention_pallas.py``
``fused_attention`` (forward ``_fwd`` / ``_fwd_kernel``, backward ``_bwd`` /
``_bwd_kernel``). q, k, v are (B, H, T, d) with one shared T; ``lengths``
(B,) counts the valid *keys* of each batch row (clamped to [1, T]; ``None``
means T). Queries are not masked: padded query rows give finite values the
caller masks.

- :func:`attention_plain` and :func:`attention_backward_plain` are the plain
  PyTorch versions (the CPU path and the kernels' oracles), written with the
  TPU kernels' rounding points: products take operands in the input dtype
  and accumulate in fp32 (here a bf16 operand is widened and multiplied in
  fp32, which is exact), the scale is applied to the fp32 scores, masking
  (``-FLT_MAX``, not ``-inf``), max-subtraction with the all-masked guard,
  ``exp``, the denominator and the log-sum-exp are fp32, ``p`` is rounded to
  the input dtype before ``p v`` and ``p^T dO`` and ``ds`` before ``ds k``
  and ``ds^T q``, ``o`` is divided by ``max(denominator, 1e-30)`` in fp32
  and then cast.
- :func:`fused_attention` is the differentiable wrapper: one
  ``torch.autograd.Function`` whose forward and backward take the plain
  versions for a CPU tensor and launch the kernels of ``csrc/attention.cu``
  for a CUDA tensor, or raise. The kernels run every product on the tensor
  cores: bf16 operands as they are (``mma.sync`` m16n8k16, fp32
  accumulation, the same products as the plain version, ``exp`` by
  ``ex2.approx``), fp32 operands as 3xTF32 (each operand split into two
  TF32 parts, three products summed in fp32; within ~1e-5 of the peak from
  the plain version on an H100, where one TF32 product would miss the
  tolerance tenfold).
  The wrapper saves q, k, v, ``o`` and the fp32 log-sum-exp (B*H, T); the
  backward recomputes ``p`` and never stores a (T, T) array.
  ``fused_attention.launches`` counts forward launches,
  ``fused_attention_backward.launches`` backward launches. With the span
  recorder on (``utils/spans.py``) each CUDA call is an ``op.attn_fwd``
  or ``op.attn_bwd`` span.

The kernels read their tensors by stride (last dimension contiguous,
16-byte aligned, strides multiples of 8 elements), so the (B, H, T, d) views
of a (B, T, H*d) projection and the matching cotangent are not copied; any
other layout is made contiguous first. Outputs take q's layout. Head dims up
to 128 that are multiples of 8 are taken; others raise.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..utils import spans
from . import _build

NEG_INF = float(torch.finfo(torch.float32).min)


def _key_mask(lengths, B, T, device):
    """(B, 1, 1, T) bool: key positions below the clamped length."""
    if lengths is None:
        return None
    n = lengths.to(device=device).reshape(B).clamp(1, T)
    return (torch.arange(T, device=device)[None, :] < n[:, None])[:, None,
                                                                   None, :]


def _scores(q, k, lengths, scale):
    B, _, T, _ = q.shape
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    mask = _key_mask(lengths, B, T, q.device)
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    return s


def attention_plain(q, k, v, lengths=None, scale=None):
    """``(o, lse)``: o (B, H, T, d) in q's dtype, lse (B*H, T) fp32."""
    B, H, T, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    s = _scores(q, k, lengths, scale)
    m = s.max(dim=-1, keepdim=True).values.clamp(min=NEG_INF / 2)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    o = (p.to(q.dtype).float() @ v.float()) / denom
    lse = (m + torch.log(denom)).reshape(B * H, T)
    return o.to(q.dtype), lse


def attention_backward_plain(q, k, v, o, lse, do, lengths=None, scale=None):
    """``(dq, dk, dv)`` in q's dtype from the saved ``o`` and ``lse`` and
    the cotangent ``do`` of ``o``: ``p = exp(s - lse)``, ``dv = p^T dO``,
    ``dP = dO v^T``, ``D = rowsum(dO * o)``, ``ds = p (dP - D) scale``,
    ``dq = ds k``, ``dk = ds^T q``."""
    B, H, T, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    dt = q.dtype
    do = do.to(dt)
    s = _scores(q, k, lengths, scale)
    p = torch.exp(s - lse.reshape(B, H, T, 1))
    dv = p.to(dt).float().transpose(-1, -2) @ do.float()
    dp = do.float() @ v.float().transpose(-1, -2)
    delta = (do.float() * o.float()).sum(dim=-1, keepdim=True)
    ds = (p * (dp - delta) * scale).to(dt).float()
    dq = ds @ k.float()
    dk = ds.transpose(-1, -2) @ q.float()
    return dq.to(dt), dk.to(dt), dv.to(dt)


def _lib():
    lib = _build.library("attention")
    if not getattr(lib, "_typed", False):
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.attn_forward.argtypes = [P, P, P, P, P, P, P, I, I, I, I, F, I,
                                     I, P]
        lib.attn_forward.restype = I
        lib.attn_backward.argtypes = [P] * 12 + [I, I, I, I, F, I, I, P]
        lib.attn_backward.restype = I
        lib.attn_max_head_dim.argtypes = []
        lib.attn_max_head_dim.restype = I
        lib._typed = True
    return lib


def _strided(t):
    """``t`` if the kernels can read it in place, else a contiguous copy."""
    if (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s % 8 == 0 for s in t.stride()[:-1])):
        return t
    return t.contiguous()


def _strides(*tensors):
    vals = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _checked(q, k, v, lengths, what):
    """Validate what both kernels take; returns ``(lib, lengths)``."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{what} takes q, k, v of one (B, H, T, d) shape, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{what} takes fp32 or bf16 q, k, v of one dtype, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (k.is_cuda and v.is_cuda):
        raise ValueError(f"{what}: q is on {q.device}, k on {k.device}, v on "
                         f"{v.device}")
    B, H, T, d = q.shape
    lib = _lib()
    if d > lib.attn_max_head_dim() or d % 8 or B * H > 65535 or T < 1:
        raise ValueError(
            f"{what}: head dim {d} (at most {lib.attn_max_head_dim()}, a "
            f"multiple of 8), B*H = {B * H} (at most 65535), T = {T}")
    if lengths is not None:
        if lengths.shape != (B,):
            raise ValueError(f"lengths must be ({B},), got "
                             f"{tuple(lengths.shape)}")
        lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    return lib, lengths


def _forward(q, k, v, lengths, scale):
    """``(o, lse)`` without autograd: plain on the CPU, the kernel on CUDA."""
    if not q.is_cuda:
        return attention_plain(q, k, v, lengths, scale)
    with spans.span("op.attn_fwd"):
        lib, lengths = _checked(q, k, v, lengths, "fused_attention")
        B, H, T, d = q.shape
        q, k, v = (_strided(t.detach()) for t in (q, k, v))
        o = torch.empty_like(q)
        lse = torch.empty((B * H, T), dtype=torch.float32, device=q.device)
        code = lib.attn_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(),
            lengths.data_ptr() if lengths is not None else None,
            _strides(q, k, v, o), B, H, T, d, float(scale),
            int(q.dtype == torch.bfloat16), q.device.index or 0,
            _build.stream_of(q))
        _build.check(code, lib, "attn_error_string", "fused_attention")
        fused_attention.launches += 1
        return o, lse


def fused_attention_backward(q, k, v, o, lse, do, lengths=None, *,
                             scale=None):
    """``(dq, dk, dv)`` of :func:`fused_attention` for the cotangent ``do``
    of its output (any strides), from the saved ``o`` and ``lse``. CPU
    tensors take :func:`attention_backward_plain`; CUDA tensors the
    kernels."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if not q.is_cuda:
        return attention_backward_plain(q, k, v, o, lse, do, lengths, scale)
    with spans.span("op.attn_bwd"):
        lib, lengths = _checked(q, k, v, lengths, "fused_attention_backward")
        B, H, T, d = q.shape
        if o.shape != q.shape or do.shape != q.shape or not do.is_cuda \
                or lse.shape != (B * H, T):
            raise ValueError(
                f"o {tuple(o.shape)}, cotangent {tuple(do.shape)} on "
                f"{do.device} or lse {tuple(lse.shape)} do not match q "
                f"{tuple(q.shape)}")
        q, k, v, o, do = (_strided(t.detach().to(q.dtype))
                          for t in (q, k, v, o, do))
        lse = lse.detach().float().contiguous()
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        delta = torch.empty_like(lse)
        code = lib.attn_backward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(),
            lengths.data_ptr() if lengths is not None else None,
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
            _strides(q, k, v, o, do, dq, dk, dv), B, H, T, d, float(scale),
            int(q.dtype == torch.bfloat16), q.device.index or 0,
            _build.stream_of(q))
        _build.check(code, lib, "attn_error_string",
                     "fused_attention_backward")
        fused_attention_backward.launches += 1
        return dq, dk, dv


fused_attention_backward.launches = 0


class _Attention(torch.autograd.Function):
    """Forward and backward of the masked attention on either device."""

    @staticmethod
    def forward(ctx, q, k, v, lengths, scale):
        o, lse = _forward(q, k, v, lengths, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.lengths = lengths
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = fused_attention_backward(
            q, k, v, o, lse, do, ctx.lengths, scale=ctx.scale)
        return dq, dk, dv, None, None


def fused_attention(q, k, v, lengths=None, *, scale=None):
    """``softmax((q k^T) * scale + mask) v`` for (B, H, T, d) q, k, v (fp32
    or bf16) and optional int ``lengths`` (B,) of valid keys; differentiable
    in q, k and v.

    CPU tensors take the plain versions; CUDA tensors the kernels.
    """
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _Attention.apply(q, k, v, lengths, float(scale))


fused_attention.launches = 0
