"""GroupNorm (+ optional tanh*sigmoid GLU) with masked statistics: forward
and analytic backward.

Replaces the TPU kernels of ``vae_npvc_tpu/ops/groupnorm_pallas.py``
``fused_group_norm`` (forward ``_call_fwd`` / ``_fwd_kernel``, backward
``_call_bwd`` / ``_bwd_kernel``) and covers the masked path of
``vae_npvc_tpu/nn/blocks.py`` ``group_norm``: with ``lengths`` only frames
``t < lengths[b]`` enter the moments, and the output (and ``dx``) is zero
beyond them.

- :func:`group_norm_plain` and :func:`group_norm_backward_plain` are the
  plain PyTorch versions (the CPU path and the kernels' oracles).
- :func:`fused_group_norm` is the differentiable wrapper: one
  ``torch.autograd.Function`` whose forward and backward take the plain
  versions for a CPU tensor and launch the kernels of ``csrc/groupnorm.cu``
  for a CUDA tensor, or raise. It saves x, scale, bias and lengths, not the
  output: the backward recomputes the statistics.
  ``fused_group_norm.launches`` counts forward launches,
  ``fused_group_norm_backward.launches`` backward launches.

The backward follows ``_bwd_kernel``: it rebuilds ``y = xhat*scale + bias``
in fp32 and does not round it to the compute dtype before the GLU's
derivative, so in bf16 it differs from autograd through
:func:`group_norm_plain` by that rounding; in fp32 the two agree.

On the H100 both kernels are bound by bytes; the source note in
``csrc/groupnorm.cu`` says how the time-chunked passes split a row that
does not fit one block.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build


def group_norm_plain(x, scale, bias, num_groups, eps=1e-5, lengths=None,
                     glu=False):
    """Torch-semantics GroupNorm of (B, T, C): fp32 two-pass moments over
    (valid T, C/G) per group, var clamped at 0, affine, cast to ``x.dtype``,
    mask, then ``tanh(y[..., :C/2]) * sigmoid(y[..., C/2:])`` with ``glu``.
    """
    B, T, C = x.shape
    G = num_groups
    xf = x.float().reshape(B, T, G, C // G)
    if lengths is None:
        m = torch.ones((B, T, 1, 1), dtype=torch.float32, device=x.device)
    else:
        t = torch.arange(T, device=x.device)
        m = (t[None, :] < lengths.to(x.device)[:, None]).float()[:, :, None,
                                                                  None]
    count = torch.clamp(m.sum(dim=1, keepdim=True) * (C // G), min=1.0)
    mean = (xf * m).sum(dim=(1, 3), keepdim=True) / count
    sq = ((xf - mean).square() * m).sum(dim=(1, 3), keepdim=True)
    var = torch.clamp(sq / count, min=0.0)
    xn = ((xf - mean) * torch.rsqrt(var + eps)).reshape(B, T, C)
    out = (xn * scale.float() + bias.float()).to(x.dtype)
    if lengths is not None:
        out = out * m[:, :, :, 0].to(out.dtype)
    if glu:
        H = C // 2
        out = torch.tanh(out[..., :H]) * torch.sigmoid(out[..., H:])
    return out


def group_norm_backward_plain(x, scale, bias, g, num_groups, eps=1e-5,
                              lengths=None, glu=False):
    """Analytic backward of :func:`group_norm_plain` in fp32:
    ``(dx, dscale, dbias)`` for the cotangent ``g`` of the output.

    ``dy`` is ``g``, or with ``glu`` ``[g*sig*(1 - tanh^2),
    g*tanh*sig*(1 - sig)]`` of the unrounded ``y``; ``dscale = sum dy*xhat``,
    ``dbias = sum dy``; ``dx = (dxhat - mean(dxhat) - xhat*mean(dxhat*xhat))
    * rstd`` per (row, group) with ``dxhat = dy*scale``. Sums and means run
    over the valid frames; ``dx`` is zero beyond them. ``dx`` has ``x``'s
    dtype, the parameter gradients are fp32.
    """
    B, T, C = x.shape
    G = num_groups
    Cg = C // G
    xf = x.float().reshape(B, T, G, Cg)
    if lengths is None:
        m = torch.ones((B, T, 1, 1), dtype=torch.float32, device=x.device)
    else:
        t = torch.arange(T, device=x.device)
        m = (t[None, :] < lengths.to(x.device)[:, None]).float()[:, :, None,
                                                                  None]
    count = torch.clamp(m.sum(dim=1, keepdim=True) * Cg, min=1.0)
    mean = (xf * m).sum(dim=(1, 3), keepdim=True) / count
    sq = ((xf - mean).square() * m).sum(dim=(1, 3), keepdim=True)
    rstd = torch.rsqrt(torch.clamp(sq / count, min=0.0) + eps)
    xn4 = (xf - mean) * rstd
    xn = xn4.reshape(B, T, C)
    scale, bias, gf = scale.float(), bias.float(), g.float()
    if glu:
        H = C // 2
        y = xn * scale + bias
        ta, sb = torch.tanh(y[..., :H]), torch.sigmoid(y[..., H:])
        dy = torch.cat([gf * sb * (1.0 - ta.square()),
                        gf * ta * sb * (1.0 - sb)], dim=-1)
    else:
        dy = gf
    dy = dy * m[:, :, :, 0]
    dscale = (dy * xn).sum(dim=(0, 1))
    dbias = dy.sum(dim=(0, 1))
    dxn = (dy * scale).reshape(B, T, G, Cg)
    m1 = dxn.sum(dim=(1, 3), keepdim=True) / count
    m2 = (dxn * xn4).sum(dim=(1, 3), keepdim=True) / count
    dx = ((dxn - m1 - xn4 * m2) * rstd * m).reshape(B, T, C).to(x.dtype)
    return dx, dscale, dbias


def _lib():
    lib = _build.library("groupnorm")
    if not getattr(lib, "_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.gn_forward.argtypes = [P, P, P, P, P, P, I, I, I, I, I, I,
                                   ctypes.c_float, I, P]
        lib.gn_forward.restype = I
        lib.gn_scratch_floats.argtypes = [I, I, I]
        lib.gn_scratch_floats.restype = I
        lib.gn_max_groups.restype = I
        lib.gn_backward.argtypes = [P, P, P, P, P, P, P, P, P, I, I, I, I, I,
                                    I, ctypes.c_float, I, P]
        lib.gn_backward.restype = I
        lib.gn_bwd_scratch_floats.argtypes = [I, I, I, I]
        lib.gn_bwd_scratch_floats.restype = ctypes.c_longlong
        lib._typed = True
    return lib


def _checked(x, scale, bias, G, lengths, glu, what):
    """Validate and make contiguous what both kernels take; returns
    ``(lib, x, scale, bias, lengths)``."""
    B, T, C = x.shape
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what} takes fp32 or bf16, got {x.dtype}")
    if C % G or (glu and C % 2):
        raise ValueError(f"C={C} must divide into {G} groups"
                         + (" and two GLU halves" if glu else ""))
    if scale.shape != (C,) or bias.shape != (C,):
        raise ValueError(f"scale/bias must be ({C},)")
    lib = _lib()
    if G > lib.gn_max_groups():
        raise ValueError(f"at most {lib.gn_max_groups()} groups, got {G}")
    scale = scale.detach().to(device=x.device, dtype=torch.float32) \
        .contiguous()
    bias = bias.detach().to(device=x.device, dtype=torch.float32) \
        .contiguous()
    if lengths is not None:
        if lengths.shape != (B,):
            raise ValueError(f"lengths must be ({B},), got {lengths.shape}")
        lengths = lengths.to(device=x.device, dtype=torch.int32).contiguous()
    return lib, x.detach().contiguous(), scale, bias, lengths


def _forward(x, scale, bias, num_groups, eps, lengths, glu):
    """The forward without autograd: plain on the CPU, the kernel on CUDA."""
    if not x.is_cuda:
        return group_norm_plain(x, scale, bias, num_groups, eps, lengths, glu)
    B, T, C = x.shape
    G = int(num_groups)
    lib, x, scale, bias, lengths = _checked(x, scale, bias, G, lengths, glu,
                                            "fused_group_norm")
    out = torch.empty((B, T, C // 2 if glu else C), dtype=x.dtype,
                      device=x.device)
    part = torch.empty((lib.gn_scratch_floats(B, T, G),), dtype=torch.float32,
                       device=x.device)
    code = lib.gn_forward(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        lengths.data_ptr() if lengths is not None else None,
        out.data_ptr(), part.data_ptr(), B, T, C, G, int(bool(glu)),
        int(x.dtype == torch.bfloat16), float(eps), x.device.index or 0,
        _build.stream_of(x))
    _build.check(code, lib, "gn_error_string", "fused_group_norm")
    fused_group_norm.launches += 1
    return out


def fused_group_norm_backward(x, scale, bias, g, num_groups, eps=1e-5, *,
                              lengths=None, glu=False):
    """``(dx, dscale, dbias)`` of GroupNorm(+GLU) for the output cotangent
    ``g`` (``x``'s dtype; any strides). CPU tensors take
    :func:`group_norm_backward_plain`; CUDA tensors the kernel."""
    if not x.is_cuda:
        return group_norm_backward_plain(x, scale, bias, g, num_groups, eps,
                                         lengths, glu)
    B, T, C = x.shape
    G = int(num_groups)
    lib, x, scale, bias, lengths = _checked(x, scale, bias, G, lengths, glu,
                                            "fused_group_norm_backward")
    if g.shape != (B, T, C // 2 if glu else C) or not g.is_cuda:
        raise ValueError(f"cotangent of shape {tuple(g.shape)} on {g.device} "
                         f"does not match x {tuple(x.shape)} glu={glu}")
    g = g.detach().to(x.dtype).contiguous()
    dx = torch.empty_like(x)
    dscale = torch.empty((C,), dtype=torch.float32, device=x.device)
    dbias = torch.empty((C,), dtype=torch.float32, device=x.device)
    scratch = torch.empty((lib.gn_bwd_scratch_floats(B, T, C, G),),
                          dtype=torch.float32, device=x.device)
    code = lib.gn_backward(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), g.data_ptr(),
        lengths.data_ptr() if lengths is not None else None,
        dx.data_ptr(), dscale.data_ptr(), dbias.data_ptr(),
        scratch.data_ptr(), B, T, C, G, int(bool(glu)),
        int(x.dtype == torch.bfloat16), float(eps), x.device.index or 0,
        _build.stream_of(x))
    _build.check(code, lib, "gn_error_string", "fused_group_norm_backward")
    fused_group_norm_backward.launches += 1
    return dx, dscale, dbias


fused_group_norm_backward.launches = 0


class _GroupNorm(torch.autograd.Function):
    """Forward and backward of GroupNorm(+GLU) on either device."""

    @staticmethod
    def forward(ctx, x, scale, bias, lengths, num_groups, eps, glu):
        ctx.save_for_backward(x, scale, bias)
        ctx.lengths = lengths
        ctx.args = (num_groups, eps, glu)
        return _forward(x, scale, bias, num_groups, eps, lengths, glu)

    @staticmethod
    def backward(ctx, g):
        x, scale, bias = ctx.saved_tensors
        num_groups, eps, glu = ctx.args
        dx, dscale, dbias = fused_group_norm_backward(
            x, scale, bias, g, num_groups, eps, lengths=ctx.lengths, glu=glu)
        return (dx, dscale.to(scale.dtype), dbias.to(bias.dtype), None, None,
                None, None)


def fused_group_norm(x, scale, bias, num_groups, eps=1e-5, *, lengths=None,
                     glu=False):
    """GroupNorm(+GLU) of (B, T, C) ``x`` (fp32 or bf16) with fp32 ``scale``
    and ``bias`` (C,) and optional int ``lengths`` (B,), differentiable in
    ``x``, ``scale`` and ``bias``.

    CPU tensors take the plain versions; CUDA tensors the kernels.
    """
    return _GroupNorm.apply(x, scale, bias, lengths, num_groups, eps, glu)


fused_group_norm.launches = 0
