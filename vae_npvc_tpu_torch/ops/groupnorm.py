"""GroupNorm (+ optional tanh*sigmoid GLU) forward with masked statistics.

Replaces the TPU kernel ``vae_npvc_tpu/ops/groupnorm_pallas.py``
``fused_group_norm`` (forward, ``_call_fwd`` / ``_fwd_kernel``) and covers
the masked path of ``vae_npvc_tpu/nn/blocks.py`` ``group_norm``: with
``lengths`` only frames ``t < lengths[b]`` enter the moments, and the
output is zero beyond them.

- :func:`group_norm_plain` is the plain PyTorch version (the CPU path and
  the kernel's oracle).
- :func:`fused_group_norm` is the wrapper: a CPU tensor takes the plain
  version; a CUDA tensor launches the kernel of ``csrc/groupnorm.cu`` or
  raises. ``fused_group_norm.launches`` counts kernel launches.

On the H100 the kernel is bound by bytes (one read of x, one write of the
output); the source note in ``csrc/groupnorm.cu`` says how its time-chunked
design splits a row that does not fit one block.
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
        lib._typed = True
    return lib


def fused_group_norm(x, scale, bias, num_groups, eps=1e-5, *, lengths=None,
                     glu=False):
    """GroupNorm(+GLU) of (B, T, C) ``x`` (fp32 or bf16) with fp32 ``scale``
    and ``bias`` (C,) and optional int ``lengths`` (B,).

    CPU tensors take :func:`group_norm_plain`; CUDA tensors the kernel.
    """
    if not x.is_cuda:
        return group_norm_plain(x, scale, bias, num_groups, eps, lengths, glu)
    B, T, C = x.shape
    G = int(num_groups)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_group_norm takes fp32 or bf16, got {x.dtype}")
    if C % G or (glu and C % 2):
        raise ValueError(f"C={C} must divide into {G} groups"
                         + (" and two GLU halves" if glu else ""))
    if scale.shape != (C,) or bias.shape != (C,):
        raise ValueError(f"scale/bias must be ({C},)")
    lib = _lib()
    if G > lib.gn_max_groups():
        raise ValueError(f"at most {lib.gn_max_groups()} groups, got {G}")
    x = x.contiguous()
    scale = scale.to(device=x.device, dtype=torch.float32).contiguous()
    bias = bias.to(device=x.device, dtype=torch.float32).contiguous()
    if lengths is not None:
        if lengths.shape != (B,):
            raise ValueError(f"lengths must be ({B},), got {lengths.shape}")
        lengths = lengths.to(device=x.device, dtype=torch.int32).contiguous()
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


fused_group_norm.launches = 0
