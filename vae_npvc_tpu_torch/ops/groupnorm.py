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
- :func:`fused_group_norm` is the differentiable wrapper around the
  operator ``vae_npvc_torch::group_norm`` (``torch.library``): its CPU
  implementation is the plain version, its CUDA implementation launches the
  forward kernel of ``csrc/groupnorm.cu`` or raises, and a fake
  implementation gives ``torch.export`` the output's shape and memory order
  (x's, as the kernel writes it), so an exported graph holds the operator
  and launches the kernel on the card. Its autograd formula
  (``register_autograd``) is the backward kernel on a CUDA tensor and
  :func:`group_norm_backward_plain` on a CPU one; it saves x, scale, bias
  and lengths, not the output: the backward recomputes the statistics.
  Inference and training take the one operator.
  ``fused_group_norm.launches`` counts forward launches,
  ``fused_group_norm_backward.launches`` backward launches. With the span
  recorder on (``utils/spans.py``) each CUDA call is an ``op.gn_fwd`` or
  ``op.gn_bwd`` span (``op.gn_split_stats``, ``op.gn_split_apply`` for the
  split pair below).

Split statistics (sequence-parallel inference, where a row's frames lie
on several ranks): :func:`group_norm_split_stats` gives this rank's
per-(row, group) count, mean and centred sum of squares, and
:func:`group_norm_split_apply` normalizes with every rank's of them merged
in rank order by Chan's formula, never as E[x^2] - mean^2. On a CUDA
tensor each launches its one kernel of ``csrc/groupnorm.cu``
(``gn_split_stats``, ``gn_split_apply``) or raises;
``group_norm_split_stats.launches`` and ``group_norm_split_apply.launches``
count them. The statistics kernel picks the block that merges a (row,
group) by an atomic ticket; its counters live in one zeroed int32 buffer
per (device, stream) (:func:`_tickets`), which every launch leaves at 0.
Gathering the partials over the ranks is the parallel layer's
(``parallel/halo.psum_group_norm``). Forward only: the split path serves
inference.

The backward follows ``_bwd_kernel``: it rebuilds ``y = xhat*scale + bias``
in fp32 and does not round it to the compute dtype before the GLU's
derivative, so in bf16 it differs from autograd through
:func:`group_norm_plain` by that rounding; in fp32 the two agree.

x and the cotangent are read in place in either layout the convolutions
hand over (T or C the unit stride), and the output and ``dx`` come back in
x's memory order, on the CPU as on the card. On the H100 both kernels are
bound by bytes; the source note in ``csrc/groupnorm.cu`` says how a
thread-block cluster holds a row on chip (one pass over device memory) and
how rows too long for it stream in chunks (:func:`plan` says which a shape
takes).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..utils import spans
from . import _build


def _valid_mask(x, lengths):
    """(B, T, 1, 1) fp32: 1 at the frames ``t < lengths[b]`` (all without
    lengths)."""
    B, T, _ = x.shape
    if lengths is None:
        return torch.ones((B, T, 1, 1), dtype=torch.float32, device=x.device)
    t = torch.arange(T, device=x.device)
    return (t[None, :] < lengths.to(x.device)[:, None]).float()[:, :, None,
                                                                None]


def group_norm_plain(x, scale, bias, num_groups, eps=1e-5, lengths=None,
                     glu=False):
    """Torch-semantics GroupNorm of (B, T, C): fp32 two-pass moments over
    (valid T, C/G) per group, var clamped at 0, affine, cast to ``x.dtype``,
    mask, then ``tanh(y[..., :C/2]) * sigmoid(y[..., C/2:])`` with ``glu``.
    """
    B, T, C = x.shape
    G = num_groups
    xf = x.float().reshape(B, T, G, C // G)
    m = _valid_mask(x, lengths)
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
    dtype and memory order, the parameter gradients are fp32.
    """
    B, T, C = x.shape
    G = num_groups
    Cg = C // G
    xf = x.float().reshape(B, T, G, Cg)
    m = _valid_mask(x, lengths)
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
    return torch.empty_like(x).copy_(dx), dscale, dbias


def _lib():
    lib = _build.library("groupnorm")
    if not getattr(lib, "_typed", False):
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.gn_forward.argtypes = [P, P, P, P, P, P, P, P, I, I, I, I, I, I,
                                   F, I, P]
        lib.gn_forward.restype = I
        lib.gn_backward.argtypes = [P, P, P, P, P, P, P, P, P, P, P, P, I, I,
                                    I, I, I, I, F, I, P]
        lib.gn_backward.restype = I
        lib.gn_scratch_floats.argtypes = [I, I, I, I, I, I, I, I]
        lib.gn_scratch_floats.restype = ctypes.c_longlong
        lib.gn_plan.argtypes = [I, I, I, I, I, I, I]
        lib.gn_plan.restype = I
        lib.gn_max_groups.restype = I
        lib.gn_split_scratch_floats.argtypes = [I, I, I, I, I, I]
        lib.gn_split_scratch_floats.restype = ctypes.c_longlong
        lib.gn_split_stats.argtypes = [P, P, P, P, P, P, I, I, I, I, I, I,
                                       P]
        lib.gn_split_stats.restype = I
        lib.gn_split_apply.argtypes = [P, P, P, P, P, P, I, P, P, I, I, I,
                                       I, I, I, F, I, P]
        lib.gn_split_apply.restype = I
        lib._typed = True
    return lib


def _unit_stride(t):
    """Whether T or C is the unit stride of a (B, T, C) view (a size-1
    axis counts as either): the views the kernels read in place."""
    B, T, C = t.shape
    sb, st, sc = t.stride()
    return sc == 1 or C == 1 or st == 1 or T == 1


def _strides(t, what):
    """``(sb, st, sc)`` of a (B, T, C) view with T or C as the unit stride
    (a size-1 axis counts as either), as a ctypes array the kernels read
    in place; channels-last wins when both hold. Raises on any other
    pattern."""
    if not _unit_stride(t):
        raise ValueError(f"{what}: strides {t.stride()} of {tuple(t.shape)} "
                         "have neither T nor C as the unit stride")
    B, T, C = t.shape
    sb, st, sc = t.stride()
    if sc == 1 or C == 1:
        sc = 1
    else:
        st = 1
    return (ctypes.c_longlong * 3)(sb, st, sc)


def _like_x(x, channels):
    """An empty (B, T, channels) tensor in ``x``'s memory order."""
    B, T, C = x.shape
    if x.stride(2) == 1 or C == 1:
        return torch.empty((B, T, channels), dtype=x.dtype, device=x.device)
    return torch.empty((B, channels, T), dtype=x.dtype,
                       device=x.device).transpose(1, 2)


def _checked(x, scale, bias, G, lengths, glu, what):
    """Validate what both kernels take; returns ``(lib, scale, bias,
    lengths)`` with the parameters as fp32 and lengths as int32 on x's
    device. x itself is read in place."""
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
    return lib, scale, bias, lengths


def _scratch(lib, x, G, glu, backward, what):
    B, T, C = x.shape
    n = lib.gn_scratch_floats(B, T, C, G, int(bool(glu)),
                              int(x.dtype == torch.bfloat16), int(backward),
                              x.device.index or 0)
    if n < 0:
        raise ValueError(f"{what}: a row of {C} channels is too wide for "
                         "the kernel's shared memory")
    return torch.empty((n,), dtype=torch.float32, device=x.device)


def plan(x, glu=False, backward=False):
    """The launch a CUDA ``x`` of this shape takes: 8 or 16 (one thread-block
    cluster of that many blocks holds each batch row), 0 (streaming chunks)
    or -1 (too wide)."""
    B, T, C = x.shape
    return _lib().gn_plan(B, T, C, int(bool(glu)),
                          int(x.dtype == torch.bfloat16), int(backward),
                          x.device.index or 0)


def _forward(x, scale, bias, num_groups, eps, lengths, glu):
    """The forward kernel's launch for a CUDA ``x`` (the operator's CUDA
    implementation)."""
    B, T, C = x.shape
    G = int(num_groups)
    lib, scale, bias, lengths = _checked(x, scale, bias, G, lengths, glu,
                                         "fused_group_norm")
    x = x.detach()
    out = _like_x(x, C // 2 if glu else C)
    scratch = _scratch(lib, x, G, glu, False, "fused_group_norm")
    code = lib.gn_forward(
        x.data_ptr(), _strides(x, "fused_group_norm"), scale.data_ptr(),
        bias.data_ptr(), lengths.data_ptr() if lengths is not None else None,
        out.data_ptr(), _strides(out, "fused_group_norm"), scratch.data_ptr(),
        B, T, C, G, int(bool(glu)), int(x.dtype == torch.bfloat16),
        float(eps), x.device.index or 0, _build.stream_of(x))
    _build.check(code, lib, "gn_error_string", "fused_group_norm")
    fused_group_norm.launches += 1
    return out


def fused_group_norm_backward(x, scale, bias, g, num_groups, eps=1e-5, *,
                              lengths=None, glu=False):
    """``(dx, dscale, dbias)`` of GroupNorm(+GLU) for the output cotangent
    ``g`` (``x``'s dtype; T or C the unit stride of each of x and g). dx
    is in x's memory order. CPU tensors take
    :func:`group_norm_backward_plain`; CUDA tensors the kernel."""
    if not x.is_cuda:
        return group_norm_backward_plain(x, scale, bias, g, num_groups, eps,
                                         lengths, glu)
    with spans.span("op.gn_bwd"):
        B, T, C = x.shape
        G = int(num_groups)
        what = "fused_group_norm_backward"
        lib, scale, bias, lengths = _checked(x, scale, bias, G, lengths, glu,
                                             what)
        if g.shape != (B, T, C // 2 if glu else C) or not g.is_cuda:
            raise ValueError(f"cotangent of shape {tuple(g.shape)} on "
                             f"{g.device} does not match x {tuple(x.shape)} "
                             f"glu={glu}")
        x, g = x.detach(), g.detach().to(x.dtype)
        dx = _like_x(x, C)
        dscale = torch.empty((C,), dtype=torch.float32, device=x.device)
        dbias = torch.empty((C,), dtype=torch.float32, device=x.device)
        scratch = _scratch(lib, x, G, glu, True, what)
        code = lib.gn_backward(
            x.data_ptr(), _strides(x, what), scale.data_ptr(), bias.data_ptr(),
            g.data_ptr(), _strides(g, what),
            lengths.data_ptr() if lengths is not None else None,
            dx.data_ptr(), _strides(dx, what), dscale.data_ptr(),
            dbias.data_ptr(), scratch.data_ptr(), B, T, C, G, int(bool(glu)),
            int(x.dtype == torch.bfloat16), float(eps), x.device.index or 0,
            _build.stream_of(x))
        _build.check(code, lib, "gn_error_string", what)
        fused_group_norm_backward.launches += 1
        return dx, dscale, dbias


fused_group_norm_backward.launches = 0


@torch.library.custom_op("vae_npvc_torch::group_norm", mutates_args=(),
                         device_types="cpu")
def _group_norm_op(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   lengths: Optional[torch.Tensor], num_groups: int,
                   eps: float, glu: bool) -> torch.Tensor:
    return group_norm_plain(x, scale, bias, num_groups, eps, lengths, glu)


@_group_norm_op.register_kernel("cuda")
def _group_norm_cuda(x, scale, bias, lengths, num_groups, eps, glu):
    with spans.span("op.gn_fwd"):
        return _forward(x, scale, bias, num_groups, eps, lengths, glu)


@_group_norm_op.register_fake
def _group_norm_fake(x, scale, bias, lengths, num_groups, eps, glu):
    return _like_x(x, x.shape[2] // 2 if glu else x.shape[2])


def _setup_context(ctx, inputs, output):
    x, scale, bias, lengths, num_groups, eps, glu = inputs
    ctx.save_for_backward(x, scale, bias)
    ctx.lengths = lengths
    ctx.args = (num_groups, eps, glu)


def _backward(ctx, g):
    x, scale, bias = ctx.saved_tensors
    num_groups, eps, glu = ctx.args
    if g.is_cuda and not _unit_stride(g):
        # autograd may hand over any strides (a stride-0 expansion from
        # .sum()); the kernel reads only T or C as the unit stride
        g = g.contiguous()
    dx, dscale, dbias = fused_group_norm_backward(
        x, scale, bias, g, num_groups, eps, lengths=ctx.lengths, glu=glu)
    return (dx, dscale.to(scale.dtype), dbias.to(bias.dtype), None, None,
            None, None)


_group_norm_op.register_autograd(_backward, setup_context=_setup_context)


def fused_group_norm(x, scale, bias, num_groups, eps=1e-5, *, lengths=None,
                     glu=False):
    """GroupNorm(+GLU) of (B, T, C) ``x`` (fp32 or bf16) with fp32 ``scale``
    and ``bias`` (C,) and optional int ``lengths`` (B,), differentiable in
    ``x``, ``scale`` and ``bias``, through ``vae_npvc_torch::group_norm``.

    CPU tensors take the plain versions; CUDA tensors the kernels.
    """
    return torch.ops.vae_npvc_torch.group_norm(
        x, scale, bias, lengths, int(num_groups), float(eps), bool(glu))


fused_group_norm.launches = 0


# ------------------------------------------------------- split statistics
def group_norm_split_stats_plain(x, num_groups, lengths=None, mask=None):
    """(B, G, 3) fp32: per (row, group) the count of valid elements, their
    mean (0 with none) and their centred sum of squares, two-pass. A
    (B, T, 1) {0, 1} ``mask`` of the frames that enter may stand in for
    ``lengths`` (no kernel takes one)."""
    B, T, C = x.shape
    G = num_groups
    xf = x.float().reshape(B, T, G, C // G)
    m = (_valid_mask(x, lengths) if mask is None
         else mask.float()[:, :, :, None])
    n = m.sum(dim=1, keepdim=True) * (C // G)
    mean = (xf * m).sum(dim=(1, 3), keepdim=True) / torch.clamp(n, min=1.0)
    m2 = ((xf - mean).square() * m).sum(dim=(1, 3), keepdim=True)
    return torch.stack([n.expand_as(mean), mean, m2], dim=-1).reshape(B, G, 3)


def chan_merge_plain(part):
    """Merge the (B, G, R, 3) triples over R in order (Chan's formula):
    ``(n, mean, m2)``, each (B, G)."""
    n = torch.zeros(part.shape[:2], dtype=torch.float32, device=part.device)
    mean, m2 = torch.zeros_like(n), torch.zeros_like(n)
    for k in range(part.shape[2]):
        nb, mb, qb = part[:, :, k, 0], part[:, :, k, 1], part[:, :, k, 2]
        nt = n + nb
        w = torch.where(nb > 0, nb / torch.clamp(nt, min=1.0),
                        torch.zeros_like(nb))
        delta = mb - mean
        cross = torch.where(nb > 0, n * nb / torch.clamp(nt, min=1.0),
                            torch.zeros_like(nb))
        mean = mean + delta * w
        m2 = m2 + torch.where(nb > 0, qb, torch.zeros_like(qb)) \
            + delta * delta * cross
        n = nt
    return n, mean, m2


def group_norm_split_apply_plain(x, scale, bias, part, num_groups, eps=1e-5,
                                 lengths=None, glu=False):
    """GroupNorm of the local ``x`` with the gathered partials ``part``
    (B, G, R, 3) merged in rank order; the affine, cast, mask and GLU of
    :func:`group_norm_plain`."""
    B, T, C = x.shape
    G = num_groups
    n, mean, m2 = chan_merge_plain(part.float())
    rstd = torch.rsqrt(torch.clamp(m2 / torch.clamp(n, min=1.0), min=0.0)
                       + eps)
    xf = x.float().reshape(B, T, G, C // G)
    xn = ((xf - mean[:, None, :, None]) * rstd[:, None, :, None]) \
        .reshape(B, T, C)
    out = (xn * scale.float() + bias.float()).to(x.dtype)
    if lengths is not None:
        out = out * _valid_mask(x, lengths)[:, :, :, 0].to(out.dtype)
    if glu:
        H = C // 2
        out = torch.tanh(out[..., :H]) * torch.sigmoid(out[..., H:])
    return out


def _split_checked(x, G, what):
    if x.requires_grad and torch.is_grad_enabled():
        raise ValueError(f"{what} is forward only (inference); call it "
                         "under torch.no_grad()")
    return x.detach()


# the split statistics' ticket counters by (device index, stream): zeroed
# once, left at 0 by every launch; a buffer is never shared by two streams
_ticket_bufs: dict = {}
_TICKETS_MIN = 4096


def _tickets(device, stream, n):
    """At least ``n`` zeroed int32 counters for launches on ``stream`` of
    ``device``: allocated (and zeroed, one fill kernel) on first use and
    when a launch needs more, reused by every later launch there."""
    key = (device.index or 0, stream)
    buf = _ticket_bufs.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros((max(n, _TICKETS_MIN),), dtype=torch.int32,
                          device=device)
        _ticket_bufs[key] = buf
    return buf


def group_norm_split_stats(x, num_groups, lengths=None):
    """This rank's (B, G, 3) partial statistics of ``x`` (fp32 or bf16,
    T or C the unit stride). CPU tensors take the plain version, CUDA
    tensors the ``gn_split_stats`` kernel."""
    if not x.is_cuda:
        return group_norm_split_stats_plain(x, num_groups, lengths)
    with spans.span("op.gn_split_stats"):
        B, T, C = x.shape
        G = int(num_groups)
        what = "group_norm_split_stats"
        # no parameters: _checked validates empty stand-ins (no launch)
        dummy = torch.empty((C,), dtype=torch.float32, device=x.device)
        lib, _, _, lengths = _checked(x, dummy, dummy, G, lengths, False, what)
        x = _split_checked(x, G, what)
        n = lib.gn_split_scratch_floats(B, T, C, G,
                                        int(x.dtype == torch.bfloat16),
                                        x.device.index or 0)
        if n < 0:
            raise ValueError(f"{what}: a row of {T} x {C} elements is too "
                             "long")
        stream = _build.stream_of(x)
        scratch = torch.empty((n,), dtype=torch.float32, device=x.device)
        tickets = _tickets(x.device, stream, B * G)
        part = torch.empty((B, G, 3), dtype=torch.float32, device=x.device)
        code = lib.gn_split_stats(
            x.data_ptr(), _strides(x, what),
            lengths.data_ptr() if lengths is not None else None,
            part.data_ptr(), scratch.data_ptr(), tickets.data_ptr(), B, T, C,
            G, int(x.dtype == torch.bfloat16), x.device.index or 0, stream)
        _build.check(code, lib, "gn_error_string", what)
        group_norm_split_stats.launches += 1
        return part


group_norm_split_stats.launches = 0


def group_norm_split_apply(x, scale, bias, part, num_groups, eps=1e-5,
                           lengths=None, glu=False):
    """GroupNorm(+GLU) of the local ``x`` with the gathered partials
    ``part`` (B, G, R, 3) of R ranks, merged in rank order. CPU tensors
    take the plain version, CUDA tensors the ``gn_split_apply`` kernel."""
    if not x.is_cuda:
        return group_norm_split_apply_plain(x, scale, bias, part, num_groups,
                                            eps, lengths, glu)
    with spans.span("op.gn_split_apply"):
        B, T, C = x.shape
        G = int(num_groups)
        what = "group_norm_split_apply"
        lib, scale, bias, lengths = _checked(x, scale, bias, G, lengths, glu,
                                             what)
        x = _split_checked(x, G, what)
        if part.shape[:2] != (B, G) or part.shape[3] != 3 or not part.is_cuda:
            raise ValueError(f"{what}: partials of shape "
                             f"{tuple(part.shape)} on {part.device}, expected "
                             f"({B}, {G}, R, 3) on the card")
        part = part.to(torch.float32).contiguous()
        out = _like_x(x, C // 2 if glu else C)
        code = lib.gn_split_apply(
            x.data_ptr(), _strides(x, what), scale.data_ptr(), bias.data_ptr(),
            lengths.data_ptr() if lengths is not None else None,
            part.data_ptr(), int(part.shape[2]), out.data_ptr(),
            _strides(out, what), B, T, C, G, int(bool(glu)),
            int(x.dtype == torch.bfloat16), float(eps), x.device.index or 0,
            _build.stream_of(x))
        _build.check(code, lib, "gn_error_string", what)
        group_norm_split_apply.launches += 1
        return out


group_norm_split_apply.launches = 0

