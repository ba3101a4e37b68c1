"""Building blocks, channels-last (B, T, C), as torch ``nn.Module``s.

Counterpart of ``vae_npvc_tpu/nn/blocks.py``. Parameter names and shapes
are the flax ones (``v`` (K, in, out), ``g``, ``b``; ``scale``/``bias``;
``embedding``; ``kernel`` (in, out) for ``Dense``), so a ``state_dict`` maps
one to one onto the JAX variable tree (utils/bridge.py). Convolutions
transpose to PyTorch's (B, C, T) inside and back. ``Dense``, ``Conv``,
``LayerNorm`` and ``Embed`` stand in for the flax modules of those names.

Casts follow the JAX package: weight norm in fp32 as a channel scale, the
conv in the compute dtype, ``(y + b)`` in fp32 then cast to the compute
dtype; GroupNorm statistics in fp32 with the output cast before the mask
and the GLU. The stride-1 "ConvTranspose" layers of the reference are
forward convs with the input-side weight-norm scale (``wn_dim="in"``),
as in the JAX package; the strided upsampling layer is a real transposed
conv (``WNConvTranspose1d``).

``seq_axis`` (sequence-parallel inference, the JAX blocks' argument of that
name) names a bound mesh axis over which the time axis is split: a stride-1
conv with ``k > 1`` pulls its receptive-field halo from the neighbouring
ranks (``parallel/halo.py``) and convolves without padding, and a GroupNorm
takes its statistics over every rank's frames through K2's split entry
points (``parallel/halo.psum_group_norm``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.groupnorm import fused_group_norm
from ..parallel.halo import halo_exchange, psum_group_norm


def length_mask(lengths, T, dtype=torch.float32):
    """(B,) lengths -> (B, T, 1) {0, 1} mask."""
    t = torch.arange(T, device=lengths.device)
    return (t[None, :] < lengths[:, None]).to(dtype)[:, :, None]


def sinusoidal_positions(length, dim, device=None):
    """(length, dim) fixed sinusoidal position table in fp32: sin on the
    even columns, cos on the odd ones."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32,
                                 device=device) * (-math.log(10000.0) / dim))
    angles = pos * div[None, :]
    pe = torch.zeros((length, dim), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(angles)
    pe[:, 1::2] = torch.cos(angles[:, :dim // 2])
    return pe


def group_norm(x, scale, bias, num_groups, eps=1e-5, lengths=None,
               glu=False):
    """Torch-semantics GroupNorm of (B, T, C) with statistics over the valid
    frames ``t < lengths[b]`` and an optional tanh*sigmoid GLU epilogue.

    The JAX function takes a (B, T, 1) mask; the port takes the lengths
    that mask is made from. CPU tensors take the plain version, CUDA
    tensors the kernel (ops/groupnorm.py).
    """
    return fused_group_norm(x, scale, bias, num_groups, eps, lengths=lengths,
                            glu=glu)


class GroupNorm(nn.Module):
    """Affine GroupNorm (optionally masked; ``glu=True`` appends the
    channel-halves tanh*sigmoid gate)."""

    def __init__(self, num_groups, num_channels, eps=1e-5, glu=False,
                 seq_axis=None):
        super().__init__()
        self.num_groups, self.eps, self.glu = num_groups, eps, glu
        self.seq_axis = seq_axis
        self.scale = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def init_(self, gen):
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()

    def forward(self, x, lengths=None):
        if self.seq_axis is not None:
            return psum_group_norm(x, self.scale, self.bias,
                                   self.num_groups, self.seq_axis,
                                   eps=self.eps, lengths=lengths,
                                   glu=self.glu)
        return group_norm(x, self.scale, self.bias, self.num_groups, self.eps,
                          lengths, glu=self.glu)


class WNConv1d(nn.Module):
    """Weight-normalized 1-D conv, (B, T, C) -> (B, T', C').

    ``v`` (K, in, out), ``g`` per output channel (``wn_dim="out"``, torch
    ``Conv1d``) or per input channel (``wn_dim="in"``, torch
    ``ConvTranspose1d``), ``b`` (out,). The weight norm is a channel scale:
    ``conv(x, v) * g/||v||`` on the output side, or ``conv(x * g/||v||, v)``
    on the input side, the same function of (v, g) as ``g*v/||v||``.
    """

    def __init__(self, in_channels, features, kernel_size, stride=1,
                 dilation=1, padding="SAME_TORCH", use_weight_norm=True,
                 wn_dim="out", dtype=torch.float32, seq_axis=None):
        super().__init__()
        if wn_dim not in ("out", "in"):
            raise ValueError(f"wn_dim must be 'out' or 'in', got {wn_dim!r}")
        if seq_axis is not None and kernel_size > 1 and stride != 1:
            raise ValueError("time sharding needs stride-1 convs")
        self.seq_axis = seq_axis if kernel_size > 1 else None
        self.kernel_size, self.stride, self.dilation = (kernel_size, stride,
                                                        dilation)
        self.padding, self.wn_dim, self.dtype = padding, wn_dim, dtype
        self.v = nn.Parameter(torch.empty(kernel_size, in_channels, features))
        if use_weight_norm:
            self.g = nn.Parameter(torch.empty(
                in_channels if wn_dim == "in" else features))
        else:
            self.register_parameter("g", None)
        self.b = nn.Parameter(torch.empty(features))

    def init_(self, gen):
        """Torch-default uniform init (the JAX package's ``_kaiming_v_init``
        and ``_torch_bias_init``), ``g`` = ||v|| along the chosen axis."""
        k, cin, _ = self.v.shape
        bound = 1.0 / math.sqrt(k * cin)
        with torch.no_grad():
            self.v.copy_(torch.rand(self.v.shape, generator=gen) * 2 * bound
                         - bound)
            self.b.copy_(torch.rand(self.b.shape, generator=gen) * 2 * bound
                         - bound)
            if self.g is not None:
                self.g.copy_(self._norm(self.v))

    def _norm(self, v):
        dims = (0, 2) if self.wn_dim == "in" else (0, 1)
        return torch.sqrt(torch.sum(v * v, dim=dims))

    def forward(self, x):
        if self.seq_axis is not None:
            # sequence-parallel: the neighbours' receptive-field halo
            # (zeros at the true ends), then a convolution without padding
            x = halo_exchange(x, (self.kernel_size - 1) // 2 * self.dilation,
                              self.seq_axis)
        scale = None
        if self.g is not None:
            scale = self.g / self._norm(self.v)
            if self.wn_dim == "in":
                x = x * scale.to(x.dtype)
                scale = None
        w = self.v.to(self.dtype).permute(2, 1, 0)          # (out, in, K)
        xc = x.to(self.dtype).transpose(1, 2)               # (B, C, T)
        if self.seq_axis is not None:
            pad = 0
        elif self.padding == "SAME_TORCH":
            pad = (self.kernel_size - 1) // 2 * self.dilation
        elif self.padding[0] == self.padding[1]:
            pad = self.padding[0]       # symmetric: the conv pads, no copy
        else:
            xc = F.pad(xc, tuple(self.padding))
            pad = 0
        y = F.conv1d(xc, w, stride=self.stride, padding=pad,
                     dilation=self.dilation).transpose(1, 2)
        if scale is not None:
            y = y * scale.to(y.dtype)
        return (y + self.b).to(self.dtype)


class WNConvTranspose1d(nn.Module):
    """Weight-normalized strided transposed conv: x``scale`` upsampling,
    (B, T, C) -> (B, T * scale, C').

    The reference's resampling layer: kernel 2s, stride s, padding
    s//2 + s%2, output padding s%2, so the output has exactly T*s frames.
    ``v`` (2s, in, out) as the JAX package stores it; the JAX module flips
    it and convolves the s-dilated input, which is what
    ``F.conv_transpose1d`` computes from the unflipped (in, out, K) weight.
    ``g`` is per input channel by default (torch's ``ConvTranspose1d``
    weight-norm axis), applied as an input channel scale.
    """

    def __init__(self, in_channels, features, scale, use_weight_norm=True,
                 wn_dim="in", dtype=torch.float32):
        super().__init__()
        if wn_dim not in ("out", "in"):
            raise ValueError(f"wn_dim must be 'out' or 'in', got {wn_dim!r}")
        self.scale, self.wn_dim, self.dtype = scale, wn_dim, dtype
        self.v = nn.Parameter(torch.empty(2 * scale, in_channels, features))
        if use_weight_norm:
            self.g = nn.Parameter(torch.empty(
                in_channels if wn_dim == "in" else features))
        else:
            self.register_parameter("g", None)
        self.b = nn.Parameter(torch.empty(features))

    init_ = WNConv1d.init_
    _norm = WNConv1d._norm

    def forward(self, x):
        s = self.scale
        scale = None
        if self.g is not None:
            scale = self.g / self._norm(self.v)
            if self.wn_dim == "in":
                x = x * scale.to(x.dtype)
                scale = None
        w = self.v.to(self.dtype).permute(1, 2, 0)          # (in, out, K)
        y = F.conv_transpose1d(x.to(self.dtype).transpose(1, 2), w, stride=s,
                               padding=s // 2 + s % 2,
                               output_padding=s % 2).transpose(1, 2)
        if scale is not None:
            y = y * scale.to(y.dtype)
        return (y + self.b).to(self.dtype)


class ConvResStack(nn.Module):
    """LReLU -> dilated conv -> GN(1) (x layers) + 1x1 skip."""

    def __init__(self, channels, kernel_size=3, layers=2, dilation=1,
                 use_weight_norm=True, dtype=torch.float32, seq_axis=None):
        super().__init__()
        self.layers = layers
        for i in range(layers):
            setattr(self, f"conv_{i}", WNConv1d(
                channels, channels, kernel_size,
                dilation=dilation if i == 0 else 1,
                use_weight_norm=use_weight_norm, dtype=dtype,
                seq_axis=seq_axis))
            setattr(self, f"norm_{i}", GroupNorm(1, channels,
                                                 seq_axis=seq_axis))
        self.skip = WNConv1d(channels, channels, 1,
                             use_weight_norm=use_weight_norm, dtype=dtype)

    def forward(self, x, lengths=None):
        h = x
        for i in range(self.layers):
            h = F.leaky_relu(h, 0.2)
            h = getattr(self, f"conv_{i}")(h)
            h = getattr(self, f"norm_{i}")(h, lengths)
        out = h + self.skip(x)
        if lengths is not None:
            out = out * length_mask(lengths, out.shape[1], out.dtype)
        return out


class GLUResSkip(nn.Module):
    """Dilated conv -> + 1x1(cond) -> GN(2) -> tanh*sigmoid GLU -> 1x1
    res+skip. Returns ``(x + res, skip)``; ``c`` is (B, 1, cond) or
    (B, T, cond)."""

    def __init__(self, channels, cond_channels, skip_channels, kernel_size=3,
                 dilation=1, use_weight_norm=True, dtype=torch.float32,
                 seq_axis=None):
        super().__init__()
        C = channels
        self.channels = C
        self.conv_in = WNConv1d(C, 2 * C, kernel_size, dilation=dilation,
                                use_weight_norm=use_weight_norm, wn_dim="in",
                                dtype=dtype, seq_axis=seq_axis)
        if cond_channels and cond_channels > 0:
            self.conv_cond = WNConv1d(cond_channels, 2 * C, 1,
                                      use_weight_norm=use_weight_norm,
                                      dtype=dtype)
        else:
            self.conv_cond = None
        self.norm = GroupNorm(2, 2 * C, glu=True, seq_axis=seq_axis)
        self.res_skip = WNConv1d(C, C + skip_channels, 1,
                                 use_weight_norm=use_weight_norm, dtype=dtype)

    def forward(self, x, c, lengths=None):
        h = self.conv_in(x)
        if self.conv_cond is not None:
            h = h + self.conv_cond(c)
        h = self.norm(h, lengths)
        rs = self.res_skip(h)
        if lengths is not None:
            rs = rs * length_mask(lengths, rs.shape[1], rs.dtype)
        C = self.channels
        return x + rs[..., :C], rs[..., C:]


class Conditions(nn.Module):
    """Speaker/condition embedding table; ``normalize`` renormalizes rows
    to unit L2 norm at lookup time."""

    def __init__(self, num, dim, normalize=False, dtype=torch.float32):
        super().__init__()
        self.normalize, self.dtype = normalize, dtype
        self.embedding = nn.Parameter(torch.empty(num, dim))

    def init_(self, gen):
        with torch.no_grad():
            self.embedding.copy_(torch.randn(self.embedding.shape,
                                             generator=gen))

    def forward(self, idx):
        table = self.embedding
        if self.normalize:
            table = table / torch.linalg.vector_norm(table, dim=1,
                                                     keepdim=True)
        return table[idx.long()].to(self.dtype)


class Dense(nn.Module):
    """``x @ kernel + bias`` in the compute dtype; ``kernel`` is (in, out)
    as flax stores it. ``bias=False`` is flax's ``use_bias=False``."""

    def __init__(self, in_features, features, dtype=torch.float32,
                 bias=True):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(in_features, features))
        self.bias = nn.Parameter(torch.zeros(features)) if bias else None

    def init_(self, gen):
        with torch.no_grad():
            self.kernel.copy_(torch.randn(self.kernel.shape, generator=gen)
                              / math.sqrt(self.kernel.shape[0]))
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x):
        y = x.to(self.dtype) @ self.kernel.to(self.dtype)
        return y if self.bias is None else y + self.bias.to(self.dtype)


class Conv(nn.Module):
    """flax ``nn.Conv`` over (B, T, C) with ``padding="SAME"``: ``kernel``
    (K, in, out) as flax stores it, ``bias`` (out,), fp32. SAME pads
    ``(ceil(T / stride) - 1) * stride + (K - 1) * dilation + 1 - T`` frames,
    the smaller half on the left: a stride-2 conv of an even T pads 1 left
    and 2 right, which ``Conv1d(padding=...)`` cannot express. ``bias=False``
    is flax's ``use_bias=False``; ``dtype`` the compute dtype."""

    def __init__(self, in_features, features, kernel_size, stride=1,
                 dilation=1, bias=True, dtype=torch.float32):
        super().__init__()
        self.stride, self.dilation, self.dtype = stride, dilation, dtype
        self.kernel = nn.Parameter(torch.empty(kernel_size, in_features,
                                               features))
        self.bias = nn.Parameter(torch.zeros(features)) if bias else None

    def init_(self, gen):
        k, cin, _ = self.kernel.shape
        with torch.no_grad():
            self.kernel.copy_(torch.randn(self.kernel.shape, generator=gen)
                              / math.sqrt(k * cin))
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x):
        T = x.shape[1]
        k = self.kernel.shape[0]
        out = -(-T // self.stride)
        pad = max((out - 1) * self.stride + (k - 1) * self.dilation + 1 - T,
                  0)
        dt = self.dtype
        xc = F.pad(x.to(dt).transpose(1, 2), (pad // 2, pad - pad // 2))
        y = F.conv1d(xc, self.kernel.to(dt).permute(2, 1, 0),
                     None if self.bias is None else self.bias.to(dt),
                     stride=self.stride, dilation=self.dilation)
        return y.transpose(1, 2)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis with flax's defaults: epsilon 1e-6 (not
    torch's 1e-5), variance as ``E[x^2] - E[x]^2`` clamped at 0, statistics
    and output in fp32 whatever the input's dtype."""

    def __init__(self, features, eps=1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def init_(self, gen):
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()

    def forward(self, x):
        x = x.float()
        mean = x.mean(dim=-1, keepdim=True)
        var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mean * mean,
                          min=0.0)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.scale) \
            + self.bias


class Embed(nn.Module):
    """Embedding table lookup (fp32 rows)."""

    def __init__(self, num, features):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(num, features))

    def init_(self, gen):
        with torch.no_grad():
            self.embedding.copy_(
                torch.randn(self.embedding.shape, generator=gen)
                / math.sqrt(self.embedding.shape[1]))

    def forward(self, idx):
        return self.embedding[idx.long()]


def init_parameters(module, seed):
    """Seeded random init of every block in ``module`` (CPU generator, so
    the same seed gives the same weights on any device)."""
    gen = torch.Generator().manual_seed(int(seed))
    for m in module.modules():
        if hasattr(m, "init_"):
            m.init_(gen)
