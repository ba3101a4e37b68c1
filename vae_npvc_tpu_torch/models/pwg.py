"""The native Parallel WaveGAN vocoder: generator and discriminator.

Counterpart of ``vae_npvc_tpu/models/pwg.py`` (``MelUpsampler``,
``PWGGenerator``, ``PWGDiscriminator``; Yamamoto et al., ICASSP 2020): a
non-autoregressive WaveNet generator (gated dilated convolutions at the
sample rate, conditioned on the upsampled log-mel, noise in) and a
dilated-convolution waveform discriminator. Every layer is a
weight-normalized conv holding the JAX package's parameters under its flax
names (``v`` (K, in, out), ``g`` (out,), ``b``): ``upsample.smooth_{i}``,
``in``, ``dil_{i}``, ``cond_{i}``, ``res_{i}``, ``skip_{i}``, ``out_0``,
``out_1`` and ``conv_{i}``, so ``utils/bridge.py`` carries the weights
across unchanged.

The interface is the JAX modules' (noise (B, S, 1), mel (B, T, n_mels),
waveform out (B, S, 1) in fp32), but the trunk runs channels-first (B, C,
S) with ``F.conv1d`` on the normalized weights ``v * g / ||v||`` (the same
function of (v, g, b) as JAX's conv-then-scale), so no layer transposes its
activations. Layers that read the same input and differ only in their
output channels run as one product: each residual block's ``res_{i}`` and
``skip_{i}``, and every layer's ``cond_{i}`` of one stack, whose input is
the shared upsampled mel.

Architecture keys (published defaults): ``layers`` 30, ``stacks`` 3,
``residual_channels`` 64, ``gate_channels`` 128, ``skip_channels`` 64,
``kernel_size`` 3, ``upsample_scales`` (product = hop); the discriminator's
``disc_layers`` 10, ``disc_channels`` 64, ``disc_kernel_size`` 3. The mel
width is ``aux_channels`` (default: ``n_mels``, else 80), which JAX reads
from its input's shape.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.blocks import WNConv1d, init_parameters
from ..utils.device import compute_dtype


def _weight(layer, dtype):
    """(out, in, K) conv weight ``v * g / ||v||`` of a ``WNConv1d`` (whose
    ``g`` is per output channel), cast to ``dtype``."""
    w = layer.v * (layer.g / layer._norm(layer.v))
    return w.to(dtype).permute(2, 1, 0)


def _in_dtype(value, dtype):
    """A Python scalar rounded to ``dtype``, as JAX casts a constant to the
    trunk's type before it multiplies."""
    return float(torch.tensor(value, dtype=dtype))


def _conv(x, layers, dtype, dilation=1):
    """Channels-first SAME conv of ``x`` (B, C, S) by the ``WNConv1d``
    layers stacked on their output channels."""
    w = torch.cat([_weight(m, dtype) for m in layers])
    b = torch.cat([m.b for m in layers]).to(dtype)
    k = w.shape[-1]
    return F.conv1d(x, w, b, padding=(k - 1) // 2 * dilation,
                    dilation=dilation)


class MelUpsampler(nn.Module):
    """(B, C, T) -> (B, C, T * prod(scales)): each stage repeats every frame
    ``s`` times, then smooths with a weight-normalized conv of kernel
    ``2 s + 1``."""

    def __init__(self, channels, scales, dtype=torch.float32):
        super().__init__()
        self.scales, self.dtype = tuple(scales), dtype
        for i, s in enumerate(self.scales):
            setattr(self, f"smooth_{i}",
                    WNConv1d(channels, channels, 2 * s + 1, dtype=dtype))

    def forward(self, c):
        for i, s in enumerate(self.scales):
            c = torch.repeat_interleave(c, s, dim=2)
            c = _conv(c, [getattr(self, f"smooth_{i}")], self.dtype)
        return c


class PWGGenerator(nn.Module):
    """Noise (B, S, 1) + log-mel (B, T, n_mels) -> waveform (B, S, 1), fp32,
    with S = T * hop."""

    def __init__(self, arch, dtype=None, aux_channels=None):
        super().__init__()
        a = dict(arch)
        self.dtype = compute_dtype(a, dtype)
        self.layers = a.get("layers", 30)
        self.stacks = a.get("stacks", 3)
        res_ch = a.get("residual_channels", 64)
        gate_ch = a.get("gate_channels", 128)
        skip_ch = a.get("skip_channels", 64)
        kernel = a.get("kernel_size", 3)
        aux = aux_channels or a.get("aux_channels", a.get("n_mels", 80))
        self.scales = tuple(a.get("upsample_scales", (4, 4, 4, 4)))
        self.hop = math.prod(self.scales)
        self.cycle = self.layers // self.stacks
        self.aux_channels = aux
        self.upsample = MelUpsampler(aux, self.scales, self.dtype)
        # ``in`` is a Python keyword: registered by name so its keys stay
        # ``in.v``, ``in.g``, ``in.b``
        self.add_module("in", WNConv1d(1, res_ch, 1, dtype=self.dtype))
        half = gate_ch // 2
        for i in range(self.layers):
            d = 2 ** (i % self.cycle)
            setattr(self, f"dil_{i}", WNConv1d(res_ch, gate_ch, kernel,
                                               dilation=d, dtype=self.dtype))
            setattr(self, f"cond_{i}", WNConv1d(aux, gate_ch, 1,
                                                dtype=self.dtype))
            setattr(self, f"res_{i}", WNConv1d(half, res_ch, 1,
                                               dtype=self.dtype))
            setattr(self, f"skip_{i}", WNConv1d(half, skip_ch, 1,
                                                dtype=self.dtype))
        self.out_0 = WNConv1d(skip_ch, skip_ch, 1, dtype=self.dtype)
        self.out_1 = WNConv1d(skip_ch, 1, 1, dtype=self.dtype)
        self.res_ch, self.gate_ch, self.skip_ch = res_ch, gate_ch, skip_ch

    def init_random(self, seed):
        """Seeded random weights (torch-default uniform, ``g`` = ||v||)."""
        init_parameters(self, seed)
        return self

    def forward(self, z, c):
        dt = self.dtype
        B, S = z.shape[0], z.shape[1]
        c_up = self.upsample(c.to(dt).transpose(1, 2))      # (B, aux, S)
        if c_up.shape[2] != S:
            raise ValueError(f"noise length {S} != mel frames x hop "
                             f"{c_up.shape[2]}")
        x = _conv(z.to(dt).reshape(B, 1, S), [getattr(self, "in")], dt)
        root_half = _in_dtype(math.sqrt(0.5), dt)
        skips = None
        # channel groups are taken with split/chunk, whose backward is one
        # concatenation (a slice's would fill and add a whole-size buffer)
        for i in range(self.layers):
            if i % self.cycle == 0:
                # one stack's conditioning layers as one 1x1 product of
                # the shared upsampled mel
                stack = range(i, min(i + self.cycle, self.layers))
                conds = _conv(c_up, [getattr(self, f"cond_{j}")
                                     for j in stack], dt).split(
                                         self.gate_ch, dim=1)
            h = _conv(x, [getattr(self, f"dil_{i}")], dt,
                      dilation=2 ** (i % self.cycle))
            ha, hb = (h + conds[i % self.cycle]).chunk(2, dim=1)
            g = torch.tanh(ha) * torch.sigmoid(hb)
            res, skip = _conv(g, [getattr(self, f"res_{i}"),
                                  getattr(self, f"skip_{i}")], dt).split(
                                      [self.res_ch, self.skip_ch], dim=1)
            # published blocks scale (x + residual) by sqrt(0.5) to keep
            # the trunk's variance across the layers; the skips sum in the
            # compute type, as JAX's do
            x = (x + res) * root_half
            skips = skip if skips is None else skips + skip
        h = F.relu(skips * _in_dtype(1.0 / math.sqrt(self.layers), dt))
        h = F.relu(_conv(h, [self.out_0], dt))
        wav = _conv(h, [self.out_1], dt)
        return wav.float().reshape(B, S, 1)


class PWGDiscriminator(nn.Module):
    """Waveform (B, S, 1) -> per-sample logits (B, S, 1), fp32 (LSGAN)."""

    def __init__(self, arch, dtype=None):
        super().__init__()
        a = dict(arch)
        self.dtype = compute_dtype(a, dtype)
        self.n_layers = a.get("disc_layers", 10)
        ch = a.get("disc_channels", 64)
        kernel = a.get("disc_kernel_size", 3)
        cin = 1
        for i in range(self.n_layers - 1):
            setattr(self, f"conv_{i}", WNConv1d(cin, ch, kernel,
                                                dilation=max(i, 1),
                                                dtype=self.dtype))
            cin = ch
        setattr(self, f"conv_{self.n_layers - 1}",
                WNConv1d(cin, 1, kernel, dtype=self.dtype))

    def init_random(self, seed):
        init_parameters(self, seed)
        return self

    def forward(self, x):
        dt = self.dtype
        B, S = x.shape[0], x.shape[1]
        h = x.to(dt).reshape(B, 1, S)
        for i in range(self.n_layers - 1):
            h = F.leaky_relu(_conv(h, [getattr(self, f"conv_{i}")], dt,
                                   dilation=max(i, 1)), 0.2)
        out = _conv(h, [getattr(self, f"conv_{self.n_layers - 1}")], dt)
        return out.float().reshape(B, S, 1)
