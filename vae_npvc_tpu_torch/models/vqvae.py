"""Flat speaker-conditioned VQ-VAE: training forward and inference.

Counterpart of ``vae_npvc_tpu/models/vqvae.py`` (``Encoder``, ``Decoder``,
``Model``), same config keys, same channels-last layout, same casts. The
encoder's downsampling convs (kernel 2s, stride s, padding s//2 + s%2) and
the decoder's transposed upsampling convs are the hierarchical families'
resampling layers (models/vqvae2*.py).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.blocks import (Conditions, ConvResStack, GLUResSkip, WNConv1d,
                         WNConvTranspose1d, init_parameters, length_mask)
from ..ops import vq as vq_ops
from ..ops.jitter import jitter as jitter_op
from ..ops.losses import log_loss

class Encoder(nn.Module):
    """Conv encoder: per scale [conv -> res-stack x n -> LReLU], final 1x1.

    A scale ``s != 1`` downsamples with a kernel-2s, stride-s conv padded
    by s//2 + s%2. ``return_hidden`` also returns the pre-projection
    features, which the next level of a hierarchy reads.
    """

    def __init__(self, arch, dtype=torch.float32, return_hidden=False,
                 seq_axis=None):
        super().__init__()
        a = dict(arch)
        in_channels = a.get("in_channels", [513, 1024, 512, 256])
        out_channels = a.get("out_channels", [1024, 512, 256, 128])
        scales = a.get("downsample_scales", [1] * len(in_channels))
        kernel_size = a.get("kernel_size", 3)
        dilation = a.get("dilation", True)
        stack_kernel = a.get("stack_kernel_size", 3)
        stack_layers = a.get("stack_layers", 2)
        stacks = a.get("stacks", [3] * len(in_channels))
        use_wn = a.get("use_weight_norm", True)
        self.stacks = list(stacks)
        self.scales = list(scales)
        self.return_hidden = return_hidden
        ch = in_channels[0]
        for i, (out_ch, ds, n_stack) in enumerate(zip(out_channels, scales,
                                                      stacks)):
            if ds == 1:
                conv = WNConv1d(ch, out_ch, kernel_size,
                                use_weight_norm=use_wn, dtype=dtype,
                                seq_axis=seq_axis)
            else:
                if seq_axis is not None:
                    raise ValueError(
                        "time sharding supports stride-1 encoders only")
                p = ds // 2 + ds % 2
                conv = WNConv1d(ch, out_ch, 2 * ds, stride=ds, padding=(p, p),
                                use_weight_norm=use_wn, dtype=dtype)
            setattr(self, f"conv_{i}", conv)
            for j in range(n_stack):
                setattr(self, f"stack_{i}_{j}", ConvResStack(
                    out_ch, stack_kernel, stack_layers,
                    dilation=2 ** j if dilation else 1,
                    use_weight_norm=use_wn, dtype=dtype, seq_axis=seq_axis))
            ch = out_ch
        self.proj = WNConv1d(ch, a.get("z_channels", 128), 1,
                             use_weight_norm=use_wn, dtype=dtype)
        self.dtype = dtype

    @staticmethod
    def out_lengths(arch, lengths):
        """Frame-count transform (torch conv length formula, clamped >= 1
        per downsampling step); numpy arrays or tensors."""
        for ds in arch.get("downsample_scales",
                           [1] * len(arch.get("in_channels", [1]))):
            if ds != 1:
                p = ds // 2 + ds % 2
                lengths = ((lengths + 2 * p - 2 * ds) // ds + 1).clip(min=1)
        return lengths

    @staticmethod
    def min_input_frames(archs):
        """Smallest T whose padded time stays >= 1 through every level."""
        t = 1
        for arch in reversed(list(archs)):
            for ds in reversed(arch.get(
                    "downsample_scales",
                    [1] * len(arch.get("in_channels", [1])))):
                if ds != 1:
                    p = ds // 2 + ds % 2
                    t = (t - 1) * ds + 2 * ds - 2 * p
        return t

    def forward(self, x, lengths=None):
        """(B, T, C) -> (B, T', z) (and the (B, T', C') hidden features
        with ``return_hidden``); ``lengths`` follow the downsampling, each
        step clamped to at least one frame."""
        h = x
        mask = None
        if lengths is not None:
            mask = length_mask(lengths, h.shape[1])
            h = h * mask.to(h.dtype)
        for i, (ds, n_stack) in enumerate(zip(self.scales, self.stacks)):
            p = ds // 2 + ds % 2
            if ds != 1 and (h.shape[1] + 2 * p - 2 * ds) // ds + 1 <= 0:
                # checked before the conv, which refuses an input shorter
                # than its kernel
                raise ValueError(
                    f"input too short for this encoder's x{ds} "
                    f"downsampling (0 frames after conv_{i}); pad the "
                    "input to >= Encoder.min_input_frames(...) frames — "
                    "the bucketed conversion path does this "
                    "automatically. (torch would crash here too: Conv1d "
                    "input smaller than its kernel)")
            h = getattr(self, f"conv_{i}")(h)
            if ds != 1 and lengths is not None:
                lengths = ((lengths + 2 * p - 2 * ds) // ds + 1).clamp(min=1)
                mask = length_mask(lengths, h.shape[1])
            if mask is not None:
                h = h * mask.to(h.dtype)
            for j in range(n_stack):
                h = getattr(self, f"stack_{i}_{j}")(h, lengths)
            h = F.leaky_relu(h, 0.2)
        hidden = h
        h = self.proj(h)
        if mask is not None:
            h = h * mask.to(h.dtype)
        if self.return_hidden:
            return h, hidden
        return h


class Decoder(nn.Module):
    """Decoder with speaker-conditioned GLU res-skip stacks; the skips are
    summed, scaled by sqrt(1/total_layers), then ReLU/1x1/ReLU/1x1. A scale
    ``us != 1`` upsamples x``us`` with a transposed conv (``lengths`` too).
    """

    def __init__(self, arch, dtype=torch.float32, seq_axis=None):
        super().__init__()
        a = dict(arch)
        in_channels = a.get("in_channels", [128, 256, 512, 1024])
        out_channels = a.get("out_channels", [256, 512, 1024, 513])
        scales = a.get("upsample_scales", [1] * len(in_channels))
        cond = a.get("cond_channels", 128)
        skip = a.get("skip_channels", 80)
        kernel_size = a.get("kernel_size", 5)
        dilation = a.get("dilation", True)
        stack_kernel = a.get("stack_kernel_size", 3)
        stacks = a.get("stacks", [3] * len(in_channels))
        use_wn = a.get("use_weight_norm", True)
        self.stacks = list(stacks)
        self.scales = list(scales)
        self.total_layers = len(in_channels) + sum(stacks)
        ch = in_channels[0]
        for i, (out_ch, us, n_stack) in enumerate(zip(out_channels, scales,
                                                      stacks)):
            if us == 1:
                # the reference's stride-1 ConvTranspose1d: a forward conv
                # with the input-side weight-norm scale
                up = WNConv1d(ch, out_ch, kernel_size, use_weight_norm=use_wn,
                              wn_dim="in", dtype=dtype, seq_axis=seq_axis)
            else:
                if seq_axis is not None:
                    raise ValueError(
                        "time sharding supports stride-1 decoders only")
                up = WNConvTranspose1d(ch, out_ch, us, use_weight_norm=use_wn,
                                       dtype=dtype)
            setattr(self, f"up_{i}", up)
            for j in range(n_stack):
                setattr(self, f"stack_{i}_{j}", GLUResSkip(
                    out_ch, cond, skip, stack_kernel,
                    dilation=2 ** j if dilation else 1,
                    use_weight_norm=use_wn, dtype=dtype, seq_axis=seq_axis))
            ch = out_ch
        self.final_0 = WNConv1d(skip, skip, 1, use_weight_norm=use_wn,
                                dtype=dtype)
        self.final_1 = WNConv1d(skip, a.get("final_channels", 80), 1,
                                use_weight_norm=use_wn, dtype=dtype)

    @staticmethod
    def out_lengths(arch, lengths):
        for us in arch.get("upsample_scales",
                           [1] * len(arch.get("in_channels", [1]))):
            if us != 1:
                lengths = lengths * us
        return lengths

    def forward(self, z, c, lengths=None):
        h = z
        mask = None
        if lengths is not None:
            mask = length_mask(lengths, h.shape[1])
            h = h * mask.to(h.dtype)
        skip_sum = None
        for i, (us, n_stack) in enumerate(zip(self.scales, self.stacks)):
            h = getattr(self, f"up_{i}")(h)
            if us != 1 and lengths is not None:
                lengths = lengths * us
                mask = length_mask(lengths, h.shape[1])
            if mask is not None:
                h = h * mask.to(h.dtype)
            for j in range(n_stack):
                h, skip = getattr(self, f"stack_{i}_{j}")(h, c, lengths)
                skip_sum = skip if skip_sum is None else skip_sum + skip
        h = skip_sum * (1.0 / self.total_layers) ** 0.5
        h = self.final_0(F.relu(h))
        h = self.final_1(F.relu(h))
        if mask is not None:
            h = h * mask.to(h.dtype)
        return h


class EmaQuantizer(nn.Module):
    """The EMA codebook as buffers (the JAX ``ema`` collection's
    ``quantizer`` leaf: ``initted``, ``emb``, ``emb_sum``, ``emb_elem``)."""

    def __init__(self, num_codes, dim):
        super().__init__()
        self.register_buffer("initted", torch.zeros((), dtype=torch.bool))
        self.register_buffer("emb", torch.zeros(num_codes, dim))
        self.register_buffer("emb_sum", torch.zeros(num_codes, dim))
        self.register_buffer("emb_elem", torch.ones(num_codes))

    def state(self):
        return vq_ops.EmaVqState(self.initted, self.emb, self.emb_sum,
                                 self.emb_elem)

    def set_state(self, state):
        """Copy ``state`` into the buffers (in place)."""
        with torch.no_grad():
            for buf, new in zip(self.state(), state):
                buf.copy_(new)


class Model(nn.Module):
    """Flat VQ-VAE with speaker conditioning.

    ``arch`` is the flat experiment config (model keys at the top level).
      forward(x, y_idx, train)      -> (xhat, loss, detail)  # training
      encode(x, lengths)            -> (B, T') int32 ids
      decode(ids, y_idx, lengths)   -> (B, T, D) fp32 mel
      infer(x, y_idx, lengths)      -> (B, T, D) fp32 mel

    The EMA codebook lives in the ``quantizer`` buffers. A training
    forward does not write them: it leaves the updated state in
    ``pending_ema`` (the JAX package's mutable ``ema`` collection), and the
    trainer commits it once the step is accepted.
    """

    def __init__(self, arch, dtype=torch.float32):
        super().__init__()
        a = dict(arch)
        self.arch = a
        self.dtype = dtype
        # sequence-parallel inference splits time over this axis; the
        # data-parallel step sums the EMA statistics over dp_axis. Both are
        # mesh axis names, bound by the caller (parallel/comm.bind)
        self.seq_axis = a.get("seq_axis")
        self.dp_axis = a.get("dp_axis")
        self.encoder = Encoder(a.get("encoder", {}), dtype=dtype,
                               seq_axis=self.seq_axis)
        self.decoder = Decoder(a.get("decoder", {}), dtype=dtype,
                               seq_axis=self.seq_axis)
        self.embeds = Conditions(a.get("y_num", 10), a.get("y_dim", 128),
                                 normalize=False, dtype=dtype)
        self.use_ema = a.get("use_ema", False)
        self.embed_norm = a.get("embed_norm", True)
        self.mu = a.get("mu", 0.9)
        self.beta = a.get("beta", 0.01)
        self.jitter_p = a.get("jitter_p", 0.0)
        self.legacy_no_ste = a.get("legacy_no_ste", False)
        self.remat = a.get("remat", False)
        self.pending_ema = None
        z_num, z_dim = a.get("z_num", 512), a.get("z_dim", 128)
        if self.use_ema:
            self.quantizer = EmaQuantizer(z_num, z_dim)
        else:
            self.quantizer_embedding = nn.Parameter(torch.empty(z_num, z_dim))

    def init_random(self, seed):
        """Seeded random weights (the codebook stays as initialized)."""
        init_parameters(self, seed)
        if not self.use_ema:
            gen = torch.Generator().manual_seed(int(seed) + 1)
            with torch.no_grad():
                self.quantizer_embedding.copy_(torch.randn(
                    self.quantizer_embedding.shape, generator=gen))
        return self

    def _quantize_train(self, z, train, gen, ema_state):
        """Returns (z_vq, z_qut_loss, z_enc_loss, detail, new EMA state)."""
        z = z.float()
        if self.use_ema:
            state = self.quantizer.state() if ema_state is None else ema_state
            z_vq, qut, enc, new_state, detail = vq_ops.ema_vq_forward(
                state, z, gen if train else None, mu=self.mu,
                reduction="frame_mean", training=train, update=train,
                legacy_no_ste=self.legacy_no_ste, axis_name=self.dp_axis)
            return z_vq, qut, enc, detail, new_state if train else None
        return vq_ops.vq_forward(self.quantizer_embedding, z,
                                 normalize=self.embed_norm,
                                 reduction="frame_mean",
                                 axis_name=self.dp_axis) + (None,)

    def _run(self, module, *args):
        """``module(*args)``, recomputed in the backward with ``remat``."""
        if self.remat and torch.is_grad_enabled():
            from torch.utils.checkpoint import checkpoint

            return checkpoint(module, *args, use_reentrant=False)
        return module(*args)

    def forward(self, x, y_idx, train=True, *, gen=None, ema_state=None):
        """Training/valid forward (unmasked). x: (B, T, D) mel; y_idx: (B,)
        int. ``gen`` is the step's ``torch.Generator`` on x's device (lazy
        codebook init, restarts, jitter); ``ema_state`` overrides the
        buffers' state (chained microbatches)."""
        y = self.embeds(y_idx.reshape(-1))[:, None, :]       # (B, 1, y_dim)
        z = self._run(self.encoder, x.to(self.dtype))
        z_vq, z_qut_loss, z_enc_loss, vq_detail, self.pending_ema = \
            self._quantize_train(z, train, gen, ema_state)
        if train and self.jitter_p > 0.0:
            z_vq = jitter_op(gen, z_vq, self.jitter_p,
                             axis_name=self.dp_axis)
        xhat = self._run(self.decoder, z_vq.to(self.dtype), y).float()
        x_loss = log_loss(xhat, x.float())
        loss = x_loss + z_qut_loss + self.beta * z_enc_loss
        detail = {"Total": loss, "VQ loss": z_enc_loss, "X like": x_loss}
        detail.update(vq_detail)
        return xhat, loss, detail

    def encode(self, x, lengths=None):
        """Mel (B, T, D) -> code ids (B, T'); ids beyond the transformed
        length are garbage."""
        z = self.encoder(x.to(self.dtype), lengths).float()
        if self.use_ema:
            return vq_ops.ema_vq_encode(self.quantizer.state(), z)
        return vq_ops.vq_encode(self.quantizer_embedding, z,
                                normalize=self.embed_norm)

    def decode(self, z_idx, y_idx, lengths=None):
        """Code ids (B, T') + speaker ids (B,) or (B, K) -> mel; the flat
        model uses the first target."""
        y_idx = y_idx.reshape(y_idx.shape[0], -1)[:, 0]
        y = self.embeds(y_idx)[:, None, :]
        if self.use_ema:
            z_vq = vq_ops.ema_vq_decode(self.quantizer.state(), z_idx)
        else:
            z_vq = vq_ops.vq_decode(self.quantizer_embedding, z_idx,
                                    normalize=self.embed_norm)
        return self.decoder(z_vq.to(self.dtype), y, lengths).float()

    def infer(self, x, y_idx, lengths=None):
        z_lengths = (Encoder.out_lengths(self.arch.get("encoder", {}),
                                         lengths)
                     if lengths is not None else None)
        return self.decode(self.encode(x, lengths), y_idx, z_lengths)
