"""Shared helpers of the hierarchical VQ-VAE families (vqvae2/2a/2b).

Counterpart of ``vae_npvc_tpu/models/hier_common.py`` (``HierVQMixin``):
the per-level quantizer dispatch over plain (gradient) and EMA codebooks,
the ``_qkey`` hook (vqvae2a's shared quantizer maps every level to one
bank), the masked time mean and the length-aware upsampling.

The EMA codebooks are :class:`~.vqvae.EmaQuantizer` children named as the
JAX ``ema`` collection's roots (``quantizer_{i}``, or ``quantizer`` for a
shared bank). A training forward writes no buffer: it collects each bank's
updated state in ``pending_ema`` (a dict by name), and the trainer commits
them once the step is accepted. A bank that two levels share is updated
by the first and read updated by the second, as the JAX module's mutable
variable is.

Data-parallel training (``dp_axis``, a bound data axis; the JAX package's
GSPMD step reduces over the global batch): every EMA level sums its
statistics and pools its candidates over the axis (``ops/vq.py``), a plain
level's perplexity counts every rank's codes, and the root mean squares
(``z_rms``, ``gst_in_rms``) are the global batch's.
"""

from __future__ import annotations

import torch
from torch import nn

from ..nn.blocks import init_parameters
from ..nn.gst import StyleTokenLayer
from ..ops import vq as vq_ops
from ..ops.losses import log_loss
from ..ops.upsample import nearest_upsample, nearest_upsample_masked
from ..parallel.shard import axis_mean
from .vqvae import Decoder, EmaQuantizer, Encoder


class HierVQMixin:
    """Per-level VQ dispatch + masked helpers for hierarchical models.

    Hosts set ``arch``, ``dtype``, ``levels``, ``use_ema``, ``use_gst``,
    ``dp_axis`` and ``q_args`` (per-level quantizer dicts) and call
    :meth:`_build_levels`.
    """

    pending_ema = None
    dp_axis = None

    def _qkey(self, i):
        return i

    def _is_gst_level(self, i):
        return self.use_gst and i == self.levels - 1

    # ------------------------------------------------------------- modules
    def _build_levels(self, final_decoder=False):
        """``encoder_{i}`` (returning hidden features) and ``decoder_{i}``
        per level, optionally ``final_decoder``."""
        for i in range(self.levels):
            setattr(self, f"encoder_{i}", Encoder(
                self.arch[f"encoder.{i}"], dtype=self.dtype,
                return_hidden=True))
        for i in range(self.levels):
            setattr(self, f"decoder_{i}", Decoder(
                self.arch[f"decoder.{i}"], dtype=self.dtype))
        if final_decoder:
            self.final_decoder = Decoder(self.arch["final_decoder"],
                                         dtype=self.dtype)

    def _build_quantizer(self, key, q):
        """One codebook under the JAX name of bank ``key`` (-1: shared)."""
        suffix = "" if key == -1 else f"_{key}"
        z_num, z_dim = q.get("z_num", 512), q.get("z_dim", 128)
        if self.use_ema:
            setattr(self, f"quantizer{suffix}", EmaQuantizer(z_num, z_dim))
        else:
            setattr(self, f"quantizer_embedding{suffix}",
                    nn.Parameter(torch.empty(z_num, z_dim)))

    def _build_gst(self, q):
        """The GST top level, pinned to fp32 (a single query over ~10
        tokens; bf16 scores on large reference embeddings overflow)."""
        self.gst = StyleTokenLayer(
            ref_embed_dim=q.get("ref_embed_dim", 128),
            gst_tokens=q.get("gst_tokens", 10),
            gst_token_dim=q.get("gst_token_dim", 256),
            gst_heads=q.get("gst_heads", 4), dtype=torch.float32)

    def encoder(self, i):
        return getattr(self, f"encoder_{i}")

    def decoder(self, i):
        return getattr(self, f"decoder_{i}")

    def init_random(self, seed):
        """Seeded random weights; each plain codebook a standard normal
        (the JAX ``normal(1.0)`` init)."""
        init_parameters(self, seed)
        gen = torch.Generator().manual_seed(int(seed) + 1)
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.startswith("quantizer_embedding"):
                    p.copy_(torch.randn(p.shape, generator=gen))
        return self

    # ---------------------------------------------------------- quantizers
    def _bank(self, i):
        suffix = "" if self._qkey(i) == -1 else f"_{self._qkey(i)}"
        if self.use_ema:
            return f"quantizer{suffix}", getattr(self, f"quantizer{suffix}")
        return None, getattr(self, f"quantizer_embedding{suffix}")

    def _ema_state(self, name, bank):
        if self.pending_ema is not None and name in self.pending_ema:
            return self.pending_ema[name]
        return bank.state()

    def _begin_forward(self, ema_state):
        """Start a forward's pending EMA states from ``ema_state`` (a dict
        by bank name, chained microbatches) or the buffers."""
        self.pending_ema = dict(ema_state) if ema_state else {}

    def _quantize(self, i, z, train, gen):
        """VQ level i (never the GST level) -> (z_vq, qut, enc, detail),
        frame-mean reductions. ``gen`` draws the EMA bank's lazy init and
        restarts (training only)."""
        z = z.float()
        q = self.q_args[i]
        name, bank = self._bank(i)
        if self.use_ema:
            z_vq, qut, enc, new_state, detail = vq_ops.ema_vq_forward(
                self._ema_state(name, bank), z, gen if train else None,
                mu=q.get("mu", 0.9), threshold=q.get("threshold", 1.0),
                reduction="frame_mean", training=train, update=train,
                axis_name=self.dp_axis)
            if train:
                self.pending_ema[name] = new_state
            return z_vq, qut, enc, detail
        return vq_ops.vq_forward(bank, z, normalize=q.get("normalize", False),
                                 reduction="frame_mean",
                                 axis_name=self.dp_axis)

    def _vq_encode(self, i, z):
        _, bank = self._bank(i)
        if self.use_ema:
            return vq_ops.ema_vq_encode(bank.state(), z.float())
        return vq_ops.vq_encode(bank, z.float(),
                                normalize=self.q_args[i].get("normalize",
                                                             False))

    def _vq_decode(self, i, idx):
        _, bank = self._bank(i)
        if self.use_ema:
            return vq_ops.ema_vq_decode(bank.state(), idx)
        return vq_ops.vq_decode(bank, idx,
                                normalize=self.q_args[i].get("normalize",
                                                             False))

    @staticmethod
    def _level_gen(gen, level_gens, i):
        return gen if level_gens is None else level_gens.get(i, gen)

    # -------------------------------------------------------------- helpers
    def _rms(self, z):
        """The root mean square of ``z`` over the batch (over every rank's
        rows with ``dp_axis``; the shards are equal)."""
        return torch.sqrt(axis_mean(torch.mean(torch.square(z.float())),
                                    self.dp_axis))

    def _vq_detail(self, detail, z, enc):
        detail = dict(detail)
        detail["quanti_err"] = enc
        detail["z_rms"] = self._rms(z)
        return detail

    def _losses(self, xhat, x, qut_losses, enc_losses):
        """(x_loss, z_enc_loss, loss) = X like, VQ loss and
        X like + sum(qut) + beta * sum(enc)."""
        x_loss = log_loss(xhat, x.float())
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        z_qut = sum(qut_losses) if qut_losses else zero
        z_enc = sum(enc_losses) if enc_losses else zero
        return x_loss, z_enc, x_loss + z_qut + self.beta * z_enc

    def _len_chain(self, lengths):
        """Real latent length per level (index i = level-i z length);
        pooled and GST tops collapse to length 1 (vqvae2a/2b)."""
        if lengths is None:
            return [None] * self.levels
        lens, cur = [], lengths
        for i in range(self.levels):
            cur = Encoder.out_lengths(self.arch[f"encoder.{i}"], cur)
            if ((self.pooling_last or self._is_gst_level(i))
                    and i == self.levels - 1):
                cur = torch.ones_like(cur)
            lens.append(cur)
        return lens

    @staticmethod
    def _masked_mean(z, lengths, keepdims=True):
        """Time mean over the real lengths (the GST reference embedding /
        pooled top level)."""
        if lengths is None:
            return torch.mean(z, dim=1, keepdim=keepdims)
        mask = (torch.arange(z.shape[1], device=z.device)[None, :]
                < lengths[:, None]).to(z.dtype)
        denom = torch.clamp(lengths, min=1).to(z.dtype)[:, None]
        out = torch.sum(z * mask[..., None], dim=1) / denom
        return out[:, None, :] if keepdims else out

    @staticmethod
    def _upsample(z, t, in_len, out_len):
        if in_len is None or out_len is None:
            return nearest_upsample(z, t)
        return nearest_upsample_masked(z, t, in_len, out_len)
