"""Hierarchical VQ-VAE v2b: independent per-level decoders + fusion decoder.

Counterpart of ``vae_npvc_tpu/models/vqvae2b.py`` (``Model``), same config
keys and parameter names:

- every level quantizes its encoder output directly (pooled to one frame
  at the top with ``pooling_last``, GST optional at the top);
- each level is decoded on its own to time-aligned features by
  ``decoder_{i}``, conditioned on its own speaker table ``embeds_{i}``
  (per-level speaker control at decode time);
- ``final_decoder`` fuses the channel concat of the level decodes,
  unconditioned.
"""

from __future__ import annotations

import torch
from torch import nn

from ..nn.blocks import Conditions
from ..ops.jitter import jitter as jitter_op
from ..ops.upsample import nearest_upsample
from .hier_common import HierVQMixin
from .vqvae import Decoder, Encoder


class Model(HierVQMixin, nn.Module):
    def __init__(self, arch, dtype=torch.float32):
        super().__init__()
        a = dict(arch)
        self.arch, self.dtype = a, dtype
        self.levels = a.get("levels", 3)
        self.use_gst = a.get("use_gst", True) if self.levels > 1 else False
        self.use_ema = a.get("use_ema", True)
        # the data axis the training step binds (parallel/shard.py)
        self.dp_axis = a.get("dp_axis")
        self.beta = a.get("beta", 0.01)
        self.jitter_p = a.get("jitter_p", 0.0)
        self.pooling_last = a.get("pooling_last", True)
        self.upsample_last = a.get("upsample_last", False)
        self._build_levels(final_decoder=True)
        y_num, y_dim = a.get("y_num", 10), a.get("y_dim", 128)
        for i in range(self.levels):
            setattr(self, f"embeds_{i}", Conditions(y_num, y_dim,
                                                    normalize=False,
                                                    dtype=dtype))
        self.q_args = [dict(a.get(f"quantizer.{i}", {}))
                       for i in range(self.levels)]
        for i, q in enumerate(self.q_args):
            if self._is_gst_level(i):
                self._build_gst(q)
            else:
                self._build_quantizer(i, q)

    def _level_decode(self, i, z_vq, y, time, z_len=None, out_len=None):
        """Decode one level to ``time``-aligned features; ``z_len`` /
        ``out_len`` are the real lengths of a padded batch."""
        if self.upsample_last:
            out = self.decoder(i)(z_vq.to(self.dtype),
                                  nearest_upsample(y, z_vq.shape[1]), z_len)
            dec_len = (None if z_len is None else Decoder.out_lengths(
                self.arch[f"decoder.{i}"], z_len))
            return self._upsample(out, time, dec_len, out_len)
        return self.decoder(i)(
            self._upsample(z_vq, time, z_len, out_len).to(self.dtype),
            nearest_upsample(y, time), out_len)

    def forward(self, x, y_idx, train=True, *, gen=None, ema_state=None,
                level_gens=None):
        """Training/valid forward (unmasked); the keywords as in
        :meth:`.vqvae2.Model.forward`."""
        self._begin_forward(ema_state)
        y_first = y_idx.reshape(y_idx.shape[0], -1)[:, 0]
        time = x.shape[1]
        qut_losses, enc_losses, vq_details = [], [], []
        level_feats = []
        h = x.to(self.dtype)
        for i in range(self.levels):
            z, h = self.encoder(i)(h)
            if self.pooling_last and i == self.levels - 1:
                z = torch.mean(z.float(), dim=1, keepdim=True)
            if self._is_gst_level(i):
                z_vq = self.gst(z.float()[:, 0, :])[:, None, :]
            else:
                z_vq, qut, enc, detail = self._quantize(
                    i, z, train, self._level_gen(gen, level_gens, i))
                qut_losses.append(qut)
                enc_losses.append(enc)
                vq_details.append(self._vq_detail(detail, z, enc))
                if train and self.jitter_p > 0.0:
                    z_vq = jitter_op(gen, z_vq, self.jitter_p,
                                     axis_name=self.dp_axis)
            y = getattr(self, f"embeds_{i}")(y_first)[:, None, :]
            level_feats.append(self._level_decode(i, z_vq, y, time))
        fused = torch.cat(level_feats, dim=-1).to(self.dtype)
        xhat = self.final_decoder(fused, None).float()
        x_loss, z_enc_loss, loss = self._losses(xhat, x, qut_losses,
                                                enc_losses)
        detail = {"Total": loss, "VQ loss": z_enc_loss, "X like": x_loss}
        for i, d in enumerate(vq_details):
            detail.update({f"{k}.{i}": v for k, v in d.items()})
        return xhat, loss, detail

    def encode(self, x, lengths=None):
        """-> tuple over levels: ids (B, T_i) or the style (B, D) of a GST
        top. With ``lengths`` a padded batch gives the unpadded
        per-utterance results."""
        out = []
        h = x.to(self.dtype)
        cur_len = lengths
        for i in range(self.levels):
            z, h = self.encoder(i)(h, cur_len)
            if cur_len is not None:
                cur_len = Encoder.out_lengths(self.arch[f"encoder.{i}"],
                                              cur_len)
            if self.pooling_last and i == self.levels - 1:
                z = self._masked_mean(z.float(), cur_len)
            if self._is_gst_level(i):
                out.append(self.gst(z.float()[:, 0, :]))
            else:
                out.append(self._vq_encode(i, z))
        return tuple(out)

    def decode(self, zs, ys, target_len=None, lengths=None):
        """``ys`` (B,) or (B, levels): per-level speaker ids; ``lengths``
        the real output frame counts."""
        ys = ys.reshape(ys.shape[0], -1)
        if target_len is None:
            # the finest VQ level's length (a GST entry is not temporal)
            target_len = max(zs[i].shape[-1] for i in range(self.levels)
                             if not self._is_gst_level(i))
        z_lens = self._len_chain(lengths)
        level_feats = []
        for i in range(self.levels):
            y = getattr(self, f"embeds_{i}")(
                ys[:, min(i, ys.shape[1] - 1)])[:, None, :]
            if self._is_gst_level(i):
                z_vq = zs[i][:, None, :]
            else:
                z_vq = self._vq_decode(i, zs[i])
            level_feats.append(self._level_decode(i, z_vq, y, target_len,
                                                  z_len=z_lens[i],
                                                  out_len=lengths))
        fused = torch.cat(level_feats, dim=-1).to(self.dtype)
        return self.final_decoder(fused, None, lengths).float()

    def infer(self, x, y_idx, lengths=None):
        return self.decode(self.encode(x, lengths), y_idx,
                           target_len=x.shape[1], lengths=lengths)
