"""Hierarchical VQ-VAE v2a: per-level direct quantization, cascaded decode.

Counterpart of ``vae_npvc_tpu/models/vqvae2a.py`` (``Model``), same config
keys and parameter names. Differences from vqvae2:

- every level quantizes its encoder output directly (no intermediate
  decoder before quantization);
- decoding cascades top-down: ``xhat = dec_i(upsample(cat(z_vq_i,
  xhat)))``, or decode first and upsample after (``upsample_last``);
- ``pooling_last`` mean-pools the top level to one frame;
  ``use_quantizers: false`` shares one quantizer (``quantizer`` /
  ``quantizer_embedding``) across levels; ``use_embeds`` gives each level
  its own speaker table (``embeds_{i}``, else one ``embed``), so decode
  can take per-level speakers (``ys[:, i]``).
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
        self.use_quantizers = a.get("use_quantizers", True)
        self.use_embeds = a.get("use_embeds", True)
        self.beta = a.get("beta", 0.01)
        self.jitter_p = a.get("jitter_p", 0.0)
        if self.levels > 1:
            self.pooling_last = (True if self.use_gst
                                 else a.get("pooling_last", True))
        else:
            self.pooling_last = False
        self.upsample_last = a.get("upsample_last", False)
        self._build_levels()
        y_num, y_dim = a.get("y_num", 10), a.get("y_dim", 128)
        if self.use_embeds:
            for i in range(self.levels):
                setattr(self, f"embeds_{i}", Conditions(
                    y_num, y_dim, normalize=False, dtype=dtype))
        else:
            self.embed = Conditions(y_num, y_dim, normalize=False,
                                    dtype=dtype)
        if self.use_quantizers:
            self.q_args = [dict(a.get(f"quantizer.{i}", {}))
                           for i in range(self.levels)]
            for i, q in enumerate(self.q_args):
                if self._is_gst_level(i):
                    self._build_gst(q)
                else:
                    self._build_quantizer(i, q)
        else:
            q = dict(a.get("quantizer", {}))
            self.q_args = [q] * self.levels
            self._build_quantizer(-1, q)

    def _qkey(self, i):
        return i if self.use_quantizers else -1

    def _embed(self, i, y_idx):
        table = getattr(self, f"embeds_{i}") if self.use_embeds \
            else self.embed
        return table(y_idx)[:, None, :]              # (B, 1, y_dim)

    def _encode_quantize(self, x, train, gen=None, level_gens=None):
        """Bottom-up sweep -> z_vq per level, with the losses and detail."""
        z_vq_levels = []
        qut_losses, enc_losses, vq_details = [], [], []
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
            z_vq_levels.append(z_vq)
        return z_vq_levels, qut_losses, enc_losses, vq_details

    def _decode_cascade(self, z_vq_levels, y_per_level, target_len,
                        z_lens=None, out_len=None):
        """Top-down decode; ``y_per_level[i]`` is level i's (B, 1, y_dim)
        condition, ``z_lens[i]``/``out_len`` the real lengths of a padded
        batch."""
        if z_lens is None:
            z_lens = [None] * self.levels
        xhat, cur_len = None, None
        for i in reversed(range(self.levels)):
            if i == self.levels - 1:
                xhat = z_vq_levels[i]
                cur_len = z_lens[i]
            else:
                xhat = torch.cat([z_vq_levels[i], xhat], dim=-1)
            if i == 0:
                t_next, ln_next = target_len, out_len
            else:
                t_next, ln_next = z_vq_levels[i - 1].shape[1], z_lens[i - 1]
            y = y_per_level[i]
            dec_arch = self.arch[f"decoder.{i}"]
            if self.upsample_last:
                xhat = self.decoder(i)(xhat.to(self.dtype),
                                       nearest_upsample(y, xhat.shape[1]),
                                       cur_len)
                dec_len = (None if cur_len is None
                           else Decoder.out_lengths(dec_arch, cur_len))
                xhat = self._upsample(xhat, t_next, dec_len, ln_next)
            else:
                xhat = self.decoder(i)(
                    self._upsample(xhat, t_next, cur_len,
                                   ln_next).to(self.dtype),
                    nearest_upsample(y, t_next), ln_next)
                ln_next = (None if ln_next is None
                           else Decoder.out_lengths(dec_arch, ln_next))
            cur_len = ln_next
        return xhat

    def forward(self, x, y_idx, train=True, *, gen=None, ema_state=None,
                level_gens=None):
        """Training/valid forward (unmasked); the keywords as in
        :meth:`.vqvae2.Model.forward`."""
        self._begin_forward(ema_state)
        y_first = y_idx.reshape(y_idx.shape[0], -1)[:, 0]
        z_vq_levels, qut_losses, enc_losses, vq_details = \
            self._encode_quantize(x, train, gen, level_gens)
        y_per_level = [self._embed(i, y_first) for i in range(self.levels)]
        xhat = self._decode_cascade(z_vq_levels, y_per_level,
                                    x.shape[1]).float()
        x_loss, z_enc_loss, loss = self._losses(xhat, x, qut_losses,
                                                enc_losses)
        detail = {"Total": loss, "VQ loss": z_enc_loss, "X like": x_loss}
        for i, d in enumerate(vq_details):
            detail.update({f"{k}.{i}": v for k, v in d.items()})
        return xhat, loss, detail

    def encode(self, x, lengths=None):
        """-> tuple over levels (fine -> coarse): ids (B, T_i), or the
        style embedding (B, D) of a GST top. With ``lengths`` a padded
        batch gives the unpadded per-utterance results."""
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
        """``zs`` from :meth:`encode`; ``ys`` (B,) or (B, levels) speaker
        ids per level; ``lengths`` the real output frame counts."""
        ys = ys.reshape(ys.shape[0], -1)
        z_vq_levels = []
        for i in range(self.levels):
            if self._is_gst_level(i):
                z_vq_levels.append(zs[i][:, None, :])
            else:
                z_vq_levels.append(self._vq_decode(i, zs[i]))
        if target_len is None:
            target_len = z_vq_levels[0].shape[1]
        y_per_level = [self._embed(i, ys[:, min(i, ys.shape[1] - 1)])
                       for i in range(self.levels)]
        return self._decode_cascade(z_vq_levels, y_per_level, target_len,
                                    z_lens=self._len_chain(lengths),
                                    out_len=lengths).float()

    def infer(self, x, y_idx, lengths=None):
        return self.decode(self.encode(x, lengths), y_idx,
                           target_len=x.shape[1], lengths=lengths)
