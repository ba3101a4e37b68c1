"""Hierarchical VQ-VAE (v2): stacked encoders, top-down quantize/decode.

Counterpart of ``vae_npvc_tpu/models/vqvae2.py`` (``Model``), same config
keys (``levels``/``use_gst``/``use_ema``/``beta``/``jitter_p``/
``gst_scale_penalty`` and the dotted ``encoder.i``/``quantizer.i``/
``decoder.i``), same parameter names (``encoder_{i}``, ``decoder_{i}``,
``embeds``, ``gst``, ``quantizer_embedding_{i}`` or the EMA banks
``quantizer_{i}``), same casts.

- encoders run bottom-up; each level reads the previous level's
  pre-projection hidden features;
- decoding runs top-down: the top level is quantized (GST over the time
  mean when ``use_gst``, else VQ); each intermediate decoder refines the
  next-finer encoder output conditioned on the concat of all coarser
  quantized latents upsampled to its time scale, and its output is what
  the next quantizer sees;
- the final decoder reads the concat of all quantized levels (coarse ->
  fine) conditioned on the speaker embedding;
- loss = X like + sum(qut) + beta * sum(enc); the per-VQ-level detail keys
  are suffixed ``.0`` (coarsest VQ level) upwards, plus ``quanti_err``,
  ``z_rms`` and, with a GST top, ``gst_in_rms``.

The GST level runs in fp32 under bf16 compute, as in the JAX package; its
single query against the token bank takes the stock softmax (no lengths),
not the attention kernels.
"""

from __future__ import annotations

import torch
from torch import nn

from ..nn.blocks import Conditions
from ..ops.jitter import jitter as jitter_op
from ..ops.upsample import nearest_upsample
from .hier_common import HierVQMixin
from .vqvae import Encoder


class Model(HierVQMixin, nn.Module):
    """forward(x, y_idx, train) -> (xhat, loss, detail); encode(x, lengths)
    -> (ids coarse -> fine, style or None); decode(ids, y_idx, style,
    target_len, lengths) -> mel; infer(x, y_idx, lengths) -> mel."""

    def __init__(self, arch, dtype=torch.float32):
        super().__init__()
        a = dict(arch)
        self.arch, self.dtype = a, dtype
        self.levels = a.get("levels", 3)
        self.use_gst = a.get("use_gst", True)
        self.use_ema = a.get("use_ema", True)
        # the data axis the training step binds (parallel/shard.py)
        self.dp_axis = a.get("dp_axis")
        self.beta = a.get("beta", 0.01)
        self.jitter_p = a.get("jitter_p", 0.0)
        self.gst_scale_penalty = a.get("gst_scale_penalty", 0.0)
        self._build_levels()
        self.embeds = Conditions(a.get("y_num", 10), a.get("y_dim", 128),
                                 normalize=False, dtype=dtype)
        self.q_args = [dict(a.get(f"quantizer.{i}", {}))
                       for i in range(self.levels)]
        for i, q in enumerate(self.q_args):
            if self._is_gst_level(i):
                self._build_gst(q)
            else:
                self._build_quantizer(i, q)

    def _encode_levels(self, x, lengths=None):
        """Bottom-up encoder sweep -> (z per level, padded time per level
        incl. T_x, real length per level or Nones)."""
        z_levels, time_levels = [], [x.shape[1]]
        len_levels = [lengths]
        h = x.to(self.dtype)
        for i in range(self.levels):
            z, h = self.encoder(i)(h, len_levels[-1])
            z_levels.append(z)
            time_levels.append(z.shape[1])
            len_levels.append(
                Encoder.out_lengths(self.arch[f"encoder.{i}"], len_levels[-1])
                if lengths is not None else None)
        return z_levels, time_levels, len_levels

    def forward(self, x, y_idx, train=True, *, gen=None, ema_state=None,
                level_gens=None):
        """Training/valid forward (unmasked). ``gen`` is the step's
        generator (jitter, and each EMA level's draws unless
        ``level_gens`` maps the level to its own); ``ema_state`` overrides
        the EMA banks' states by name (chained microbatches)."""
        self._begin_forward(ema_state)
        y = self.embeds(y_idx.reshape(y_idx.shape[0], -1)[:, 0])[:, None, :]
        z_levels, time_levels, _ = self._encode_levels(x)
        z_vq_levels = []
        qut_losses, enc_losses, vq_details = [], [], []
        gst_in_rms = None
        z_ = z_levels.pop()
        for i in reversed(range(self.levels)):
            if self._is_gst_level(i):
                z32 = z_.float()
                style = self.gst(torch.mean(z32, dim=1))
                z_vq = style[:, None, :]
                gst_in_rms = self._rms(z32)
            else:
                z_vq, qut, enc, detail = self._quantize(
                    i, z_, train, self._level_gen(gen, level_gens, i))
                qut_losses.append(qut)
                enc_losses.append(enc)
                vq_details.append(self._vq_detail(detail, z_, enc))
                if train and self.jitter_p > 0.0:
                    z_vq = jitter_op(gen, z_vq, self.jitter_p,
                                     axis_name=self.dp_axis)
            z_vq_levels.append([nearest_upsample(z_vq, t)
                                for t in time_levels[:i + 1]])
            if i > 0:
                z_ = z_levels.pop()
                cond = torch.cat([lv[i] for lv in z_vq_levels],
                                 dim=-1).to(self.dtype)
                z_ = self.decoder(i)(z_.to(self.dtype), cond)

        z_vq = torch.cat([lv[0] for lv in z_vq_levels], dim=-1).to(self.dtype)
        xhat = self.decoder(0)(z_vq, nearest_upsample(y, time_levels[0]))
        xhat = xhat.float()
        x_loss, z_enc_loss, loss = self._losses(xhat, x, qut_losses,
                                                enc_losses)
        if self.use_gst and self.gst_scale_penalty > 0.0:
            loss = loss + self.gst_scale_penalty * torch.square(
                torch.log(torch.clamp(gst_in_rms, min=1e-12)))
        detail = {"Total": loss, "VQ loss": z_enc_loss, "X like": x_loss}
        if self.use_gst:
            detail["gst_in_rms"] = gst_in_rms
        for idx, d in enumerate(vq_details):
            detail.update({f"{k}.{idx}": v for k, v in d.items()})
        return xhat, loss, detail

    def encode(self, x, lengths=None):
        """-> (ids tuple coarse -> fine for the VQ levels, style (B, D) or
        None), by the deterministic top-down chain. With ``lengths`` a
        zero-padded batch gives the unpadded per-utterance results (ids
        beyond each level's length are garbage)."""
        z_levels, time_levels, len_levels = self._encode_levels(x, lengths)
        ids, style = [], None
        z_vq_levels = []
        z_ = z_levels.pop()
        for i in reversed(range(self.levels)):
            if self._is_gst_level(i):
                style = self.gst(self._masked_mean(
                    z_.float(), len_levels[i + 1], keepdims=False))
                z_vq = style[:, None, :]
                in_len = (None if lengths is None else
                          torch.ones_like(len_levels[i + 1]))
            else:
                idx = self._vq_encode(i, z_)
                ids.append(idx)
                z_vq = self._vq_decode(i, idx)
                in_len = len_levels[i + 1]
            z_vq_levels.append([self._upsample(z_vq, time_levels[j], in_len,
                                               len_levels[j])
                                for j in range(i + 1)])
            if i > 0:
                z_ = z_levels.pop()
                cond = torch.cat([lv[i] for lv in z_vq_levels],
                                 dim=-1).to(self.dtype)
                z_ = self.decoder(i)(z_.to(self.dtype), cond, len_levels[i])
        return tuple(ids), style

    def decode(self, ids, y_idx, style=None, target_len=None, lengths=None):
        """ids (coarse -> fine) + speaker -> mel through the final decoder.
        ``lengths`` are the real output frame counts; the per-level code
        lengths follow from the encoder chain."""
        len_levels = [lengths]
        for i in range(self.levels):
            len_levels.append(
                Encoder.out_lengths(self.arch[f"encoder.{i}"], len_levels[-1])
                if lengths is not None else None)
        levels, level_lens = [], []
        vq_levels = [i for i in reversed(range(self.levels))
                     if not self._is_gst_level(i)]
        if self.use_gst:
            if style is None:
                raise ValueError("a GST hierarchy needs the style embedding")
            levels.append(style[:, None, :])
            level_lens.append(None if lengths is None
                              else torch.ones_like(lengths))
        for lvl, idx in zip(vq_levels, ids):
            levels.append(self._vq_decode(lvl, idx))
            level_lens.append(len_levels[lvl + 1])
        T = target_len if target_len is not None else levels[-1].shape[1]
        z_vq = torch.cat([self._upsample(lv, T, ln, lengths)
                          for lv, ln in zip(levels, level_lens)],
                         dim=-1).to(self.dtype)
        y = self.embeds(y_idx.reshape(y_idx.shape[0], -1)[:, 0])[:, None, :]
        return self.decoder(0)(z_vq, nearest_upsample(y, T), lengths).float()

    def infer(self, x, y_idx, lengths=None):
        ids, style = self.encode(x, lengths)
        return self.decode(ids, y_idx, style=style, target_len=x.shape[1],
                           lengths=lengths)
