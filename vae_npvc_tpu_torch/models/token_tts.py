"""Token->mel synthesizer (non-autoregressive, FastSpeech2-style).

Counterpart of ``vae_npvc_tpu/models/token_tts.py`` (``TransformerBlock``,
``length_regulate``, ``mel_pitch_proxy``, ``mel_energy``, ``Model``), same
config keys, parameter names, channels-last layout and casts:

  token embed (+ speaker condition) -> encoder -> duration predictor
  -> length regulation (true durations in training, predicted in ``infer``)
  -> variance adaptor (pitch + energy predictors)
  -> decoder -> mel -> conv postnet residual

``block_type: transformer`` runs pre-LN self-attention blocks whose
attention core is :func:`..ops.attention.fused_attention` (12 launches per
``infer`` with 6 + 6 blocks, and as many backward launches per training
step); ``block_type: conv`` runs ``ConvResStack``s (the GroupNorm kernels).
``block_type: tacotron2`` (the autoregressive family) is not ported yet and
raises.

Speaker conditioning: int ids go through a learned table (``spk_embed``);
with ``use_spk_embed: true`` the model instead holds ``spk_emb_proj``, a
Dense layer over continuous (B, ``spk_embed_dim``) embeddings. The JAX
module creates whichever of the two its first input calls for; the port
decides from the config, since its parameters exist before any input.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.blocks import (Conditions, ConvResStack, Dense, Embed, LayerNorm,
                         WNConv1d, init_parameters, length_mask,
                         sinusoidal_positions)
from ..nn.gst import MultiHeadedAttention

LOG_2PI = math.log(2.0 * math.pi)

_TACOTRON2 = ("block_type 'tacotron2' (Tacotron2Net, the autoregressive "
              "token->mel family) is not ported to PyTorch yet (ROADMAP "
              "Queue A item 6, token TTS: Tacotron2 family)")


class TransformerBlock(nn.Module):
    """Pre-LN self-attention + FFN with key-padding masking. LayerNorm
    statistics and the attention softmax are fp32 whatever ``dtype``."""

    def __init__(self, hidden, heads, ffn, dtype=torch.float32,
                 fused_attention="auto"):
        super().__init__()
        self.dtype = dtype
        self.ln_attn = LayerNorm(hidden)
        self.mha = MultiHeadedAttention(heads, hidden, dtype=dtype,
                                        fused=fused_attention)
        self.ln_ffn = LayerNorm(hidden)
        self.ffn_in = Dense(hidden, ffn, dtype)
        self.ffn_out = Dense(ffn, hidden, dtype)

    def forward(self, x, mask):
        """x: (B, T, hidden); mask: (B, T, 1), 1 on the valid length
        prefix. Padded keys are left out of every softmax."""
        lengths = (mask[:, :, 0] > 0).sum(dim=1).to(torch.int32)
        h = self.ln_attn(x).to(self.dtype)
        h = self.mha(h, h, h, lengths=lengths)
        x = x + h * mask.to(h.dtype)
        h = self.ln_ffn(x).to(self.dtype)
        h = self.ffn_out(F.relu(self.ffn_in(h)))
        return x + h * mask.to(h.dtype)


def length_regulate(enc, durations, max_frames):
    """Expand (B, L, C) token features to (B, T, C) frames by durations:
    frame t takes the token whose cumulative-duration interval holds t
    (frames past the total repeat the last token; the caller masks them)."""
    cum = torch.cumsum(durations.long(), dim=1)               # (B, L)
    t = torch.arange(max_frames, device=enc.device)
    # index of the first token with cum > t
    frame_tok = torch.searchsorted(
        cum, t[None, :].expand(cum.shape[0], -1).contiguous(), right=True)
    frame_tok = frame_tok.clamp(max=enc.shape[1] - 1)
    return torch.gather(enc, 1,
                        frame_tok[:, :, None].expand(-1, -1, enc.shape[2]))


def mel_pitch_proxy(mel):
    """(B, T, D) mel -> (B, T) spectral-centroid pitch proxy in [0, 1]."""
    p = torch.softmax(mel.float(), dim=-1)
    bins = torch.linspace(0.0, 1.0, mel.shape[-1], device=mel.device)
    return (p * bins).sum(dim=-1)


def mel_energy(mel):
    """(B, T, D) mel -> (B, T) per-frame mean log-mel energy."""
    return mel.float().mean(dim=-1)


class Model(nn.Module):
    """Token->mel synthesizer.

      forward(tokens, durations, mels, y, tok_lens, mel_lens, train)
                                        -> (mel_hat, loss, detail)
      infer(tokens, y, tok_lens, max_frames=None) -> (mel, mel_lens)

    ``y`` is (B,) int speaker ids, or (B, E) float speaker embeddings when
    the config says ``use_spk_embed: true``.
    """

    use_ema = False       # no EMA collection: the trainer commits none
    pending_ema = None

    def __init__(self, arch, dtype=torch.float32):
        super().__init__()
        a = dict(arch)
        self.arch = a
        self.dtype = dtype
        self.token_num = a.get("token_num", a.get("z_num", 128))
        self.token_dim = a.get("token_dim", 128)
        self.block_type = a.get("block_type", "conv")
        fused = a.get("fused_attention", "auto")
        if self.block_type == "transformer":
            self.hidden = a.get("adim", a.get("hidden", 256))
            self.heads = a.get("aheads", 4)
            self.enc_stacks = a.get("elayers", a.get("enc_stacks", 4))
            self.dec_stacks = a.get("dlayers", a.get("dec_stacks", 4))
            eunits = a.get("eunits", 4 * self.hidden)
            dunits = a.get("dunits", 4 * self.hidden)
        elif self.block_type == "conv":
            self.hidden = a.get("hidden", 256)
            self.enc_stacks = a.get("enc_stacks", 4)
            self.dec_stacks = a.get("dec_stacks", 4)
            eunits = dunits = None
        elif self.block_type == "tacotron2":
            raise NotImplementedError(_TACOTRON2)
        else:
            raise ValueError(f"unknown block_type {self.block_type!r}")
        self.mel_dim = a.get("mel_dim", 80)
        self.postnet_layers = a.get("postnet_layers", 3)
        self.use_variance = a.get("variance_predictor", True)
        self.dur_weight = a.get("dur_weight", 0.1)
        self.var_weight = a.get("var_weight", 0.1)
        self.max_frames = a.get("max_frames", 512)
        self.y_dim = a.get("y_dim", 128)
        H, dt = self.hidden, dtype

        def conv(cin, cout, k):
            return WNConv1d(cin, cout, k, dtype=dt)

        def block(j, units):
            if self.block_type == "transformer":
                return TransformerBlock(H, self.heads, units, dtype=dt,
                                        fused_attention=fused)
            return ConvResStack(H, 3, layers=1, dilation=2 ** (j % 3),
                                dtype=dt)

        self.tok_embed = Embed(self.token_num, self.token_dim)
        if a.get("use_spk_embed", False):
            self.spk_emb_proj = Dense(a.get("spk_embed_dim", 64), self.y_dim,
                                      dt)
        else:
            self.spk_embed = Conditions(a.get("y_num", 10), self.y_dim,
                                        normalize=False, dtype=dt)
        self.enc_in = conv(self.token_dim, H, 1)
        self.spk_proj_enc = conv(self.y_dim, H, 1)
        for j in range(self.enc_stacks):
            setattr(self, f"enc_{j}", block(j, eunits))
        names = ["dur"] + (["pitch", "energy"] if self.use_variance else [])
        for name in names:
            setattr(self, f"{name}_0", conv(H, H // 2, 3))
            setattr(self, f"{name}_1", conv(H // 2, 1, 1))
        if self.use_variance:
            self.pitch_proj = conv(1, H, 1)
            self.energy_proj = conv(1, H, 1)
        self.spk_proj = conv(self.y_dim, H, 1)
        for j in range(self.dec_stacks):
            setattr(self, f"dec_{j}", block(j, dunits))
        self.mel_out = conv(H, self.mel_dim, 1)
        for j in range(self.postnet_layers):
            last = j == self.postnet_layers - 1
            setattr(self, f"postnet_{j}", conv(
                self.mel_dim if j == 0 else H // 2,
                self.mel_dim if last else H // 2, 5))

    def init_random(self, seed):
        """Seeded random weights."""
        init_parameters(self, seed)
        return self

    def _speaker_vector(self, y):
        """(B,) int ids -> table lookup; (B, E) float -> Dense projection."""
        if y.is_floating_point():
            if not hasattr(self, "spk_emb_proj"):
                raise ValueError(
                    "float speaker embeddings need a model built with "
                    "use_spk_embed: true (and spk_embed_dim)")
            return self.spk_emb_proj(y.reshape(y.shape[0], -1).to(self.dtype))
        if not hasattr(self, "spk_embed"):
            raise ValueError("this model was built with use_spk_embed: true "
                             "and takes float speaker embeddings, not ids")
        return self.spk_embed(y.reshape(y.shape[0], -1)[:, 0])

    def _predictor(self, h, name):
        d = getattr(self, f"{name}_1")(F.relu(getattr(self, f"{name}_0")(h)))
        return d[..., 0].float()

    def _stack(self, h, prefix, n, lengths, mask):
        """The encoder or decoder blocks over the masked input."""
        if self.block_type == "transformer":
            pos = sinusoidal_positions(h.shape[1], self.hidden, h.device)
            h = (h + pos[None].to(h.dtype)) * mask.to(h.dtype)
            for j in range(n):
                h = getattr(self, f"{prefix}_{j}")(h, mask)
            return h
        # the embed and speaker biases make padded positions nonzero, and a
        # ConvResStack masks only its statistics and output: zero its input
        # too, or the dilated convs pull padding into valid frames
        h = h * mask.to(h.dtype)
        for j in range(n):
            h = getattr(self, f"{prefix}_{j}")(h, lengths)
        return h

    def _network(self, tokens, durations, y, tok_lens, mel_frames,
                 use_true_dur, target_mel=None):
        B, L = tokens.shape
        tok_mask = length_mask(tok_lens, L)
        h = self.tok_embed(tokens).to(self.dtype) * tok_mask
        h = self.enc_in(h)
        # the speaker condition enters the encoder too, so durations and
        # variance can depend on the speaker
        spk = self._speaker_vector(y)
        h = h + self.spk_proj_enc(spk[:, None, :])
        enc = self._stack(h, "enc", self.enc_stacks, tok_lens, tok_mask)

        # duration predictor on detached encodings (FastSpeech convention)
        log_dur_pred = self._predictor(enc.detach(), "dur")

        if use_true_dur:
            durs = durations
        else:
            durs = torch.clamp(torch.round(torch.expm1(log_dur_pred)), min=1)
            durs = (durs * tok_mask[..., 0]).to(torch.int32)
        frames = length_regulate(enc, durs, mel_frames)

        mel_lens = torch.clamp(durs.sum(dim=1), max=mel_frames)
        mel_mask = length_mask(mel_lens, mel_frames)
        # length_regulate fills frames beyond sum(durs) with the last
        # token's encoding: mask them, so the variance predictors'
        # kernel-3 convs do not read past mel_lens
        frames = frames * mel_mask.to(frames.dtype)

        pitch_pred = energy_pred = None
        if self.use_variance:
            vin = frames.detach()
            pitch_pred = self._predictor(vin, "pitch")        # (B, T)
            energy_pred = self._predictor(vin, "energy")      # (B, T)
            if target_mel is not None:
                pitch_c = mel_pitch_proxy(target_mel)
                energy_c = mel_energy(target_mel)
            else:
                pitch_c, energy_c = pitch_pred, energy_pred
            frames = frames \
                + self.pitch_proj(pitch_c[..., None].to(self.dtype)) \
                + self.energy_proj(energy_c[..., None].to(self.dtype))

        h = frames + self.spk_proj(spk[:, None, :])
        h = self._stack(h, "dec", self.dec_stacks, mel_lens, mel_mask)
        mel_pre = self.mel_out(h).float() * mel_mask

        if self.postnet_layers > 0:
            p = mel_pre.to(self.dtype)
            for j in range(self.postnet_layers):
                p = getattr(self, f"postnet_{j}")(p)
                if j < self.postnet_layers - 1:
                    p = torch.tanh(p) * mel_mask.to(p.dtype)
            mel = mel_pre + p.float() * mel_mask
        else:
            mel = mel_pre
        return (mel, mel_pre, log_dur_pred, pitch_pred, energy_pred,
                mel_lens, mel_mask)

    def forward(self, tokens, durations, mels, y_idx, tok_lens, mel_lens,
                train=True, *, gen=None):
        """Training/valid forward: masked frame-mean Gaussian NLL on the
        postnet and pre-postnet mels + ``dur_weight`` * MSE(log durations)
        + ``var_weight`` * (MSE(pitch) + MSE(energy)). ``gen`` is the
        trainer's step generator; this family draws nothing from it."""
        B, T, D = mels.shape
        mel_hat, mel_pre, log_dur_pred, pitch_pred, energy_pred, _, _ = \
            self._network(tokens, durations, y_idx, tok_lens, T,
                          use_true_dur=True, target_mel=mels)

        mel_mask = length_mask(mel_lens, T)
        n_frames = torch.clamp(mel_lens.sum(), min=1)
        x_loss = torch.sum(0.5 * (LOG_2PI + (mels - mel_hat) ** 2)
                           * mel_mask) / (n_frames * 1.0)
        x_pre = torch.sum(0.5 * (LOG_2PI + (mels - mel_pre) ** 2)
                          * mel_mask) / (n_frames * 1.0)

        tok_mask = length_mask(tok_lens, tokens.shape[1])[..., 0]
        dur_target = torch.log1p(durations.float())
        dur_loss = torch.sum((log_dur_pred - dur_target) ** 2 * tok_mask) \
            / torch.clamp(tok_mask.sum(), min=1)

        loss = x_loss + x_pre + self.dur_weight * dur_loss
        detail = {"X like": x_loss, "X pre like": x_pre,
                  "DUR loss": dur_loss}
        if self.use_variance:
            fmask = mel_mask[..., 0]
            nf = torch.clamp(fmask.sum(), min=1)
            p_loss = torch.sum((pitch_pred - mel_pitch_proxy(mels)) ** 2
                               * fmask) / nf
            e_loss = torch.sum((energy_pred - mel_energy(mels)) ** 2
                               * fmask) / nf
            loss = loss + self.var_weight * (p_loss + e_loss)
            detail["PITCH loss"] = p_loss
            detail["ENERGY loss"] = e_loss
        detail["Total"] = loss
        return mel_hat, loss, detail

    def infer(self, tokens, y_idx, tok_lens, max_frames=None):
        """-> (mel (B, T, D), mel_lens) with predicted durations and
        variance. ``y_idx``: int speaker ids (B,) or float speaker
        embeddings (B, E)."""
        T = max_frames or self.max_frames
        out = self._network(tokens, torch.zeros_like(tokens), y_idx,
                            tok_lens, T, use_true_dur=False)
        return out[0], out[5]
