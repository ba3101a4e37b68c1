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
``block_type: tacotron2`` is the autoregressive family (``Tacotron2Net``):
a conv + BiLSTM encoder, a prenet + location-sensitive attention + LSTM
decoder stepped over ``T / r`` groups, a stop-token head and a conv
postnet, on no kernel of the port's own (its attention is additive, one
query per step; the LSTMs are torch's). The JAX package scans the decoder
in one compiled loop; the port steps it from Python, one group per step,
teacher-forced in training and free-running in ``infer``.

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

from ..nn.blocks import (Conditions, Conv, ConvResStack, Dense, Embed,
                         LayerNorm, WNConv1d, init_parameters, length_mask,
                         sinusoidal_positions)
from ..nn.gst import MultiHeadedAttention
from ..nn.rnn import LSTM
from ..parallel.shard import count_share, local_rows

LOG_2PI = math.log(2.0 * math.pi)


def bernoulli(gen, p, shape, device):
    """A bool mask, True with probability ``p``, drawn from ``gen``: every
    dropout and zoneout mask of ``Tacotron2Net``."""
    return torch.rand(shape, generator=gen, device=device) < p


def _mask(gen, p, shape, device, axis_name):
    """:func:`bernoulli` of this rank's rows of the global batch's mask
    (``axis_name``: the bound data axis, as JAX draws a sharded batch's
    masks whole)."""
    return local_rows(lambda s: bernoulli(gen, p, s, device), shape,
                      axis_name)


def _dropout(gen, h, rate, axis_name=None):
    keep = _mask(gen, 1.0 - rate, h.shape, h.device, axis_name)
    return torch.where(keep, h / (1.0 - rate), torch.zeros_like(h))


class Tacotron2Net(nn.Module):
    """Tacotron2-style autoregressive token->mel network (the JAX
    ``Tacotron2Net``, same keys, dashed or not, and flax's layer names).

      forward(tokens, y, tok_lens, mels=None, mel_lens=None,
              max_frames=None, train=True, free_run=False, gen=None)
          -> (mel (B, T, D), mel_pre, stop_logits (B, T))

    Random draws come from ``gen`` only: the encoder convs' dropout and the
    decoder LSTMs' zoneout when ``train`` and ``gen`` is given, the
    prenet's dropout whenever ``gen`` is given (in ``infer`` too, as in
    JAX). Without ``gen`` nothing is drawn.
    """

    def __init__(self, cfg, mel_dim, y_num, dtype=torch.float32):
        super().__init__()

        def a(name, default):
            return cfg.get(name, cfg.get(name.replace("-", "_"), default))

        self.mel_dim, self.dtype = mel_dim, dtype
        embed_dim = a("embed-dim", 512)
        self.econv_layers = a("econv-layers", 3)
        econv_chans = a("econv-chans", 512)
        econv_filts = a("econv-filts", 5)
        eunits = a("eunits", 512)
        self.postnet_layers = a("postnet-layers", 5)
        postnet_chans = a("postnet-chans", 512)
        postnet_filts = a("postnet-filts", 5)
        self.r = a("reduction-factor", 2)
        self.dropout = a("dropout-rate", 0.5)
        self.dp_axis = cfg.get("dp_axis")

        self.tok_embed = Embed(a("token_num", 128), embed_dim)
        cin = embed_dim
        for j in range(self.econv_layers):
            setattr(self, f"econv_{j}", Conv(cin, econv_chans, econv_filts,
                                             dtype=dtype))
            setattr(self, f"enorm_{j}", LayerNorm(econv_chans))
            cin = econv_chans
        half = eunits // 2
        # the BiLSTM's directions under flax's names: the two cells of its
        # nn.RNNs sit at this level, forward first
        self.OptimizedLSTMCell_0 = LSTM(cin, half)
        self.OptimizedLSTMCell_1 = LSTM(cin, half)
        if cfg.get("use_spk_embed", False):
            self.spk_proj = Dense(cfg.get("spk_embed_dim", 64), 2 * half)
        else:
            self.spk_embed = Embed(y_num, 2 * half)
        self.att_enc_proj = Dense(2 * half, a("adim", 128), bias=False)
        self.dec_cell = Tacotron2Cell(
            enc_dim=2 * half, dunits=a("dunits", 1024),
            dlayers=a("dlayers", 2), prenet_layers=a("prenet-layers", 2),
            prenet_units=a("prenet-units", 256), adim=a("adim", 128),
            aconv_chans=a("aconv-chans", 32),
            aconv_filts=a("aconv-filts", 15),
            mel_dim=mel_dim, r=self.r, cumulate=a("cumulate-att-w", True),
            use_concate=a("use-concate", True),
            zoneout=a("zoneout-rate", 0.1), dropout=self.dropout,
            dtype=dtype, dp_axis=self.dp_axis)
        for j in range(self.postnet_layers):
            last = j == self.postnet_layers - 1
            setattr(self, f"postnet_{j}", Conv(
                mel_dim if j == 0 else postnet_chans,
                mel_dim if last else postnet_chans, postnet_filts,
                dtype=dtype))

    def _speaker(self, y, B, dtype):
        if y.is_floating_point():
            if not hasattr(self, "spk_proj"):
                raise ValueError(
                    "float speaker embeddings need a model built with "
                    "use_spk_embed: true (and spk_embed_dim)")
            return self.spk_proj(y.reshape(B, -1).to(dtype))
        if not hasattr(self, "spk_embed"):
            raise ValueError("this model was built with use_spk_embed: true "
                             "and takes float speaker embeddings, not ids")
        return self.spk_embed(y.reshape(B, -1)[:, 0]).to(dtype)

    def encode(self, tokens, y, tok_lens, train=True, gen=None):
        """-> (hs (B, L, eunits) fp32, keys_proj (B, L, adim), kmask (B, L)
        bool)."""
        B, L = tokens.shape
        tok_mask = length_mask(tok_lens, L)
        h = self.tok_embed(tokens).to(self.dtype) * tok_mask
        for j in range(self.econv_layers):
            h = getattr(self, f"econv_{j}")(h * tok_mask.to(h.dtype))
            h = getattr(self, f"enorm_{j}")(h).to(self.dtype)
            h = F.relu(h)
            if gen is not None and train and self.dropout > 0:
                h = _dropout(gen, h, self.dropout, self.dp_axis)
        # BiLSTM: a forward pass and an index-flipped backward pass, so a
        # padded batch equals the unpadded rows
        fwd = self.OptimizedLSTMCell_0(h.float())[0]
        t = torch.arange(L, device=h.device)[None, :]
        flip = torch.clamp(tok_lens.long()[:, None] - 1 - t, 0, L - 1)
        bwd = self.OptimizedLSTMCell_1(_rows_of(h, flip).float())[0]
        bwd = _rows_of(bwd, flip)
        hs = torch.cat([fwd, bwd], dim=-1) * tok_mask
        hs = (hs + self._speaker(y, B, hs.dtype)[:, None, :]) * tok_mask
        return hs, self.att_enc_proj(hs), tok_mask[..., 0] > 0

    def forward(self, tokens, y, tok_lens, mels=None, mel_lens=None,
                max_frames=None, train=True, free_run=False, gen=None):
        B = tokens.shape[0]
        hs, keys_proj, kmask = self.encode(tokens, y, tok_lens, train, gen)
        r, D = self.r, self.mel_dim
        T = int(max_frames) if free_run else mels.shape[1]
        pad = (-T) % r
        Tr = (T + pad) // r
        if free_run:
            teacher = None
        else:
            last = F.pad(mels.float(), (0, 0, 0, pad))[:, r - 1::r]
            teacher = torch.cat([last.new_zeros((B, 1, D)), last[:, :-1]],
                                dim=1)                        # (B, Tr, D)

        # initial state: uniform attention over the valid keys, zero LSTM
        # state, zero previous frame
        km = kmask.float()
        w0 = km / torch.clamp(km.sum(dim=1, keepdim=True), min=1)
        cell = self.dec_cell
        zeros = hs.new_zeros((B, cell.dunits), dtype=torch.float32)
        carry = {"att_w": w0, "att_w_cum": w0,
                 "c": [zeros] * cell.dlayers, "h": [zeros] * cell.dlayers,
                 "prev": hs.new_zeros((B, D), dtype=torch.float32)}
        groups, stops = [], []
        for t in range(Tr):
            prev = carry["prev"] if free_run else teacher[:, t]
            carry, group, stop = cell(carry, prev, hs, keys_proj, kmask,
                                      train, gen)
            groups.append(group)
            stops.append(stop)
        mel_pre = torch.stack(groups, dim=1).reshape(B, Tr * r, D)[:, :T] \
            .float()
        stop_logits = torch.stack(stops, dim=1).reshape(B, Tr * r)[:, :T] \
            .float()

        # the postnet reads masked input: the decoder runs over padded
        # steps, and the postnet's receptive field would carry them into
        # the last valid frames
        if mel_lens is not None:
            mel_mask = length_mask(mel_lens, T)
            mel_pre = mel_pre * mel_mask
            stop_logits = stop_logits * mel_mask[..., 0]
        p = mel_pre.to(self.dtype)
        for j in range(self.postnet_layers):
            p = getattr(self, f"postnet_{j}")(p)
            if j < self.postnet_layers - 1:
                p = torch.tanh(p)
                if mel_lens is not None:
                    p = p * mel_mask.to(p.dtype)
        mel = mel_pre + p.float()
        if mel_lens is not None:
            mel = mel * mel_mask
        return mel, mel_pre, stop_logits


class Tacotron2Cell(nn.Module):
    """One decoder step (the JAX ``_Tacotron2Cell``): prenet -> location-
    sensitive attention -> LSTM stack (zoneout in training) -> frame group
    and stop logits. The attention query is the first LSTM layer's hidden
    state of the previous step; the LSTM input is ``[context, prenet]``;
    the heads read ``[top hidden, context]`` with ``use-concate``."""

    def __init__(self, enc_dim, dunits, dlayers, prenet_layers, prenet_units,
                 adim, aconv_chans, aconv_filts, mel_dim, r, cumulate,
                 use_concate, zoneout, dropout, dtype=torch.float32,
                 dp_axis=None):
        super().__init__()
        self.dunits, self.dlayers = dunits, dlayers
        self.dp_axis = dp_axis
        self.prenet_layers, self.mel_dim, self.r = prenet_layers, mel_dim, r
        self.cumulate, self.use_concate = cumulate, use_concate
        self.zoneout, self.dropout, self.dtype = zoneout, dropout, dtype
        cin = mel_dim
        for j in range(prenet_layers):
            setattr(self, f"prenet_{j}", Dense(cin, prenet_units))
            cin = prenet_units
        self.loc_conv = Conv(1, aconv_chans, 2 * aconv_filts + 1, bias=False,
                             dtype=dtype)
        self.att_loc_proj = Dense(aconv_chans, adim, bias=False)
        self.att_query_proj = Dense(dunits, adim, bias=False)
        self.att_v = Dense(adim, 1, bias=False)
        x_dim = enc_dim + cin
        for l in range(dlayers):
            setattr(self, f"lstm_{l}", LSTM(x_dim, dunits))
            x_dim = dunits
        z_dim = dunits + enc_dim if use_concate else dunits
        self.feat_out = Dense(z_dim, mel_dim * r, bias=False)
        self.prob_out = Dense(z_dim, r)

    def forward(self, carry, prev, hs, keys_proj, kmask, train, gen):
        """-> (new carry, group (B, r*D), stop logits (B, r))."""
        p = prev.to(self.dtype)
        for j in range(self.prenet_layers):
            p = F.relu(getattr(self, f"prenet_{j}")(p))
            if gen is not None and self.dropout > 0:
                p = _dropout(gen, p, self.dropout, self.dp_axis)

        att_prev = carry["att_w_cum"] if self.cumulate else carry["att_w"]
        f = self.att_loc_proj(self.loc_conv(att_prev[..., None]))
        q = self.att_query_proj(carry["h"][0])[:, None, :]
        e = self.att_v(torch.tanh(q + keys_proj + f))[..., 0]
        e = torch.where(kmask, e.float(), torch.full_like(e, -1e9,
                                                          dtype=torch.float32))
        att_w = torch.softmax(e, dim=-1) * kmask
        context = torch.einsum("bl,blc->bc", att_w.to(hs.dtype), hs)

        x = torch.cat([context.float(), p.float()], dim=-1)
        cs, hs_new = [], []
        for l in range(self.dlayers):
            c_old, h_old = carry["c"][l], carry["h"][l]
            c_new, h_new = getattr(self, f"lstm_{l}").step((c_old, h_old),
                                                           x)
            if train and gen is not None and self.zoneout > 0:
                kc = _mask(gen, self.zoneout, c_new.shape, c_new.device,
                           self.dp_axis)
                kh = _mask(gen, self.zoneout, h_new.shape, h_new.device,
                           self.dp_axis)
                c_new = torch.where(kc, c_old, c_new)
                h_new = torch.where(kh, h_old, h_new)
            cs.append(c_new)
            hs_new.append(h_new)
            x = h_new

        zcs = (torch.cat([hs_new[-1], context.float()], dim=-1)
               if self.use_concate else hs_new[-1]).to(self.dtype)
        group = self.feat_out(zcs)
        stop = self.prob_out(zcs)
        new = {"att_w": att_w,
               "att_w_cum": carry["att_w_cum"] + att_w if self.cumulate
               else att_w,
               "c": cs, "h": hs_new,
               "prev": group.float()[:, -self.mel_dim:]}
        return new, group, stop


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


def _rows_of(x, idx):
    """``x[b, idx[b, t]]`` for (B, L, ...) ``x`` and (B, T) ``idx``: the
    same values as ``torch.gather`` along dim 1, with a backward that sums
    repeated rows in a fixed order on the card (``gather``'s backward adds
    them with atomics, so a step would not repeat bit for bit)."""
    b = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[b, idx]


def length_regulate(enc, durations, max_frames):
    """Expand (B, L, C) token features to (B, T, C) frames by durations:
    frame t takes the token whose cumulative-duration interval holds t
    (frames past the total repeat the last token; the caller masks them)."""
    cum = torch.cumsum(durations.long(), dim=1)               # (B, L)
    t = torch.arange(max_frames, device=enc.device)
    # index of the first token with cum > t
    frame_tok = torch.searchsorted(
        cum, t[None, :].expand(cum.shape[0], -1).contiguous(), right=True)
    return _rows_of(enc, frame_tok.clamp(max=enc.shape[1] - 1))


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
        # the data axis the training step binds: the losses' denominators
        # count every rank's frames and tokens (parallel/shard.py)
        self.dp_axis = a.get("dp_axis")
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
            # the network and its keys are Tacotron2Net's; the NAR layers
            # below are not built (flax creates no parameters for them)
            self.mel_dim = a.get("mel_dim", 80)
            self.max_frames = a.get("max_frames", 512)
            self.bce_pos_weight = a.get("bce-pos-weight",
                                        a.get("bce_pos_weight", 3.0))
            self.tac2 = Tacotron2Net(dict(a, token_num=self.token_num),
                                     self.mel_dim, a.get("y_num", 10), dtype)
            return
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

    def _denominators(self, *counts):
        """The masked means' denominators, fp32, each floored at 1: the
        batch's counts, or with ``dp_axis`` this rank's share of the global
        batch's (``parallel.shard.count_share``: the axis mean of the
        ranks' losses is then the global batch's masked mean, as JAX's
        sums over a sharded batch are global)."""
        return count_share(torch.stack([c.float() for c in counts]),
                           self.dp_axis).unbind()

    def forward(self, tokens, durations, mels, y_idx, tok_lens, mel_lens,
                train=True, *, gen=None):
        """Training/valid forward: masked frame-mean Gaussian NLL on the
        postnet and pre-postnet mels + ``dur_weight`` * MSE(log durations)
        + ``var_weight`` * (MSE(pitch) + MSE(energy)). ``gen`` is the
        trainer's step generator; this family draws nothing from it."""
        if self.block_type == "tacotron2":
            # durations are unused: the attention learns the alignment
            return self._tacotron_loss(tokens, mels, y_idx, tok_lens,
                                       mel_lens, train, gen)
        B, T, D = mels.shape
        mel_hat, mel_pre, log_dur_pred, pitch_pred, energy_pred, _, _ = \
            self._network(tokens, durations, y_idx, tok_lens, T,
                          use_true_dur=True, target_mel=mels)

        mel_mask = length_mask(mel_lens, T)
        tok_mask = length_mask(tok_lens, tokens.shape[1])[..., 0]
        fmask = mel_mask[..., 0]
        n_frames, n_tokens, nf = self._denominators(
            mel_lens.sum(), tok_mask.sum(), fmask.sum())
        x_loss = torch.sum(0.5 * (LOG_2PI + (mels - mel_hat) ** 2)
                           * mel_mask) / n_frames
        x_pre = torch.sum(0.5 * (LOG_2PI + (mels - mel_pre) ** 2)
                          * mel_mask) / n_frames

        dur_target = torch.log1p(durations.float())
        dur_loss = torch.sum((log_dur_pred - dur_target) ** 2 * tok_mask) \
            / n_tokens

        loss = x_loss + x_pre + self.dur_weight * dur_loss
        detail = {"X like": x_loss, "X pre like": x_pre,
                  "DUR loss": dur_loss}
        if self.use_variance:
            p_loss = torch.sum((pitch_pred - mel_pitch_proxy(mels)) ** 2
                               * fmask) / nf
            e_loss = torch.sum((energy_pred - mel_energy(mels)) ** 2
                               * fmask) / nf
            loss = loss + self.var_weight * (p_loss + e_loss)
            detail["PITCH loss"] = p_loss
            detail["ENERGY loss"] = e_loss
        detail["Total"] = loss
        return mel_hat, loss, detail

    def _tacotron_loss(self, tokens, mels, y_idx, tok_lens, mel_lens,
                       train, gen):
        """Teacher-forced forward: Gaussian NLL on the postnet and
        pre-postnet mels + the stop BCE with ``bce-pos-weight`` on the
        last valid frame."""
        B, T, D = mels.shape
        mel_hat, mel_pre, stop_logits = self.tac2(
            tokens, y_idx, tok_lens, mels=mels, mel_lens=mel_lens,
            train=train, gen=gen)
        mel_mask = length_mask(mel_lens, T)
        fmask = mel_mask[..., 0]
        n_frames, nf = self._denominators(mel_lens.sum(), fmask.sum())
        x_loss = torch.sum(0.5 * (LOG_2PI + (mels - mel_hat) ** 2)
                           * mel_mask) / n_frames
        x_pre = torch.sum(0.5 * (LOG_2PI + (mels - mel_pre) ** 2)
                          * mel_mask) / n_frames
        t = torch.arange(T, device=mels.device)[None, :]
        stop_target = (t == (mel_lens.long()[:, None] - 1)).float()
        bce = -(self.bce_pos_weight * stop_target * F.logsigmoid(stop_logits)
                + (1.0 - stop_target) * F.logsigmoid(-stop_logits))
        stop_loss = torch.sum(bce * fmask) / nf
        loss = x_loss + x_pre + stop_loss
        detail = {"X like": x_loss, "X pre like": x_pre,
                  "STOP loss": stop_loss, "Total": loss}
        return mel_hat, loss, detail

    def infer(self, tokens, y_idx, tok_lens, max_frames=None):
        """-> (mel (B, T, D), mel_lens) with predicted durations and
        variance, or for ``tacotron2`` by free-running decoding over all
        ``max_frames`` steps: ``mel_lens`` is the first frame whose stop
        probability exceeds 0.5, plus one (``T`` if none does), and the mel
        is zero after it. ``y_idx``: int speaker ids (B,) or float speaker
        embeddings (B, E)."""
        T = max_frames or self.max_frames
        if self.block_type == "tacotron2":
            mel, _, stop_logits = self.tac2(tokens, y_idx, tok_lens,
                                            max_frames=T, train=False,
                                            free_run=True)
            stopped = torch.sigmoid(stop_logits) > 0.5
            first = torch.argmax(stopped.to(torch.uint8), dim=1)
            mel_lens = torch.where(stopped.any(dim=1), first + 1,
                                   torch.full_like(first, T)).to(torch.int32)
            return mel * length_mask(mel_lens, T), mel_lens
        out = self._network(tokens, torch.zeros_like(tokens), y_idx,
                            tok_lens, T, use_true_dur=False)
        return out[0], out[5]
