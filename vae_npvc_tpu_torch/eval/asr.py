"""Intelligibility evaluation: pluggable recognizer + in-framework CTC proxy.

Counterpart of ``vae_npvc_tpu/eval/asr.py``, same public names:
:func:`build_vocab`, the two encoders of :func:`_ctc_model`
(:class:`CTCEncoder`, dilated convs; :class:`TransformerCTCEncoder`, pre-LN
blocks of ``models/token_tts.TransformerBlock``), :func:`spec_augment`,
:func:`train_ctc` (its state and step: :class:`CTCTrainer`),
:func:`ctc_prefix_beam_search` (host numpy in float64, copied),
:class:`CTCRecognizer` and :func:`get_recognizer`. Parameters keep
flax's names and layouts (``sub``, ``conv_{i}`` / ``blk_{i}``, ``ln_out``,
``out``), so a recognizer checkpoint is the JAX msgpack payload ``{params,
vocab (JSON), arch}`` and moves between the packages both ways.

On a CUDA tensor the transformer's attention core is the hand-written
kernel pair of ``ops/attention.py`` (K4 forward, K5 backward: three of each
per training step, three forwards per transcribe batch); on the CPU the
plain versions. The recognizer runs fp32 (TF32 off, ``utils/device.py``).

The CTC loss is ``optax.ctc_loss``'s (:func:`ctc_loss`): a row whose labels
fit its frames takes ``F.ctc_loss`` (the same value and, through the
log-softmax, the same logit gradient); a row that cannot be aligned takes
optax's recursion with its ``log_epsilon = -1e5`` floor, so it gives
optax's finite ~1e5 loss and its gradient where ``F.ctc_loss`` gives inf.
``train_ctc`` truncates features to ``max_frames`` but not their text, so
such rows occur.

Random draws (the initial parameters, SpecAugment's masks) come from seeded
``torch.Generator``s, not ``jax.random``; ``train_ctc`` takes injected
parameters and :func:`spec_augment` injected draws for the lockstep tests.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.token_tts import TransformerBlock
from ..nn.blocks import (Conv, Dense, LayerNorm, init_parameters,
                         length_mask, sinusoidal_positions)
from ..utils import msgpack_io
from ..utils.bridge import load_flax_params, params_to_flax
from ..utils.device import resolve_device

BLANK = 0  # CTC blank id; vocab ids start at 1
LOG_EPSILON = -1e5  # optax.ctc_loss's stand-in for log(0)


# ---------------------------------------------------------------------------
# vocab
# ---------------------------------------------------------------------------

def build_vocab(texts) -> Dict[str, int]:
    """Character vocabulary from an iterable of transcripts (space kept)."""
    chars = sorted({c for t in texts for c in t})
    return {c: i + 1 for i, c in enumerate(chars)}


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

def _out_lengths(lengths):
    return None if lengths is None else (lengths + 1) // 2


class CTCEncoder(nn.Module):
    """Mel (B, T, D) -> (log-prob logits (B, ceil(T/2), vocab+1), lengths):
    a stride-2 conv, then ``blocks`` residual dilated convs. No mask between
    the layers: padded frames reach the valid ones near the end, as in
    JAX."""

    def __init__(self, feat_dim, vocab_size, width=192, blocks=3):
        super().__init__()
        self.sub = Conv(feat_dim, width, 5, stride=2)
        self.blocks = blocks
        for i in range(blocks):
            setattr(self, f"conv_{i}", Conv(width, width, 3,
                                            dilation=2 ** i))
        self.out = Dense(width, vocab_size + 1)

    def forward(self, x, lengths=None):
        h = F.relu(self.sub(x))
        for i in range(self.blocks):
            h = h + F.relu(getattr(self, f"conv_{i}")(h))
        return self.out(h), _out_lengths(lengths)


class TransformerCTCEncoder(nn.Module):
    """Mel (B, T, D) -> (logits (B, ceil(T/2), vocab+1), lengths): a
    stride-2 conv, sinusoidal positions, ``blocks`` pre-LN self-attention +
    FFN blocks (``heads`` heads, FFN 4 x width) over the valid frames, a
    final LayerNorm."""

    def __init__(self, feat_dim, vocab_size, width=192, blocks=3, heads=4):
        super().__init__()
        self.width, self.blocks = width, blocks
        self.sub = Conv(feat_dim, width, 5, stride=2)
        for i in range(blocks):
            setattr(self, f"blk_{i}", TransformerBlock(width, heads,
                                                       4 * width))
        self.ln_out = LayerNorm(width)
        self.out = Dense(width, vocab_size + 1)

    def forward(self, x, lengths=None):
        h = F.relu(self.sub(x))
        B, T = h.shape[:2]
        out_len = _out_lengths(lengths)
        h = h + sinusoidal_positions(T, self.width, h.device)[None]
        mask = (length_mask(out_len, T) if out_len is not None
                else torch.ones((B, T, 1), device=h.device))
        for i in range(self.blocks):
            h = getattr(self, f"blk_{i}")(h, mask)
        return self.out(self.ln_out(h)), out_len


def _ctc_model(vocab_size: int, width: int = 192, blocks: int = 3,
               arch: str = "conv", heads: int = 4, *, feat_dim: int = 80,
               seed: int = 0):
    """The encoder for ``arch`` ('conv' or 'transformer') on the CPU, its
    parameters drawn from ``seed``."""
    model = (TransformerCTCEncoder(feat_dim, vocab_size, width, blocks, heads)
             if arch == "transformer"
             else CTCEncoder(feat_dim, vocab_size, width, blocks))
    init_parameters(model, seed)
    return model


# ---------------------------------------------------------------------------
# CTC loss
# ---------------------------------------------------------------------------

def ctc_feasible(labels, label_lengths, logit_lengths):
    """(B,) bool numpy: rows whose labels fit their frames (one frame per
    label plus one blank between each repeated pair)."""
    labels = np.asarray(labels)
    out = []
    for row, n, t in zip(labels, np.asarray(label_lengths),
                         np.asarray(logit_lengths)):
        row = row[:int(n)]
        out.append(int(n) + int(np.sum(row[1:] == row[:-1])) <= int(t))
    return np.array(out, bool)


def _ctc_optax(logp, labels, logit_lengths, label_lengths, blank=BLANK):
    """``optax.ctc_loss_with_forward_probs``'s recursion on log-probs
    (B, T, K), with its ``log_epsilon`` floor: finite on rows that cannot
    be aligned."""
    B, T, _ = logp.shape
    N = labels.shape[1]
    dev, dt = logp.device, logp.dtype
    pad = (torch.arange(T, device=dev)[None] >= logit_lengths[:, None]) \
        .to(dt)
    repeat = F.pad((labels[:, :-1] == labels[:, 1:]).to(dt), (0, 1))
    lp_phi = logp[:, :, blank:blank + 1]                       # (B, T, 1)
    lp_emit = torch.gather(logp, 2, labels[:, None, :].expand(B, T, N))

    def update_phi(phi, added):
        return torch.cat([phi[:, :1], torch.logaddexp(phi[:, 1:], added)],
                         dim=1)

    phi = torch.full((B, N + 1), LOG_EPSILON, dtype=dt, device=dev)
    phi[:, 0] = 0.0
    emit = torch.full((B, N), LOG_EPSILON, dtype=dt, device=dev)
    for t in range(T):
        prev_phi = update_phi(phi, emit + LOG_EPSILON * repeat)
        next_emit = torch.logaddexp(prev_phi[:, :-1] + lp_emit[:, t],
                                    emit + lp_emit[:, t])
        next_phi = update_phi(prev_phi + lp_phi[:, t],
                              emit + lp_phi[:, t]
                              + LOG_EPSILON * (1.0 - repeat))
        p = pad[:, t:t + 1]
        emit = p * emit + (1.0 - p) * next_emit
        phi = p * phi + (1.0 - p) * next_phi
    last = update_phi(phi, emit)
    return -torch.gather(last, 1, label_lengths[:, None].long())[:, 0]


def ctc_loss(logits, logit_lengths, labels, label_lengths, blank=BLANK,
             feasible=None):
    """Per-row CTC loss of (B, T, K) ``logits`` with ``optax.ctc_loss``'s
    semantics: frames at or past ``logit_lengths`` and labels at or past
    ``label_lengths`` are padding. ``feasible`` (B,) numpy bool
    (:func:`ctc_feasible`) saves reading the lengths back from the
    device."""
    logp = F.log_softmax(logits.float(), dim=-1)
    if feasible is None:
        feasible = ctc_feasible(labels.cpu().numpy(),
                                label_lengths.cpu().numpy(),
                                logit_lengths.cpu().numpy())
    labels = labels.long()

    def library(lp, lab, n_in, n_lab, blank):
        return F.ctc_loss(lp.transpose(0, 1), lab, n_in.long(), n_lab.long(),
                          blank=blank, reduction="none", zero_infinity=False)

    if feasible.all():
        return library(logp, labels, logit_lengths, label_lengths, blank)
    out = torch.zeros(logits.shape[0], device=logits.device)
    for rows, fn in ((np.flatnonzero(feasible), library),
                     (np.flatnonzero(~feasible), _ctc_optax)):
        if len(rows):
            i = torch.as_tensor(rows, device=logits.device)
            out = out.index_put((i,), fn(logp[i], labels[i],
                                         logit_lengths[i], label_lengths[i],
                                         blank))
    return out


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _load_corpus(data_dir, max_frames):
    from ..data import kaldi_io

    data_dir = Path(data_dir)
    scp = kaldi_io.read_scp(data_dir / "feats.scp")
    texts = kaldi_io.load_dict_data(data_dir / "text")
    items = []
    for utt, rx in scp.items():
        if utt in texts:
            items.append((utt, kaldi_io.load_mat(rx)[:max_frames],
                          texts[utt]))
    if not items:
        raise ValueError(f"no (feats, text) pairs under {data_dir}")
    return items


def spec_augment_draws(gen, B, D, *, n_time_masks=2, time_width=20,
                       n_freq_masks=2, freq_width=8):
    """The random draws of :func:`spec_augment` from ``gen``: per time mask
    a width (B, 1) and a uniform (B, 1) start fraction, per frequency mask
    a width and a start bin."""
    time = [(torch.randint(0, time_width + 1, (B, 1), generator=gen),
             torch.rand((B, 1), generator=gen)) for _ in range(n_time_masks)]
    freq = [(torch.randint(0, freq_width + 1, (B, 1), generator=gen),
             torch.randint(0, max(D - freq_width, 1), (B, 1), generator=gen))
            for _ in range(n_freq_masks)]
    return time, freq


def spec_augment(gen, feats, flens, *, n_time_masks=2, time_width=20,
                 n_freq_masks=2, freq_width=8, draws=None):
    """SpecAugment (time + frequency masking) on a padded (B, T, D) batch,
    as the JAX function masks: a time mask of width ``w`` starts at
    ``int(u * max(flens - w, 1))``. ``draws`` (:func:`spec_augment_draws`)
    replaces the generator's."""
    B, T, D = feats.shape
    if draws is None:
        draws = spec_augment_draws(gen, B, D, n_time_masks=n_time_masks,
                                   time_width=time_width,
                                   n_freq_masks=n_freq_masks,
                                   freq_width=freq_width)
    dev = feats.device
    mask = torch.ones((B, T, D), dtype=feats.dtype, device=dev)
    t = torch.arange(T, device=dev)[None, :]
    for w, u in draws[0]:
        w, u = w.to(dev), u.to(dev)
        t0 = (u * torch.clamp(flens[:, None] - w, min=1)).to(torch.int32)
        mask = mask * ((t < t0) | (t >= t0 + w))[:, :, None]
    f = torch.arange(D, device=dev)[None, :]
    for w, f0 in draws[1]:
        w, f0 = w.to(dev), f0.to(dev)
        mask = mask * ((f < f0) | (f >= f0 + w))[:, None, :]
    return feats * mask


class CTCTrainer:
    """The state of :func:`train_ctc` on ``device``: the corpus, the model,
    Adam over its parameters and JAX's batch sampler
    (``np.random.default_rng(seed)`` picks the rows; each batch is padded
    to the corpus's longest utterance). ``params`` (a flax ``params`` tree)
    replaces the seeded initial parameters."""

    def __init__(self, data_dir, *, batch_size=16, lr=1e-3, width=192,
                 max_frames=1200, seed=0, specaug=False, arch="conv",
                 device="cuda", params=None):
        from ..train.optim import Adam

        self.dev = resolve_device(device)
        self.items = _load_corpus(data_dir, max_frames)
        self.vocab = build_vocab(t for _, _, t in self.items)
        self.D = self.items[0][1].shape[1]
        self.arch, self.specaug = arch, specaug
        model = _ctc_model(len(self.vocab), width, arch=arch,
                           feat_dim=self.D, seed=seed)
        if params is not None:
            load_flax_params(model, params)
        self.model = model.to(self.dev).train()
        self.weights = list(self.model.parameters())
        self.T_max = max(mat.shape[0] for _, mat, _ in self.items)
        self.L_max = max(len(t) for _, _, t in self.items)
        self.batch_size = min(batch_size, len(self.items))
        self.tx, self.opt_state = Adam(lr, 0.9, 0.999, None), None
        self.rng = np.random.default_rng(seed)
        self.aug = torch.Generator().manual_seed(seed + 1)

    def make_batch(self, idx):
        B = self.batch_size
        feats = np.zeros((B, self.T_max, self.D), np.float32)
        flens = np.zeros((B,), np.int32)
        labels = np.zeros((B, self.L_max), np.int32)
        llens = np.zeros((B,), np.int32)
        for b, k in enumerate(idx):
            _, mat, text = self.items[k]
            feats[b, :mat.shape[0]] = mat
            flens[b] = mat.shape[0]
            ids = [self.vocab[c] for c in text]
            labels[b, :len(ids)] = ids
            llens[b] = len(ids)
        return feats, flens, labels, llens

    def step(self):
        """One optimizer step on the next batch; returns the loss (a
        device scalar, not read back)."""
        from ..train.optim import apply_updates

        idx = self.rng.choice(len(self.items), size=self.batch_size,
                              replace=len(self.items) < self.batch_size)
        feats, flens, labels, llens = self.make_batch(idx)
        feasible = ctc_feasible(labels, llens, (flens + 1) // 2)
        x, fl, lab, ll = (torch.as_tensor(a, device=self.dev)
                          for a in (feats, flens, labels, llens))
        if self.specaug:
            x = spec_augment(self.aug, x, fl)
        logits, out_len = self.model(x, fl)
        per_seq = ctc_loss(logits, out_len, lab, ll, feasible=feasible)
        loss = torch.mean(per_seq / torch.clamp(ll, min=1))
        grads = torch.autograd.grad(loss, self.weights)
        self.opt_state = apply_updates(self.tx, self.opt_state, self.weights,
                                       grads)
        return loss.detach()

    def recognizer(self):
        return CTCRecognizer(self.model.eval(), None, self.vocab,
                             arch=self.arch)


def train_ctc(data_dir, *, steps: int = 3000, batch_size: int = 16,
              lr: float = 1e-3, width: int = 192, max_frames: int = 1200,
              seed: int = 0, log_every: int = 500, specaug: bool = False,
              arch: str = "conv", device="cuda", params=None, losses=None):
    """Train the CTC proxy on a data dir with ``feats.scp`` + ``text``
    (:class:`CTCTrainer`); returns a ready :class:`CTCRecognizer` on
    ``device``. ``losses``, a list, receives each step's loss."""
    trainer = CTCTrainer(data_dir, batch_size=batch_size, lr=lr, width=width,
                         max_frames=max_frames, seed=seed, specaug=specaug,
                         arch=arch, device=device, params=params)
    step_losses = []
    for i in range(steps):
        step_losses.append(trainer.step())
        if log_every and i % log_every == 0:
            print(f"ctc step {i}: loss {float(step_losses[-1]):.4f}")
    if losses is not None:
        losses.extend(float(v) for v in step_losses)
    # steps=0 is legal (score with random init / caller expected a ckpt hit
    # — e.g. an --arch flag mismatching the stored arch falls through here)
    print("ctc final loss: "
          + (f"{float(step_losses[-1]):.4f}" if step_losses
             else "n/a (0 steps)"))
    return trainer.recognizer()


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------

def ctc_prefix_beam_search(log_probs: np.ndarray, *, beam_size: int = 10,
                           blank: int = BLANK, lm=None,
                           lm_weight: float = 0.6, penalty: float = 0.0,
                           id2char: Mapping[int, str] | None = None):
    """CTC prefix beam search with optional shallow LM fusion.

    The reference's eval ASR decodes with beam search + a shallow-fused
    RNNLM (reference: egs/vcc20/vae1/conf/ob_eval/decode_asr.yaml —
    ``beam-size: 10, lm-weight: 0.6, penalty: 0.0``; evaluate.sh:150-152).
    This is the CTC-only analog (Hannun-style prefix search): prefixes carry
    separate blank/non-blank path masses so repeats merge exactly, and each
    prefix extension adds ``lm_weight * log P_lm(c | prefix) + penalty``
    (ESPnet's per-token insertion bonus). EOS is scored at finalization.

    ``log_probs``: (T, V) log-softmaxed frame posteriors. Returns the best
    prefix as a list of non-blank label ids.
    """
    neg_inf = -np.inf
    T, V = log_probs.shape
    if lm is not None and id2char is None:
        raise ValueError("id2char required for LM fusion")

    # prefix (tuple of ids) -> [log P(ending in blank), log P(non-blank)]
    beams: Dict[tuple, List[float]] = {(): [0.0, neg_inf]}
    lm_scores: Dict[tuple, float] = {(): 0.0}

    def lm_score(prefix: tuple) -> float:
        s = lm_scores.get(prefix)
        if s is None:
            parent = prefix[:-1]
            s = lm_scores[parent] + penalty
            if lm is not None:
                ctx = [id2char[i] for i in parent]
                s += lm_weight * lm.logp(ctx, id2char[prefix[-1]])
            lm_scores[prefix] = s
        return s

    for t in range(T):
        frame = log_probs[t]
        nxt: Dict[tuple, List[float]] = {}

        def acc(prefix, slot, val):
            entry = nxt.setdefault(prefix, [neg_inf, neg_inf])
            entry[slot] = np.logaddexp(entry[slot], val)

        for prefix, (lp_b, lp_nb) in beams.items():
            lp_tot = np.logaddexp(lp_b, lp_nb)
            acc(prefix, 0, lp_tot + frame[blank])
            if prefix:
                acc(prefix, 1, lp_nb + frame[prefix[-1]])
            for c in range(V):
                if c == blank:
                    continue
                # a repeat char can only extend via the blank-ended path
                base = lp_b if (prefix and c == prefix[-1]) else lp_tot
                if base == neg_inf:
                    continue
                acc(prefix + (c,), 1, base + frame[c])

        # LM-score only an acoustically-plausible shortlist: scoring every
        # candidate is O(beam*V) LM calls per frame — cheap for English char
        # vocabs, pathological for large token sets (e.g. aishell3 Mandarin)
        cands = sorted(nxt.items(),
                       key=lambda kv: np.logaddexp(kv[1][0], kv[1][1]),
                       reverse=True)[:max(5 * beam_size, 30)]
        scored = sorted(
            cands,
            key=lambda kv: np.logaddexp(kv[1][0], kv[1][1]) + lm_score(kv[0]),
            reverse=True)
        beams = dict(scored[:beam_size])
        # drop cache entries for prefixes that fell out of the beam — future
        # lm_score calls only ever look up a current beam as the parent
        lm_scores = {p: lm_scores[p] for p in beams}

    def final_score(prefix, lps):
        s = np.logaddexp(lps[0], lps[1]) + lm_score(prefix)
        if lm is not None:
            s += lm_weight * lm.logp_eos([id2char[i] for i in prefix])
        return s

    best = max(beams.items(), key=lambda kv: final_score(*kv))[0]
    return list(best)


# ---------------------------------------------------------------------------
# recognizer interface
# ---------------------------------------------------------------------------

class CTCRecognizer:
    """CTC recognizer satisfying the recognizer interface
    (``transcribe_scp(scp) -> {utt: text}``).

    ``model`` is an encoder module (it holds the parameters; ``params``, a
    flax tree, is loaded into it when given). Decoding is greedy collapse by
    default; ``beam_size > 1`` switches to prefix beam search with optional
    shallow LM fusion (:func:`ctc_prefix_beam_search`).
    """

    def __init__(self, model, params, vocab: Mapping[str, int],
                 arch: str = "conv"):
        self.model = model
        if params is not None:
            load_flax_params(model, params)
        self.vocab = dict(vocab)
        self.arch = arch
        self.id2char = {i: c for c, i in self.vocab.items()}

    @property
    def params(self):
        """The parameters as a flax ``params`` tree of numpy arrays."""
        return params_to_flax(self.model.state_dict())

    def logits(self, x, lens):
        """(B, T, D) feats and (B,) lengths (numpy) -> (fp32 logits, output
        lengths) tensors on the model's device."""
        dev = next(self.model.parameters()).device
        with torch.inference_mode():
            return self.model(torch.as_tensor(x, device=dev),
                              torch.as_tensor(lens, device=dev))

    def transcribe_scp(self, scp, *, batch_size: int = 16,
                       bucket: int = 256, max_frames: int = 3000,
                       beam_size: int = 1, lm=None, lm_weight: float = 0.6,
                       penalty: float = 0.0) -> Dict[str, str]:
        from ..data import kaldi_io

        self.model.eval()
        items = [(u, kaldi_io.load_mat(rx)[:max_frames])
                 for u, rx in kaldi_io.read_scp(scp).items()]
        buckets: dict = {}
        for u, mat in items:
            T_pad = -(-mat.shape[0] // bucket) * bucket
            buckets.setdefault(T_pad, []).append((u, mat))

        out: Dict[str, str] = {}
        for T_pad in sorted(buckets):
            group = buckets[T_pad]
            for lo in range(0, len(group), batch_size):
                chunk = group[lo:lo + batch_size]
                D = chunk[0][1].shape[1]
                x = np.zeros((batch_size, T_pad, D), np.float32)
                lens = np.ones((batch_size,), np.int32)
                for b, (u, mat) in enumerate(chunk):
                    x[b, :mat.shape[0]] = mat
                    lens[b] = mat.shape[0]
                logits, _ = self.logits(x, lens)
                out_len = (lens + 1) // 2
                if beam_size > 1:
                    lp = F.log_softmax(logits.float(), dim=-1).cpu().numpy() \
                        .astype(np.float64)
                    for b, (u, _) in enumerate(chunk):
                        ids = ctc_prefix_beam_search(
                            lp[b, :out_len[b]], beam_size=beam_size, lm=lm,
                            lm_weight=lm_weight, penalty=penalty,
                            id2char=self.id2char)
                        out[u] = "".join(self.id2char.get(i, "")
                                         for i in ids)
                else:
                    ids = torch.argmax(logits, dim=-1).cpu().numpy()
                    for b, (u, _) in enumerate(chunk):
                        out[u] = self._collapse(ids[b, :out_len[b]])
        return out

    def _collapse(self, frame_ids) -> str:
        chars: List[str] = []
        prev = BLANK
        for i in frame_ids:
            if i != BLANK and i != prev:
                chars.append(self.id2char.get(int(i), ""))
            prev = i
        return "".join(chars)

    # -------------------------------------------------------- serialization
    def save(self, path):
        payload = {"params": self.params, "vocab": json.dumps(self.vocab),
                   "arch": self.arch}
        Path(path).write_bytes(msgpack_io.msgpack_serialize(payload))

    @classmethod
    def load(cls, path, width: int | None = None, device="cuda"):
        """Restore a recognizer (the JAX package's files too) on
        ``device``; the width, block count, input dim and encoder arch are
        read from the stored payload (``width`` remains as an override;
        pre-arch checkpoints restore as 'conv' by structure sniffing)."""
        payload = msgpack_io.msgpack_restore(Path(path).read_bytes())
        params = payload["params"]
        vocab = json.loads(payload["vocab"])
        arch = payload.get("arch")
        if arch is None:
            arch = ("transformer" if any(
                k.startswith(("blk_", "mha_")) for k in params) else "conv")
        if isinstance(arch, bytes):
            arch = arch.decode()
        if any(k.startswith("mha_") for k in params):
            raise ValueError(
                f"{path} is a pre-ae6b8bd transformer recognizer checkpoint "
                "(mha_i param layout); retrain it — eval recognizers are "
                "per-run artifacts, not long-lived models")
        kernel = np.asarray(params["sub"]["kernel"])
        if width is None:
            width = int(kernel.shape[-1])
        blocks = len([k for k in params if k.startswith(("conv_", "blk_"))])
        model = _ctc_model(len(vocab), width, blocks=blocks or 3, arch=arch,
                           feat_dim=int(kernel.shape[1]))
        load_flax_params(model, params)
        return cls(model.to(resolve_device(device)).eval(), None, vocab,
                   arch=arch)


def get_recognizer(spec: str, **kwargs):
    """Resolve ``module.path:ClassName`` → instantiated recognizer."""
    import importlib

    mod_name, _, cls_name = spec.partition(":")
    cls = getattr(importlib.import_module(mod_name), cls_name)
    return cls(**kwargs)
