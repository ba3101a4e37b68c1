"""Speaker-similarity evaluation with an in-framework x-vector-style embedder.

Counterpart of ``vae_npvc_tpu/eval/similarity.py``, same public names: the
SITW-shaped x-vector TDNN (:class:`XVectorTDNN`, five dilated frame layers
with LayerNorm, masked statistics pooling, the x-vector as the first segment
layer's pre-activation) and the legacy three-conv :class:`SpeakerEmbedder`
(:func:`_embedder`), :func:`save_embedder` / :func:`load_embedder` (the JAX
msgpack payload ``{meta, params}``, both ways), :func:`train_embedder` with
JAX's numpy batch sampler (:func:`_override_batches`, copied, so the batches
are equal), the wav-domain MFCC + VAD front-end (:func:`mfcc_vad_scp`),
:func:`embed_scp` / :func:`embed_feats`, the cosine and PLDA reports and
:func:`write_scores`.

The networks run fp32 on the device (cuDNN convolutions with TF32 off);
statistics pooling masks the padded frames in training and scoring alike.
Parameters keep flax's names (``tdnn_{i}``, ``norm_{i}``, ``embed``,
``seg6_norm``, ``segment7``, ``seg7_norm``, ``classify``; ``conv_{i}`` for
the legacy net); a trained embedder is handed around as ``(model, params)``
with ``params`` the flax tree (numpy), which the embedding functions load
into the model, as the JAX functions apply it.
"""

from __future__ import annotations

from pathlib import Path
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..nn.blocks import Conv, Dense, LayerNorm, init_parameters
from ..utils import msgpack_io
from ..utils.bridge import load_flax_params, params_to_flax
from ..utils.device import resolve_device


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

def _stats_pool(h, lengths):
    """(B, T, C) -> (B, 2C): mean and standard deviation over the frames
    below ``lengths`` (all frames without)."""
    if lengths is not None:
        t = torch.arange(h.shape[1], device=h.device)[None, :, None]
        m = (t < lengths[:, None, None]).to(h.dtype)
        cnt = torch.clamp(torch.sum(m, dim=1), min=1.0)
        mean = torch.sum(h * m, dim=1) / cnt
        var = torch.sum(torch.square(h - mean[:, None, :]) * m, dim=1) / cnt
    else:
        mean = torch.mean(h, dim=1)
        var = torch.var(h, dim=1, unbiased=False)
    return torch.cat([mean, torch.sqrt(var + 1e-6)], dim=-1)


class XVectorTDNN(nn.Module):
    """SITW x-vector TDNN (reference: egs/vcc20/vae1/local/ob_eval/
    evaluate_similarity.sh:54-64): frame layers of contexts {t-2..t+2},
    {t-2,t,t+2}, {t-3,t,t+3}, {t}, {t} (the last 3 x width), each ReLU then
    LayerNorm; statistics pooling; ``embed`` (the x-vector), ReLU +
    LayerNorm, ``segment7``, ReLU + LayerNorm, ``classify``.
    Mel (B, T, D) -> (x-vector (B, E), logits (B, S))."""

    SPECS = ((5, 1, 1), (3, 2, 1), (3, 3, 1), (1, 1, 1), (1, 1, 3))

    def __init__(self, feat_dim, num_speakers, emb_dim=64, width=128):
        super().__init__()
        cin = feat_dim
        for i, (k, d, mult) in enumerate(self.SPECS):
            setattr(self, f"tdnn_{i}", Conv(cin, mult * width, k,
                                            dilation=d))
            setattr(self, f"norm_{i}", LayerNorm(mult * width))
            cin = mult * width
        self.embed = Dense(2 * cin, emb_dim)
        self.seg6_norm = LayerNorm(emb_dim)
        self.segment7 = Dense(emb_dim, emb_dim)
        self.seg7_norm = LayerNorm(emb_dim)
        self.classify = Dense(emb_dim, num_speakers)

    def forward(self, x, lengths=None):
        h = x
        for i in range(len(self.SPECS)):
            h = getattr(self, f"norm_{i}")(
                F.relu(getattr(self, f"tdnn_{i}")(h)))
        emb = self.embed(_stats_pool(h, lengths))
        h2 = self.segment7(self.seg6_norm(F.relu(emb)))
        return emb, self.classify(self.seg7_norm(F.relu(h2)))


class SpeakerEmbedder(nn.Module):
    """Legacy embedder: 3 plain convs (kernel 5, dilations 1, 2, 3) +
    statistics pooling."""

    def __init__(self, feat_dim, num_speakers, emb_dim=64, width=128):
        super().__init__()
        cin = feat_dim
        for i, dil in enumerate((1, 2, 3)):
            setattr(self, f"conv_{i}", Conv(cin, width, 5, dilation=dil))
            cin = width
        self.embed = Dense(2 * width, emb_dim)
        self.classify = Dense(emb_dim, num_speakers)

    def forward(self, x, lengths=None):
        h = x
        for i in range(3):
            h = F.relu(getattr(self, f"conv_{i}")(h))
        emb = self.embed(_stats_pool(h, lengths))
        return emb, self.classify(F.relu(emb))


def _embedder(num_speakers, emb_dim=64, width=128, arch="tdnn", *,
              feat_dim=80, seed=0):
    """The embedder for ``arch`` ('tdnn' or 'conv3') on the CPU, its
    parameters drawn from ``seed``."""
    cls = XVectorTDNN if arch == "tdnn" else SpeakerEmbedder
    model = cls(feat_dim, num_speakers, emb_dim, width)
    init_parameters(model, seed)
    return model


def save_embedder(path, model_meta, params):
    """Persist the trained embedder (meta + flax ``params`` tree) for reuse
    across the per-pair eval invocations of run.sh stage 7."""
    payload = {"meta": dict(model_meta), "params": params}
    Path(path).write_bytes(msgpack_io.msgpack_serialize(payload))


def load_embedder(path, device="cuda"):
    """→ (model, params, meta). Rebuilds the net from the stored meta on
    ``device``."""
    payload = msgpack_io.msgpack_restore(Path(path).read_bytes())
    meta = payload["meta"]
    arch = meta.get("arch", "tdnn")
    if isinstance(arch, bytes):
        arch = arch.decode()
    model = _embedder(int(meta["num_speakers"]), int(meta["emb_dim"]),
                      int(meta["width"]), arch,
                      feat_dim=int(meta["feat_dim"]))
    params = payload["params"]
    load_flax_params(model, params)
    return model.to(resolve_device(device)).eval(), params, meta


def train_embedder(data_dir, config, *, steps=2000, batch_size=64,
                   emb_dim=64, lr=1e-3, seed=0, log_every=500, feats=None,
                   arch="tdnn", width=128, ckpt=None, device="cuda",
                   params=None, losses=None):
    """Train the speaker classifier on a dump dir; returns (model, params).

    ``feats``: optional {utt: (T, D)} override — the wav-domain MFCC+VAD
    front-end (``mfcc_vad_scp``) instead of the dump dir's mels; speaker
    labels still come from the dir's ``utt2spk_id``.
    ``arch``: 'tdnn' (SITW x-vector TDNN, default) or 'conv3' (the legacy
    3-conv stand-in). ``ckpt``: load-if-exists-else-train-and-save path.
    ``params`` (a flax tree) replaces the seeded initial parameters;
    ``losses``, a list, receives each step's loss.
    """
    from ..data import kaldi_io
    from ..train.optim import Adam, apply_updates

    dev = resolve_device(device)
    if ckpt is not None and Path(ckpt).exists():
        model, stored, meta = load_embedder(ckpt, device=dev)
        # reuse only when the stored model matches the request — a stale
        # checkpoint from a run with different --embedder/--width would
        # otherwise silently score with the wrong architecture
        if feats:
            feat_dim = np.asarray(next(iter(feats.values()))).shape[-1]
        else:
            scp = kaldi_io.read_scp(Path(data_dir) / "feats.scp")
            feat_dim = kaldi_io.matrix_header(next(iter(scp.values())))[1]
        if (meta.get("arch", "tdnn") == arch
                and int(meta.get("width", width)) == int(width)
                and int(meta.get("emb_dim", emb_dim)) == int(emb_dim)
                and (feat_dim is None
                     or int(meta.get("feat_dim", feat_dim))
                     == int(feat_dim))):
            print(f"loaded speaker embedder from {ckpt}")
            return model, stored
        print(f"ignoring {ckpt}: stored "
              f"{meta.get('arch')}/w{meta.get('width')}/"
              f"e{meta.get('emb_dim')} != requested "
              f"{arch}/w{width}/e{emb_dim}; retraining")

    if feats is not None:
        it, num_speakers, feats0 = _override_batches(
            data_dir, feats, batch_size, seed)
    else:
        # lazy scp-backed sampler: training pools real per-row lengths, as
        # embed_feats does at scoring time
        scp = kaldi_io.read_scp(Path(data_dir) / "feats.scp")
        crop = int((config or {}).get("crop_length", 200))
        it, num_speakers, feats0 = _override_batches(
            data_dir, scp, batch_size, seed, crop=crop)
    model = _embedder(num_speakers, emb_dim, width, arch,
                      feat_dim=feats0.shape[-1], seed=seed)
    if params is not None:
        load_flax_params(model, params)
    model = model.to(dev).train()
    weights = list(model.parameters())
    tx = Adam(lr, 0.9, 0.999, None)
    opt_state = None
    step_losses = []
    for i, (x, spks, lengths) in enumerate(it):
        x, spks, lengths = (torch.as_tensor(a, device=dev)
                            for a in (x, spks, lengths))
        _, logits = model(x, lengths)
        loss = F.cross_entropy(logits, spks.long())
        grads = torch.autograd.grad(loss, weights)
        opt_state = apply_updates(tx, opt_state, weights, grads)
        step_losses.append(loss.detach())
        if log_every and i % log_every == 0:
            print(f"spk-embedder step {i}: loss "
                  f"{float(step_losses[-1]):.4f}")
        if i + 1 >= steps:
            break
    if losses is not None:
        losses.extend(float(v) for v in step_losses)
    model.eval()
    trained = params_to_flax(model.state_dict())
    if ckpt is not None:
        save_embedder(ckpt, {"arch": arch, "width": width,
                             "emb_dim": emb_dim,
                             "num_speakers": num_speakers,
                             "feat_dim": int(feats0.shape[-1])}, trained)
        print(f"saved speaker embedder to {ckpt}")
    return model, trained


def _override_batches(data_dir, feats, batch_size, seed, crop=200):
    """Batch iterator with labels from ``data_dir/utt2spk_id`` (random
    crop-or-pad to ``crop`` frames). Yields ``(x, spk, lengths)`` — lengths
    carry each row's real frame count so the stats pool can mask padding
    during training exactly as it does at scoring time. ``feats`` is either
    an in-memory {utt: (T, D)} dict or a feats.scp mapping {utt: position}
    (entries loaded lazily per batch)."""
    from ..data import kaldi_io

    utt2spk = {}
    for line in open(Path(data_dir) / "utt2spk_id"):
        u, s = line.split()
        utt2spk[u] = int(s)
    lazy = feats and isinstance(next(iter(feats.values())), str)

    def load(u):
        return kaldi_io.load_mat(feats[u]) if lazy else feats[u]

    if lazy:
        utts = [u for u in feats if u in utt2spk
                and kaldi_io.matrix_header(feats[u])[0] > 0]
        D = kaldi_io.matrix_header(feats[utts[0]])[1] if utts else 0
    else:
        utts = [u for u in feats if u in utt2spk and len(feats[u]) > 0]
        D = feats[utts[0]].shape[1] if utts else 0
    if not utts:
        raise ValueError(f"no labeled utterances with voiced frames in "
                         f"{data_dir}")
    num_speakers = max(utt2spk[u] for u in utts) + 1
    batch_size = min(batch_size, len(utts))
    rng = np.random.default_rng(seed)

    def gen():
        while True:
            pick = rng.choice(len(utts), size=batch_size, replace=False)
            x = np.zeros((batch_size, crop, D), np.float32)
            y = np.zeros((batch_size,), np.int32)
            lens = np.zeros((batch_size,), np.int32)
            for b, i in enumerate(pick):
                mat, u = load(utts[i]), utts[i]
                if len(mat) > crop:
                    t0 = rng.integers(0, len(mat) - crop + 1)
                    x[b] = mat[t0:t0 + crop]
                    lens[b] = crop
                else:
                    x[b, :len(mat)] = mat
                    lens[b] = len(mat)
                y[b] = utt2spk[u]
            yield x, y, lens

    return gen(), num_speakers, np.zeros((batch_size, crop, D), np.float32)


def mfcc_vad_scp(wav_scp, fs=16000, *, mfcc_opts=None, vad_opts=None):
    """Wav-domain front-end: wav.scp → {utt: voiced MFCC frames} on the host
    (30-dim Kaldi-semantics MFCC + energy VAD, conf/mfcc.conf +
    conf/vad.conf); non-16k sources are polyphase-resampled.
    ``wav_scp``: a wav.scp path or an in-memory {utt: wav-path} dict."""
    from ..data import kaldi_io
    from ..data.features import resample
    from ..data.mfcc import mfcc_vad

    opts = dict(mfcc_opts or {})
    opts.setdefault("high_freq", 7600.0)  # conf/mfcc.conf
    entries = (wav_scp if isinstance(wav_scp, Mapping)
               else kaldi_io.load_dict_data(wav_scp))
    out = {}
    for utt, entry in entries.items():
        sr, x = kaldi_io.read_wav_scp_entry(entry)
        if sr != fs:
            x = resample(x, sr, fs)
        # Kaldi computes features on int16-scale samples; the conf's VAD
        # threshold (5.5) and the energy C0 are calibrated to that scale
        out[utt] = mfcc_vad(x * 32768.0, fs, mfcc_opts=opts,
                            vad_opts=vad_opts)
    return out


def embed_scp(model, params, scp_path, max_frames=800, batch_size=16,
              bucket=128):
    """Embed every utterance in a feats.scp → {utt: unit-norm embedding}
    (length-bucketed batches)."""
    from ..data import kaldi_io

    items = [(u, kaldi_io.load_mat(rx)[:max_frames])
             for u, rx in kaldi_io.read_scp(scp_path).items()]
    return embed_feats(model, params, items, batch_size=batch_size,
                       bucket=bucket)


def embed_feats(model, params, items, batch_size=16, bucket=128,
                max_frames=800):
    """Embed [(utt, (T, D))] or {utt: (T, D)} → {utt: unit-norm embedding};
    ``params`` (a flax tree, or None to keep the model's own) is loaded into
    ``model`` first."""
    if isinstance(items, Mapping):
        items = list(items.items())
    items = [(u, np.asarray(m)[:max_frames]) for u, m in items]
    items = [(u, m) for u, m in items if len(m) > 0]

    if params is not None:
        load_flax_params(model, params)
    model.eval()
    dev = next(model.parameters()).device
    buckets: dict = {}
    for u, mat in items:
        T_pad = -(-mat.shape[0] // bucket) * bucket
        buckets.setdefault(T_pad, []).append((u, mat))

    out = {}
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
            with torch.inference_mode():
                embs = model(torch.as_tensor(x, device=dev),
                             torch.as_tensor(lens, device=dev))[0] \
                    .cpu().numpy()
            for b, (u, _) in enumerate(chunk):
                e = embs[b]
                out[u] = e / max(np.linalg.norm(e), 1e-9)
    return out


def cosine_similarity_report(conv_embs, enroll_embs, utt2target,
                             enroll_utt2spk):
    """Mean cosine of each converted utt vs its target speaker's enrollment
    centroid. Returns (mean_score, per_utt dict)."""
    spk_centroid: dict = {}
    for utt, spk in enroll_utt2spk.items():
        if utt in enroll_embs:
            spk_centroid.setdefault(spk, []).append(enroll_embs[utt])
    spk_centroid = {s: np.mean(v, axis=0) for s, v in spk_centroid.items()}
    per_utt = {}
    for utt, tgt in utt2target.items():
        if utt in conv_embs and tgt in spk_centroid:
            c = spk_centroid[tgt]
            per_utt[utt] = float(np.dot(conv_embs[utt],
                                        c / max(np.linalg.norm(c), 1e-9)))
    if not per_utt:
        raise ValueError("no scorable (converted utt, target) pairs")
    return float(np.mean(list(per_utt.values()))), per_utt


def plda_similarity_report(plda, conv_embs, enroll_embs, utt2target,
                           enroll_utt2spk):
    """Mean PLDA LLR of each converted utt vs its target speaker's raw-mean
    enrollment vector (Kaldi ivector-mean + --num-utts semantics,
    reference evaluate_similarity.sh:121-129). Returns (mean, per_utt)."""
    from .plda import plda_score

    spk_vecs: dict = {}
    for utt, spk in enroll_utt2spk.items():
        if utt in enroll_embs:
            spk_vecs.setdefault(spk, []).append(enroll_embs[utt])
    spk_mean = {s: np.mean(v, axis=0) for s, v in spk_vecs.items()}
    spk_count = {s: len(v) for s, v in spk_vecs.items()}
    per_utt = {}
    for utt, tgt in utt2target.items():
        if utt in conv_embs and tgt in spk_mean:
            per_utt[utt] = plda_score(plda, spk_mean[tgt], conv_embs[utt],
                                      n_enroll=spk_count[tgt])
    if not per_utt:
        raise ValueError("no scorable (converted utt, target) pairs")
    return float(np.mean(list(per_utt.values()))), per_utt


def write_scores(path, target, per_utt, mean):
    """Reference scores-file shape: ``<trg>_enroll <utt> <score>`` rows plus
    a final Mean row (evaluate_similarity.sh:136-142; test.sh greps $3 of the
    tail line)."""
    with open(path, "w") as f:
        for utt, s in per_utt.items():
            f.write(f"{target}_enroll {utt} {s:.6f}\n")
        f.write(f"{target}_enroll Mean {mean:.6f}\n")
