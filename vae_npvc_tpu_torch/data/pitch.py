"""Kaldi-style pitch features (the ``make_fbank_pitch.sh`` 3-dim append).

The reference's eval-ASR stage re-extracts "fbank+pitch" features from the
synthesized wavs (reference: egs/vcc20/vae1/local/ob_eval/evaluate.sh:110-115
via Kaldi ``steps/make_fbank_pitch.sh``; conf/pitch.conf = 16 kHz defaults).
Kaldi's extractor (compute-and-process-kaldi-pitch-feats, Ghahremani et al.
2014) is NCCF + Viterbi tracking followed by POV/log-pitch post-processing;
this module reimplements that pipeline from the algorithm spec:

- lowpass (1 kHz) + polyphase resample to 4 kHz;
- NCCF over integer lags [fs/max_f0, fs/min_f0] on 25 ms windows every 10 ms,
  twice: ballast-normalized (pitch decision) and ballast-free (POV);
- Viterbi over the lag grid maximizing Σ nccf − penalty·log²(lag ratio);
- features: [pov_feature, normalized_log_pitch, delta_pitch] with the Kaldi
  POV warp ``2((1.0001−n)^0.15 − 1)``, POV-weighted sliding-window mean
  subtraction of log-pitch, and a 2-frame delta.

Documented deviations from Kaldi (offline env — no bit-level oracle):
the POV→probability map uses a logistic fit instead of Kaldi's piecewise
polynomial, delta noise is omitted (deterministic pipeline), and the online
(frame-by-frame) recomputation path is not modeled — this is the batch path.

Host-side numpy: eval/feature-extraction path, not the training hot loop.

The port's own copy of ``vae_npvc_tpu/data/pitch.py`` (host numpy; the port
imports nothing of the JAX package).
"""

from __future__ import annotations

import math

import numpy as np


def _lowpass_resample(x, fs, resample_freq=4000, cutoff=1000.0):
    from scipy.signal import butter, resample_poly, sosfiltfilt

    sos = butter(4, cutoff / (fs / 2.0), output="sos")
    y = sosfiltfilt(sos, np.asarray(x, np.float64))
    g = math.gcd(int(fs), int(resample_freq))
    return resample_poly(y, resample_freq // g, int(fs) // g)


def _frames_centered(x, centers, length):
    """Frames of ``length`` centered at ``centers`` with reflected edges."""
    N = len(x)
    starts = np.asarray(centers) - length // 2
    idx = starts[:, None] + np.arange(length)[None, :]
    # Kaldi edge reflection includes the boundary sample: s<0 -> -s-1,
    # s>=N -> 2N-1-s (matches ExtractWindow semantics, see data/mfcc.py)
    idx = np.where(idx < 0, -idx - 1, idx)
    idx = np.where(idx > N - 1, 2 * N - 1 - idx, idx)
    return x[np.clip(idx, 0, N - 1)]


def nccf(frames, lags, ballast=0.0):
    """Normalized cross-correlation: (T, W) frames × lags → (T, L).

    nccf[t, l] = <v0, vl> / sqrt(e0 · el + ballast), windows of length
    W − max(lags) so every lag compares equal-length segments.
    """
    T, W = frames.shape
    w = W - int(max(lags))
    v0 = frames[:, :w]
    e0 = np.sum(v0 * v0, axis=1)
    out = np.empty((T, len(lags)), np.float64)
    for i, lag in enumerate(lags):
        vl = frames[:, lag:lag + w]
        el = np.sum(vl * vl, axis=1)
        denom = np.sqrt(e0 * el + ballast)
        out[:, i] = np.sum(v0 * vl, axis=1) / np.maximum(denom, 1e-20)
    return out


def _viterbi_lags(scores, lags, penalty_factor):
    """Max-sum path over the lag grid with log²-ratio transition cost."""
    T, L = scores.shape
    log_lag = np.log(np.asarray(lags, np.float64))
    trans = -penalty_factor * (log_lag[:, None] - log_lag[None, :]) ** 2
    acc = scores[0].copy()
    back = np.zeros((T, L), np.int32)
    for t in range(1, T):
        total = acc[None, :] + trans  # (to, from)
        back[t] = np.argmax(total, axis=1)
        acc = total[np.arange(L), back[t]] + scores[t]
    path = np.zeros((T,), np.int32)
    path[-1] = int(np.argmax(acc))
    for t in range(T - 1, 0, -1):
        path[t - 1] = back[t, path[t]]
    return path


def kaldi_pitch(x, fs, *, min_f0=50.0, max_f0=400.0, frame_shift_ms=10.0,
                frame_length_ms=25.0, resample_freq=4000,
                lowpass_cutoff=1000.0, penalty_factor=0.1,
                nccf_ballast=7000.0, n_frames=None):
    """Waveform → (T, 2) columns [nccf_pov, f0_hz] (Kaldi compute-kaldi-pitch
    semantics; defaults = conf/pitch.conf at 16 kHz). ``n_frames`` forces the
    output frame count (to align with an fbank extracted at the same shift).
    """
    y = _lowpass_resample(x, fs, resample_freq, lowpass_cutoff)
    shift = int(resample_freq * frame_shift_ms / 1000)
    if n_frames is None:
        n_frames = 1 + int(len(x) / (fs * frame_shift_ms / 1000))
    centers = (np.arange(n_frames) * shift).astype(np.int64)

    lag_min = int(resample_freq / max_f0)
    lag_max = int(round(resample_freq / min_f0))
    lags = np.arange(lag_min, lag_max + 1)
    W = int(resample_freq * frame_length_ms / 1000) + lag_max
    frames = _frames_centered(y, centers, W)
    frames = frames - frames.mean(axis=1, keepdims=True)

    # Ballast suppresses NCCF of below-average-energy (silence) frames so the
    # Viterbi path prefers continuity there. Kaldi scales it by a running
    # signal energy; the batch analog normalizes by the utterance mean frame
    # energy, calibrated so the default (7000) weighs a mean-energy frame by
    # 1/sqrt(2) — same qualitative selectivity, scale-invariant input.
    w = W - lag_max
    mean_e = float(np.mean(np.sum(frames[:, :w] ** 2, axis=1))) + 1e-20
    scores = nccf(frames, lags,
                  ballast=(nccf_ballast / 7000.0) * mean_e ** 2)
    pov_scores = nccf(frames, lags, ballast=0.0)

    path = _viterbi_lags(scores, lags, penalty_factor)
    f0 = resample_freq / lags[path].astype(np.float64)
    pov = pov_scores[np.arange(n_frames), path]
    return np.stack([pov, f0], axis=1).astype(np.float32)


def _pov_feature(n):
    """Kaldi NccfToPovFeature: 2((1.0001 − n)^0.15 − 1)."""
    return 2.0 * ((1.0001 - n) ** 0.15 - 1.0)


def _pov_prob(n):
    """P(voiced | nccf): logistic fit of Kaldi's NccfToPov polynomial
    (documented deviation — same monotone shape, 0..1 range)."""
    return 1.0 / (1.0 + np.exp(-8.0 * (np.clip(n, -1.0, 1.0) - 0.4)))


def process_pitch(pitch, *, normalization_window=151, delta_window=2,
                  delta_scale=10.0):
    """(T, 2) [nccf, f0] → (T, 3) [pov_feature, norm_log_pitch, delta_pitch]
    (Kaldi process-kaldi-pitch-feats default output layout)."""
    nccf_col, f0 = pitch[:, 0].astype(np.float64), pitch[:, 1].astype(
        np.float64)
    T = len(f0)
    log_f0 = np.log(np.maximum(f0, 1e-10))
    prob = _pov_prob(nccf_col)

    # POV-weighted sliding mean of log-pitch
    half = normalization_window // 2
    norm = np.empty_like(log_f0)
    for t in range(T):
        lo, hi = max(0, t - half), min(T, t + half + 1)
        wsum = prob[lo:hi].sum()
        mean = ((prob[lo:hi] * log_f0[lo:hi]).sum() / wsum
                if wsum > 1e-8 else log_f0[lo:hi].mean())
        norm[t] = log_f0[t] - mean

    # delta of log-pitch (standard regression delta, window 2)
    d = delta_window
    denom = 2.0 * sum(i * i for i in range(1, d + 1))
    padded = np.pad(log_f0, (d, d), mode="edge")
    delta = np.zeros_like(log_f0)
    for i in range(1, d + 1):
        delta += i * (padded[d + i:d + i + T] - padded[d - i:d - i + T])
    delta = delta / denom * delta_scale

    return np.stack([_pov_feature(nccf_col), norm, delta],
                    axis=1).astype(np.float32)


def pitch_feats(x, fs, *, n_frames=None, **kw):
    """Full chain: waveform → (T, 3) pitch features."""
    return process_pitch(kaldi_pitch(x, fs, n_frames=n_frames, **kw))
