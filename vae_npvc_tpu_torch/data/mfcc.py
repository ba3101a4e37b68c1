"""Kaldi-semantics MFCC + energy VAD (the x-vector front-end features).

The reference's similarity stage extracts 30-dim MFCCs and an energy-VAD mask
with Kaldi's ``compute-mfcc-feats`` / ``compute-vad`` before the SITW x-vector
net (reference: egs/vcc20/vae1/local/ob_eval/evaluate_similarity.sh:82-104,
conf/mfcc.conf = 16 kHz / 25 ms / 30 bins / 30 ceps / low 20 / high 7600 /
snip-edges false; conf/vad.conf = threshold 5.5 / mean-scale 0.5 /
proportion 0.12 / context 2). This module reimplements both from the Kaldi
algorithm spec so the in-framework embedder chain (eval/similarity.py) can run
the reference's wav-domain front-end without Kaldi:

- framing: snip-edges=false centering (frame t centered at
  ``t*shift + shift/2``) with edge reflection, per-frame DC removal, raw log
  energy before preemphasis, preemphasis 0.97, povey window
  ``(0.5 - 0.5 cos)^0.85``;
- power spectrum → HTK-scale mel bank (no area norm) → ln → orthonormal
  DCT-II → cepstral lifter 22 → optional C0 := raw log energy
  (Kaldi --use-energy default);
- VAD: frame voiced iff ≥ ``proportion``-fraction of its ±context window
  exceeds ``threshold + mean_scale · mean(log_energy)``.

Deviation from Kaldi (documented): no dither (deterministic pipeline — the
reference recipes score converted, i.e. synthetic, audio where dither's
numeric effect is negligible and reproducibility matters more).

Host-side numpy: this is the objective-eval path (a few hundred short
utterances), not the training hot loop — the training features stay on-device
in data/features.py.

The port's own copy of ``vae_npvc_tpu/data/mfcc.py`` (host numpy; the port
imports nothing of the JAX package).
"""

from __future__ import annotations

import math

import numpy as np

EPS = np.finfo(np.float32).eps


def hz_to_mel_htk(f):
    return 1127.0 * np.log1p(np.asarray(f, np.float64) / 700.0)


def mel_to_hz_htk(m):
    return 700.0 * (np.exp(np.asarray(m, np.float64) / 1127.0) - 1.0)


def mel_banks_htk(num_bins, n_fft, fs, low_freq=20.0, high_freq=0.0):
    """Kaldi MelBanks: (num_bins, n_fft//2+1), triangles in HTK-mel space,
    unnormalized. ``high_freq <= 0`` means Nyquist + high_freq."""
    if high_freq <= 0.0:
        high_freq = fs / 2.0 + high_freq
    n_freqs = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, fs / 2.0, n_freqs)
    mel_low, mel_high = hz_to_mel_htk(low_freq), hz_to_mel_htk(high_freq)
    centers = np.linspace(mel_low, mel_high, num_bins + 2)
    mel_f = hz_to_mel_htk(fft_freqs)
    lower = (mel_f[None, :] - centers[:-2, None]) / (
        centers[1:-1, None] - centers[:-2, None])
    upper = (centers[2:, None] - mel_f[None, :]) / (
        centers[2:, None] - centers[1:-1, None])
    return np.maximum(0.0, np.minimum(lower, upper)).astype(np.float64)


def povey_window(n):
    return (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / (n - 1))) ** 0.85


def frame_signal(x, frame_length, frame_shift, snip_edges=False):
    """(N,) → (T, frame_length). snip_edges=false: frame t is centered at
    ``t*shift + shift/2`` with reflected edges; T = (N + shift/2) // shift."""
    x = np.asarray(x, np.float64)
    N = len(x)
    if snip_edges:
        T = max(0, 1 + (N - frame_length) // frame_shift)
        starts = np.arange(T) * frame_shift
    else:
        T = (N + frame_shift // 2) // frame_shift
        centers = np.arange(T) * frame_shift + frame_shift // 2
        starts = centers - frame_length // 2
    idx = starts[:, None] + np.arange(frame_length)[None, :]
    # reflect out-of-range indices: Kaldi ExtractWindow mirrors about the
    # edge INCLUDING the boundary sample (x[-1]->x[0], x[N]->x[N-1]),
    # i.e. s<0 -> -s-1 and s>=N -> 2N-1-s
    idx = np.where(idx < 0, -idx - 1, idx)
    idx = np.where(idx > N - 1, 2 * N - 1 - idx, idx)
    idx = np.clip(idx, 0, N - 1)
    return x[idx]


def mfcc(x, fs=16000, *, frame_length_ms=25.0, frame_shift_ms=10.0,
         num_mel_bins=30, num_ceps=30, low_freq=20.0, high_freq=-100.0,
         preemphasis=0.97, cepstral_lifter=22.0, use_energy=True,
         snip_edges=False):
    """Kaldi-semantics MFCC of one waveform (N,) → (T, num_ceps) float32.

    Defaults = the reference's conf/mfcc.conf (high_freq=-100 ≡ 7900 at
    16 kHz; the conf pins 7600, i.e. high_freq passed as 7600).
    Also returns the raw log-energy column separately: (feats, log_energy).
    """
    frame_length = int(fs * frame_length_ms / 1000)
    frame_shift = int(fs * frame_shift_ms / 1000)
    n_fft = 1 << (frame_length - 1).bit_length()  # round up to power of 2

    frames = frame_signal(x, frame_length, frame_shift, snip_edges)
    frames = frames - frames.mean(axis=1, keepdims=True)      # remove DC
    log_energy = np.log(np.maximum(np.sum(frames ** 2, axis=1), EPS))
    if preemphasis:
        pre = np.concatenate([frames[:, :1], frames[:, :-1]], axis=1)
        frames = frames - preemphasis * pre
    frames = frames * povey_window(frame_length)[None, :]

    spec = np.fft.rfft(frames, n=n_fft, axis=1)
    power = spec.real ** 2 + spec.imag ** 2
    banks = mel_banks_htk(num_mel_bins, n_fft, fs, low_freq, high_freq)
    mel = np.log(np.maximum(power @ banks.T, EPS))

    # orthonormal DCT-II, first num_ceps rows
    n = num_mel_bins
    k = np.arange(num_ceps)[:, None]
    dct = np.cos(np.pi * k * (2 * np.arange(n)[None, :] + 1) / (2 * n))
    dct *= np.sqrt(2.0 / n)
    dct[0] *= 1.0 / np.sqrt(2.0)
    feats = mel @ dct.T

    if cepstral_lifter:
        i = np.arange(num_ceps)
        feats = feats * (1.0 + 0.5 * cepstral_lifter
                         * np.sin(np.pi * i / cepstral_lifter))[None, :]
    if use_energy:
        feats[:, 0] = log_energy
    return feats.astype(np.float32), log_energy.astype(np.float32)


def compute_vad(log_energy, *, energy_threshold=5.5, energy_mean_scale=0.5,
                frames_context=2, proportion_threshold=0.12):
    """Kaldi ComputeVadEnergy: per-frame 0/1 voiced mask.

    Defaults = the reference's conf/vad.conf. A frame is voiced iff at least
    ``proportion_threshold`` of the frames in its ±context window have
    ``log_energy > threshold + mean_scale * mean(log_energy)``.
    """
    e = np.asarray(log_energy, np.float64)
    T = len(e)
    if T == 0:
        return np.zeros((0,), np.float32)
    thresh = energy_threshold + energy_mean_scale * e.mean()
    above = (e > thresh).astype(np.float64)
    out = np.zeros((T,), np.float32)
    c = frames_context
    for t in range(T):
        lo, hi = max(0, t - c), min(T, t + c + 1)
        den = hi - lo
        num = above[lo:hi].sum()
        out[t] = 1.0 if num >= den * proportion_threshold else 0.0
    return out


def mfcc_vad(x, fs=16000, *, mfcc_opts=None, vad_opts=None):
    """Full front-end: waveform → voiced-only MFCC frames (Kaldi
    select-voiced-frames semantics, evaluate_similarity.sh:95-104).

    Kaldi's energy-VAD thresholds assume int16-scale samples; unit-range
    input ([-1, 1] floats, the shared wav readers' convention) is scaled up
    internally so the adaptive energy threshold keeps Kaldi's operating
    point — callers pass either convention."""
    x = np.asarray(x, np.float64)
    if x.size and np.abs(x).max() <= 1.0:
        x = x * 32768.0
    feats, log_e = mfcc(x, fs, **(mfcc_opts or {}))
    mask = compute_vad(log_e, **(vad_opts or {})) > 0.5
    return feats[mask]
