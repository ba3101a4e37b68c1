"""STFT -> log10-mel fbank and its inverse (Griffin-Lim), with torch.fft.

Counterpart of ``vae_npvc_tpu/data/features.py`` (lines 31-233): hann
window, centered frames with reflect padding, |STFT|, slaney-normalized mel
filterbank over [fmin, fmax], ``log10(max(EPS, mel))``. Waveforms and
spectra are tensors on any device; the filterbank is host numpy, built once
per parameter set.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

EPS = 1e-10


def hz_to_mel(f):
    """Slaney mel scale (librosa default, htk=False)."""
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = math.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz)
                    / logstep, f / f_sp)


def mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = math.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)), m * f_sp)


@functools.lru_cache(maxsize=16)
def mel_filterbank(sr, n_fft, n_mels, fmin=0.0, fmax=None):
    """(n_mels, n_fft//2+1) slaney-normalized triangular filterbank."""
    if fmax is None:
        fmax = sr / 2.0
    n_freqs = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sr / 2.0, n_freqs)
    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2:n_mels + 2] - hz_pts[:n_mels])
    return (weights * enorm[:, None]).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _inverse_filterbank(sr, n_fft, n_mels, fmin, fmax):
    """(n_freqs, n_mels) non-negative pseudo-inverse of the filterbank."""
    return np.maximum(0.0, np.linalg.pinv(
        mel_filterbank(sr, n_fft, n_mels, fmin, fmax))).astype(np.float32)


def resample(x, sr, fs):
    """Polyphase-resample host ``x`` from rate ``sr`` to ``fs``."""
    sr, fs = int(sr), int(fs)
    if sr == fs:
        return np.asarray(x, np.float32)
    from scipy.signal import resample_poly

    g = math.gcd(fs, sr)
    return resample_poly(x, fs // g, sr // g).astype(np.float32)


def num_frames(n_samples, n_shift):
    """Frame count of the centered STFT (librosa: 1 + n // hop)."""
    return 1 + n_samples // n_shift


@functools.lru_cache(maxsize=32)
def _window(n_fft, win_length, device, window="hann"):
    """Periodic hann (or, with ``window=None``, rectangular) window of
    ``win_length`` centered in ``n_fft``, on ``device`` (cached: read only).
    """
    win_length = win_length or n_fft
    if window == "hann":
        w = np.hanning(win_length + 1)[:-1].astype(np.float32)
    elif window is None:
        w = np.ones((win_length,), np.float32)
    else:
        raise ValueError(f"unknown window {window!r}")
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        w = np.pad(w, (lpad, n_fft - win_length - lpad))
    return torch.from_numpy(w).to(device)


def _frames(x, n_fft, n_shift, center):
    """(B, N) -> (B, T, n_fft) frames (a strided view)."""
    if center:
        pad = n_fft // 2
        x = F.pad(x[:, None, :], (pad, pad), mode="reflect")[:, 0]
    elif x.shape[1] < n_fft:
        raise ValueError(f"center=False needs >= n_fft={n_fft} samples, "
                         f"got {x.shape[1]}")
    return x.unfold(1, n_fft, n_shift)


def stft_magnitude(x, n_fft, n_shift, win_length=None, window="hann",
                   center=True):
    """|STFT| of (B, N) -> (B, T, n_fft//2+1), centered, reflect-padded."""
    w = _window(n_fft, win_length, x.device, window)
    frames = _frames(x, n_fft, n_shift, center)
    return torch.fft.rfft(frames * w, n=n_fft, dim=-1).abs()


def logmelspectrogram(x, *, fs, n_fft, n_shift, n_mels=80, fmin=None,
                      fmax=None, win_length=None, window="hann",
                      center=True):
    """(B, N) waveform -> (B, T, n_mels) log10-mel, ESPnet-compatible."""
    spc = stft_magnitude(x, n_fft, n_shift, win_length, window, center)
    mel = torch.from_numpy(mel_filterbank(fs, n_fft, n_mels, fmin or 0.0,
                                          fmax)).to(x.device)
    return torch.log10(torch.clamp(spc @ mel.T, min=EPS))


@functools.lru_cache(maxsize=32)
def _ola_norm(T, n_fft, n_shift, win_length, device):
    """Overlap-added squared window of T frames, floored at 1e-10, on
    ``device`` (cached: read only)."""
    w = _window(n_fft, win_length, device).cpu().numpy()
    idx = np.arange(T)[:, None] * n_shift + np.arange(n_fft)[None, :]
    norm = np.zeros(((T - 1) * n_shift + n_fft,), np.float32)
    np.add.at(norm, idx.reshape(-1), np.tile(w * w, T))
    return torch.from_numpy(np.maximum(norm, 1e-10)).to(device)


def istft(spec, n_fft, n_shift, win_length=None, window="hann", length=None):
    """Inverse STFT with hann-squared overlap-add normalization.

    ``spec`` complex (B, T, n_fft//2+1) -> (B, N).
    """
    B, T, _ = spec.shape
    w = _window(n_fft, win_length, spec.device)
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1) * w       # (B, T, n_fft)
    N_pad = (T - 1) * n_shift + n_fft
    out = F.fold(frames.transpose(1, 2), output_size=(1, N_pad),
                 kernel_size=(1, n_fft), stride=(1, n_shift))[:, 0, 0]
    out = out / _ola_norm(T, n_fft, n_shift, win_length, spec.device)
    out = out[:, n_fft // 2:]
    if length is not None:
        out = out[:, :length]
    return out


def griffin_lim(log_mel, *, fs, n_fft, n_shift, n_mels=80, fmin=None,
                fmax=None, win_length=None, n_iter=64, length=None, seed=0,
                phase=None):
    """log10-mel (B, T, M) -> waveform (B, N) by Griffin-Lim.

    The initial phase is ``phase`` (B, T, n_fft//2+1) when given, else
    uniform in [-pi, pi) from ``torch.Generator(device).manual_seed(seed)``.
    """
    dev = log_mel.device
    inv = torch.from_numpy(_inverse_filterbank(fs, n_fft, n_mels,
                                               fmin or 0.0, fmax)).to(dev)
    mag = torch.clamp(torch.pow(10.0, log_mel) @ inv.T, min=1e-10)
    if phase is None:
        gen = torch.Generator(dev).manual_seed(int(seed))
        phase = (torch.rand(mag.shape, generator=gen, device=dev)
                 * (2 * math.pi) - math.pi)
    spec = torch.polar(mag, phase.to(dev, torch.float32))
    T = mag.shape[1]
    for _ in range(n_iter):
        x = istft(spec, n_fft, n_shift, win_length)
        rebuilt = torch.fft.rfft(
            _frames(x, n_fft, n_shift, True)
            * _window(n_fft, win_length, dev), n=n_fft, dim=-1)[:, :T]
        spec = mag * (rebuilt / torch.clamp(rebuilt.abs(), min=1e-10))
    return istft(spec, n_fft, n_shift, win_length, length=length)
