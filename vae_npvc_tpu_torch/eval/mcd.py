"""Mel-cepstral distortion with DTW alignment (mel proxy + wav-domain mcep).

Self-contained analog of the reference's objective evaluation stage
(reference: egs/vcc20/vae1/local/ob_eval/evaluate.sh:57-69 drives an external
``mcd_calculate.py`` over WORLD mceps with per-speaker f0 search ranges from
``conf/<spk>.f0`` and knobs --mcep_dim/--mcep_alpha/--shiftms/--f0min/--f0max).
Two modes here:

- **mel proxy** (``mcd``/``mcd_from_scp``): cepstra as the DCT-II of log-mel
  features. Fast, works directly on the framework's feature arks, but numbers
  are NOT comparable to reference-published WORLD-mcep MCDs (different
  envelope estimator and frequency warping).
- **wav-domain mcep** (``mcd_wav``/``mcd_from_wavdirs``): from-scratch
  mel-cepstra with the reference's knob set — CheapTrick-style f0-adaptive
  spectral envelope by default (:func:`cheaptrick_envelope`; ``envelope=
  "stft"`` selects the plain |STFT| magnitude), first-order all-pass
  frequency warping with ``mcep_alpha`` (0.466 @ 24 kHz, the VCC2020
  setting), ``mcep_dim`` coefficients at ``shiftms`` frame shift,
  autocorrelation f0 with the per-speaker ``f0min``/``f0max`` range used to
  restrict scoring to frames voiced in both signals (WORLD/pysptk are not in
  this environment; the warping matches SPTK's mcep frequency axis, and the
  envelope's residual deviations from WORLD proper are implementation-level,
  documented on cheaptrick_envelope).

MCD formula both modes: 10/ln10 · sqrt(2 · Σ_{d≥1} (c1_d − c2_d)²) over
DTW-aligned frames, excluding c0 (energy).

The port's own copy of ``vae_npvc_tpu/eval/mcd.py`` (host numpy; the port
imports nothing of the JAX package).
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np

MCD_CONST = 10.0 / math.log(10.0) * math.sqrt(2.0)


def mel_to_cepstra(log_mel, n_cep=25):
    """(T, M) log10-mel → (T, n_cep) cepstra via orthonormal DCT-II."""
    T, M = log_mel.shape
    n = np.arange(M)
    k = np.arange(n_cep)
    basis = np.cos(np.pi * (n[None, :] + 0.5) * k[:, None] / M)  # (n_cep, M)
    basis *= np.sqrt(2.0 / M)
    basis[0] /= np.sqrt(2.0)
    # convert log10 to ln for conventional cepstra scaling
    return (log_mel * math.log(10.0)) @ basis.T


def dtw_path(cost):
    """Classic DTW over a (T1, T2) local-cost matrix → list of (i, j).

    Vectorized anti-diagonal sweep: every cell on diagonal ``i+j = d`` depends
    only on diagonals d-1 (up/left) and d-2 (diagonal), so each diagonal is one
    numpy gather+min — O(T1+T2) python iterations instead of the former
    O(T1·T2) per-cell loop (~100× at 1k×1k, making stage-7 eval of
    thousand-utterance sets feasible). Identical accumulation and backtrack
    tie-breaking (diag < up < left) to the scalar recurrence.
    """
    T1, T2 = cost.shape
    acc = np.full((T1 + 1, T2 + 1), np.inf)
    acc[0, 0] = 0.0
    for d in range(2, T1 + T2 + 1):
        i_lo, i_hi = max(1, d - T2), min(T1, d - 1)
        if i_lo > i_hi:
            continue
        i = np.arange(i_lo, i_hi + 1)
        j = d - i
        best = np.minimum(np.minimum(acc[i - 1, j], acc[i, j - 1]),
                          acc[i - 1, j - 1])
        acc[i, j] = cost[i - 1, j - 1] + best
    path = []
    i, j = T1, T2
    while i > 0 and j > 0:
        path.append((i - 1, j - 1))
        moves = (acc[i - 1, j - 1], acc[i - 1, j], acc[i, j - 1])
        m = int(np.argmin(moves))
        if m == 0:
            i, j = i - 1, j - 1
        elif m == 1:
            i -= 1
        else:
            j -= 1
    path.reverse()
    return path


def _pair_cost(ca, cb):
    """Euclidean cost matrix via one matmul (no (T1,T2,D) broadcast)."""
    sq = (np.sum(ca * ca, axis=1)[:, None] + np.sum(cb * cb, axis=1)[None, :]
          - 2.0 * (ca @ cb.T))
    return np.sqrt(np.maximum(sq, 0.0))


def mcd(log_mel_a, log_mel_b, n_cep=25, use_dtw=True):
    """MCD (dB) between two (T, M) log10-mel matrices."""
    ca = mel_to_cepstra(np.asarray(log_mel_a, np.float64), n_cep)[:, 1:]
    cb = mel_to_cepstra(np.asarray(log_mel_b, np.float64), n_cep)[:, 1:]
    if use_dtw:
        cost = _pair_cost(ca, cb)
        path = dtw_path(cost)
        d = np.array([cost[i, j] for i, j in path])
    else:
        T = min(ca.shape[0], cb.shape[0])
        d = np.sqrt(np.sum((ca[:T] - cb[:T]) ** 2, axis=-1))
    return MCD_CONST * float(np.mean(d))


def mcd_from_scp(scp_a, scp_b, n_cep=25):
    """Mean MCD over utterances shared by two feats.scp files."""
    from ..data import kaldi_io

    a = kaldi_io.read_scp(scp_a)
    b = kaldi_io.read_scp(scp_b)
    utts = [u for u in a if u in b]
    if not utts:
        raise ValueError("no shared utterances between the two scps")
    per_utt = {u: mcd(kaldi_io.load_mat(a[u]), kaldi_io.load_mat(b[u]),
                      n_cep) for u in utts}
    return float(np.mean(list(per_utt.values()))), per_utt


# ---------------------------------------------------------------------------
# wav-domain mcep MCD (reference knob set: evaluate.sh:57-69)
# ---------------------------------------------------------------------------

def read_f0_range(conf_path):
    """Read a reference-style ``conf/<spk>.f0`` file: "<f0min> <f0max>"."""
    lo, hi = Path(conf_path).read_text().split()[:2]
    return float(lo), float(hi)


def default_mcep_alpha(fs):
    """Standard all-pass warping constants by sample rate (SPTK convention;
    the VCC2020 recipes use 0.466 at 24 kHz)."""
    table = {8000: 0.312, 16000: 0.41, 22050: 0.455, 24000: 0.466,
             44100: 0.544, 48000: 0.554}
    return table.get(int(fs), 0.42)


def estimate_f0(x, fs, f0min=70.0, f0max=400.0, shiftms=5.0,
                frame_sec=0.04, voicing_threshold=0.45):
    """Frame-wise autocorrelation f0; 0 for unvoiced frames.

    Stand-in for WORLD harvest bounded by the per-speaker range
    (reference evaluate.sh:58-59 reads the range from conf/<spk>.f0).
    Batched: all frames' autocorrelations come from one FFT-based
    correlation (|rfft|² → irfft), no per-frame python work.
    """
    x = np.asarray(x, np.float64)
    hop = int(fs * shiftms / 1000.0)
    win = int(fs * frame_sec)
    lag_min = max(int(fs / f0max), 2)
    lag_max = min(int(fs / f0min), win - 1)
    n_frames = max(1 + (len(x) - win) // hop, 0)
    if n_frames == 0 or lag_max < lag_min:
        return np.zeros(n_frames)
    idx = np.arange(n_frames)[:, None] * hop + np.arange(win)[None, :]
    frames = x[idx]
    frames = frames - frames.mean(axis=1, keepdims=True)
    e0 = np.sum(frames * frames, axis=1)                       # (T,)
    nfft = 1 << int(np.ceil(np.log2(2 * win)))
    spec = np.fft.rfft(frames, nfft, axis=1)
    ac = np.fft.irfft(spec * np.conj(spec), nfft, axis=1)[:, :win]
    with np.errstate(invalid="ignore", divide="ignore"):
        nac = ac / np.maximum(e0[:, None], 1e-12)
    seg = nac[:, lag_min:lag_max + 1]                          # (T, L)
    k = np.argmax(seg, axis=1)
    peak = seg[np.arange(n_frames), k]
    f0 = np.where((peak > voicing_threshold) & (e0 >= 1e-8),
                  fs / (lag_min + k), 0.0)
    return f0


def _warp_frequencies(omega, alpha):
    """First-order all-pass frequency warping ω → ω̃ (SPTK mcep axis)."""
    return omega + 2.0 * np.arctan2(alpha * np.sin(omega),
                                    1.0 - alpha * np.cos(omega))


def cheaptrick_envelope(x, fs, f0, shiftms=5.0, n_fft=1024,
                        default_f0=500.0, q1=-0.15, f0_frame_sec=0.04):
    """CheapTrick-style spectral envelope (T, n_fft//2+1), power domain.

    From-scratch implementation of the WORLD CheapTrick algorithm (Morise
    2015) — the envelope estimator behind the reference's mcep MCD stage
    (reference: egs/vcc20/vae1/local/ob_eval/evaluate.sh:57-69 calls an
    mcd_calculate.py that extracts WORLD mceps; WORLD itself is not in this
    environment). Steps per frame:

      1. f0-adaptive Hanning window of length ``3·fs/f0`` centered on the
         frame, power spectrum (unvoiced frames use ``default_f0`` = 500 Hz,
         WORLD's kDefaultF0);
      2. rectangular smoothing of the power spectrum with width ``2·f0/3``
         (via the cumulative integral — exact boxcar of per-frame width);
      3. quefrency liftering of the log spectrum with
         ``sinc(f0·τ)·(1 + 2·q1·(1 - cos(2π·f0·τ)))``-style smoothing +
         compensation lifter (q1 = −0.15, WORLD's value; the 2015 paper
         prints −0.09 — documented deviation source).

    Remaining deviations from WORLD proper: no DC-component correction below
    f0 (step 1's add-noise/DC replacement) and f0 comes from the
    autocorrelation tracker, not DIO/Harvest.
    """
    x = np.asarray(x, np.float64)
    hop = int(fs * shiftms / 1000.0)
    K = n_fft // 2 + 1
    T = len(f0)
    f0_use = np.where(f0 > 0, f0, default_f0)
    # clamp so the 3·T0 window fits the FFT
    f0_use = np.maximum(f0_use, 3.0 * fs / n_fft)

    # 1. f0-adaptive windowed power spectra (zero-padded into one batch FFT)
    # Frame t's adaptive window is centered on the SAME sample as
    # estimate_f0's frame t (its [t·hop, t·hop+win) analysis window's
    # midpoint, win = fs·f0_frame_sec) so the f0 value sizing the window /
    # smoothing / lifter describes the segment it is applied to.
    frames = np.zeros((T, n_fft))
    centers = np.arange(T) * hop + int(fs * f0_frame_sec) // 2
    for t in range(T):  # windows have per-frame lengths; placement only
        half = int(1.5 * fs / f0_use[t])
        n = np.arange(-half, half + 1)
        w = 0.5 + 0.5 * np.cos(np.pi * n / (half + 1))   # Hanning, len 3·T0
        seg_idx = np.clip(centers[t] + n, 0, len(x) - 1)
        seg = np.where((centers[t] + n >= 0) & (centers[t] + n < len(x)),
                       x[seg_idx], 0.0)
        m = min(len(seg), n_fft)
        frames[t, :m] = (seg * w)[:m]
    power = np.abs(np.fft.rfft(frames, n_fft, axis=1)) ** 2 + 1e-30

    # 2. boxcar smoothing, width 2/3·f0 per frame, by cumulative integral
    freqs = np.arange(K) * fs / n_fft
    cum = np.concatenate([np.zeros((T, 1)), np.cumsum(power, axis=1)], axis=1)
    width = (2.0 / 3.0) * f0_use                          # Hz, per frame
    half_bins = width[:, None] / 2.0 / (fs / n_fft)       # fractional bins
    pos_hi = np.clip(np.arange(K)[None, :] + half_bins, 0, K - 1)
    pos_lo = np.clip(np.arange(K)[None, :] - half_bins, 0, K - 1)

    def frac_cum(pos):
        lo = np.floor(pos).astype(int)
        wfrac = pos - lo
        r = np.arange(T)[:, None]
        # integral of power from bin 0 to fractional bin `pos`
        return cum[r, lo] + power[r, np.minimum(lo, K - 1)] * wfrac

    smoothed = (frac_cum(pos_hi) - frac_cum(pos_lo)) / np.maximum(
        pos_hi - pos_lo, 1e-9)

    # 3. cepstral liftering of the log spectrum
    logp = np.log(smoothed)
    cep = np.fft.irfft(logp, n_fft, axis=1)[:, :K]        # real cepstrum half
    tau = np.arange(K) / fs
    ft = f0_use[:, None] * tau[None, :]
    smoothing = np.sinc(ft)                               # sin(πfτ)/(πfτ)
    # WORLD: (1 - 2q1) + 2q1·cos(2πf0τ)  ==  1 - 2q1·(1 - cos(2πf0τ))
    compensation = 1.0 - 2.0 * q1 * (1.0 - np.cos(2.0 * np.pi * ft))
    lifted = cep * smoothing * compensation
    # rebuild the even-symmetric cepstrum and return to the log spectrum
    full = np.concatenate([lifted, lifted[:, -2:0:-1]], axis=1)
    return np.exp(np.real(np.fft.rfft(full, axis=1))[:, :K])


def mcep_from_wav(x, fs, mcep_dim=34, mcep_alpha=None, shiftms=5.0,
                  n_fft=1024, envelope="cheaptrick", f0=None,
                  f0min=70.0, f0max=400.0):
    """(samples,) → (T, mcep_dim+1) warped cepstra (c0..c_dim).

    Log spectral envelope resampled onto the alpha-warped frequency axis, then
    an inverse-DCT-style projection to ``mcep_dim+1`` cepstral coefficients —
    the same frequency warping as SPTK mcep (the reference's extractor).
    ``envelope`` selects the estimator:

    - ``"cheaptrick"`` (default): f0-adaptive CheapTrick-style envelope
      (:func:`cheaptrick_envelope`) — the WORLD algorithm the reference's
      mcd_calculate.py uses, making MCD values directly comparable to
      reference-published numbers up to the documented implementation-level
      deviations;
    - ``"stft"``: plain log |STFT| magnitude (the pre-round-3 behavior).
    """
    if mcep_alpha is None:
        mcep_alpha = default_mcep_alpha(fs)
    x = np.asarray(x, np.float64)
    hop = int(fs * shiftms / 1000.0)
    K = n_fft // 2 + 1
    if envelope == "cheaptrick":
        if f0 is None:
            f0 = estimate_f0(x, fs, f0min, f0max, shiftms)
        env = cheaptrick_envelope(x, fs, f0, shiftms, n_fft)  # power
        logs = 0.5 * np.log(np.maximum(env, 1e-20))           # log amplitude
    else:
        win = np.hanning(n_fft)
        n_frames = max(1 + (len(x) - n_fft) // hop, 0)
        frames = np.stack([x[t * hop:t * hop + n_fft] * win
                           for t in range(n_frames)]) if n_frames else \
            np.zeros((0, n_fft))
        spec = np.abs(np.fft.rfft(frames, n_fft, axis=-1))
        logs = np.log(np.maximum(spec, 1e-10))

    # sample the log envelope on the UNwarped axis at positions whose warped
    # image is uniform: invert the warp by interpolation
    omega = np.linspace(0.0, np.pi, K)
    warped = _warp_frequencies(omega, mcep_alpha)      # monotone 0..pi
    uniform = np.linspace(0.0, np.pi, K)
    # for each uniform warped frequency find the source (unwarped) frequency
    src = np.interp(uniform, warped, omega)
    pos = src / np.pi * (K - 1)
    lo = np.floor(pos).astype(int)
    hi = np.minimum(lo + 1, K - 1)
    w = pos - lo
    warped_logs = logs[:, lo] * (1.0 - w) + logs[:, hi] * w

    # cepstra of the warped log envelope (orthonormal-free cosine transform,
    # the convention behind the 10/ln10*sqrt(2) MCD constant)
    k = np.arange(mcep_dim + 1)
    basis = np.cos(np.pi * np.arange(K)[None, :] * k[:, None] / (K - 1))
    basis[:, 0] *= 0.5
    basis[:, -1] *= 0.5
    return (warped_logs @ basis.T) * (2.0 / (K - 1))


def mcd_wav(x_a, x_b, fs, *, mcep_dim=34, mcep_alpha=None, shiftms=5.0,
            f0min=70.0, f0max=400.0, voiced_only=True, n_fft=1024,
            envelope="cheaptrick"):
    """Reference-knob MCD between two waveforms (converted vs ground truth).

    DTW over warped mceps excluding c0; with ``voiced_only`` the reported
    mean runs over aligned frame pairs voiced in both signals (f0 search
    bounded by the per-speaker range, reference conf/<spk>.f0).
    """
    f0a = estimate_f0(x_a, fs, f0min, f0max, shiftms)
    f0b = estimate_f0(x_b, fs, f0min, f0max, shiftms)
    ca = mcep_from_wav(x_a, fs, mcep_dim, mcep_alpha, shiftms, n_fft,
                       envelope=envelope, f0=f0a)[:, 1:]
    cb = mcep_from_wav(x_b, fs, mcep_dim, mcep_alpha, shiftms, n_fft,
                       envelope=envelope, f0=f0b)[:, 1:]
    if min(len(ca), len(cb)) == 0:
        raise ValueError("empty mcep sequence")
    cost = _pair_cost(ca, cb)
    path = dtw_path(cost)
    if voiced_only:
        va, vb = f0a > 0, f0b > 0
        sel = [(i, j) for i, j in path
               if i < len(va) and j < len(vb) and va[i] and vb[j]]
        if sel:
            path = sel
    d = np.array([cost[i, j] for i, j in path])
    return MCD_CONST * float(np.mean(d))


def mcd_from_wavdirs(wavdir, gtwavdir, *, f0_conf=None, mcep_dim=34,
                     mcep_alpha=None, shiftms=5.0, f0min=70.0, f0max=400.0,
                     voiced_only=True, envelope="cheaptrick"):
    """Mean MCD between converted wavs and target ground-truth wavs.

    Pairing: a converted ``<src>_<stem>.wav`` matches a GT file whose name
    ends with the same ``<stem>`` (the parallel-corpus convention — VCC2020
    eval sentences exist for every speaker; reference mcd stage pairs
    converted audio with ``${db_root}/${trgspk}`` recordings of the same
    sentence, evaluate.sh:60-69).
    """
    from ..data.kaldi_io import read_wav_scp_entry

    def read_wav(p):
        # shared reader: handles int16/int32/uint8/float and collapses
        # multi-channel to mono (a hand-rolled int16-only frombuffer would
        # silently misparse stereo/24-bit ground truth)
        fs, x = read_wav_scp_entry(str(p), dtype=np.float64)
        if x.ndim > 1:
            x = x.mean(axis=1)
        return fs, x

    if f0_conf:
        f0min, f0max = read_f0_range(f0_conf)
    gt = {}
    for p in sorted(Path(gtwavdir).glob("**/*.wav")):
        stem = p.stem.split("_")[-1]
        if stem in gt:
            raise ValueError(
                f"ambiguous ground truth for sentence stem '{stem}': "
                f"{gt[stem]} and {p} — pass the single-speaker directory "
                "(e.g. db_root/<trgspk>), not a multi-speaker root")
        gt[stem] = p
    per_utt = {}
    for p in sorted(Path(wavdir).glob("*.wav")):
        stem = p.stem.split("_")[-1]
        if stem not in gt:
            continue
        fs_a, xa = read_wav(p)
        fs_b, xb = read_wav(gt[stem])
        if fs_a != fs_b:
            raise ValueError(f"sample-rate mismatch {p} vs {gt[stem]}")
        per_utt[p.stem] = mcd_wav(xa, xb, fs_a, mcep_dim=mcep_dim,
                                  mcep_alpha=mcep_alpha, shiftms=shiftms,
                                  f0min=f0min, f0max=f0max,
                                  voiced_only=voiced_only, envelope=envelope)
    if not per_utt:
        raise ValueError("no (converted, ground-truth) wav pairs matched")
    return float(np.mean(list(per_utt.values()))), per_utt
