"""Aligned (waveform, log-mel) segments for training the vocoder.

Counterpart of ``vae_npvc_tpu/data/wav_mel.py`` (``WavMelDataset``) over
the Kaldi data-dir contract: reads ``wav.scp`` (plain paths or commands
ending in ``|``), resamples to ``fs`` when needed, zero-pads an utterance
shorter than ``batch_max_frames + 1`` frames, extracts the log-mel with the
experiment's fbank parameters (``data/features.logmelspectrogram``, on the
CPU) and yields random segments where mel frames ``[m0, m0 + M)`` align
with samples ``[m0 * hop, (m0 + M) * hop)``. The crops are numpy draws,
the same as JAX's for the same seed.

Corpora of at most ``preload_limit`` utterances (default 4000) are read and
featurized once; larger ones are read per batch.

Config keys: ``fs``, ``n_fft``, ``n_shift``, ``n_mels``, ``fmin``, ``fmax``,
``batch_max_frames`` (mel frames per segment) and ``preload_limit``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch


class WavMelDataset:
    def __init__(self, data_dir, config):
        from . import kaldi_io

        cfg = dict(config)
        self.fs = cfg.get("fs", 24000)
        self.n_fft = cfg.get("n_fft", 1024)
        self.hop = cfg.get("n_shift", 256)
        self.n_mels = cfg.get("n_mels", 80)
        self.fmin = cfg.get("fmin")
        self.fmax = cfg.get("fmax")
        self.max_frames = cfg.get("batch_max_frames", 48)

        data_dir = Path(data_dir)
        scp = data_dir / "wav.scp" if data_dir.is_dir() else data_dir
        self.entries = list(kaldi_io.read_scp(scp).items())
        if not self.entries:
            raise ValueError(f"no wav.scp entries under {scp}")
        self.preload = len(self.entries) <= cfg.get("preload_limit", 4000)
        self.items = None  # (utt, wav (N,), mel (T, n_mels)) when preloaded
        if self.preload:
            self.items = [self._load(u, e) for u, e in self.entries]

    def _load(self, utt, entry):
        from . import kaldi_io
        from .features import logmelspectrogram, resample

        sr, x = kaldi_io.read_wav_scp_entry(entry)
        if x.ndim > 1:
            x = x[:, 0]
        x = resample(x, sr, self.fs)
        min_samples = (self.max_frames + 1) * self.hop
        if len(x) < min_samples:
            x = np.pad(x, (0, min_samples - len(x)))
        x = x.astype(np.float32)
        with torch.no_grad():
            mel = logmelspectrogram(
                torch.from_numpy(x[None]), fs=self.fs, n_fft=self.n_fft,
                n_shift=self.hop, n_mels=self.n_mels, fmin=self.fmin,
                fmax=self.fmax)[0].numpy()
        return utt, x, mel

    def _get(self, k):
        if self.items is not None:
            return self.items[k]
        return self._load(*self.entries[k])

    def __len__(self):
        return len(self.entries)

    def padded_nbytes(self):
        """Bytes :meth:`padded_arrays` stages (the ``device_resident:
        auto`` size check)."""
        if not self.preload:
            raise ValueError("padded_nbytes() needs the preloaded mode")
        T_max = max(mel.shape[0] for _, _, mel in self.items)
        return len(self.items) * T_max * (self.hop + self.n_mels) * 4

    def padded_arrays(self):
        """The whole corpus, padded: ``(wavs (N, S), mels (N, T, D), m_hi
        (N,))`` with ``m_hi[i]`` the largest valid segment start (in mel
        frames) of utterance i. Staged on the device once by the vocoder
        trainer, which then draws crops there. Needs the preloaded mode."""
        if not self.preload:
            raise ValueError("padded_arrays() needs the preloaded mode "
                             "(corpus <= preload_limit)")
        M = self.max_frames
        T_max = max(mel.shape[0] for _, _, mel in self.items)
        S_max = T_max * self.hop
        N = len(self.items)
        wavs = np.zeros((N, S_max), np.float32)
        mels = np.zeros((N, T_max, self.n_mels), np.float32)
        m_hi = np.zeros((N,), np.int32)
        for i, (_, x, mel) in enumerate(self.items):
            s = min(len(x), S_max)
            wavs[i, :s] = x[:s]
            mels[i, :mel.shape[0]] = mel
            m_hi[i] = max(min(mel.shape[0], len(x) // self.hop) - M, 0)
        return wavs, mels, m_hi

    def batches(self, batch_size, *, seed=0, epochs=None):
        """Yield ``(wav (B, M * hop), mel (B, M, n_mels))`` random aligned
        crops. ``batch_size`` is clamped to the corpus size, so a small
        corpus still yields a batch every epoch."""
        rng = np.random.default_rng(seed)
        batch_size = min(batch_size, len(self.entries))
        M = self.max_frames
        seg = M * self.hop
        epoch = 0
        while epochs is None or epoch < epochs:
            epoch += 1
            order = rng.permutation(len(self.entries))
            for lo in range(0, len(order) - batch_size + 1, batch_size):
                wavs = np.zeros((batch_size, seg), np.float32)
                mels = np.zeros((batch_size, M, self.n_mels), np.float32)
                for b, k in enumerate(order[lo:lo + batch_size]):
                    _, x, mel = self._get(k)
                    # mel frame t is centred at sample t * hop; the usable
                    # starts keep the wav window inside the signal
                    m_hi = min(mel.shape[0], len(x) // self.hop) - M
                    m0 = int(rng.integers(0, max(m_hi, 0) + 1))
                    mels[b] = mel[m0:m0 + M]
                    wavs[b] = x[m0 * self.hop:(m0 + M) * self.hop]
                yield wavs, mels
