"""Griffin-Lim synthesis CLI: log-mel feature arks -> wav files.

Counterpart of ``vae_npvc_tpu/bin/convert_fbank.py``: utterances are
padded to 128-frame buckets with log10(1e-10), phase-recovered in batches
of ``batch_size`` on the device (``data/features.griffin_lim``), cut to
``frames * n_shift`` samples, peak-normalized to 0.95 and written as int16
``<utt>.wav``. ``--device cpu`` runs it on the CPU; without a GPU the
default raises, and a device failure is not retried elsewhere.

Usage:
    python -m vae_npvc_tpu_torch.bin.convert_fbank --fs 24000 --n_fft 1024 \
        --n_shift 256 --n_mels 80 --fmin 80 --fmax 7600 --iters 64 \
        decode_denorm/feats.scp decode_denorm/wav
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def convert_fbank(feats_scp, out_dir, *, fs, n_fft, n_shift, n_mels=80,
                  fmin=None, fmax=None, win_length=None, n_iter=64,
                  batch_size=4, device="cuda"):
    """Write one wav per matrix of ``feats_scp``; returns the count."""
    import torch
    from scipy.io import wavfile

    from ..data import features, kaldi_io
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    items = [(u, kaldi_io.load_mat(rx))
             for u, rx in kaldi_io.read_scp(feats_scp).items()]
    if items and items[0][1].shape[1] != n_mels:
        raise ValueError(
            f"--n_mels {n_mels} does not match the features' mel dim "
            f"{items[0][1].shape[1]} ({feats_scp}) — pass the SAME feature "
            "flags (fs/n_fft/n_shift/n_mels) the extraction stage used")

    buckets = {}
    for utt, mel in items:
        buckets.setdefault(-(-mel.shape[0] // 128) * 128, []).append(
            (utt, mel))
    n = 0
    for T_pad in sorted(buckets):
        group = buckets[T_pad]
        for lo in range(0, len(group), batch_size):
            chunk = group[lo:lo + batch_size]
            batch = np.full((len(chunk), T_pad, n_mels), np.log10(1e-10),
                            np.float32)
            for b, (_, mel) in enumerate(chunk):
                batch[b, :mel.shape[0]] = mel
            with torch.inference_mode():
                wav = features.griffin_lim(
                    torch.from_numpy(batch).to(dev), fs=fs, n_fft=n_fft,
                    n_shift=n_shift, n_mels=n_mels, fmin=fmin, fmax=fmax,
                    win_length=win_length, n_iter=n_iter).cpu().numpy()
            for b, (utt, mel) in enumerate(chunk):
                x = wav[b, :mel.shape[0] * n_shift]
                peak = np.abs(x).max()
                if peak > 1e-8:
                    x = x / peak * 0.95
                wavfile.write(out_dir / f"{utt}.wav", fs,
                              (x * 32767.0).astype(np.int16))
                n += 1
    return n


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("feats_scp", type=str)
    parser.add_argument("out_dir", type=str)
    parser.add_argument("--fs", type=int, required=True)
    parser.add_argument("--n_fft", type=int, default=1024)
    parser.add_argument("--n_shift", type=int, default=256)
    parser.add_argument("--n_mels", type=int, default=80)
    parser.add_argument("--fmin", type=float, default=None)
    parser.add_argument("--fmax", type=float, default=None)
    parser.add_argument("--win_length", type=int, default=None)
    parser.add_argument("--iters", type=int, default=64)
    parser.add_argument("--device", default="cuda",
                        help="torch device (cuda, or cpu for a CPU run)")
    args = parser.parse_args(argv)
    n = convert_fbank(args.feats_scp, args.out_dir, fs=args.fs,
                      n_fft=args.n_fft, n_shift=args.n_shift,
                      n_mels=args.n_mels, fmin=args.fmin, fmax=args.fmax,
                      win_length=args.win_length, n_iter=args.iters,
                      device=args.device)
    print(f"Synthesized {n} wavs to {args.out_dir}")
    return n


if __name__ == "__main__":
    main()
