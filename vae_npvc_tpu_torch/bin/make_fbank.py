"""Fbank extraction CLI: ``wav.scp`` -> log-mel feature arks +
``utt2num_frames``.

Counterpart of ``vae_npvc_tpu/bin/make_fbank.py``: waveforms are read and
resampled on the host in groups of 512 utterances, bucketed by their sample
count padded to a power of two, and each bucket's STFT -> mel -> log10
chain runs batched on the device (``data/features.logmelspectrogram``),
at most ``batch_frames`` frames per batch. ``--device cpu`` runs it on
the CPU; without a GPU the default raises.

Usage:
    python -m vae_npvc_tpu_torch.bin.make_fbank --fs 24000 --n_fft 1024 \
        --n_shift 256 --n_mels 80 --fmin 80 --fmax 7600 data/train fbank/train
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def _bucket_samples(n):
    """Smallest power of two >= n, at least 2^14."""
    b = 1 << 14
    while b < n:
        b <<= 1
    return b


def make_fbank(data_dir, out_dir, *, fs, n_fft, n_shift, n_mels=80,
               fmin=None, fmax=None, win_length=None, batch_frames=200000,
               compress=False, pitch=False, group_utts=512, device="cuda"):
    """Write ``out_dir/feats_raw.ark`` + ``feats.scp`` + ``utt2num_frames``
    (and copy ``utt2spk``/``spk2utt``); returns the utterances written.
    ``pitch=True`` appends the 3-dim Kaldi-style pitch features [pov,
    normalized log-pitch, delta-pitch] of each frame, computed on the host
    (data/pitch.py)."""
    import torch

    from ..data import kaldi_io
    from ..data.features import logmelspectrogram, num_frames, resample
    from ..data.pitch import pitch_feats
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    data_dir, out_dir = Path(data_dir), Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    wav_scp = kaldi_io.load_dict_data(data_dir / "wav.scp")

    def load(utt_entry):
        utt, entry = utt_entry
        sr, x = kaldi_io.read_wav_scp_entry(entry)
        if x.ndim > 1:
            x = x.mean(axis=1)
        return utt, resample(x, sr, fs)

    # groups bound the host memory of decoded waveforms at corpus scale
    entries = list(wav_scp.items())
    n_written = 0
    with kaldi_io.ArkWriter(out_dir / "feats_raw.ark", out_dir / "feats.scp",
                            compression_method=1 if compress else None) as w, \
            open(out_dir / "utt2num_frames", "w") as unf, \
            torch.inference_mode():
        for glo in range(0, len(entries), group_utts):
            buckets = {}
            for utt, x in map(load, entries[glo:glo + group_utts]):
                buckets.setdefault(_bucket_samples(len(x)), []).append(
                    (utt, x))
            for pad_n in sorted(buckets):
                group = buckets[pad_n]
                bsz = max(1, batch_frames // num_frames(pad_n, n_shift))
                for lo in range(0, len(group), bsz):
                    chunk = group[lo:lo + bsz]
                    batch = np.zeros((len(chunk), pad_n), np.float32)
                    for i, (_, x) in enumerate(chunk):
                        batch[i, :len(x)] = x
                    feats = logmelspectrogram(
                        torch.from_numpy(batch).to(dev), fs=fs, n_fft=n_fft,
                        n_shift=n_shift, n_mels=n_mels, fmin=fmin,
                        fmax=fmax, win_length=win_length).cpu().numpy()
                    for i, (utt, x) in enumerate(chunk):
                        T = num_frames(len(x), n_shift)
                        out = feats[i, :T]
                        if pitch:
                            out = np.concatenate([out, pitch_feats(
                                x, fs, n_frames=T,
                                frame_shift_ms=1000.0 * n_shift / fs)],
                                axis=1)
                        w.write(utt, out)
                        unf.write(f"{utt} {T}\n")
                        n_written += 1
    for f in ("utt2spk", "spk2utt"):
        if (data_dir / f).exists():
            (out_dir / f).write_text((data_dir / f).read_text())
    return n_written


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("data_dir", help="Kaldi data dir with wav.scp")
    parser.add_argument("out_dir", help="output dir for feats.scp/ark")
    parser.add_argument("--fs", type=int, required=True)
    parser.add_argument("--n_fft", type=int, default=1024)
    parser.add_argument("--n_shift", type=int, default=256)
    parser.add_argument("--n_mels", type=int, default=80)
    parser.add_argument("--fmin", type=float, default=None)
    parser.add_argument("--fmax", type=float, default=None)
    parser.add_argument("--win_length", type=int, default=None)
    parser.add_argument("--compress", action="store_true")
    parser.add_argument("--pitch", action="store_true",
                        help="append 3-dim Kaldi-style pitch features "
                             "(make_fbank_pitch.sh analog)")
    parser.add_argument("--device", default="cuda",
                        help="torch device (cuda, or cpu for a CPU run)")
    args = parser.parse_args(argv)
    n = make_fbank(args.data_dir, args.out_dir, fs=args.fs, n_fft=args.n_fft,
                   n_shift=args.n_shift, n_mels=args.n_mels, fmin=args.fmin,
                   fmax=args.fmax, win_length=args.win_length,
                   compress=args.compress, pitch=args.pitch,
                   device=args.device)
    print(f"Wrote {n} utterances to {args.out_dir}")
    return n


if __name__ == "__main__":
    main()
