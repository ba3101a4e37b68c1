#!/usr/bin/env python3
"""How far streamed front-end rows are from the offline rows on one GPU.

    python3 tools/torch_stream_front.py [--utts 8]

Builds a mel-only ``ConversionEngine`` of the flagship flat model
(``chip_smoke.FLAGSHIP``: ``egs/vcc20/vae1/conf/train_vqvae.yaml`` widths,
bf16, seeded random weights) and converts speech-like utterances of 2-10 s
at 24 kHz twice, one request at a time: offline (``engine.convert``) and as
an exact-mode ``StreamingSession`` fed in ragged chunks. For two front
ends it prints one JSON line per utterance: the log-mel rows that differ
between the two paths, their largest difference, the K1 ids that differ
and the largest difference of the converted mel.

- ``slabs``: the engine's front end, every call ``FRONT_ROWS`` frames;
- ``whole``: one call per window, i.e. the whole request canvas offline
  (T_pad rows) against 64-row blocks streamed.

Also the device kernels of one 64-row and one 1,024-row front-end call by
name, and the card's name and power limit. Needs CUDA; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def _ragged(x, seed):
    rng = np.random.default_rng(seed)
    out, i = [], 0
    while i < x.size:
        n = int(rng.choice([1, 7, 130, 333, 1024, 4800]))
        out.append(x[i:i + n])
        i += n
    return out


def _kernels(torch, fn):
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.name[:80] for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA})


def main():
    import torch

    p = argparse.ArgumentParser()
    p.add_argument("--utts", type=int, default=8)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("torch_stream_front: no CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as S
    from vae_npvc_tpu_torch.data import features
    from vae_npvc_tpu_torch.serve import ConversionEngine, StreamingSession

    fs, D = 24000, 80
    stats = np.zeros((2, D + 1), np.float64)
    stats[0, :-1] = -3.0 * 1000
    stats[0, -1] = 1000
    stats[1, :-1] = (1.0 + 3.0 ** 2) * 1000
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = Path(tmp) / "flagship.msgpack"
        S._random_checkpoint(torch, ckpt)
        eng = ConversionEngine(S.FLAGSHIP, ckpt, stats, vocoder="none",
                               device="cuda")
    slabs = eng._mel_window

    def whole(window):
        with torch.inference_mode():
            x = torch.as_tensor(window[None], device=eng.device)
            return features.logmelspectrogram(
                x, fs=eng.fs, **eng._front_kw(),
                center=False)[0].cpu().numpy()

    try:
        eng.warmup(1)
        for name, front in (("slabs", slabs), ("whole", whole)):
            eng._mel_window = front
            for i, sec in enumerate(np.linspace(2.0, 10.0, args.utts)):
                x = S._speechlike(int(sec * fs), fs, 900 + i)
                T = features.num_frames(x.size, eng.n_shift)
                xp = np.zeros((1, eng._pick_pad(T) * eng.n_shift - 1),
                              np.float32)
                xp[0, :x.size] = x
                off_rows = eng._mel_batch(xp)[0][:T]
                off, off_ids = S._k1_ids(
                    lambda: eng.convert(x, fs, i, return_mel=True)[0])
                s = StreamingSession(eng, i, fs)
                for c in _ragged(x, i):
                    s.feed(c)

                def finish():
                    (_, mel), = s.finish()
                    return mel
                got, got_ids = S._k1_ids(finish)
                rows = np.concatenate(s._mel_blocks)[:T]
                differ = np.any(rows != off_rows, axis=1)
                ids_differ = sum(int((a != b).sum())
                                 for a, b in zip(off_ids, got_ids))
                print(json.dumps({
                    "front": name, "seconds": float(sec), "frames": int(T),
                    "rows_differ": int(differ.sum()),
                    "rows_max_abs_diff": float(np.abs(rows - off_rows).max()),
                    "k1_calls": [len(off_ids), len(got_ids)],
                    "k1_ids_differ": ids_differ,
                    "mel_out_max_abs_diff": float(np.abs(got - off).max()),
                    "mel_out_bit_equal": bool(np.array_equal(got, off))}),
                    flush=True)
        eng._mel_window = slabs
        for n in (64, 1024):
            w = np.random.default_rng(n).normal(
                size=((n - 1) * eng.n_shift + 1024,)).astype(np.float32)
            print(json.dumps({"front_call_rows": n,
                              "kernels": _kernels(torch, lambda: whole(w))}),
                  flush=True)
    finally:
        eng.close()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
        .strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
