"""Conversion real-time-factor harness.

Counterpart of ``vae_npvc_tpu/eval/rtf.py``: the any-to-many conversion path
(source mel -> latent -> target-speaker decode) of one padded batch through
the port's ``Converter`` model, RTF = processing time / audio time. The
timed calls are synchronized with the device (``torch.cuda.synchronize``
on a GPU) before the clock is read.
"""

from __future__ import annotations

import time

import numpy as np
import torch


def measure_rtf(converter, feats, lengths, targets, frame_rate_hz,
                warmup=2, repeats=5):
    """RTF of one padded batch through the converter's ``infer`` on its
    device. ``feats`` (B, T, D), ``lengths`` (B,), ``targets`` (B,).
    Returns (rtf, frames_per_sec)."""
    dev = converter.device
    x = torch.as_tensor(np.asarray(feats, np.float32), device=dev)
    n = torch.as_tensor(np.asarray(lengths, np.int32), device=dev)
    tgt = torch.as_tensor(np.asarray(targets, np.int32), device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    with torch.inference_mode():
        for _ in range(warmup):
            converter.model.infer(x, tgt, n)
        sync()
        t0 = time.perf_counter()
        for _ in range(repeats):
            converter.model.infer(x, tgt, n)
        sync()
    dt = (time.perf_counter() - t0) / repeats

    total_frames = int(np.sum(lengths))
    audio_seconds = total_frames / frame_rate_hz
    return dt / audio_seconds, total_frames / dt
