"""Seeded inputs, made on the device in a few large draws.

:func:`mel_corpus` is ``chip_smoke.py``'s ``_synthetic_corpus`` (smooth
mel-like utterances: four slow sinusoids per band on a speaker-dependent
offset, plus noise, lengths uniform in a range), drawn with a
``torch.Generator`` on the device instead of numpy and written nowhere.
The corpus is padded to the longest length the range allows, so every
seed gives the same shapes.
"""

from __future__ import annotations

import math

import torch


class StagedCorpus:
    """What ``Trainer.stage_dataset`` takes: ``padded_arrays()`` and the
    crop length."""

    def __init__(self, feats, n_frames, spk_ids, crop_length):
        self.feats, self.n_frames, self.spk_ids = feats, n_frames, spk_ids
        self.crop_length = crop_length

    def padded_arrays(self):
        return self.feats, self.n_frames, self.spk_ids


def mel_corpus(gen, n_utts, frames, D, n_spk, device):
    """``(feats[n, frames[1], D] fp32, n_frames[n] int32, spk[n] int32)``,
    zero beyond each utterance's length."""
    lo, hi = frames
    n_frames = torch.randint(lo, hi + 1, (n_utts,), generator=gen,
                             device=device)
    spk = torch.randint(0, n_spk, (n_utts,), generator=gen, device=device)
    offset = 0.5 * torch.randn(n_spk, D, generator=gen, device=device)
    u = torch.rand(n_utts, 4, 4, generator=gen, device=device)
    amp = 0.3 + 0.7 * u[..., 0]
    freq = 0.5 + 3.5 * u[..., 1]
    slope = 0.5 + 2.5 * u[..., 2]
    phase = u[..., 3]
    t = (torch.arange(hi, device=device, dtype=torch.float32) / 100.0
         )[None, :, None, None]
    band = torch.linspace(0, 1, D, device=device)[None, None, None, :]
    arg = 2 * math.pi * (freq[:, None, :, None] * t
                         + slope[:, None, :, None] * band
                         + phase[:, None, :, None])
    mel = (amp[:, None, :, None] * torch.sin(arg)).sum(dim=2)
    mel = mel + offset[spk][:, None, :] \
        + 0.1 * torch.randn(n_utts, hi, D, generator=gen, device=device)
    valid = torch.arange(hi, device=device)[None, :] < n_frames[:, None]
    return (mel * valid[..., None], n_frames.int(), spk.int())
