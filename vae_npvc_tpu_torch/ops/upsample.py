"""Nearest-neighbour temporal upsampling, channels-last (B, T, C).

Counterpart of ``vae_npvc_tpu/ops/upsample.py``: repeat each frame
``target_len // T`` times, then crop to ``target_len`` or repeat the last
frame up to it; the masked version applies that rule to each batch row's
real lengths, so a padded batch equals the unpadded per-utterance runs.
"""

from __future__ import annotations

import torch


def nearest_upsample(z, target_len):
    """(B, T, C) -> (B, target_len, C) by frame repetition + crop/edge-pad."""
    T = z.shape[1]
    factor = max(target_len // T, 1)
    z = torch.repeat_interleave(z, factor, dim=1)
    if z.shape[1] >= target_len:
        return z[:, :target_len]
    pad = z[:, -1:].expand(-1, target_len - z.shape[1], -1)
    return torch.cat([z, pad], dim=1)


def nearest_upsample_masked(z, target_len, in_len, out_len):
    """Length-aware :func:`nearest_upsample` for padded batches: row b
    repeats by ``out_len[b] // in_len[b]`` and frame ``j`` reads
    ``min(j // factor, in_len[b] - 1)``, so positions beyond the real
    length repeat the last real frame (masked downstream).

    z: (B, T_pad_in, C); in_len/out_len: (B,) real frame counts.
    """
    in_len = torch.as_tensor(in_len, device=z.device).long()
    out_len = torch.as_tensor(out_len, device=z.device).long()
    factor = torch.clamp(out_len // torch.clamp(in_len, min=1), min=1)
    j = torch.arange(target_len, device=z.device)[None, :]
    idx = torch.minimum(j // factor[:, None], in_len[:, None] - 1)
    # a 0-frame row reads index -1 and, as in numpy, the last frame
    idx = torch.where(idx < 0, idx + z.shape[1], idx)
    return torch.gather(z, 1, idx[..., None].expand(-1, -1, z.shape[2]))
