"""Vectorized latent jitter (Chorowski et al., 2019).

Counterpart of ``vae_npvc_tpu/ops/jitter.py``: per-(batch, time)
Bernoulli(p) replacement of a frame by a uniform +-1 temporal neighbor
(ends take their only neighbor), as one gather. ``per_batch=False`` draws
per-timestep decisions shared across the batch. :func:`jitter_gather` is
the deterministic part, given the draws.
"""

from __future__ import annotations

import torch


def jitter_gather(x, replace, forward):
    """Replace frames of ``x`` (B, T, D) where ``replace`` by the next
    (``forward``) or previous frame; both masks are bool (B, T) or (1, T)."""
    B, T, D = x.shape
    t = torch.arange(T, device=x.device)[None, :]
    direction = torch.where(forward, 1, -1)
    direction = torch.where(t == 0, 1, torch.where(t == T - 1, -1, direction))
    src = torch.where(replace, t + direction, t).expand(B, T)
    return torch.gather(x, 1, src[:, :, None].expand(B, T, D))


def jitter(gen, x, probability, per_batch=True):
    """Randomly replace timesteps of ``x`` (B, T, D) with a temporal
    neighbor; ``gen`` is a ``torch.Generator`` on x's device."""
    if probability == 0.0:
        return x
    B, T, _ = x.shape
    shape = (B, T) if per_batch else (1, T)
    replace = torch.rand(shape, generator=gen, device=x.device) < probability
    forward = torch.rand(shape, generator=gen, device=x.device) < 0.5
    return jitter_gather(x, replace, forward)
