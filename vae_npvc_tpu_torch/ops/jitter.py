"""Vectorized latent jitter (Chorowski et al., 2019).

Counterpart of ``vae_npvc_tpu/ops/jitter.py``: per-(batch, time)
Bernoulli(p) replacement of a frame by a uniform +-1 temporal neighbor
(ends take their only neighbor), as one gather. ``per_batch=False`` draws
per-timestep decisions shared across the batch. :func:`jitter_gather` is
the deterministic part, given the draws. Under a data axis
(``axis_name``) the per-row draws are the global batch's, each rank's
rows sliced from them (``parallel.shard.local_rows``), as JAX draws a
sharded batch's.
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


def jitter(gen, x, probability, per_batch=True, axis_name=None):
    """Randomly replace timesteps of ``x`` (B, T, D) with a temporal
    neighbor; ``gen`` is a ``torch.Generator`` on x's device, ``axis_name``
    a bound data axis the batch is split over."""
    if probability == 0.0:
        return x
    B, T, _ = x.shape

    def draw(p):
        return lambda shape: torch.rand(shape, generator=gen,
                                        device=x.device) < p

    if per_batch and axis_name is not None:
        from ..parallel.shard import local_rows

        replace = local_rows(draw(probability), (B, T), axis_name)
        forward = local_rows(draw(0.5), (B, T), axis_name)
    else:
        shape = (B, T) if per_batch else (1, T)
        replace, forward = draw(probability)(shape), draw(0.5)(shape)
    return jitter_gather(x, replace, forward)
