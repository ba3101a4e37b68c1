"""Vector-quantization core, inference half: plain and EMA codebooks.

Counterpart of ``vae_npvc_tpu/ops/vq.py`` (``l2_normalize``,
``nearest_code``, ``vq_encode``, ``vq_decode``, ``EmaVqState``,
``ema_vq_encode``, ``ema_vq_decode``). Layout is channels-last (B, T, D).
``ema_vq_encode`` goes through the fused VQ wrapper in its ids-only mode,
so a CUDA tensor runs the kernel of ``csrc/vq.cu``. The training forward
(``ema_vq_forward``, restart candidates) belongs to the training slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .vq_fused import nearest_code, vq_fused


def l2_normalize(x, dim=-1, target_norm=1.0, eps=1e-12):
    """Scale rows to ``target_norm`` (norm floored at ``eps``)."""
    n = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    if eps:
        n = torch.clamp(n, min=eps)
    return target_norm * x / n


def vq_encode(emb, z, *, normalize=False):
    """(B, T, D) -> (B, T) int32 code indices."""
    B, T, D = z.shape
    z_flat = z.reshape(B * T, D)
    if normalize:
        z_flat = l2_normalize(z_flat)
        emb = l2_normalize(emb)
    return nearest_code(z_flat, emb).reshape(B, T)


def vq_decode(emb, idx, *, normalize=False):
    """(B, T) indices -> (B, T, D) codebook vectors."""
    if normalize:
        emb = l2_normalize(emb)
    return emb[idx.long()]


class EmaVqState(NamedTuple):
    """EMA codebook state (the JAX package's ``ema`` collection leaf)."""
    initted: torch.Tensor   # () bool
    emb: torch.Tensor       # (K, D) codebook
    emb_sum: torch.Tensor   # (K, D) EMA of per-code vector sums
    emb_elem: torch.Tensor  # (K,) EMA of per-code counts


def ema_vq_encode(state, z):
    """(B, T, D) fp32 -> (B, T) int32 ids through the fused VQ (ids only)."""
    B, T, D = z.shape
    return vq_fused(z.reshape(B * T, D), state.emb, stats=False).idx \
        .reshape(B, T)


def ema_vq_decode(state, idx):
    return state.emb[idx.long()]
