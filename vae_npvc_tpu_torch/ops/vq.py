"""Vector-quantization core: plain (gradient-codebook) and EMA codebooks.

Counterpart of ``vae_npvc_tpu/ops/vq.py``, function for function. Layout
is channels-last (B, T, D). The EMA codebook is explicit state
(:class:`EmaVqState`) that :func:`ema_vq_forward` takes and returns; it
writes no buffer itself, so a trainer can keep the old state when it skips
a step. Every search without statistics (``ema_vq_encode``, the EMA
forward outside training, the plain codebooks' :func:`vq_encode` and
:func:`vq_forward`) goes through the registered ids-mode operator
(``nearest_code``); a training step of :func:`ema_vq_forward` takes ids,
gathered codes and cluster statistics from the fused VQ wrapper
(``vq_fused``). A CUDA tensor runs the kernel of ``csrc/vq.cu`` either
way.

Random draws (lazy init, dead-code restarts) come from a
``torch.Generator`` on the tensors' device; they are not JAX's draws.

Data-parallel training (``axis_name``, as ``vae_npvc_tpu/ops/vq.py``'s
shard_map path): each rank runs the statistics mode on its own rows, the
per-code sums and counts are summed over the axis, and the lazy-init and
restart candidates are each rank's K draws gathered in rank order, of
which K are re-picked with the step's generator, the same on every rank,
so every rank commits the same codebook.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .vq_fused import nearest_code, vq_fused


def l2_normalize(x, dim=-1, target_norm=1.0, eps=1e-12):
    """Scale rows to ``target_norm`` (norm floored at ``eps``)."""
    n = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    if eps:
        n = torch.clamp(n, min=eps)
    return target_norm * x / n


def _reduce(loss_elem, reduction, B, T):
    """Reduction modes of the reference; ``loss_elem`` is (B*T, D)."""
    if reduction == "sum":
        return loss_elem.sum()
    if reduction == "mean":
        return loss_elem.mean()
    if reduction == "batch_mean":
        return loss_elem.sum() / B
    if reduction == "frame_mean":
        return loss_elem.sum() / (B * T)
    if reduction == "none":
        return loss_elem.reshape(B, T, -1)
    raise ValueError(f"unknown reduction {reduction!r}")


def codebook_perplexity(idx, num_codes, axis_name=None):
    """exp(entropy) of the empirical code distribution; with ``axis_name``
    (a bound data axis) of the codes of every rank's rows (the counts
    summed over the axis in one collective)."""
    # one count a code with no read on the host (a CUDA bincount sizes its
    # output from the largest id, read back), so a captured step can hold
    # it; whole counts are exact in float32 in any order of addition
    ids = idx.reshape(-1).long()
    counts = torch.zeros((num_codes,), dtype=torch.float32,
                         device=idx.device).index_add_(
        0, ids, torch.ones_like(ids, dtype=torch.float32))
    if axis_name is None:
        probs = counts / idx.numel()
    else:
        from ..parallel import comm

        counts = comm.psum_(counts, axis_name)
        probs = counts / counts.sum()
    return torch.exp(-torch.sum(probs * torch.log(probs + 1e-10)))


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


def sparsity_loss(emb):
    """Diagonal cross-entropy codebook-sparsity regularizer: the Gram matrix
    E.E^T as logits, targets = identity."""
    logp = torch.log_softmax(emb @ emb.T, dim=-1)
    return -torch.mean(torch.diagonal(logp))


def vq_forward(emb, z, *, normalize=False, reduction="frame_mean",
               quantize=True, axis_name=None):
    """Training-time quantization with straight-through gradients.

    Returns ``(z_vq, z_qut_loss, z_enc_loss, detail)``: the codebook loss
    mse(e, sg(z)), the commitment loss mse(sg(e), z) (+ the normalization
    loss with ``normalize``), ``z_vq = z + sg(e - z)`` and
    ``detail['entropy']`` (codebook perplexity, over every rank's codes
    with ``axis_name``).
    """
    B, T, D = z.shape
    if not quantize:
        zero = torch.zeros((), dtype=torch.float32, device=z.device)
        return z, zero, zero, {"entropy": zero}
    z_flat = z.reshape(B * T, D)
    if normalize:
        z_norm = l2_normalize(z_flat)
        emb_n = l2_normalize(emb)
    else:
        z_norm = z_flat
        emb_n = emb
    idx = nearest_code(z_norm.detach(), emb_n.detach())
    z_q = emb_n[idx.long()]                     # gradients flow to emb

    z_qut_elem = (z_q - z_norm.detach()) ** 2
    z_enc_elem = (z_q.detach() - z_norm) ** 2
    if normalize:
        z_enc_elem = z_enc_elem + (z_norm - z_flat) ** 2
    z_qut_loss = _reduce(z_qut_elem, reduction, B, T)
    z_enc_loss = _reduce(z_enc_elem, reduction, B, T)

    z_vq = z_norm + (z_q - z_norm).detach()
    detail = {"entropy": codebook_perplexity(idx, emb.shape[0], axis_name)}
    return z_vq.reshape(B, T, D), z_qut_loss, z_enc_loss, detail


class EmaVqState(NamedTuple):
    """EMA codebook state (the JAX package's ``ema`` collection leaf)."""
    initted: torch.Tensor   # () bool
    emb: torch.Tensor       # (K, D) codebook
    emb_sum: torch.Tensor   # (K, D) EMA of per-code vector sums
    emb_elem: torch.Tensor  # (K,) EMA of per-code counts


def ema_vq_init(num_codes, dim, dtype=torch.float32, device=None):
    return EmaVqState(
        initted=torch.zeros((), dtype=torch.bool, device=device),
        emb=torch.zeros((num_codes, dim), dtype=dtype, device=device),
        emb_sum=torch.zeros((num_codes, dim), dtype=dtype, device=device),
        emb_elem=torch.ones((num_codes,), dtype=dtype, device=device))


def _tiled_candidates(gen, z_flat, num_codes):
    """Random restart candidates: tile z with noise until >= K rows,
    permute, take K. ``gen`` is a ``torch.Generator`` on z's device."""
    N, D = z_flat.shape
    if N < num_codes:
        reps = (num_codes + N - 1) // N
        z_flat = z_flat.repeat(reps, 1)
        z_flat = z_flat + torch.randn(
            z_flat.shape, generator=gen, dtype=z_flat.dtype,
            device=z_flat.device) * (0.01 / math.sqrt(D))
    perm = torch.randperm(z_flat.shape[0], generator=gen,
                          device=z_flat.device)
    return z_flat[perm[:num_codes]]


def _pick(gen, n, num_codes, device):
    """Indices of the ``num_codes`` rows re-picked from a pool of ``n``
    gathered candidates (a draw of ``gen``, identical on every rank)."""
    return torch.randperm(n, generator=gen, device=device)[:num_codes]


def _pooled(gen, pool, num_codes):
    """K of the ``(n, K, D)`` gathered candidates. A pool of one rank is
    that rank's draw, already a random choice, taken as it is."""
    n = pool.shape[0]
    pool = pool.reshape(-1, pool.shape[-1])
    if n == 1:
        return pool
    return pool[_pick(gen, pool.shape[0], num_codes, pool.device)]


def ema_vq_encode(state, z):
    """(B, T, D) fp32 -> (B, T) int32 ids through the fused VQ's ids mode
    (``nearest_code``)."""
    B, T, D = z.shape
    return nearest_code(z.reshape(B * T, D), state.emb).reshape(B, T)


def ema_vq_decode(state, idx):
    return state.emb[idx.long()]


def ema_vq_forward(state, z, gen=None, *, mu=0.9, threshold=1.0,
                   reduction="frame_mean", training=True, update=True,
                   legacy_no_ste=False, axis_name=None):
    """EMA quantizer forward + codebook update.

    Returns ``(z_vq, z_qut_loss, z_enc_loss, new_state, detail)``; the
    caller commits ``new_state``. ``z_qut_loss`` is always 0 (no codebook
    gradient). ``detail`` carries {entropy, used_curr, usage, diff_emb}
    when the codebook was updated. ``gen`` draws the lazy-init and restart
    candidates (training only).

    The search and the statistics run on detached fp32 ``z``. With
    ``training and update`` ids, gathered codes, per-code sums and counts
    come from one fused pass (the kernel's statistics mode on CUDA). The
    lazy init is a tensor select on ``state.initted``, not a host branch,
    so a step never waits for the device.

    ``axis_name`` (training only) names a bound data axis
    (``parallel.comm.bind``): the statistics are summed over it in one
    collective, and both candidate sets (lazy init, restarts) are gathered
    over it in one more; outside a bound axis it raises ``ValueError``.
    """
    B, T, D = z.shape
    K = state.emb.shape[0]
    z_flat = z.reshape(B * T, D)
    z_sg = z_flat.detach()
    comm = None
    if axis_name is not None and training:
        from ..parallel import comm

        comm.axis(axis_name)        # raises on an unbound name

    if training:
        # lazy data-dependent init on the first training batch; the
        # restart candidates are drawn right after (the search draws
        # nothing), so one collective gathers both
        emb0 = _tiled_candidates(gen, z_sg, K)
        cand = _tiled_candidates(gen, z_sg, K) if update else None
        if comm is not None:
            both = emb0 if cand is None else torch.cat([emb0, cand])
            pool = comm.all_gather(both, axis_name)
            emb0 = _pooled(gen, pool[:, :K], K)
            if cand is not None:
                cand = _pooled(gen, pool[:, K:], K)
        keep = state.initted
        state = EmaVqState(
            torch.ones_like(state.initted),
            torch.where(keep, state.emb, emb0),
            torch.where(keep, state.emb_sum, emb0),
            torch.where(keep, state.emb_elem,
                        torch.ones_like(state.emb_elem)))

    if training and update:
        idx, z_q, batch_sum, batch_elem = vq_fused(z_sg, state.emb,
                                                   stats=True)
        if comm is not None:
            stats = comm.psum_(torch.cat([batch_sum, batch_elem[:, None]],
                                         dim=1), axis_name)
            batch_sum, batch_elem = stats[:, :D], stats[:, D]

        old_emb = state.emb
        emb_sum = mu * state.emb_sum + (1.0 - mu) * batch_sum
        emb_elem = mu * state.emb_elem + (1.0 - mu) * batch_elem
        usage = (emb_elem >= threshold).to(z.dtype)[:, None]      # (K, 1)
        emb = usage * (emb_sum / emb_elem[:, None]) + (1.0 - usage) * cand

        k_prob = batch_elem / batch_elem.sum()
        detail = {
            "entropy": torch.exp(-torch.sum(k_prob
                                            * torch.log(k_prob + 1e-8))),
            "used_curr": (batch_elem >= threshold).sum().float(),
            "usage": usage.sum(),
            "diff_emb": torch.linalg.vector_norm(emb - old_emb)
                        / math.sqrt(K * D),
        }
        state = EmaVqState(state.initted, emb, emb_sum, emb_elem)
    else:
        idx = nearest_code(z_sg, state.emb)
        z_q = state.emb[idx.long()]
        detail = {}

    z_enc_loss = _reduce((z_q - z_flat) ** 2, reduction, B, T)
    z_qut_loss = torch.zeros((), dtype=z.dtype, device=z.device)

    if legacy_no_ste and reduction != "none":
        # the reference's missing straight-through: the decoder sees the
        # detached code vector
        z_vq = z_q
    else:
        z_vq = z_flat + (z_q - z_flat).detach()

    return z_vq.reshape(B, T, D), z_qut_loss, z_enc_loss, state, detail
