"""Time-axis (sequence) sharding with halo exchange for conv stacks.

Counterpart of ``vae_npvc_tpu/parallel/halo.py``. The time axis of a
(B, T, D) utterance is split over the ranks of a mesh axis; a conv pulls
its receptive-field halo from the neighbouring ranks (one batch of
point-to-point sends and receives, zeros at the two true ends, as SAME
padding has there), convolves without padding and keeps its own frames.
The result equals the unsharded computation as long as

- the stack's receptive-field half-width is at most ``halo``; and
- every normalization over time counts the frames of all ranks
  (:func:`psum_group_norm`, or the blocks' ``seq_axis`` GroupNorm).

Every function here runs inside ``comm.bind`` of a mesh whose axis
``axis_name`` splits time.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.groupnorm import (group_norm_split_apply, group_norm_split_stats,
                             group_norm_split_stats_plain)
from . import comm


def halo_exchange(x, halo, axis_name):
    """(B, T_local, D) -> (B, halo + T_local + halo, D) with the
    neighbours' frames; the first and last rank get zeros outside."""
    ax = comm.axis(axis_name)
    n, i = ax.size, ax.index
    if halo == 0:
        return x
    left_edge = x[:, :halo].contiguous()
    right_edge = x[:, -halo:].contiguous()
    sends, recvs = [], []
    if i + 1 < n:
        sends.append((i + 1, right_edge))
        recvs.append((i + 1, left_edge))
    if i > 0:
        sends.append((i - 1, left_edge))
        recvs.append((i - 1, right_edge))
    got = comm.exchange(axis_name, sends, recvs)
    from_right = got.pop(0) if i + 1 < n else torch.zeros_like(right_edge)
    from_left = got.pop(0) if i > 0 else torch.zeros_like(left_edge)
    return torch.cat([from_left, x, from_right], dim=1)


def receptive_halo(kernel_size, dilations):
    """Half-width of a stride-1 conv stack's receptive field."""
    return sum((kernel_size - 1) // 2 * d for d in dilations)


def psum_group_norm(x, scale, bias, num_groups, axis_name, valid_mask=None,
                    eps=1e-5, lengths=None, glu=False):
    """GroupNorm(+GLU) whose statistics span the time axis of every rank.

    ``x`` is the local shard (B, T_local, C). This rank's per-(row, group)
    count, mean and centred sum of squares (K2's ``gn_split_stats``) are
    gathered over ``axis_name`` with one ``all_gather`` and merged in rank
    order by Chan's formula inside the apply (``gn_split_apply``), never as
    E[x^2] - mean^2. ``lengths`` (B,) counts each row's local valid frames:
    only they enter the statistics and the output is zero past them, as in
    K2's masked path. ``valid_mask`` (B, T_local, 1), the JAX function's
    argument, excludes any frames from the statistics and leaves the output
    normalized everywhere; no kernel takes an arbitrary mask, so it is for
    CPU tensors only and a CUDA tensor with one raises.
    """
    if valid_mask is not None:
        if x.is_cuda:
            raise ValueError(
                "psum_group_norm: no kernel takes an arbitrary valid_mask on "
                "a CUDA tensor; give each row's local valid frames as "
                "lengths")
        if lengths is not None:
            raise ValueError("psum_group_norm: give valid_mask or lengths, "
                             "not both")
        part = group_norm_split_stats_plain(x, num_groups, mask=valid_mask)
    else:
        part = group_norm_split_stats(x, num_groups, lengths)
    gathered = comm.all_gather(part, axis_name)          # (R, B, G, 3)
    return group_norm_split_apply(x, scale, bias,
                                  gathered.permute(1, 2, 0, 3).contiguous(),
                                  num_groups, eps, lengths, glu)


def sharded_conv1d(x, w, b, halo, axis_name, dilation=1):
    """SAME stride-1 conv over a time-sharded (B, T_local, D) input; ``w``
    is (k, in, out) as the JAX package stores it, ``b`` (out,).
    ``halo`` must be at least the conv's half receptive field."""
    rf_half = (w.shape[0] - 1) // 2 * dilation
    assert halo >= rf_half, (
        f"halo {halo} < conv half receptive field {rf_half} "
        f"(kernel {w.shape[0]}, dilation {dilation}) — the crop below would "
        "silently return wrong frames")
    assert halo <= x.shape[1], (
        f"halo {halo} > local shard length {x.shape[1]} — neighbors don't "
        "hold enough frames for one exchange")
    xh = halo_exchange(x, halo, axis_name)
    y = F.conv1d(xh.transpose(1, 2), w.permute(2, 1, 0),
                 dilation=dilation).transpose(1, 2)
    # a conv without padding on the haloed input: crop back to the local
    # shard's frames
    start = halo - rf_half
    return y[:, start:start + x.shape[1]] + b
