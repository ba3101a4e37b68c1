"""The explicit data-parallel train step: shards, one gradient mean.

Counterpart of ``vae_npvc_tpu/parallel/shard.py``: where JAX builds the
step with ``make_shard_map_step``, ``Trainer(config, mesh=...)``
(``train/trainer.py``) runs it with the pieces below. Each rank of the
``data`` axis runs the forward and backward on its rows of the global
batch; then

- one ``pmean`` of the flat gradient (the trainer keeps every gradient in
  one flat fp32 vector, so this is one collective);
- one ``pmean`` of the loss detail, so the logs are the global batch's;
- inside the EMA quantizer (``ops/vq.py`` with ``axis_name``) the cluster
  statistics are summed over the axis and the lazy-init and restart
  candidates are pooled, so every rank commits the same codebook.

The renorm, the clip and the non-finite guard then see the same values on
every rank and decide the same.
"""

from __future__ import annotations

import torch

from . import comm

AXIS = "data"


def enable_explicit_dp(config):
    """Config transform: the flat model's EMA quantizer sums its
    statistics over the ``data`` axis (the ``dp_axis`` arch key, read when
    the model is built; it must then run inside ``comm.bind``)."""
    out = dict(config)
    out["dp_axis"] = AXIS
    return out


def shard_rows(batch, mesh, axis=AXIS):
    """``(local batch, sharded)``: this rank's contiguous rows of the
    global ``batch`` when the axis size divides its rows, else the whole
    batch on every rank (``sharded`` False: the JAX trainer replicates such
    a batch)."""
    ax = mesh.axis(axis)
    B = batch[0].shape[0]
    if B % ax.size:
        return batch, False
    per = B // ax.size
    return tuple(a[ax.index * per:(ax.index + 1) * per] for a in batch), True


def mean_detail(detail, axis=AXIS):
    """The axis mean of every detail value, in one collective."""
    keys = list(detail)
    vals = torch.stack([torch.as_tensor(detail[k]).float().reshape(())
                        for k in keys])
    vals = comm.pmean_(vals, axis)
    return dict(zip(keys, vals.unbind(0)))


def reduce_gradient(flat_g, detail, axis=AXIS):
    """The step's collectives after the backward: the flat gradient's axis
    mean (in place) and the detail's."""
    return comm.pmean_(flat_g, axis), mean_detail(detail, axis)
