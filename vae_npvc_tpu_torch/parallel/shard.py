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

The models keep the global batch's values where a mean of the ranks' means
would not give them (``dp_axis`` names the bound axis):

- a masked mean over a batch's valid frames or tokens (the synthesizer's
  losses) divides by :func:`count_share`, so the axis mean of the ranks'
  losses is the global batch's masked mean however the valid frames fall;
- a nonlinear function of a batch-wide mean (a root mean square, a code
  perplexity) takes the mean over the axis first (:func:`axis_mean`);
- a random draw with one value per row (dropout and zoneout masks, the
  critic's interpolation weights) is drawn for the global batch on every
  rank from the same generator and sliced to the rank's rows
  (:func:`local_rows`).

A batch the axis does not divide runs whole on every rank under an axis of
one (:func:`bind_data`), so the same code sees its own values there.
"""

from __future__ import annotations

import torch

from . import comm
from .mesh import Axis

AXIS = "data"


def enable_explicit_dp(config):
    """Config transform: the model reduces over the ``data`` axis where
    the global batch's values are not the mean of the ranks' (the
    ``dp_axis`` arch key, read when the model is built; its training and
    validation forwards must then run inside :func:`bind_data`)."""
    out = dict(config)
    out["dp_axis"] = AXIS
    return out


def shard_rows(batch, mesh, axis=AXIS, micro=1):
    """``(local batch, sharded)``: this rank's rows of the global
    ``batch`` cut into ``micro`` equal microbatches, each split over the
    axis (the JAX trainer's accumulation step reshapes the global batch to
    (micro, B / micro) and shards each microbatch). The local batch holds
    this rank's part of microbatch 0, then of microbatch 1, ...: with n
    ranks, rank r's part of microbatch i is the global rows
    [i*B/micro + r*B/(micro*n), i*B/micro + (r+1)*B/(micro*n)); with
    ``micro`` 1 its contiguous B/n rows. When the axis size does not
    divide a microbatch (or ``micro`` the batch), the whole batch runs on
    every rank (``sharded`` False: the JAX trainer replicates such a
    batch, and its math is the global microbatch's either way)."""
    ax = mesh.axis(axis)
    B = batch[0].shape[0]
    if B % micro or (B // micro) % ax.size:
        return batch, False
    per = B // micro // ax.size
    rows = slice(ax.index * per, (ax.index + 1) * per)
    if micro == 1:
        return tuple(a[rows] for a in batch), True
    return tuple(a.reshape((micro, B // micro) + tuple(a.shape[1:]))[:, rows]
                 .reshape((micro * per,) + tuple(a.shape[1:]))
                 for a in batch), True


def bind_data(mesh, split=True, axis=AXIS):
    """Bind ``axis`` for a step's model calls: ``mesh``'s axis when the
    ranks split the batch, else an axis of one (every rank holds the whole
    batch; its collectives return their input)."""
    ax = mesh.axis(axis)
    if not split:
        ax = Axis(axis, 1, 0, [mesh.rank], None, ax.backend)
    return comm.bind({axis: ax})


class _AxisMean(torch.autograd.Function):
    """The all-reduce mean of a value the ranks replicate downstream; its
    backward is the axis mean of the cotangents. The trainer averages the
    ranks' gradients, so each rank's share of ``d loss / d x`` comes back
    once (``jax.lax.pmean``'s transpose, scaled as ``reduce_gradient``
    scales it)."""

    @staticmethod
    def forward(ctx, x, axis_name):
        # the Axis itself: a CUDA backward runs in autograd's device
        # thread, where this thread's names are not bound
        ctx.axis = comm.axis(axis_name)
        return comm.pmean(x, ctx.axis)

    @staticmethod
    def backward(ctx, g):
        return comm.pmean(g, ctx.axis), None


def axis_mean(x, axis_name):
    """``x`` averaged over the bound axis ``axis_name`` (differentiable);
    ``x`` itself when ``axis_name`` is None."""
    if axis_name is None:
        return x
    return _AxisMean.apply(x, axis_name)


def count_share(counts, axis_name):
    """The denominators of masked means: ``counts`` ((k,) fp32, this
    rank's valid frames or tokens per loss) floored at 1, or with
    ``axis_name`` their sum over the axis (one collective) floored at 1
    and divided by the axis size. A rank's masked sum over its share is
    then its part of the global batch's masked mean, and the axis mean of
    the ranks' losses (:func:`reduce_gradient`) is that mean."""
    if axis_name is None:
        return counts.clamp_min(1)
    ax = comm.axis(axis_name)
    return comm.psum(counts, ax).clamp_min(1) / ax.size


def local_rows(draw, shape, axis_name):
    """This rank's rows of ``draw`` over the global batch: ``draw(shape)``
    with ``shape[0]`` times the axis size rows, sliced to this rank's
    ``shape[0]`` (``draw(shape)`` itself on an axis of one or without
    ``axis_name``). Every rank draws from a generator seeded alike, so the
    ranks' rows are one process's draw on the global batch."""
    if axis_name is None:
        return draw(shape)
    ax = comm.axis(axis_name)
    if ax.size == 1:
        return draw(shape)
    B = shape[0]
    whole = draw((B * ax.size,) + tuple(shape[1:]))
    return whole[ax.index * B:(ax.index + 1) * B]


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
