"""Pipeline parallelism: a GPipe schedule over homogeneous layers.

Counterpart of ``vae_npvc_tpu/parallel/pp.py``. The flagship decoder is a
stack of identical speaker-conditioned GLU res-skip blocks, so its
parameters stack into one ``(L, ...)`` tree and split contiguously over
the ranks of a ``pipe`` axis: stage ``d`` runs layers ``[d*k, (d+1)*k)``.

Schedule (GPipe, the JAX function's ``M + P - 1`` ticks): at tick ``t``
stage ``d`` takes microbatch ``t - d`` (stage 0 a fresh one, the others
the activation that arrived from ``d - 1`` on the previous tick), runs
its ``k`` layers, and a hop (:class:`Hop`) sends the result to ``d + 1``
around the ring. The last stage keeps the finished microbatches; a final
all-reduce (:class:`ReplicateLast`) gives every rank the result. A stage
with no microbatch at a tick (the bubble) runs no layer and passes its
input on, so every stage launches its layers ``M`` times.

The hop is a ``torch.autograd.Function``: its backward sends the
cotangent the other way round the ring, as JAX's ``ppermute`` transposes.
Every rank must run the backward of every hop, in one order. The hops of
one rank form a chain (each tick's input is the last tick's hop), so they
run in reverse tick order; each hop also takes the stage's parameters as
inputs (with no gradient of its own), so a gradient asked of them reaches
every hop, even one that carries a bubble; and :class:`ReplicateLast`
takes the last tick's value, so the chain is part of every rank's graph.
Parameter gradients stay with their stage.
"""

from __future__ import annotations

import torch

from . import comm

AXIS = "pipe"


class Hop(torch.autograd.Function):
    """Send the ``n`` carry tensors to the next rank of the ring in one
    batch and return what the previous rank sent; the backward sends their
    cotangents back to the previous rank and returns the ones the next
    rank sent. The remaining inputs are anchors (no gradient)."""

    @staticmethod
    def forward(ctx, axis_name, n, *tensors):
        ctx.ax = ax = comm.axis(axis_name)   # the backward runs unbound
        ctx.n_anchors = len(tensors) - n
        P = ax.size
        return comm.ppermute(tuple(t.contiguous() for t in tensors[:n]), ax,
                             [(i, (i + 1) % P) for i in range(P)])

    @staticmethod
    def backward(ctx, *g):
        P = ctx.ax.size
        back = comm.ppermute(tuple(t.contiguous() for t in g), ctx.ax,
                             [(i, (i - 1) % P) for i in range(P)])
        return (None, None) + tuple(back) + (None,) * ctx.n_anchors


class ReplicateLast(torch.autograd.Function):
    """Sum over the axis of ``out`` where this is the last stage and 0
    elsewhere: every rank gets the last stage's ``out``. Each rank's loss
    is the same function of it, so the cotangent passes through unchanged
    to the last stage's ``out`` and is 0 for the others and for ``tail``
    (the last tick's value, an input so that every rank's hop chain is in
    its graph)."""

    @staticmethod
    def forward(ctx, out, tail, axis_name):
        ax = comm.axis(axis_name)
        ctx.last = ax.index == ax.size - 1
        ctx.tail = (tail.shape, tail.dtype, tail.device)
        buf = out.detach().clone() if ctx.last else torch.zeros_like(out)
        return comm.psum_(buf, axis_name)

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.tail
        return (g if ctx.last else torch.zeros_like(g),
                torch.zeros(shape, dtype=dtype, device=device), None)


def stack_layer_params(params, names):
    """Stack per-layer parameter dicts ``params[name]`` (name -> tensor)
    into one dict of ``(L, ...)`` tensors. The layers must be identical in
    shape: a dilated stack, whose layers differ, is refused."""
    trees = [params[n] for n in names]
    keys = list(trees[0])
    for name, tree in zip(names, trees):
        if list(tree) != keys or any(tuple(tree[k].shape)
                                     != tuple(trees[0][k].shape)
                                     for k in keys):
            raise ValueError(f"layer {name} differs from {names[0]}: only "
                             "identical layers stack")
    return {k: torch.stack([t[k] for t in trees]) for k in keys}


def _layer(stacked, i):
    return {k: v[i] for k, v in stacked.items()}


def pipeline_stack(block_apply, stacked_params, inputs, mesh, axis=AXIS):
    """Run ``L`` stacked layers over ``mesh``'s ``axis`` as a GPipe
    pipeline, on every rank of it.

    ``block_apply(layer_params, carry) -> carry`` is one layer over a
    tuple of tensors; ``stacked_params`` the ``(L, ...)`` parameter dict
    (this rank reads its ``k = L / P`` layers); ``inputs`` a tuple of
    ``(M, ...)`` microbatch tensors, the same on every rank. Returns the
    outputs as a tuple of ``(M, ...)`` tensors on every rank.
    """
    ax = mesh.axis(axis)
    P, d = ax.size, ax.index
    L = next(iter(stacked_params.values())).shape[0]
    M = inputs[0].shape[0]
    if L % P:
        raise ValueError(f"layers {L} not divisible by stages {P}")
    k = L // P
    mine = {n: v[d * k:(d + 1) * k] for n, v in stacked_params.items()}
    first = torch.tensor(d == 0, device=inputs[0].device)

    def stage(carry):
        for i in range(k):
            carry = block_apply(_layer(mine, i), carry)
        return carry

    anchors = tuple(mine.values())
    carry = tuple(torch.zeros_like(x[0]) for x in inputs)
    outs = [None] * M
    y = carry
    with comm.bind(mesh, (axis,)):
        for t in range(M + P - 1):
            fresh = tuple(x[min(t, M - 1)] for x in inputs)
            inp = tuple(torch.where(first, f, c) for f, c in zip(fresh, carry))
            mb = t - d
            y = stage(inp) if 0 <= mb < M else inp
            if d == P - 1 and 0 <= mb < M:
                outs[mb] = y
            if t < M + P - 2:
                carry = Hop.apply(axis, len(y), *y, *anchors)
        result = []
        for j in range(len(inputs)):
            out = (torch.stack([o[j] for o in outs]) if d == P - 1
                   else torch.zeros_like(inputs[j]))
            result.append(ReplicateLast.apply(out, y[j], axis))
    return tuple(result)


# ---------------------------------------------------------------------------
# model integration: the flat decoder's GLU res-skip stack
# ---------------------------------------------------------------------------

def decoder_stack_names(arch):
    """Layer names of the (single-scale, undilated) decoder stack."""
    stacks = arch.get("stacks", [3])
    if len(stacks) != 1:
        raise ValueError("pipeline split supports single-scale decoders")
    if arch.get("dilation", True):
        raise ValueError(
            "dilated stacks have per-layer architectures and cannot stack; "
            "the shipped flagship config uses dilation: false")
    return [f"stack_0_{j}" for j in range(stacks[0])]


def decoder_layer_params(decoder, names):
    """``{layer name: {parameter name: tensor}}`` of a ``Decoder``
    module's stack layers."""
    return {n: dict(getattr(decoder, n).named_parameters()) for n in names}


def decoder_block(config, device, dtype=torch.float32):
    """One ``GLUResSkip`` of the flat decoder's stack, whose parameters
    :func:`pipeline_decoder_stack` supplies."""
    from ..nn.blocks import GLUResSkip

    arch = dict(config["decoder"])
    return GLUResSkip(arch["out_channels"][0], arch.get("cond_channels", 128),
                      arch.get("skip_channels", 80),
                      arch.get("stack_kernel_size", 3), dilation=1,
                      use_weight_norm=arch.get("use_weight_norm", True),
                      dtype=dtype).to(device)


def pipeline_decoder_stack(config, stacked, h, cond, mesh, axis=AXIS,
                           microbatches=None, block=None):
    """Run the flat model's decoder res-skip stack pipelined over
    ``axis``.

    ``stacked``: the stack's parameters from :func:`stack_layer_params`
    (over :func:`decoder_stack_names`); ``h``: (B, T, width) activations
    entering the stack (after ``up_0``); ``cond``: (B, 1, cond_ch) speaker
    condition. Returns ``(h, skip_sum)``, equal to the sequential stack.
    """
    from torch.func import functional_call

    arch = dict(config["decoder"])
    if block is None:
        block = decoder_block(config, h.device, h.dtype)

    def block_apply(p, carry):
        hh, skip, c = carry
        h2, s = functional_call(block, p, (hh, c))
        return (h2, skip + s, c)

    M = microbatches or mesh.axis(axis).size
    B = h.shape[0]
    if B % M:
        raise ValueError(f"batch {B} not divisible by {M} microbatches")

    def split(x):
        return x.reshape((M, B // M) + tuple(x.shape[1:]))

    skip0 = torch.zeros(tuple(h.shape[:2]) + (arch.get("skip_channels", 80),),
                        dtype=h.dtype, device=h.device)
    h_out, skip, _ = pipeline_stack(block_apply, stacked,
                                    (split(h), split(skip0), split(cond)),
                                    mesh, axis)
    return (h_out.reshape((B,) + tuple(h_out.shape[2:])),
            skip.reshape((B,) + tuple(skip.shape[2:])))
