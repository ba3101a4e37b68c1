"""Collectives over a named mesh axis: ``psum``, ``pmean``,
``all_gather``, ``ppermute`` and ``reduce_scatter_mean``.

The port's counterpart of ``jax.lax.psum``/``pmean``/``all_gather``/
``ppermute`` inside ``shard_map``. JAX binds axis names to a mesh by
entering ``shard_map``; here :func:`bind` binds them to a mesh's process
groups for a block of code in one thread, and a collective over a name
that is not bound raises ``ValueError`` naming it, as JAX does on an
unbound axis name.

On an NCCL group the collectives take the CUDA tensors as they are. gloo
does not take CUDA tensors for ``all_gather``, ``send``/``recv`` or
``reduce_scatter``, so on a gloo group a CUDA tensor is copied to pinned
host memory (a synchronous copy, ordered after the kernels that wrote it on
the current stream), reduced or exchanged there, and copied back: that is
how several ranks share one card. The choice follows the group's backend;
only the transport goes through the host, the compute stays on the card.
An axis of one process without a group returns its input.

``log``, when set to a list, records ``(name, axis, numel)`` of each
collective (the smoke counts a step's collectives with it).
"""

from __future__ import annotations

import contextlib
import threading

import torch

_local = threading.local()   # .bound: this thread's stack of {name: Axis}
log = None


@contextlib.contextmanager
def bind(mesh, names=None):
    """Bind ``names`` (default: every axis of ``mesh``) to ``mesh``'s
    process groups inside the block; a dict ``{name: Axis}`` binds as
    given."""
    axes = (dict(mesh) if isinstance(mesh, dict) else
            {n: mesh.axis(n) for n in (names or mesh.axis_names)})
    stack = _stack()
    stack.append(axes)
    try:
        yield axes
    finally:
        stack.pop()


def _stack():
    if not hasattr(_local, "bound"):
        _local.bound = []
    return _local.bound


def axis(name):
    """The bound :class:`~.mesh.Axis` of ``name`` (an ``Axis`` passes
    through); raises ``ValueError`` when no enclosing :func:`bind` binds
    it."""
    if not isinstance(name, str):
        return name
    for axes in reversed(_stack()):
        if name in axes:
            return axes[name]
    raise ValueError(
        f"axis name {name!r} is not bound: call inside "
        "parallel.comm.bind(mesh) (a data-parallel step, a sequence-"
        "parallel call or a pipeline binds its mesh's axes)")


def _note(name, ax, t):
    if log is not None:
        log.append((name, ax.name, int(t.numel())))


def _staged(ax, t):
    """Whether ``t`` goes through host memory on ``ax``'s group."""
    return t.is_cuda and ax.backend == "gloo"


def _host(t):
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


def psum_(x, axis_name):
    """Sum ``x`` over the axis in place; returns ``x``."""
    import torch.distributed as dist

    ax = axis(axis_name)
    if ax.group is None:
        return x
    _note("psum", ax, x)
    if _staged(ax, x):
        h = _host(x)
        dist.all_reduce(h, group=ax.group)
        return x.copy_(h)
    dist.all_reduce(x, group=ax.group)
    return x


def psum(x, axis_name):
    return psum_(x.clone(), axis_name)


def pmean_(x, axis_name):
    """Mean of ``x`` over the axis in place (sum, then divide by the
    axis size; at size 1 the division is exact)."""
    ax = axis(axis_name)
    return psum_(x, axis_name).div_(ax.size)


def pmean(x, axis_name):
    return pmean_(x.clone(), axis_name)


def all_gather(x, axis_name):
    """``(n, *x.shape)``: every rank's ``x`` in axis order."""
    import torch.distributed as dist

    ax = axis(axis_name)
    x = x.contiguous()
    if ax.group is None:
        return x[None].clone()
    _note("all_gather", ax, x)
    if _staged(ax, x) or ax.backend == "gloo":
        h = _host(x) if x.is_cuda else x
        parts = [torch.empty_like(h) for _ in range(ax.size)]
        dist.all_gather(parts, h, group=ax.group)
        return torch.stack(parts).to(x.device)
    out = torch.empty((ax.size,) + tuple(x.shape), dtype=x.dtype,
                      device=x.device)
    dist.all_gather_into_tensor(out, x, group=ax.group)
    return out


def reduce_scatter_mean(x, axis_name):
    """Row ``index`` of the axis mean of ``x`` (``(n, ...)``, one row per
    rank). NCCL reduce-scatters; gloo, which has no reduce-scatter of these
    tensors, all-reduces the rows and keeps its own."""
    import torch.distributed as dist

    ax = axis(axis_name)
    if x.shape[0] != ax.size:
        raise ValueError(f"reduce_scatter_mean: {x.shape[0]} rows for an "
                         f"axis of {ax.size}")
    if ax.group is None:
        return x[0].clone()
    _note("reduce_scatter", ax, x)
    if ax.backend == "gloo":
        h = _host(x) if x.is_cuda else x.clone()
        dist.all_reduce(h, group=ax.group)
        return h[ax.index].to(x.device).div_(ax.size)
    x = x.contiguous()
    out = torch.empty(x.shape[1:], dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, x, group=ax.group)
    return out.div_(ax.size)


def exchange(axis_name, sends, recvs):
    """Point-to-point exchange along the axis in one batch: ``sends`` is
    a list of ``(destination index, tensor)``, ``recvs`` a list of
    ``(source index, template)``; returns the received tensors (the
    templates' shapes, dtypes and devices) in ``recvs``' order. An index
    equal to this rank's is a local copy."""
    import torch.distributed as dist

    ax = axis(axis_name)
    local = {}
    for dst, t in sends:
        if dst == ax.index:
            local[dst] = t
    out = [None] * len(recvs)
    ops, bufs = [], []
    for i, (src, like) in enumerate(recvs):
        if src == ax.index:
            out[i] = local[src].clone()
            continue
        staged = _staged(ax, like)
        buf = torch.empty(like.shape, dtype=like.dtype,
                          pin_memory=staged,
                          device="cpu" if staged else like.device)
        bufs.append((i, buf, like.device))
        ops.append(dist.P2POp(dist.irecv, buf, ax.ranks[src], ax.group))
    for dst, t in sends:
        if dst == ax.index:
            continue
        t = t.contiguous()
        if _staged(ax, t):
            t = _host(t)
        ops.append(dist.P2POp(dist.isend, t, ax.ranks[dst], ax.group))
    if ops:
        _note("ppermute", ax, sends[0][1] if sends else recvs[0][1])
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    for i, buf, dev in bufs:
        out[i] = buf.to(dev)
    return out


def ppermute(x, axis_name, perm):
    """``jax.lax.ppermute``: ``perm`` lists ``(source, destination)``
    index pairs; this rank sends ``x`` (a tensor, or a tuple of tensors in
    one batch) to its destination and returns what its source sent (zeros
    when no pair names it as a destination)."""
    ax = axis(axis_name)
    xs = x if isinstance(x, tuple) else (x,)
    dst = [d for s, d in perm if s == ax.index]
    src = [s for s, d in perm if d == ax.index]
    got = exchange(axis_name, [(d, t) for d in dst for t in xs],
                   [(s, t) for s in src for t in xs])
    out = tuple(got) if got else tuple(torch.zeros_like(t) for t in xs)
    return out if isinstance(x, tuple) else out[0]


def barrier():
    """Wait for every rank of the world (no-op without a group)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.barrier()
