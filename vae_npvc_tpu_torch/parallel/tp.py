"""Model-axis parameter sharding, weight-gathered.

Counterpart of ``vae_npvc_tpu/parallel/tp.py``: the same shape-generic rule
picks, for each parameter, the dimension it is split along over the
``model`` axis (its largest dimension divisible by the axis size, ties to
the trailing-most; parameters below ``min_size`` elements or with no
divisible dimension stay whole). XLA's GSPMD chooses the collectives from
that layout; here they are explicit, in the weight-gathered form that
``tp.py`` names:

- each model-axis rank stores its slice of every split parameter and of
  both Adam moments (:class:`TpLayout`);
- the whole parameters are all-gathered before the forward;
- the gradients, after the data axis's mean, are reduce-scattered over the
  model axis, so each rank updates its own slices (the whole parameters'
  gradients are averaged over it);
- the global gradient norm of the clip and the guard is the sum over the
  model axis of the slices' squares plus the whole parameters' squares.

A spec is a tuple with ``"model"`` at the split dimension and ``None``
elsewhere, ``()`` for a whole parameter (the JAX ``PartitionSpec``'s
entries).
"""

from __future__ import annotations

import math

import torch

from . import comm

MODEL_AXIS = "model"


def param_spec(shape, n_model, min_size=1024):
    """The spec of one parameter under the shape-generic rule."""
    if n_model <= 1 or int(math.prod(shape)) < min_size:
        return ()
    best = None
    for d, extent in enumerate(shape):
        if extent % n_model == 0 and extent >= n_model:
            if best is None or extent >= shape[best]:
                best = d  # >= keeps the trailing-most maximal dim
    if best is None:
        return ()
    spec = [None] * len(shape)
    spec[best] = MODEL_AXIS
    return tuple(spec)


def _n_model(mesh):
    return dict(mesh.shape).get(MODEL_AXIS, 1)


def param_partition_specs(params, mesh, min_size=1024):
    """``{name: spec}`` for a dict of tensors (or shapes)."""
    n = _n_model(mesh)
    return {k: param_spec(tuple(getattr(v, "shape", v)), n, min_size)
            for k, v in params.items()}


def _split_dim(spec):
    return spec.index(MODEL_AXIS) if MODEL_AXIS in spec else None


def shard_params(params, mesh, min_size=1024):
    """This rank's slices of a dict of whole parameters under the rule."""
    specs = param_partition_specs(params, mesh, min_size)
    n = _n_model(mesh)
    r = mesh.coords.get(MODEL_AXIS, 0) if hasattr(mesh, "coords") else 0
    out = {}
    for k, v in params.items():
        d = _split_dim(specs[k])
        out[k] = v if d is None else v.chunk(n, dim=d)[r]
    return out


def constrain_params(params, mesh, shapes, min_size=1024):
    """Pin a dict of parameters to the rule's layout: a tensor with its
    whole shape (``shapes[name]``) becomes this rank's slice, a slice
    passes through, any other shape raises. The eager counterpart of the
    sharding constraint inside the JAX step."""
    n = _n_model(mesh)
    whole = {k: v for k, v in params.items()
             if tuple(v.shape) == tuple(shapes[k])}
    out = dict(params)
    out.update(shard_params(whole, mesh, min_size))
    for k, v in out.items():
        d = _split_dim(param_spec(tuple(shapes[k]), n, min_size))
        want = list(shapes[k])
        if d is not None:
            want[d] //= n
        if list(v.shape) != want:
            raise ValueError(f"{k}: shape {tuple(v.shape)} is neither the "
                             f"whole {tuple(shapes[k])} nor a slice "
                             f"{tuple(want)}")
    return out


class TpLayout:
    """Where this rank's slices lie in the trainer's flat parameter
    vector (``layout``: ``[(name, shape), ...]`` in flat order).

    ``piece_idx`` (n, S) holds, per model-axis rank, the flat positions of
    its slices of every split parameter, in parameter order; ``rep_idx``
    the positions of the whole parameters. This rank's local vector is its
    slices followed by the whole parameters.
    """

    def __init__(self, layout, n_model, index, min_size=1024, device=None):
        self.n, self.index = int(n_model), int(index)
        self.specs = {}
        pieces = [[] for _ in range(self.n)]
        rep = []
        off = 0
        for name, shape in layout:
            numel = int(math.prod(shape))
            pos = torch.arange(off, off + numel).view(shape)
            spec = param_spec(tuple(shape), self.n, min_size)
            self.specs[name] = spec
            d = _split_dim(spec)
            if d is None:
                rep.append(pos.reshape(-1))
            else:
                for r, part in enumerate(pos.chunk(self.n, dim=d)):
                    pieces[r].append(part.reshape(-1))
            off += numel
        empty = torch.zeros((0,), dtype=torch.long)
        self.piece_idx = torch.stack([torch.cat(p) if p else empty
                                      for p in pieces]).to(device)
        self.rep_idx = (torch.cat(rep) if rep else empty).to(device)
        self.n_piece = int(self.piece_idx.shape[1])
        self.local_idx = torch.cat([self.piece_idx[self.index],
                                    self.rep_idx])
        self.numel = off

    @property
    def sharded(self):
        """Whether any parameter is split."""
        return self.n_piece > 0

    def local(self, full):
        """This rank's local vector of a flat (P,) vector."""
        return full[self.local_idx]

    def gather(self, local, out, axis_name=MODEL_AXIS):
        """Write the whole (P,) vector ``out`` from every rank's local
        vector: one all-gather of the slices."""
        pieces = comm.all_gather(local[:self.n_piece], axis_name)
        out[self.piece_idx.reshape(-1)] = pieces.reshape(-1).to(out.dtype)
        out[self.rep_idx] = local[self.n_piece:].to(out.dtype)
        return out

    def reduce_scatter(self, full_g, axis_name=MODEL_AXIS):
        """This rank's local gradient: its slices' model-axis mean (one
        reduce-scatter) and the whole parameters' model-axis mean (one
        all-reduce of the small ones). The ranks of a data row take the
        same rows, but on the card their sums may round apart (cuDNN's
        weight gradients are not bit-reproducible): the means keep every
        rank's parameters the same."""
        mine = comm.reduce_scatter_mean(full_g[self.piece_idx], axis_name)
        rep = comm.pmean_(full_g[self.rep_idx], axis_name)
        return torch.cat([mine, rep])

    def sq_norm(self, local_g, axis_name=MODEL_AXIS):
        """Squared norm of the whole gradient from a local one."""
        sliced = comm.psum_((local_g[:self.n_piece].square().sum())[None],
                            axis_name)[0]
        return sliced + local_g[self.n_piece:].square().sum()
