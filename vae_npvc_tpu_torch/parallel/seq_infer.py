"""Sequence-parallel inference: one long utterance across the ranks of an
axis.

Counterpart of ``vae_npvc_tpu/parallel/seq_infer.py``. Each rank holds
``T / n`` frames of the utterance; every conv pulls its receptive-field
halo from the neighbouring ranks and every GroupNorm merges the ranks'
statistics (K2's split entry points), so the output equals one rank's
``infer`` of the whole utterance, with the work and the activations split
n ways. Stride-1 (flat) configs; ``x`` (1, T, D) with T divisible by the
axis size.

Usage (on every rank of the mesh):
    out = sequence_parallel_infer(config, state, x, y_idx, mesh)
"""

from __future__ import annotations

import torch

from . import comm

AXIS = "data"


def sequence_parallel_model(config, state, device="cuda", axis_name=AXIS):
    """The model of ``config`` with ``seq_axis`` set and ``state`` (its
    ``state_dict``) loaded, for :func:`sequence_parallel_infer`."""
    from ..models import build_model

    model = build_model({**dict(config), "seq_axis": axis_name},
                        device).eval()
    model.load_state_dict(state, strict=True)
    return model


def sequence_parallel_infer(config, state, x, y_idx, mesh, axis_name=AXIS,
                            device="cuda", model=None):
    """Time-sharded ``model.infer`` over ``mesh``'s ``axis_name`` axis.

    ``state`` is the flat model's ``state_dict`` (or pass a ``model`` from
    :func:`sequence_parallel_model`); ``x`` (1, T, D) is the whole
    utterance on every rank, of which this rank converts its ``T / n``
    frames. Returns the whole (1, T, D') output, gathered in rank order,
    on every rank.
    """
    ax = mesh.axis(axis_name)
    n = ax.size
    T = x.shape[1]
    if T % n:
        raise ValueError(f"sequence length {T} must divide the {axis_name} "
                         f"axis size {n} (pad the utterance)")
    if model is None:
        model = sequence_parallel_model(config, state, device, axis_name)
    dev = next(model.parameters()).device
    x = torch.as_tensor(x, dtype=torch.float32)
    y_idx = torch.as_tensor(y_idx).to(dev)
    local = x[:, ax.index * (T // n):(ax.index + 1) * (T // n)].to(dev)
    with comm.bind(mesh, (axis_name,)), torch.inference_mode():
        out = model.infer(local, y_idx)
        parts = comm.all_gather(out.contiguous(), axis_name)
    return torch.cat(list(parts), dim=1)
