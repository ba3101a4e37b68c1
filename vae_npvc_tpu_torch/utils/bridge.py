"""Parameter bridge between the JAX package's variable trees and the port's
``state_dict``.

The layer layouts are those of ``vae_npvc_tpu/utils/torch_export.py``
(lines 12-22), kept as they are: a weight-normalized conv stores ``v``
(K, in, out), ``g`` and ``b``; GroupNorm ``scale``/``bias``; the speaker
table ``embedding``; the EMA codebook ``initted/emb/emb_sum/emb_elem``. The
port's modules use the flax names, so a ``state_dict`` key is the flax path
joined with dots (``encoder.stack_0_0.conv_0.v``) and the bridge only
flattens and converts. The ``ema`` collection's roots (``quantizer``) sit
beside the parameters.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

EMA_ROOTS = ("quantizer",)


def _flatten(tree, prefix, out):
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            _flatten(v, key + ".", out)
        else:
            if key in out:
                raise ValueError(f"duplicate variable {key!r}")
            out[key] = v


def from_jax_variables(variables) -> "OrderedDict[str, torch.Tensor]":
    """``{"params": tree, "ema": tree}`` of numpy arrays -> ``state_dict``."""
    flat = OrderedDict()
    _flatten(variables.get("params", {}), "", flat)
    ema = OrderedDict()
    _flatten(variables.get("ema", {}), "", ema)
    for k in ema:
        if k in flat or k.split(".")[0] not in EMA_ROOTS:
            raise ValueError(f"unexpected ema variable {k!r}")
    flat.update(ema)
    return OrderedDict(
        (k, torch.from_numpy(np.array(v, copy=True))) for k, v in flat.items())


def to_jax_variables(state_dict):
    """Inverse of :func:`from_jax_variables`: ``state_dict`` ->
    ``{"params": tree, "ema": tree}`` of numpy arrays."""
    out = {"params": {}, "ema": {}}
    for key, t in state_dict.items():
        parts = key.split(".")
        node = out["ema" if parts[0] in EMA_ROOTS else "params"]
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t.detach().cpu().numpy()
    return out
