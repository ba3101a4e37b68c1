"""Weight-norm axis migration of old checkpoints, applied at load time.

Counterpart of ``vae_npvc_tpu/utils/migrate.py`` (numpy only; the port
keeps its own copy). Checkpoints of weight-norm axis format 1 stored every
magnitude ``g`` per OUTPUT channel. The layers that stand in for the
reference's transposed convolutions, the GLU ``conv_in`` and the decoders'
``up_N``, now keep ``g`` per INPUT channel (``wn_dim='in'``). A format-1
checkpoint's such layers are re-decomposed: the effective kernel under the
old parameterization (``w = v·g/||v||_out``) is split along the new axis
(``v' = w``, ``g' = ||w||_in``), so the layer computes the same function.
Checkpoints written since carry ``wn_axis_format = 2`` and are not walked.
"""

from __future__ import annotations

import logging

import numpy as np

logger = logging.getLogger("vae_npvc_tpu_torch.migrate")

WN_AXIS_FORMAT = 2

# layers built with wn_dim='in': the names resolve a square layer (in ==
# out channels), whose shapes alone cannot tell the axis
_IN_AXIS_NAMES = ("conv_in",)
_IN_AXIS_PREFIXES = ("up_",)


def _is_in_axis_name(name: str) -> bool:
    return name in _IN_AXIS_NAMES or any(
        name.startswith(p) for p in _IN_AXIS_PREFIXES)


def _redecompose(g_out, v):
    """(g per out-channel, v) -> (g per in-channel, v'), the same kernel."""
    g_out = np.asarray(g_out, np.float64)
    v = np.asarray(v, np.float64)                      # (K, in, out)
    norm_out = np.sqrt(np.sum(v * v, axis=(0, 1)))     # (out,)
    w = v * (g_out / np.maximum(norm_out, 1e-12))[None, None, :]
    g_in = np.sqrt(np.sum(w * w, axis=(0, 2)))         # (in,)
    return g_in.astype(np.float32), w.astype(np.float32)


def migrate_weight_norm(payload_model, template, path="", _count=None):
    """``payload_model`` with its old-axis weight-norm layers
    re-decomposed.

    ``template`` is the parameter tree of the model being loaded (nested
    dicts of arrays, e.g. ``to_jax_variables(model.state_dict())
    ["params"]``). A layer that stores ``g`` and ``v`` is migrated when its
    stored ``g`` is per output channel and either the template's ``g`` is
    per input channel (a shape mismatch) or the layer is square and named
    as a ``wn_dim='in'`` layer (``conv_in``, ``up_N``).
    """
    if not isinstance(payload_model, dict) or not isinstance(template, dict):
        return payload_model
    out = {}
    for key, stored in payload_model.items():
        tmpl = template.get(key)
        if (isinstance(stored, dict) and "g" in stored and "v" in stored
                and isinstance(tmpl, dict) and "g" in tmpl):
            sv = np.asarray(stored["v"])
            sg = np.asarray(stored["g"])
            tg_shape = np.shape(tmpl["g"])
            if sv.ndim == 3 and sg.shape == (sv.shape[2],):
                mismatch = (tg_shape == (sv.shape[1],)
                            and sg.shape != tg_shape)
                square = (sv.shape[1] == sv.shape[2]
                          and _is_in_axis_name(key))
                if mismatch or square:
                    g_new, v_new = _redecompose(sg, sv)
                    stored = dict(stored, g=g_new, v=v_new)
                    if _count is not None:
                        _count[0] += 1
                    logger.info(f"migrated weight-norm axis out->in: "
                                f"{path}{key} (g {sg.shape} -> "
                                f"{g_new.shape})")
                    out[key] = stored
                    continue
        if isinstance(stored, dict):
            out[key] = migrate_weight_norm(stored, tmpl or {},
                                           path=f"{path}{key}/",
                                           _count=_count)
        else:
            out[key] = stored
    return out


def maybe_migrate_model(payload, template):
    """``(model tree, changed)`` of a checkpoint payload: migrated by
    :func:`migrate_weight_norm` when its ``wn_axis_format`` (1 when absent)
    is below :data:`WN_AXIS_FORMAT`. ``changed`` says whether a layer was
    re-decomposed; the stored optimizer moments of such a layer no longer
    apply."""
    model = payload.get("model", {})
    if payload.get("wn_axis_format", 1) >= WN_AXIS_FORMAT:
        return model, False
    count = [0]
    migrated = migrate_weight_norm(model, template, _count=count)
    return migrated, count[0] > 0
