"""Parameter bridge between the JAX package's variable trees and the port's
``state_dict``.

The layer layouts are those of ``vae_npvc_tpu/utils/torch_export.py``
(lines 12-22), kept as they are: a weight-normalized conv stores ``v``
(K, in, out), ``g`` and ``b``; GroupNorm ``scale``/``bias``; the speaker
table ``embedding``; the EMA codebook ``initted/emb/emb_sum/emb_elem``. The
token->mel synthesizer adds flax's own layers under their flax names: Dense
``kernel`` (in, out) and ``bias`` (``spk_emb_proj``, and in every
``enc_{j}``/``dec_{j}`` block ``mha/linear_{q,k,v,out}``, ``ffn_in``,
``ffn_out``), LayerNorm ``scale``/``bias`` (``ln_attn``, ``ln_ffn``) and
Embed ``embedding`` (``tok_embed``, ``spk_embed``); its checkpoints carry an
empty ``ema`` collection. The
port's modules use the flax names, so a ``state_dict`` key is the flax path
joined with dots (``encoder.stack_0_0.conv_0.v``) and the bridge only
flattens and converts. The ``ema`` collection's roots (the EMA codebooks:
``quantizer``, or ``quantizer_{i}`` per level of a hierarchy) sit beside the
parameters. A hierarchy's modules carry their flax names too
(``encoder_{i}``, ``decoder_{i}``, ``final_decoder``, ``gst``, ``embeds``
or ``embeds_{i}``/``embed``, ``quantizer_embedding[_{i}]``); a GST top
level has no codebook.

The trainer's optimizer state crosses the same way. The port keeps every
parameter, and Adam's two moments, in one flat vector in
``named_parameters`` order; the JAX checkpoint's ``optimizer`` entry for the
chain clip -> adam(schedule) is ``{"0": {}, "1": {"0": {"count", "mu",
"nu"}, "1": {"count"}}}`` with ``mu``/``nu`` shaped like the parameter tree
(no ``"0": {}`` level without the clip, an empty ``"1"`` without a
schedule). RAdam's chain has the same tree; AdamW's holds the empty state of
its decoupled weight decay at ``"1"`` and the schedule's count at ``"2"``.
:func:`optimizer_to_jax` and :func:`optimizer_from_jax` convert between the
two. The vocoder trainer's ``optimizer_G``/``optimizer_D`` are such trees,
one per network.

The evaluation modules (the CTC recognizer, the character LSTM LM and the
speaker embedder, ``eval/``) keep flax's names too, except the LM's LSTM:
flax stores layer ``i`` as ``OptimizedLSTMCell_{i}`` with input kernels
``ii/if/ig/io`` (in, hidden), no input bias, and recurrent kernels and
biases ``hi/hf/hg/ho``; the port runs ``torch.nn.LSTM`` (``lstm.weight_ih_l{i}``
(4 hidden, in) in the same gate order i, f, g, o, ``weight_hh_l{i}``,
``bias_hh_l{i}``, and ``bias_ih_l{i}`` held at zero).
:func:`params_from_flax` and :func:`params_to_flax` convert such a ``params``
tree and the module's ``state_dict``; :func:`load_flax_params` loads a tree
into a module on its device.
"""

from __future__ import annotations

import re
from collections import OrderedDict

import numpy as np
import torch

# roots of the ``ema`` collection: the flat model's (and vqvae2a's shared)
# ``quantizer``, a hierarchy's per-level ``quantizer_{i}``
EMA_ROOTS = re.compile(r"quantizer(_\d+)?")


def is_ema_root(name):
    return EMA_ROOTS.fullmatch(name) is not None


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
        if k in flat or not is_ema_root(k.split(".")[0]):
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
        node = out["ema" if is_ema_root(parts[0]) else "params"]
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t.detach().cpu().numpy()
    return out


def _unflatten(flat, layout):
    """Flat vector -> nested numpy tree; ``layout`` is ``[(dotted name,
    shape), ...]`` in the vector's order."""
    flat = flat.detach().cpu().numpy()
    tree, off = {}, 0
    for name, shape in layout:
        n = int(np.prod(shape, dtype=np.int64))
        parts = name.split(".")
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = flat[off:off + n].reshape(shape).copy()
        off += n
    if off != flat.size:
        raise ValueError(f"layout covers {off} of {flat.size} values")
    return tree


def _flatten_like(tree, layout):
    """Nested tree -> flat float32 tensor in ``layout`` order."""
    flat = {}
    _flatten(tree, "", flat)
    if set(flat) != {name for name, _ in layout}:
        raise ValueError("optimizer moments do not match the parameters: "
                         f"{sorted(set(flat) ^ {n for n, _ in layout})}")
    chunks = []
    for name, shape in layout:
        a = np.asarray(flat[name], np.float32)
        if a.shape != tuple(shape):
            raise ValueError(f"{name}: moment shape {a.shape}, parameter "
                             f"shape {tuple(shape)}")
        chunks.append(a.reshape(-1))
    return torch.from_numpy(np.concatenate(chunks))


def optimizer_to_jax(opt_state, layout, clips, decoupled=False):
    """The port's Adam-family state -> the JAX checkpoint's ``optimizer``
    tree. ``opt_state`` has ``count``, ``mu``, ``nu``, ``sched_count``
    (``None`` without a schedule); ``clips`` says whether the chain starts
    with the global-norm clip, ``decoupled`` whether it is AdamW's (an
    empty weight-decay state before the schedule's)."""
    adam = {"0": {"count": np.asarray(opt_state.count.cpu().numpy(),
                                      np.int32),
                  "mu": _unflatten(opt_state.mu, layout),
                  "nu": _unflatten(opt_state.nu, layout)}}
    if decoupled:
        adam["1"] = {}
    adam[str(len(adam))] = (
        {} if opt_state.sched_count is None else
        {"count": np.asarray(opt_state.sched_count.cpu().numpy(), np.int32)})
    return {"0": {}, "1": adam} if clips else {"0": adam}


def optimizer_from_jax(tree, layout, clips, scheduled, device,
                       decoupled=False):
    """Inverse of :func:`optimizer_to_jax`: ``(count, mu, nu,
    sched_count)`` tensors on ``device``."""
    adam = tree["1" if clips else "0"]
    inner = adam["0"]

    def count(v):
        return torch.tensor(int(v), dtype=torch.int32, device=device)

    sched = (count(adam["2" if decoupled else "1"]["count"]) if scheduled
             else None)
    return (count(inner["count"]),
            _flatten_like(inner["mu"], layout).to(device),
            _flatten_like(inner["nu"], layout).to(device), sched)


_LSTM_CELL = re.compile(r"OptimizedLSTMCell_(\d+)")
_LSTM_KEY = re.compile(r"lstm\.(weight_ih|weight_hh|bias_ih|bias_hh)_l(\d+)")
_GATES = "ifgo"


def params_from_flax(tree) -> "OrderedDict[str, torch.Tensor]":
    """A flax ``params`` tree of numpy arrays -> ``state_dict`` of an
    evaluation module; ``OptimizedLSTMCell_{i}`` becomes ``lstm.*_l{i}``."""
    flat = OrderedDict()
    for name, sub in tree.items():
        m = _LSTM_CELL.fullmatch(name)
        if m is None:
            _flatten({name: sub}, "", flat)
            continue
        i = m.group(1)

        def cat(kind, leaf):
            return np.concatenate([np.asarray(sub[f"{kind}{g}"][leaf])
                                   for g in _GATES], axis=-1)
        flat[f"lstm.weight_ih_l{i}"] = cat("i", "kernel").T
        flat[f"lstm.weight_hh_l{i}"] = cat("h", "kernel").T
        bias = cat("h", "bias")
        flat[f"lstm.bias_ih_l{i}"] = np.zeros_like(bias)
        flat[f"lstm.bias_hh_l{i}"] = bias
    return OrderedDict((k, torch.from_numpy(np.array(v, copy=True)))
                       for k, v in flat.items())


def _sorted_tree(node):
    return {k: _sorted_tree(node[k]) if isinstance(node[k], dict)
            else node[k] for k in sorted(node)}


def params_to_flax(state_dict):
    """Inverse of :func:`params_from_flax`: ``state_dict`` -> flax
    ``params`` tree of numpy arrays, keys in flax's sorted order. Raises if
    an LSTM input bias is not zero (flax's cell has none)."""
    tree, cells = {}, {}
    for key, t in state_dict.items():
        a = t.detach().cpu().numpy()
        m = _LSTM_KEY.fullmatch(key)
        if m is not None:
            cells.setdefault(m.group(2), {})[m.group(1)] = a
            continue
        parts = key.split(".")
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = a
    for i, c in cells.items():
        if np.any(c["bias_ih"]):
            raise ValueError(f"lstm.bias_ih_l{i} is not zero: flax's "
                             "OptimizedLSTMCell has no input bias")
        cell = {}
        for kind, w in (("i", c["weight_ih"]), ("h", c["weight_hh"])):
            for g, part in zip(_GATES, np.split(w.T, 4, axis=1)):
                cell[f"{kind}{g}"] = {"kernel": np.ascontiguousarray(part)}
        for g, part in zip(_GATES, np.split(c["bias_hh"], 4)):
            cell[f"h{g}"]["bias"] = part.copy()
        tree[f"OptimizedLSTMCell_{i}"] = cell
    return _sorted_tree(tree)


def load_flax_params(module, tree):
    """Load a flax ``params`` tree (numpy) into ``module`` on the device
    of its parameters; returns the module."""
    dev = next(module.parameters()).device
    module.load_state_dict({k: v.to(dev) for k, v in
                            params_from_flax(tree).items()}, strict=True)
    return module
