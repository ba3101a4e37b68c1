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
speaker embedder, ``eval/``) keep flax's names too. An LSTM cell is where
the two layouts differ: flax stores an ``OptimizedLSTMCell`` as input
kernels ``ii/if/ig/io`` (in, hidden), no input bias, and recurrent kernels
and biases ``hi/hf/hg/ho``; the port holds each cell as one
``nn/rnn.LSTM`` layer at the same path, named by the model after the flax
cell (the LM's ``OptimizedLSTMCell_{i}``, the Tacotron2 encoder's two
directions, its decoder's ``dec_cell/lstm_{l}``), with ``weight_ih_l0``
(4 hidden, in) in the same gate order i, f, g, o, ``weight_hh_l0`` and
``bias_hh_l0`` (its zero input bias is not in the ``state_dict``).
:func:`params_from_flax` and :func:`params_to_flax` convert such a ``params``
tree and the module's ``state_dict``; :func:`load_flax_params` loads a tree
into a module on its device. :func:`from_jax_variables` and
:func:`to_jax_variables` map the cells too, so the trainer's checkpoints
carry them.
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
    flat = params_from_flax(variables.get("params", {}))
    ema = OrderedDict()
    _flatten(variables.get("ema", {}), "", ema)
    for k in ema:
        if k in flat or not is_ema_root(k.split(".")[0]):
            raise ValueError(f"unexpected ema variable {k!r}")
        flat[k] = torch.from_numpy(np.array(ema[k], copy=True))
    return flat


def to_jax_variables(state_dict):
    """Inverse of :func:`from_jax_variables`: ``state_dict`` ->
    ``{"params": tree, "ema": tree}`` of numpy arrays."""
    params, ema = OrderedDict(), {}
    for key, t in state_dict.items():
        parts = key.split(".")
        if not is_ema_root(parts[0]):
            params[key] = t
            continue
        node = ema
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t.detach().cpu().numpy()
    return {"params": params_to_flax(params, sort=False), "ema": ema}


def _unflatten(flat, layout):
    """Flat vector -> nested numpy tree of the parameters' flax layout;
    ``layout`` is ``[(dotted name, shape), ...]`` in the vector's order
    (an LSTM's packed tensors become flax's per-gate leaves)."""
    flat = flat.detach().cpu().clone()
    tensors, off = OrderedDict(), 0
    for name, shape in layout:
        n = int(np.prod(shape, dtype=np.int64))
        tensors[name] = flat[off:off + n].reshape(shape)
        off += n
    if off != flat.numel():
        raise ValueError(f"layout covers {off} of {flat.numel()} values")
    return params_to_flax(tensors)


def _flatten_like(tree, layout):
    """Nested tree of the flax layout -> flat float32 tensor in ``layout``
    order."""
    flat = params_from_flax(tree)
    names = {name for name, _ in layout}
    if names != set(flat):
        raise ValueError("optimizer moments do not match the parameters: "
                         f"{sorted(names ^ set(flat))}")
    chunks = []
    for name, shape in layout:
        a = flat[name].float()
        if tuple(a.shape) != tuple(shape):
            raise ValueError(f"{name}: moment shape {tuple(a.shape)}, "
                             f"parameter shape {tuple(shape)}")
        chunks.append(a.reshape(-1))
    return torch.cat(chunks)


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


# an LSTM layer's tensors (``nn/rnn.LSTM``): ``{cell path}.{kind}_l0``
_LSTM_KEY = re.compile(r"(.+)\.(weight_ih|weight_hh|bias_hh)_l0")
_GATES = "ifgo"
_CELL_LEAVES = {f"{kind}{g}" for kind in "ih" for g in _GATES}


def _is_flax_cell(node):
    return isinstance(node, dict) and set(node) == _CELL_LEAVES


def params_from_flax(tree, path=()) -> "OrderedDict[str, torch.Tensor]":
    """A flax ``params`` tree of numpy arrays -> ``state_dict``; each
    ``OptimizedLSTMCell`` becomes the packed tensors of the LSTM layer at
    its path."""
    flat = OrderedDict()
    for name, sub in tree.items():
        key = ".".join(path + (name,))
        if not isinstance(sub, dict):
            flat[key] = sub
        elif not _is_flax_cell(sub):
            flat.update(params_from_flax(sub, path + (name,)))
        else:
            def cat(kind, leaf):
                return np.concatenate([np.asarray(sub[f"{kind}{g}"][leaf])
                                       for g in _GATES], axis=-1)
            flat[f"{key}.weight_ih_l0"] = cat("i", "kernel").T
            flat[f"{key}.weight_hh_l0"] = cat("h", "kernel").T
            flat[f"{key}.bias_hh_l0"] = cat("h", "bias")
    if path:
        return flat
    return OrderedDict((k, torch.from_numpy(np.array(v, copy=True)))
                       for k, v in flat.items())


def _sorted_tree(node):
    return {k: _sorted_tree(node[k]) if isinstance(node[k], dict)
            else node[k] for k in sorted(node)}


def params_to_flax(state_dict, sort=True):
    """Inverse of :func:`params_from_flax`: ``state_dict`` -> flax
    ``params`` tree of numpy arrays, keys in flax's sorted order (in the
    ``state_dict``'s with ``sort=False``)."""
    tree, cells = {}, {}
    for key, t in state_dict.items():
        a = t.detach().cpu().numpy()
        m = _LSTM_KEY.fullmatch(key)
        path = tuple((m.group(1) if m else key).split("."))
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        if m is None:
            node[path[-1]] = a
        else:
            cells.setdefault(path, node.setdefault(path[-1], {}))[
                m.group(2)] = a
    for c in cells.values():
        w_ih, w_hh, b_hh = (c.pop(k) for k in ("weight_ih", "weight_hh",
                                                "bias_hh"))
        for kind, w in (("i", w_ih), ("h", w_hh)):
            for g, part in zip(_GATES, np.split(w.T, 4, axis=1)):
                c[f"{kind}{g}"] = {"kernel": np.ascontiguousarray(part)}
        for g, part in zip(_GATES, np.split(b_hh, 4)):
            c[f"h{g}"]["bias"] = part.copy()
    return _sorted_tree(tree) if sort else tree


def load_flax_params(module, tree):
    """Load a flax ``params`` tree (numpy) into ``module`` on the device
    of its parameters; returns the module."""
    dev = next(module.parameters()).device
    module.load_state_dict({k: v.to(dev) for k, v in
                            params_from_flax(tree).items()}, strict=True)
    return module
