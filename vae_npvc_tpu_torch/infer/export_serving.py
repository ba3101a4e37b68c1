"""Serving export: the conversion graph as ``torch.export`` artifacts.

Counterpart of ``vae_npvc_tpu/infer/export_serving.py``. A checkpoint's
bucketed conversion function (``Model.infer`` at a fixed padded batch) is
exported with ``torch.export`` into a bundle directory:

    bundle.json          metadata (buckets, batch/target shape, speaker map)
    params.msgpack       the model variables, stored ONCE
    bucket_<T>.pt2       ``torch.export.save`` of the program for length T

Loading a bundle (:class:`ServingBundle`) needs torch, numpy and the port's
``ops`` (which register the two kernel operators the programs call): no
model code, no config, no checkpoint code.

- Each program takes the variables as an input (a flat dict of the model's
  ``state_dict`` keys, the analog of JAX's state-dict argument), so no
  ``.pt2`` holds a weight; ``params.msgpack`` carries them once, in the JAX
  package's layout and bytes (fp32, or weight-only int8 with
  ``quantize="int8"``, dequantized to fp32 at load).
- The programs hold K1 (``vae_npvc_torch::nearest_code``) and K2
  (``vae_npvc_torch::group_norm``) as the registered operators, so a bundle
  served on the card launches both kernels. (The JAX export forces
  ``use_pallas_vq: false`` for portable StableHLO; there is no such switch
  here.)
- A program is exported on one device (``bundle.json`` ``device``); a bundle
  loaded on another is moved with ``torch.export.passes.move_to_device_pass``
  or refused, never run silently on the CPU. A failure at call time raises:
  there is no retry on another device.
- Bucketing mirrors ``infer/convert.Converter``: every multiple of
  ``decode_bucket_size`` up to ``max_frames``, clamped to the family's
  ``min_input_frames``; masked inference makes a padded batch equal to
  unpadded runs.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path

import numpy as np
import torch

from ..ops import groupnorm as _groupnorm  # noqa: F401 — registers K2's op
from ..ops import vq_fused as _vq_fused  # noqa: F401 — registers K1's op
from ..utils import msgpack_io
from ..utils.bridge import from_jax_variables
from ..utils.device import resolve_device

logger = logging.getLogger("vae_npvc_tpu_torch.export_serving")

_FORMAT_VERSION = 1
EXPORTER = "torch.export"

_Q8_KEY = "__q8__"


def _quantize_tree(tree, min_size):
    """Weight-only symmetric int8: float leaves with >= ``min_size``
    elements and at least two axes become ``{__q8__, scale}`` nodes
    (per-last-axis-channel scales); the others stay as they are. The
    dequantized weight differs from the original by <= scale/2."""
    def q(leaf):
        a = np.asarray(leaf)
        if a.dtype.kind != "f" or a.size < min_size or a.ndim < 2:
            return a
        amax = np.max(np.abs(a), axis=tuple(range(a.ndim - 1)))
        scale = np.maximum(amax, 1e-12).astype(np.float32) / 127.0
        q8 = np.clip(np.rint(a / scale), -127, 127).astype(np.int8)
        return {_Q8_KEY: q8, "scale": scale}

    if isinstance(tree, dict):
        return {k: _quantize_tree(v, min_size) for k, v in tree.items()}
    return q(tree)


def _dequantize_tree(tree):
    if isinstance(tree, dict):
        if _Q8_KEY in tree:
            return (tree[_Q8_KEY].astype(np.float32)
                    * np.asarray(tree["scale"], np.float32))
        return {k: _dequantize_tree(v) for k, v in tree.items()}
    return tree


def read_params(path, quantize=None):
    """The variables of a bundle's ``params.msgpack`` (the port's or the
    JAX package's) as a flat ``{state_dict key: CPU tensor}`` dict in key
    order, int8 leaves dequantized to fp32."""
    tree = msgpack_io.msgpack_restore(Path(path).read_bytes())
    if quantize == "int8" and "params" in tree:
        tree = dict(tree, params=_dequantize_tree(tree["params"]))
    return dict(sorted(from_jax_variables(tree).items()))


class _InferCall(torch.nn.Module):
    """``model.infer`` as a module call, for ``functional_call``."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, x, y, lengths):
        return self.model.infer(x, y, lengths)


class _Program(torch.nn.Module):
    """What a bucket exports: ``(variables, x, y, lengths) -> mel``. The
    model is held outside the module tree, so the exported program has no
    parameters or buffers of its own: every weight is an input."""

    def __init__(self, model):
        super().__init__()
        object.__setattr__(self, "_call", _InferCall(model))

    def forward(self, variables, x, y, lengths):
        return torch.func.functional_call(
            self._call, {f"model.{k}": v for k, v in variables.items()},
            (x, y, lengths))


def _feat_dim(config):
    enc = config.get("encoder", config.get("encoder.0", {}))
    return int(enc.get("in_channels", [80])[0])


def export_bundle(config, checkpoint, out_dir, *, buckets=None,
                  max_frames=2048, batch_size=None, n_targets=1,
                  device="cuda", spk2spk_id=None, quantize=None,
                  quantize_min_size=4096):
    """Export a checkpoint's conversion path into a serving bundle.

    ``buckets``: explicit padded lengths; default = every multiple of the
    config's ``decode_bucket_size`` up to ``max_frames``. ``n_targets`` is
    the trials-line target count baked into the program shapes (rows with
    fewer targets repeat the last). ``spk2spk_id`` (name -> int) goes into
    the metadata. ``device`` is where the model is built and the programs
    are traced (the device they run on without a move). ``quantize="int8"``
    stores the params weight-only int8 (the programs are unchanged).
    Returns the metadata dict.
    """
    from ..utils.bridge import to_jax_variables
    from .convert import Converter, encoder_archs

    if quantize not in (None, "int8"):
        raise ValueError(f"unknown quantize mode {quantize!r} "
                         "(supported: 'int8')")
    conv = Converter(config, device=device)
    iteration = conv.load_checkpoint(checkpoint)
    dev = conv.device
    B = int(batch_size or conv.batch_size)
    K = int(n_targets)
    D = _feat_dim(config)
    if buckets is None:
        bs = conv.bucket_size
        buckets = list(range(bs, int(max_frames) + 1, bs)) or [bs]
    buckets = sorted({max(int(t), conv.min_frames) for t in buckets})

    state = conv.model.state_dict()
    variables = dict(sorted(state.items()))
    program = _Program(conv.model)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.no_grad():
        for T in buckets:
            args = (variables,
                    torch.zeros((B, T, D), dtype=torch.float32, device=dev),
                    torch.zeros((B, K), dtype=torch.int32, device=dev),
                    torch.full((B,), T, dtype=torch.int32, device=dev))
            exported = torch.export.export(program, args, strict=False)
            # the example inputs would be saved with the program, weights
            # and all
            exported.example_inputs = None
            path = out / f"bucket_{T:05d}.pt2"
            torch.export.save(exported, str(path))
            logger.info(f"exported {path.name} ({path.stat().st_size} "
                        "bytes)")
    store = to_jax_variables(state)
    if not store["ema"]:
        del store["ema"]     # a model without EMA codebooks has no collection
    if quantize == "int8":
        store["params"] = _quantize_tree(store["params"],
                                         int(quantize_min_size))
    (out / "params.msgpack").write_bytes(msgpack_io.msgpack_serialize(store))

    meta = {
        "format_version": 2 if quantize else _FORMAT_VERSION,
        "model_type": config.get("model_type", ""),
        "iteration": int(iteration),
        "feat_dim": D,
        "batch_size": B,
        "n_targets": K,
        "buckets": [int(t) for t in buckets],
        "min_frames": int(conv.min_frames),
        "n_encoder_levels": len(encoder_archs(config)),
        "y_num": int(config.get("y_num", 0)),
        "quantize": quantize,
        "device": dev.type,
        "torch_version": torch.__version__,
        "exporter": EXPORTER,
        "spk2spk_id": ({str(k): int(v) for k, v in spk2spk_id.items()}
                       if spk2spk_id else None),
    }
    (out / "bundle.json").write_text(json.dumps(meta, indent=1))
    return meta


def _move_pass():
    try:
        from torch.export.passes import move_to_device_pass
    except ImportError:
        return None
    return move_to_device_pass


class ServingBundle:
    """Load an exported bundle and run conversion without model code.

    The variables are read once onto ``device``; bucket programs are
    deserialized on first use. A program exported on another device type
    is moved to ``device`` as it loads.
    """

    def __init__(self, path, device="cuda"):
        self.path = Path(path)
        self.meta = json.loads((self.path / "bundle.json").read_text())
        if self.meta.get("format_version") not in (1, 2):
            raise ValueError(
                f"bundle format {self.meta.get('format_version')} not in "
                f"supported (1, 2)")
        if self.meta.get("exporter") != EXPORTER \
                or not any(self.path.glob("bucket_*.pt2")):
            found = sorted(p.name for p in self.path.glob("bucket_*"))[:3]
            raise ValueError(
                f"{self.path} holds no {EXPORTER} programs "
                f"(bucket_<T>.pt2; found {found or 'none'}): the PyTorch "
                "port serves bundles written by its own exporter, "
                "python -m vae_npvc_tpu_torch.bin.export_serving; its "
                "params.msgpack alone can be read with read_params")
        self.device = resolve_device(device)
        self.exported_on = self.meta.get("device")
        if self.exported_on != self.device.type and _move_pass() is None:
            raise ValueError(
                f"bundle exported on {self.exported_on!r} cannot be served "
                f"on {self.device.type!r}: this torch ({torch.__version__}) "
                "has no torch.export.passes.move_to_device_pass; re-export "
                f"with --device {self.device.type}")
        self.variables = {
            k: v.to(self.device) for k, v in read_params(
                self.path / "params.msgpack", self.meta.get("quantize"))
            .items()}
        self.batch_size = int(self.meta["batch_size"])
        self.n_targets = int(self.meta["n_targets"])
        self.feat_dim = int(self.meta["feat_dim"])
        self.buckets = sorted(int(t) for t in self.meta["buckets"])
        self.spk2spk_id = self.meta.get("spk2spk_id") or None
        self._fns = {}

    def _fn(self, T):
        fn = self._fns.get(T)
        if fn is None:
            program = torch.export.load(
                str(self.path / f"bucket_{T:05d}.pt2"))
            if self.exported_on != self.device.type:
                program = _move_pass()(program, self.device)
            fn = self._fns[T] = program.module()
        return fn

    def pick_bucket(self, T):
        for b in self.buckets:
            if b >= T:
                return b
        raise ValueError(
            f"utterance length {T} exceeds the largest exported bucket "
            f"{self.buckets[-1]}; re-export with a larger --max_frames")

    def resolve_target(self, t):
        """Speaker name or int id -> int id (via the embedded speaker
        map)."""
        if isinstance(t, str) and not t.lstrip("-").isdigit():
            if not self.spk2spk_id:
                raise ValueError(
                    f"named target {t!r} but the bundle embeds no spk2spk_id"
                    " map (pass spk2spk_id= at export time)")
            return int(self.spk2spk_id[t])
        return int(t)

    def infer(self, feats, tgts, lengths):
        """Padded-batch conversion through the exported program.

        ``feats`` (b, T, D) float32 with b <= batch_size, ``tgts`` (b,) or
        (b, K') int32 (K' <= n_targets; missing columns repeat the last),
        ``lengths`` (b,). Returns the raw (b, T_bucket, D) numpy array;
        callers trim to per-utterance lengths.
        """
        feats = np.asarray(feats, np.float32)
        b, T, D = feats.shape
        if b > self.batch_size:
            raise ValueError(f"batch {b} > exported batch {self.batch_size}")
        if D != self.feat_dim:
            raise ValueError(f"feat dim {D} != exported {self.feat_dim}")
        Tp = self.pick_bucket(T)
        B, K = self.batch_size, self.n_targets
        x = np.zeros((B, Tp, D), np.float32)
        x[:b, :T] = feats
        tg = np.asarray(tgts, np.int32)
        if tg.ndim == 1:
            tg = tg[:, None]
        if tg.shape[1] > K:
            raise ValueError(
                f"{tg.shape[1]} targets per row > exported n_targets {K}")
        y = np.zeros((B, K), np.int32)
        y[:b] = tg[:, [min(j, tg.shape[1] - 1) for j in range(K)]]
        lens = np.ones((B,), np.int32)
        lens[:b] = np.maximum(np.asarray(lengths, np.int32), 1)
        fn = self._fn(Tp)
        with torch.inference_mode():
            out = fn(self.variables,
                     *(torch.as_tensor(a, device=self.device)
                       for a in (x, y, lens)))
            return out[:b].cpu().numpy()

    def convert(self, items):
        """Convert a list of ``(feat[T, D], targets)`` pairs.

        ``targets`` is an int id, speaker name, or a per-level list of them.
        Items are grouped by bucket and chunked to the exported batch size.
        Returns converted arrays trimmed to each utterance's length, in
        input order.
        """
        jobs = []
        for i, (feat, targets) in enumerate(items):
            feat = np.asarray(feat, np.float32)
            if not isinstance(targets, (list, tuple)):
                targets = [targets]
            tgt = [self.resolve_target(t) for t in targets]
            jobs.append((i, feat, feat.shape[0], tgt))
        buckets: dict[int, list] = {}
        for job in jobs:
            buckets.setdefault(self.pick_bucket(job[2]), []).append(job)
        results = [None] * len(jobs)
        for Tp in sorted(buckets):
            group = buckets[Tp]
            for lo in range(0, len(group), self.batch_size):
                chunk = group[lo:lo + self.batch_size]
                Tmax = max(j[2] for j in chunk)
                feats = np.zeros((len(chunk), Tmax, self.feat_dim),
                                 np.float32)
                lens = np.zeros((len(chunk),), np.int32)
                Kc = max(len(j[3]) for j in chunk)
                tgts = np.zeros((len(chunk), Kc), np.int32)
                for r, (i, feat, T, tgt) in enumerate(chunk):
                    feats[r, :T] = feat
                    lens[r] = T
                    tgts[r] = [tgt[min(j, len(tgt) - 1)] for j in range(Kc)]
                out = self.infer(feats, tgts, lens)
                for r, (i, feat, T, tgt) in enumerate(chunk):
                    results[i] = out[r, :min(T, out.shape[1])]
        return results
