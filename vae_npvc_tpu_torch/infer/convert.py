"""Bucketed, masked batch conversion with a loaded checkpoint.

Counterpart of ``vae_npvc_tpu/infer/convert.py`` (``_bucket``,
``encoder_archs``, ``Converter``). Utterances are padded to bucket lengths
and batched; length masks inside the model make a padded batch equal to
unpadded per-utterance runs. ``infer`` runs on the converter's device or
raises: there is no retry on another device. The offline Kaldi-ark
``decode``/``sweep`` paths belong to a later slice.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import build_model
from ..models.vqvae import Encoder
from ..utils import msgpack_io
from ..utils.bridge import from_jax_variables

# checkpoint weight-norm axis format this port reads (the JAX package's
# utils/migrate.py WN_AXIS_FORMAT)
WN_AXIS_FORMAT = 2


def _bucket(T, bucket_size, min_len=1):
    return max(-(-T // bucket_size) * bucket_size, min_len)


def encoder_archs(config):
    """The chained encoder arch dicts of a config (flat or hierarchical)."""
    if "encoder" in config:
        return [config["encoder"]]
    keys = sorted((k for k in config if k.startswith("encoder.")),
                  key=lambda k: int(k.split(".")[1]))
    return [config[k] for k in keys]


def read_checkpoint(path):
    """The JAX package's msgpack checkpoint as ``(payload, variables)``:
    ``variables = {"params": ..., "ema": ...}`` numpy trees. The optimizer
    subtree is parsed and not used."""
    with open(path, "rb") as f:
        payload = msgpack_io.msgpack_restore(f.read())
    fmt = payload.get("wn_axis_format", 1)
    if fmt != WN_AXIS_FORMAT:
        raise ValueError(
            f"{path}: checkpoint weight-norm axis format {fmt}, expected "
            f"{WN_AXIS_FORMAT}; migrate it with the JAX package "
            "(vae_npvc_tpu/utils/migrate.py) first")
    ema = payload.get("ema", {})
    ema = ema.get("ema", ema)
    return payload, {"params": payload["model"], "ema": ema}


class Converter:
    """Builds the model once on ``device`` in the config's
    ``compute_dtype``; runs bucketed masked batches."""

    def __init__(self, config, device="cuda"):
        self.config = config
        self.model = build_model(config, device).eval()
        self.device = next(self.model.parameters()).device
        self.bucket_size = config.get("decode_bucket_size", 256)
        self.batch_size = config.get("decode_batch_size", 8)
        self.min_frames = Encoder.min_input_frames(encoder_archs(config))
        self.iteration = None

    def load_checkpoint(self, path):
        """Load a JAX-format msgpack checkpoint; returns its iteration."""
        payload, variables = read_checkpoint(path)
        self.model.load_state_dict(from_jax_variables(variables), strict=True)
        self.iteration = int(payload.get("iteration", 0))
        return self.iteration

    def infer(self, feats, tgts, lengths):
        """(B, T_pad, D) feats, (B,) or (B, K) target ids, (B,) lengths ->
        (B, T_pad, D') float32 numpy mel, computed on the device."""
        with torch.inference_mode():
            x = torch.as_tensor(np.asarray(feats, np.float32),
                                device=self.device)
            y = torch.as_tensor(np.asarray(tgts), device=self.device)
            n = torch.as_tensor(np.asarray(lengths, np.int32),
                                device=self.device)
            return self.model.infer(x, y, n).cpu().numpy()
