"""Model registry, keyed by the same dotted ``model_type`` strings as the
JAX package (``vae_npvc_tpu/models/__init__.py``)."""

from __future__ import annotations

from ..utils.device import compute_dtype, resolve_device
from . import token_tts as _token_tts
from . import vae as _vae
from . import vqvae as _vqvae
from . import vqvae2 as _vqvae2
from . import vqvae2a as _vqvae2a
from . import vqvae2b as _vqvae2b

_REGISTRY = {
    "vae_npvc.model.vqvae": _vqvae.Model,
    "vqvae": _vqvae.Model,
    "vae_npvc.model.vae": _vae.Model,
    "vae": _vae.Model,
    "vae_npvc.model.token_tts": _token_tts.Model,
    "token_tts": _token_tts.Model,
    "vae_npvc.model.vqvae2": _vqvae2.Model,
    "vqvae2": _vqvae2.Model,
    "vae_npvc.model.vqvae2a": _vqvae2a.Model,
    "vqvae2a": _vqvae2a.Model,
    "vae_npvc.model.vqvae2b": _vqvae2b.Model,
    "vqvae2b": _vqvae2b.Model,
}


def get_model_cls(model_type: str):
    """Resolve a model_type string (dotted reference path or short name)."""
    key = model_type.split(":")[0]
    short = key.rsplit(".", 1)[-1]
    cls = _REGISTRY.get(key) or _REGISTRY.get(short)
    if cls is not None:
        return cls
    raise KeyError(f"unknown model_type {model_type!r}; known: "
                   f"{sorted(_REGISTRY)}")


def codebook_renorm_fn(config):
    """Per-step renormalization of every normalized plain-VQ codebook (the
    JAX package's ``codebook_renorm_fn``): a ``model -> None`` function
    that snaps each such codebook parameter to unit rows in place (renorm
    first, gradients at the renormed point, update applied to the renormed
    value), or ``None`` when there is none (EMA codebooks, ``embed_norm:
    false`` / ``normalize: false``, GST levels, token TTS).

    The flat model's codebook is ``quantizer_embedding``; a hierarchy's
    are ``quantizer_embedding_{i}`` per level and vqvae2a's shared
    ``quantizer_embedding``.
    """
    import torch

    cls = get_model_cls(config.get("model_type", "vae_npvc.model.vqvae"))
    names = []
    if config.get("use_ema", False):
        return None
    if cls is _vqvae.Model:
        if config.get("embed_norm", True):
            names.append("quantizer_embedding")
    elif cls in (_vqvae2.Model, _vqvae2a.Model, _vqvae2b.Model):
        if dict(config.get("quantizer", {})).get("normalize", False):
            names.append("quantizer_embedding")  # vqvae2a shared quantizer
        for i in range(config.get("levels", 3)):
            if dict(config.get(f"quantizer.{i}", {})).get("normalize",
                                                          False):
                names.append(f"quantizer_embedding_{i}")
    if not names:
        return None

    def renorm(model):
        with torch.no_grad():
            for n in names:
                emb = getattr(model, n, None)
                if emb is None:   # a GST top level, or EMA banks
                    continue
                norm = torch.linalg.vector_norm(emb, dim=1, keepdim=True)
                emb.div_(torch.clamp(norm, min=1e-12))

    return renorm


def build_model(config, device="cuda", dtype=None):
    """Build the model of an experiment config on ``device``.

    ``dtype`` (torch dtype or name) defaults to the config's
    ``compute_dtype``. Parameters stay fp32; the compute dtype applies to
    activations. Raises when ``device`` is CUDA and no GPU is present.
    """
    dev = resolve_device(device)
    cls = get_model_cls(config.get("model_type", "vae_npvc.model.vqvae"))
    return cls(config, dtype=compute_dtype(config, dtype)).to(dev)
