"""Model registry, keyed by the same dotted ``model_type`` strings as the
JAX package (``vae_npvc_tpu/models/__init__.py``)."""

from __future__ import annotations

from ..utils.device import compute_dtype, resolve_device
from . import token_tts as _token_tts
from . import vqvae as _vqvae

_REGISTRY = {
    "vae_npvc.model.vqvae": _vqvae.Model,
    "vqvae": _vqvae.Model,
    "vae_npvc.model.token_tts": _token_tts.Model,
    "token_tts": _token_tts.Model,
}

# families of the JAX package not ported yet -> the ROADMAP item that ports
# them
_NOT_PORTED = {
    "vqvae2": "Queue A, hierarchical family",
    "vqvae2a": "Queue A, hierarchical family",
    "vqvae2b": "Queue A, hierarchical family",
    "vae": "Queue A, other families and trainers",
}


def get_model_cls(model_type: str):
    """Resolve a model_type string (dotted reference path or short name)."""
    key = model_type.split(":")[0]
    short = key.rsplit(".", 1)[-1]
    cls = _REGISTRY.get(key) or _REGISTRY.get(short)
    if cls is not None:
        return cls
    if short in _NOT_PORTED:
        raise NotImplementedError(
            f"model_type {model_type!r} is not ported to PyTorch yet "
            f"(ROADMAP {_NOT_PORTED[short]})")
    raise KeyError(f"unknown model_type {model_type!r}; known: "
                   f"{sorted(_REGISTRY)}")


def codebook_renorm_fn(config):
    """Per-step codebook renormalization of the normalized plain-VQ flat
    model (the JAX package's ``codebook_renorm_fn``): a ``model -> None``
    function that snaps ``quantizer_embedding`` to unit rows in place
    (renorm first, gradients at the renormed point, update applied to the
    renormed value), or ``None`` for the EMA path, ``embed_norm: false``
    and models without a codebook (token TTS).
    """
    import torch

    cls = get_model_cls(config.get("model_type", "vae_npvc.model.vqvae"))
    if cls is not _vqvae.Model or config.get("use_ema", False) \
            or not config.get("embed_norm", True):
        return None

    def renorm(model):
        with torch.no_grad():
            emb = model.quantizer_embedding
            norm = torch.linalg.vector_norm(emb, dim=1, keepdim=True)
            emb.div_(torch.clamp(norm, min=1e-12))

    return renorm


def build_model(config, device="cuda", dtype=None):
    """Build the model of a flat experiment config on ``device``.

    ``dtype`` (torch dtype or name) defaults to the config's
    ``compute_dtype``. Parameters stay fp32; the compute dtype applies to
    activations. Raises when ``device`` is CUDA and no GPU is present.
    """
    dev = resolve_device(device)
    cls = get_model_cls(config.get("model_type", "vae_npvc.model.vqvae"))
    return cls(config, dtype=compute_dtype(config, dtype)).to(dev)
