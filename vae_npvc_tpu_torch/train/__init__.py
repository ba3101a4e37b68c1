"""Trainer registry, keyed by the same dotted ``trainer_type`` strings as
the JAX package (``vae_npvc_tpu/train/__init__.py``)."""

from __future__ import annotations

from .gan import GanTrainer
from .trainer import Trainer

_REGISTRY = {
    "vae_npvc.trainer.basic": Trainer,
    "basic": Trainer,
    "vae_npvc.trainer.wgan_gp": GanTrainer,
    "wgan_gp": GanTrainer,
}


def get_trainer_cls(trainer_type: str):
    key = trainer_type.split(":")[0]
    short = key.rsplit(".", 1)[-1]
    cls = _REGISTRY.get(key) or _REGISTRY.get(short)
    if cls is not None:
        return cls
    raise KeyError(f"unknown trainer_type {trainer_type!r}; known: "
                   f"{sorted(_REGISTRY)}")


def build_trainer(config, **kw):
    cls = get_trainer_cls(config.get("trainer_type",
                                     "vae_npvc.trainer.basic"))
    return cls(config, **kw)
