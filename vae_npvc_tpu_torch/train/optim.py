"""Optimizer and schedule builders, functional over one flat vector.

Counterpart of ``vae_npvc_tpu/train/optim.py`` (an optax chain of
clip-by-global-norm and the configured optimizer). The trainer keeps every
parameter in one flat fp32 vector, so the transform here takes the flat
gradient and returns the flat update and the new state, as
``tx.update(grads, state)`` does in optax: the caller adds the update, and
can keep the old state when it rejects a step. All values stay on the
device; nothing here reads a tensor on the host.

Adam follows ``optax.adam``: the count is incremented first, both bias
corrections use the new count, the update is ``-lr * m_hat / (sqrt(v_hat)
+ 1e-8)``, and a schedule is read at its own count before that count is
incremented. RAdam, PlainRAdam and the warmup AdamW of the JAX package are
not ported yet and raise.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


def clip_by_global_norm_torch(grad, max_norm):
    """Scale ``grad`` by ``min(1, max_norm / (norm + 1e-6))``, the
    semantics of ``torch.nn.utils.clip_grad_norm_`` that the JAX package's
    transform of the same name keeps."""
    norm = torch.linalg.vector_norm(grad)
    return grad * torch.clamp(max_norm / (norm + 1e-6), max=1.0)


def build_schedule(config):
    """Learning-rate schedule from the reference config keys: a float, or
    for ``lr_scheduler`` a function of the step count (a tensor) giving the
    staircase ``lr * gamma^floor(count / step_size)``."""
    lr = config.get("learning_rate", 1e-3)
    if config.get("lr_scheduler") is None:
        return lr
    p = config.get("lr_param", {"step_size": 100000, "gamma": 0.5})
    step_size = p.get("step_size", 100000)
    gamma = p.get("gamma", 0.5)

    def schedule(count):
        return lr * gamma ** torch.floor(count.float() / step_size)

    return schedule


class OptState(NamedTuple):
    """Adam state over the flat parameter vector (the leaves of optax's
    ``ScaleByAdamState`` and ``ScaleByScheduleState``)."""
    count: torch.Tensor                    # () int32, Adam's step count
    mu: torch.Tensor                       # (P,) first moment
    nu: torch.Tensor                       # (P,) second moment
    sched_count: Optional[torch.Tensor]    # () int32, None without schedule


class Adam:
    """clip-by-global-norm -> Adam, as ``init``/``update`` over one flat
    vector."""

    def __init__(self, schedule, b1, b2, max_grad_norm, eps=1e-8):
        self.schedule, self.b1, self.b2 = schedule, b1, b2
        self.max_grad_norm, self.eps = max_grad_norm, eps

    @property
    def clips(self):
        return bool(self.max_grad_norm and self.max_grad_norm > 0)

    @property
    def scheduled(self):
        return callable(self.schedule)

    def init(self, params):
        zero = torch.zeros((), dtype=torch.int32, device=params.device)
        return OptState(zero, torch.zeros_like(params),
                        torch.zeros_like(params),
                        zero.clone() if self.scheduled else None)

    def update(self, grad, state):
        """``(update, new_state)``; the new parameters are ``params +
        update``."""
        if self.clips:
            grad = clip_by_global_norm_torch(grad, self.max_grad_norm)
        mu = self.b1 * state.mu + (1.0 - self.b1) * grad
        nu = self.b2 * state.nu + (1.0 - self.b2) * grad * grad
        count = state.count + 1
        c = count.float()
        mu_hat = mu / (1.0 - self.b1 ** c)
        nu_hat = nu / (1.0 - self.b2 ** c)
        step = mu_hat / (torch.sqrt(nu_hat) + self.eps)
        if self.scheduled:
            lr = self.schedule(state.sched_count)
            sched_count = state.sched_count + 1
        else:
            lr, sched_count = self.schedule, None
        return -lr * step, OptState(count, mu, nu, sched_count)


def build_optimizer(config):
    """The configured gradient transform (clip, then the optimizer)."""
    optim_type = config.get("optim_type", "Adam")
    extra = dict(config.get("optim_param", {}))
    if optim_type.upper() != "ADAM":
        raise NotImplementedError(
            f"optim_type {optim_type!r} is not ported to PyTorch yet "
            "(ROADMAP Queue A, optimizers: RAdam, PlainRAdam, warmup AdamW)")
    b1, b2 = config.get("betas", extra.get("betas", (0.5, 0.999)))
    return Adam(build_schedule(config), b1, b2,
                config.get("max_grad_norm", 5))
