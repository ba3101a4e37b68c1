"""Optimizer and schedule builders, functional over one flat vector.

Counterpart of ``vae_npvc_tpu/train/optim.py`` (an optax chain of
clip-by-global-norm and the configured optimizer). The trainers keep every
parameter in one flat fp32 vector, so the transform here takes the flat
gradient (and, for the decoupled weight decay, the flat parameters) and
returns the flat update and the new state, as ``tx.update(grads, state,
params)`` does in optax: the caller adds the update, and can keep the old
state when it rejects a step. All values stay on the device; nothing here
reads a tensor on the host.

Three optimizers, each as its optax counterpart computes it in float32:

- ``Adam`` (``optax.adam``): the count is incremented first, both bias
  corrections use the new count, the step is ``m_hat / (sqrt(v_hat) +
  1e-8)``;
- ``RAdam`` and ``PlainRAdam`` (both ``optax.radam``, threshold 5): the
  same moments; while the length of the approximated SMA ``rho`` is below
  the threshold the step is ``m_hat`` alone, after it ``r * m_hat /
  (sqrt(v_hat) + 1e-8)`` with the variance rectification ``r``;
- ``AdamW`` (``optax.adamw``, the reference's warmup AdamW): Adam's step
  plus ``weight_decay * params``, both scaled by the rate, which with
  ``warmup`` rises linearly from 1e-8 to ``learning_rate`` over that many
  steps.

The update is ``-lr * step``; a schedule is read at its own count before
that count is incremented.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


def clip_by_global_norm_torch(grad, max_norm, norm=None):
    """Scale ``grad`` by ``min(1, max_norm / (norm + 1e-6))``, the
    semantics of ``torch.nn.utils.clip_grad_norm_`` that the JAX package's
    transform of the same name keeps. ``norm`` is the global norm when
    ``grad`` is one rank's slice of the gradient (model-axis sharding);
    by default ``grad``'s own."""
    if norm is None:
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


def warmup_schedule(lr, warmup):
    """The reference AdamW's warmup (``optax.join_schedules`` of a linear
    schedule from 1e-8 to ``lr`` over ``warmup`` steps, then ``lr``); ``lr``
    itself without warmup."""
    if not warmup:
        return lr

    def schedule(count):
        frac = 1.0 - torch.clamp(count, 0, warmup).float() / warmup
        return torch.where(count < warmup, (1e-8 - lr) * frac + lr,
                           torch.full_like(frac, lr))

    return schedule


class OptState(NamedTuple):
    """Adam-family state over the flat parameter vector (the leaves of
    optax's ``ScaleByAdamState`` and ``ScaleByScheduleState``)."""
    count: torch.Tensor                    # () int32, the moments' count
    mu: torch.Tensor                       # (P,) first moment
    nu: torch.Tensor                       # (P,) second moment
    sched_count: Optional[torch.Tensor]    # () int32, None without schedule


class Adam:
    """clip-by-global-norm -> Adam, as ``init``/``update`` over one flat
    vector."""

    # the optax chain holds add_decayed_weights between the moments and the
    # rate (AdamW only): its checkpoint tree has one more (empty) slot
    decoupled = False

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

    def _step(self, mu_hat, nu_hat, count, params):
        return mu_hat / (torch.sqrt(nu_hat) + self.eps)

    def update(self, grad, state, params=None, grad_norm=None):
        """``(update, new_state)``; the new parameters are ``params +
        update``. ``grad_norm`` is the clip's global norm when ``grad`` is
        a slice of the whole gradient."""
        if self.clips:
            grad = clip_by_global_norm_torch(grad, self.max_grad_norm,
                                             grad_norm)
        mu = self.b1 * state.mu + (1.0 - self.b1) * grad
        nu = self.b2 * state.nu + (1.0 - self.b2) * grad * grad
        count = state.count + 1
        c = count.float()
        mu_hat = mu / (1.0 - self.b1 ** c)
        nu_hat = nu / (1.0 - self.b2 ** c)
        step = self._step(mu_hat, nu_hat, c, params)
        if self.scheduled:
            lr = self.schedule(state.sched_count)
            sched_count = state.sched_count + 1
        else:
            lr, sched_count = self.schedule, None
        return -lr * step, OptState(count, mu, nu, sched_count)


class RAdam(Adam):
    """clip-by-global-norm -> rectified Adam (``optax.radam``)."""

    threshold = 5.0

    def _step(self, mu_hat, nu_hat, c, params):
        # optax's arithmetic, in float32: rho from the new count
        ro_inf = 2.0 / (1.0 - self.b2) - 1.0
        b2t = self.b2 ** c
        ro = ro_inf - 2 * c * b2t / (1 - b2t)
        r = torch.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf
                       / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro))
        rect = r * mu_hat / (torch.sqrt(nu_hat) + self.eps)
        return torch.where(ro >= self.threshold, rect, mu_hat)


class AdamW(Adam):
    """clip-by-global-norm -> Adam with decoupled weight decay
    (``optax.adamw``): the step adds ``weight_decay * params``."""

    decoupled = True

    def __init__(self, schedule, b1, b2, max_grad_norm, weight_decay,
                 eps=1e-8):
        super().__init__(schedule, b1, b2, max_grad_norm, eps)
        self.weight_decay = weight_decay

    def _step(self, mu_hat, nu_hat, c, params):
        step = super()._step(mu_hat, nu_hat, c, params)
        return step + self.weight_decay * params


def build_optimizer(config):
    """The configured gradient transform (clip, then the optimizer)."""
    optim_type = config.get("optim_type", "Adam")
    extra = dict(config.get("optim_param", {}))
    max_grad_norm = config.get("max_grad_norm", 5)
    schedule = build_schedule(config)
    b1, b2 = config.get("betas", extra.get("betas", (0.5, 0.999)))
    kind = optim_type.upper()
    if kind in ("RADAM", "PLAINRADAM"):
        # PlainRAdam is RAdam without the reference's step-size cache: the
        # same update values
        return RAdam(schedule, b1, b2, max_grad_norm)
    if kind == "ADAMW":
        # the reference's warmup AdamW: betas (0.9, 0.999) unless given;
        # warmup scales the step size and the decay alike
        wb1, wb2 = config.get("betas", extra.get("betas", (0.9, 0.999)))
        if config.get("lr_scheduler") is None:
            schedule = warmup_schedule(
                config.get("learning_rate", 1e-3),
                config.get("warmup", extra.get("warmup", 0)))
        return AdamW(schedule, wb1, wb2, max_grad_norm,
                     config.get("weight_decay",
                                extra.get("weight_decay", 0.0)))
    return Adam(schedule, b1, b2, max_grad_norm)


def apply_updates(tx, state, params, grads):
    """One ``tx`` step of the tensors ``params`` by ``grads`` (lists in one
    order) through a flat vector, as ``optax.apply_updates`` adds the
    update; ``state`` None starts the optimizer. Returns the new state."""
    with torch.no_grad():
        flat = torch.cat([p.reshape(-1) for p in params])
        if state is None:
            state = tx.init(flat)
        update, state = tx.update(
            torch.cat([g.reshape(-1) for g in grads]), state, flat)
        for p, u in zip(params, torch.split(update,
                                            [p.numel() for p in params])):
            p.add_(u.view_as(p))
    return state
