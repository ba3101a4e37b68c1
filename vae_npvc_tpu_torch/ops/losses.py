"""Loss functions: unit-variance Gaussian NLL and the Gaussian-VAE toolkit.

Counterpart of ``vae_npvc_tpu/ops/losses.py``, channels-last (B, T, D).
"""

from __future__ import annotations

import math

import torch

EPSILON = 1e-6
LOG_2PI = math.log(2.0 * math.pi)


def log_loss(xhat, x, reduction="frame_mean"):
    """Unit-variance Gaussian NLL, 0.5*(log 2pi + (x - mu)^2): the
    ``'X like'`` reconstruction metric. Inputs are (B, T, D)."""
    B, T, D = x.shape
    loss = 0.5 * (LOG_2PI + (x - xhat) ** 2)
    if reduction == "sum":
        return loss.sum()
    if reduction == "mean":
        return loss.mean()
    if reduction == "batch_mean":
        return loss.sum() / B
    if reduction == "frame_mean":
        return loss.sum() / (B * T)
    if reduction == "none":
        return loss
    raise ValueError(f"unknown reduction {reduction!r}")


def gaussian_sample(gen, mu, logvar):
    """Reparameterized sample; ``gen`` is a generator on mu's device."""
    noise = torch.randn(mu.shape, generator=gen, dtype=mu.dtype,
                        device=mu.device)
    return mu + torch.exp(0.5 * logvar) * noise


def gaussian_kld(mu1, lv1, mu2, lv2, dim=-1):
    """KL(N1 || N2) summed over ``dim``."""
    v1, v2 = torch.exp(lv1), torch.exp(lv2)
    elem = 0.5 * ((lv2 - lv1) + (v1 + (mu1 - mu2) ** 2) / (v2 + EPSILON)
                  - 1.0)
    return elem.sum(dim=dim)


def gaussian_log_density(x, mu, logvar, dim=-1):
    """Diagonal-Gaussian log density summed over ``dim``."""
    var = torch.exp(logvar)
    return (-0.5 * (LOG_2PI + logvar + (x - mu) ** 2 / (var + EPSILON))) \
        .sum(dim=dim)


def kl_loss(mu, lv):
    """KL to the standard normal, summed."""
    return 0.5 * torch.sum(torch.exp(lv) + mu ** 2 - lv - 1.0)


def skl_loss(mu1, lv1, mu2, lv2):
    """Symmetric Gaussian KL, summed (the mean gap is multiplied by
    ``1/v1 + 1/v2``, as in the JAX package)."""
    v1, v2 = torch.exp(lv1), torch.exp(lv2)
    return 0.5 * torch.sum(v2 / v1 + v1 / v2 - 2.0
                           + (mu1 - mu2) ** 2 * (1.0 / v1 + 1.0 / v2))
