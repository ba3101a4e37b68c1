"""Gaussian (non-quantized) speaker-conditioned VAE.

Counterpart of ``vae_npvc_tpu/models/vae.py``: the flat VQ-VAE's encoder
and decoder stacks (``models/vqvae.py``) around a diagonal-Gaussian
latent. The encoder's ``z_channels`` is ``2 * z_dim`` (mu then logvar);
training samples ``z`` with the reparameterization from the step's
generator, evaluation and inference take ``mu``. Loss: ``X like +
kld_weight * KLD / (B * T)``, detail keys ``Total``, ``KLD loss``, ``X
like``. On the card its 10 + 10 GroupNorms (the recipe's ``stacks``) run
the GroupNorm kernels as the flat model's do.
"""

from __future__ import annotations

import torch
from torch import nn

from ..nn.blocks import Conditions, init_parameters
from ..ops.losses import gaussian_sample, kl_loss, log_loss
from ..parallel.shard import local_rows
from .vqvae import Decoder, Encoder


class Model(nn.Module):
    """forward(x, y_idx, train, gen=None) -> (xhat, loss, detail);
    encode(x, lengths) -> mu; decode(z, y_idx, lengths) -> mel;
    infer(x, y_idx, lengths) -> mel."""

    use_ema = False       # no EMA collection: the trainer commits none
    pending_ema = None

    def __init__(self, arch, dtype=torch.float32):
        super().__init__()
        a = dict(arch)
        self.arch = a
        self.dtype = dtype
        self.encoder = Encoder(a.get("encoder", {}), dtype=dtype)
        self.decoder = Decoder(a.get("decoder", {}), dtype=dtype)
        self.embeds = Conditions(a.get("y_num", 10), a.get("y_dim", 128),
                                 normalize=False, dtype=dtype)
        self.z_dim = a.get("z_dim", 128)
        self.kld_weight = a.get("kld_weight", a.get("beta", 1.0))
        # the data axis the training step binds (parallel/shard.py)
        self.dp_axis = a.get("dp_axis")

    def init_random(self, seed):
        init_parameters(self, seed)
        return self

    def _posterior(self, x, lengths=None):
        h = self.encoder(x.to(self.dtype), lengths).float()
        return h[..., :self.z_dim], h[..., self.z_dim:]

    def _speaker(self, y_idx):
        return self.embeds(y_idx.reshape(y_idx.shape[0], -1)[:, 0])[:, None]

    def forward(self, x, y_idx, train=True, *, gen=None):
        """Training/valid forward (unmasked); ``gen`` draws the
        reparameterization noise when ``train``."""
        B, T, _ = x.shape
        y = self._speaker(y_idx)
        mu, logvar = self._posterior(x)
        z = mu
        if train:
            # the noise of the global batch's rows with ``dp_axis``, as JAX
            # draws a sharded batch's (gaussian_sample at 0 is the noise)
            noise = local_rows(lambda s: gaussian_sample(
                gen, mu.new_zeros(s), mu.new_zeros(s)), mu.shape,
                self.dp_axis)
            z = mu + torch.exp(0.5 * logvar) * noise
        xhat = self.decoder(z.to(self.dtype), y).float()
        x_loss = log_loss(xhat, x.float())
        kld = kl_loss(mu, logvar) / (B * T)          # frame-mean KL
        loss = x_loss + self.kld_weight * kld
        return xhat, loss, {"Total": loss, "KLD loss": kld, "X like": x_loss}

    def encode(self, x, lengths=None):
        """The posterior mean, (B, T', z_dim)."""
        return self._posterior(x, lengths)[0]

    def decode(self, z, y_idx, lengths=None):
        return self.decoder(z.to(self.dtype), self._speaker(y_idx),
                            lengths).float()

    def infer(self, x, y_idx, lengths=None):
        z_lengths = (Encoder.out_lengths(self.arch.get("encoder", {}),
                                         lengths)
                     if lengths is not None else None)
        return self.decode(self.encode(x, lengths), y_idx, z_lengths)
