"""Conv critic of the WGAN-GP trainer.

Counterpart of ``vae_npvc_tpu/models/discriminator.py``: strided
``WNConv1d``s (weight norm off unless ``use_weight_norm``) with LeakyReLU
0.2, a 1x1 head, and the mean over time and the head's channel in fp32:
(B, T, D) -> (B,) scores. No normalization layer, so the gradient
penalty's double backward runs through convolutions only. It computes in
fp32 whatever the generator's ``compute_dtype`` (the JAX trainer builds it
with the default dtype).
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from ..nn.blocks import WNConv1d, init_parameters


class Discriminator(nn.Module):
    def __init__(self, arch, in_channels=80):
        super().__init__()
        a = dict(arch)
        channels = a.get("channels", [128, 256, 512])
        k = a.get("kernel_size", 5)
        strides = a.get("strides", [2] * len(channels))
        use_wn = a.get("use_weight_norm", False)
        self.n = len(channels)
        cin = in_channels
        for i, (ch, st) in enumerate(zip(channels, strides)):
            setattr(self, f"conv_{i}", WNConv1d(
                cin, ch, k, stride=st, padding=((k - 1) // 2, (k - 1) // 2),
                use_weight_norm=use_wn))
            cin = ch
        self.head = WNConv1d(cin, 1, 1, use_weight_norm=use_wn)

    def init_random(self, seed):
        init_parameters(self, seed)
        return self

    def forward(self, x):
        h = x
        for i in range(self.n):
            h = F.leaky_relu(getattr(self, f"conv_{i}")(h), 0.2)
        return self.head(h).float().mean(dim=(1, 2))
