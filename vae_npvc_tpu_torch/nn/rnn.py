"""An LSTM layer with the layout of flax's ``nn.OptimizedLSTMCell``.

Flax's cell computes the gates i, f, g, o (torch's order) from input
kernels without a bias and recurrent kernels with one:
``c' = f * c + i * g``, ``h' = o * tanh(c')``. :class:`LSTM` is one layer
of torch's ``nn.LSTM`` (cuDNN on the GPU) with the input bias ``bias_ih_l0``
held at zero in a buffer that is not saved, so it is neither trained, nor an
optimizer leaf, nor a ``state_dict`` entry. It runs over a sequence
(``forward``) or one step (``step``, torch's fused cell). A model names
each layer after the flax cell it holds, so the cell at flax path ``X`` is
the layer at torch path ``X``: ``utils/bridge.py`` maps its packed
``weight_ih_l0`` (4 hidden, in), ``weight_hh_l0`` and ``bias_hh_l0`` to
flax's per-gate ``ii/if/ig/io`` and ``hi/hf/hg/ho`` kernels and biases.
"""

from __future__ import annotations

import math

import torch
from torch import nn


class LSTM(nn.LSTM):
    """One layer: ``(B, T, in) [, (h, c)] -> ((B, T, hidden), (h, c))``,
    the carries (B, hidden) each, zero when not given."""

    def __init__(self, input_size, hidden_size):
        super().__init__(input_size, hidden_size, batch_first=True)
        shape = self.bias_ih_l0.shape
        delattr(self, "bias_ih_l0")
        self.register_buffer("bias_ih_l0", torch.zeros(shape),
                             persistent=False)
        self._init_flat_weights()

    def init_(self, gen):
        """torch's default draw, uniform(+-1/sqrt(hidden)), from ``gen``;
        zero recurrent bias."""
        bound = 1.0 / math.sqrt(self.hidden_size)
        with torch.no_grad():
            for name, p in self.named_parameters(recurse=False):
                if name.startswith("weight"):
                    p.copy_(torch.rand(p.shape, generator=gen) * 2 * bound
                            - bound)
                else:
                    p.zero_()

    def forward(self, x, carry=None):
        if carry is not None:
            carry = tuple(s[None] for s in carry)
        y, (h, c) = super().forward(x, carry)
        return y, (h[0], c[0])

    def step(self, carry, x):
        """One step in fp32: ``(c, h), x (B, in) -> (c', h')``."""
        c, h = carry
        h_new, c_new = torch.lstm_cell(
            x.float(), (h, c), self.weight_ih_l0, self.weight_hh_l0,
            self.bias_ih_l0, self.bias_hh_l0)
        return c_new, h_new
