"""Multi-head attention and the global-style-token layer.

Counterpart of ``vae_npvc_tpu/nn/gst.py`` (``MultiHeadedAttention``,
``StyleTokenLayer``), with flax's parameter names (``linear_q/k/v/out`` with
``kernel`` (in, out) and ``bias``; ``gst_embs``).

``MultiHeadedAttention`` has two routes, chosen as in the JAX module. A
self-attention call that passes ``lengths`` (no ``mask``, equal q/k shapes)
goes through :func:`..ops.attention.fused_attention`: the hand-written
kernels on a CUDA tensor, their plain version on the CPU. Everything else
(a ``mask``, distinct q/k lengths, or ``fused="never"``) takes the stock
math: scores divided by ``sqrt(d_k)`` in the compute dtype, an fp32 softmax
after max-subtraction, probabilities cast back to the compute dtype. The
JAX module's ``fused`` values ``"auto"`` and ``"interpret"`` both mean the
wrapper here: nothing probes at run time whether the kernel may run.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.attention import fused_attention
from .blocks import Dense

NEG_INF = float(torch.finfo(torch.float32).min)


class MultiHeadedAttention(nn.Module):
    """MHA with distinct q/k/v input dims; (B, T, n_feat) out."""

    def __init__(self, n_head, n_feat, q_dim=None, k_dim=None, v_dim=None,
                 dtype=torch.float32, fused="auto"):
        super().__init__()
        if n_feat % n_head:
            raise ValueError(f"n_feat={n_feat} must divide into {n_head} "
                             "heads")
        if fused not in ("auto", "never", "interpret"):
            raise ValueError(f"fused must be 'auto', 'never' or 'interpret', "
                             f"got {fused!r}")
        self.n_head, self.n_feat, self.dtype, self.fused = (n_head, n_feat,
                                                            dtype, fused)
        self.linear_q = Dense(q_dim or n_feat, n_feat, dtype)
        self.linear_k = Dense(k_dim or n_feat, n_feat, dtype)
        self.linear_v = Dense(v_dim or n_feat, n_feat, dtype)
        self.linear_out = Dense(n_feat, n_feat, dtype)

    def forward(self, query, key, value, mask=None, lengths=None):
        B = query.shape[0]
        d_k = self.n_feat // self.n_head
        q, k, v = (lin(x).reshape(B, -1, self.n_head, d_k).transpose(1, 2)
                   for lin, x in ((self.linear_q, query),
                                  (self.linear_k, key),
                                  (self.linear_v, value)))
        if lengths is not None and mask is None and q.shape == k.shape:
            if self.fused != "never":
                x = fused_attention(q, k, v, lengths)
                x = x.transpose(1, 2).reshape(B, -1, self.n_feat)
                return self.linear_out(x)
            t = torch.arange(k.shape[2], device=k.device)
            mask = t[None, None, :] < lengths.to(k.device)[:, None, None]
        scores = (q @ k.transpose(-1, -2)) / torch.tensor(
            math.sqrt(d_k), dtype=torch.float32).to(q.dtype)
        if mask is not None:
            scores = torch.where(mask[:, None] if mask.dim() == 3 else mask,
                                 scores, torch.full_like(scores, NEG_INF))
        scores = scores.float()
        scores = scores - scores.max(dim=-1, keepdim=True).values.detach()
        attn = torch.softmax(scores, dim=-1).to(q.dtype)
        x = (attn @ v).transpose(1, 2).reshape(B, -1, self.n_feat)
        return self.linear_out(x)


class StyleTokenLayer(nn.Module):
    """(B, ref_embed_dim) reference embedding -> (B, gst_token_dim) style: a
    single query attends over the tanh'd token bank."""

    def __init__(self, ref_embed_dim=128, gst_tokens=10, gst_token_dim=256,
                 gst_heads=4, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.gst_embs = nn.Parameter(
            torch.empty(gst_tokens, gst_token_dim // gst_heads))
        self.mha = MultiHeadedAttention(
            gst_heads, gst_token_dim, q_dim=ref_embed_dim,
            k_dim=gst_token_dim // gst_heads,
            v_dim=gst_token_dim // gst_heads, dtype=dtype)

    def init_(self, gen):
        with torch.no_grad():
            self.gst_embs.copy_(torch.randn(self.gst_embs.shape,
                                            generator=gen))

    def forward(self, ref_embs):
        B = ref_embs.shape[0]
        tokens = torch.tanh(self.gst_embs)[None].expand(B, -1, -1) \
            .to(self.dtype)
        out = self.mha(ref_embs[:, None, :].to(self.dtype), tokens, tokens)
        return out[:, 0, :]
