"""Triplane transformer backbone (TripoSR "Lean" path).

Counterpart of ``sculptmate_tpu/models/transformer.py``, with the module
names of the diffusers-style stack the reference vendors
(``tsr/models/transformer/transformer_1d.py``): GroupNorm(32, eps 1e-6) and
a projection in, blocks of pre-LN (eps 1e-5) self-attention over the 3 072
triplane tokens, cross-attention into the 1 025 image tokens and an
exact-erf GEGLU feed-forward, a projection out, and a residual around the
whole stack. Every attention call goes through ``ops.attention``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from sculptmate_tpu_torch.ops.attention import dot_product_attention


class Attention(nn.Module):
    """Multi-head attention with an optional cross-attention source."""

    def __init__(
        self,
        query_dim: int,
        heads: int = 16,
        dim_head: int = 64,
        cross_attention_dim: Optional[int] = None,
        bias: bool = False,
        out_bias: bool = True,
    ):
        super().__init__()
        inner = heads * dim_head
        context_dim = cross_attention_dim or query_dim
        self.heads = heads
        self.dim_head = dim_head
        self.to_q = nn.Linear(query_dim, inner, bias=bias)
        self.to_k = nn.Linear(context_dim, inner, bias=bias)
        self.to_v = nn.Linear(context_dim, inner, bias=bias)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim, bias=out_bias)])

    def forward(self, hidden_states, encoder_hidden_states=None):
        context = hidden_states if encoder_hidden_states is None else encoder_hidden_states
        B, Nq, _ = hidden_states.shape
        Nk = context.shape[1]
        q = self.to_q(hidden_states).reshape(B, Nq, self.heads, self.dim_head)
        k = self.to_k(context).reshape(B, Nk, self.heads, self.dim_head)
        v = self.to_v(context).reshape(B, Nk, self.heads, self.dim_head)
        out = dot_product_attention(q, k, v).reshape(B, Nq, self.heads * self.dim_head)
        return self.to_out[0](out)


class GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim_in, dim_out * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)  # exact erf form, torch's default


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        # index 1 is the reference's dropout (p = 0): kept so net.2 keeps its name
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Identity(), nn.Linear(dim * mult, dim)])

    def forward(self, x):
        for m in self.net:
            x = m(x)
        return x


class BasicTransformerBlock(nn.Module):
    """Pre-LN: self-attn -> cross-attn -> GEGLU FF, each with a residual."""

    def __init__(self, dim: int, heads: int, dim_head: int, cross_attention_dim: Optional[int] = None):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = Attention(dim, heads, dim_head)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = Attention(dim, heads, dim_head, cross_attention_dim=cross_attention_dim)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim)

    def forward(self, x, encoder_hidden_states=None):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), encoder_hidden_states)
        return x + self.ff(self.norm3(x))


class Transformer1D(nn.Module):
    """(B, C, N) channels-first in and out, (B, N, C) inside."""

    def __init__(
        self,
        in_channels: int = 1024,
        num_attention_heads: int = 16,
        attention_head_dim: int = 64,
        num_layers: int = 16,
        cross_attention_dim: Optional[int] = 768,
        norm_num_groups: int = 32,
    ):
        super().__init__()
        inner = num_attention_heads * attention_head_dim
        self.norm = nn.GroupNorm(norm_num_groups, in_channels, eps=1e-6)
        self.proj_in = nn.Linear(in_channels, inner)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(inner, num_attention_heads, attention_head_dim, cross_attention_dim)
            for _ in range(num_layers)
        )
        self.proj_out = nn.Linear(inner, in_channels)

    def forward(self, hidden_states, encoder_hidden_states=None):
        residual = hidden_states
        x = self.proj_in(self.norm(hidden_states).transpose(1, 2))
        for block in self.transformer_blocks:
            x = block(x, encoder_hidden_states)
        x = self.proj_out(x).transpose(1, 2)
        return (x + residual).to(residual.dtype)
