"""Two-stream interleave transformer: SF3D's triplane backbone.

Counterpart of ``sculptmate_tpu/models/two_stream.py`` (``CrossAttention``
to ``TwoStreamInterleaveTransformer``), with the module names of the
reference checkpoint (``sf3d/models/transformers/backbone.py:398-515``): a
latent stream (the projected image tokens followed by 1 792 learned
latents) and the 27 648-token triplane stream, interleaved through
``num_blocks`` blocks of a fuse-in (latents attend to the triplane),
``num_basic_blocks`` basic blocks (latent self-attention, cross-attention to
the raw image tokens, GEGLU feed-forward) and a fuse-out (the triplane
attends to the latents); GroupNorm and a projection in, a projection out and
a residual on the triplane stream. Every attention call goes through
``ops.attention``, so on the card it runs on kernel K1.

The reference's two unused modules are here too (nothing in the SF3D
system builds them): ``SingleStreamTransformer`` (``backbone.py:151-208``),
basic blocks over the triplane tokens at 16 heads x 88 by default (K1 at
head dim 88), and ``TriplaneAttention`` (``backbone.py:250-332``), whose
full form runs on K1 and whose masked form, each token attending along the
intersection lines of the other two planes, is a plain product with an
additive O(N^2) bias, as the JAX package computes it outside any kernel.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from sculptmate_tpu_torch.models.transformer import FeedForward
from sculptmate_tpu_torch.ops.attention import dot_product_attention


class CrossAttention(nn.Module):
    """wq/wk/wv attention: queries from x_q, keys and values from x_kv."""

    def __init__(self, dim: int, kv_dim: int, num_heads: int = 16, qkv_bias: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.wq = nn.Linear(dim, dim, bias=qkv_bias)
        self.wk = nn.Linear(kv_dim, dim, bias=qkv_bias)
        self.wv = nn.Linear(kv_dim, dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x_q: torch.Tensor, x_kv: torch.Tensor) -> torch.Tensor:
        B, Nq, C = x_q.shape
        Nk = x_kv.shape[1]
        d = C // self.num_heads
        q = self.wq(x_q).reshape(B, Nq, self.num_heads, d)
        k = self.wk(x_kv).reshape(B, Nk, self.num_heads, d)
        v = self.wv(x_kv).reshape(B, Nk, self.num_heads, d)
        return self.proj(dot_product_attention(q, k, v).reshape(B, Nq, C))


class BasicBlock(nn.Module):
    """Self-attention -> cross-attention -> GEGLU FF, pre-LN residuals."""

    def __init__(self, dim: int, kv_dim: int, num_heads: int = 16, qkv_bias: bool = False):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = CrossAttention(dim, dim, num_heads, qkv_bias)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = CrossAttention(dim, kv_dim, num_heads, qkv_bias)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim)

    def forward(self, z: torch.Tensor, x: Optional[torch.Tensor]) -> torch.Tensor:
        """Without x, the cross-attention attends to the normed z itself."""
        h = self.norm1(z)
        z = z + self.attn1(h, h)
        h = self.norm2(z)
        z = z + self.attn2(h, h if x is None else x)
        return z + self.ff(self.norm3(z))


class FuseBlock(nn.Module):
    """Fuse stream x into stream z by cross-attention."""

    def __init__(self, dim_z: int, dim_x: int, num_heads: int = 16, qkv_bias: bool = False):
        super().__init__()
        self.norm_z1 = nn.LayerNorm(dim_z, eps=1e-5)
        self.attn = CrossAttention(dim_z, dim_x, num_heads, qkv_bias)
        self.norm_z2 = nn.LayerNorm(dim_z, eps=1e-5)
        self.ff = FeedForward(dim_z)

    def forward(self, z: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        z = z + self.attn(self.norm_z1(z), x)
        return z + self.ff(self.norm_z2(z))


class TwoStreamBlock(nn.Module):
    def __init__(self, dim_latent: int, dim_input: int, dim_cross: int, num_basic_blocks: int = 3,
                 num_heads: int = 16, qkv_bias: bool = False):
        super().__init__()
        self.fuse_block_in = FuseBlock(dim_latent, dim_input, num_heads, qkv_bias)
        self.transformer_block = nn.ModuleList(
            BasicBlock(dim_latent, dim_cross, num_heads, qkv_bias) for _ in range(num_basic_blocks)
        )
        self.fuse_block_out = FuseBlock(dim_input, dim_latent, num_heads, qkv_bias)

    def forward(self, latent, input, cross_input):
        latent = self.fuse_block_in(latent, input)
        for block in self.transformer_block:
            latent = block(latent, cross_input)
        return latent, self.fuse_block_out(input, latent)


class TwoStreamInterleaveTransformer(nn.Module):
    def __init__(
        self,
        num_attention_heads: int = 16,
        attention_head_dim: int = 64,
        raw_triplane_channels: int = 1024,
        triplane_channels: int = 1024,
        raw_image_channels: int = 1024,
        num_latents: int = 1792,
        num_blocks: int = 4,
        num_basic_blocks: int = 3,
        norm_num_groups: int = 32,
        attention_bias: bool = False,
    ):
        super().__init__()
        latent_dim = num_attention_heads * attention_head_dim
        self.norm_triplane = nn.GroupNorm(norm_num_groups, raw_triplane_channels, eps=1e-6)
        self.proj_triplane = nn.Linear(raw_triplane_channels, triplane_channels)
        self.norm_image = nn.LayerNorm(raw_image_channels, eps=1e-5)
        self.proj_image = nn.Linear(raw_image_channels, latent_dim)
        self.latent_init = nn.Parameter(torch.zeros(1, num_latents, latent_dim))
        self.norm_latent = nn.LayerNorm(latent_dim, eps=1e-5)
        self.proj_latent = nn.Linear(latent_dim, latent_dim)
        self.main_blocks = nn.ModuleList(
            TwoStreamBlock(latent_dim, triplane_channels, raw_image_channels, num_basic_blocks,
                           num_attention_heads, attention_bias)
            for _ in range(num_blocks)
        )
        self.proj_out = nn.Linear(triplane_channels, raw_triplane_channels)

    def forward(self, hidden_states: torch.Tensor, encoder_hidden_states: torch.Tensor) -> torch.Tensor:
        """hidden_states: (B, C, N) channels-first triplane tokens;
        encoder_hidden_states: (B, N_image, C_image) image tokens."""
        B = hidden_states.shape[0]
        residual = hidden_states
        triplane = self.proj_triplane(self.norm_triplane(hidden_states).transpose(1, 2))
        image = self.proj_image(self.norm_image(encoder_hidden_states))
        lat = self.latent_init.expand(B, -1, -1).to(triplane.dtype)
        lat = self.proj_latent(self.norm_latent(lat))
        latent = torch.cat([image, lat], dim=1)
        for block in self.main_blocks:
            latent, triplane = block(latent, triplane, encoder_hidden_states)
        out = self.proj_out(triplane).transpose(1, 2)
        return (out + residual).to(residual.dtype)


@torch.no_grad()
def _reset_linear_norm(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded random weights at the JAX package's initializer scales:
    fan-in normal Linear kernels, zero biases, unit norms."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            m.weight.normal_(0.0, m.weight.shape[1] ** -0.5, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()


class SingleStreamTransformer(nn.Module):
    """GroupNorm and a projection in, ``num_layers`` basic blocks over the
    tokens (cross-attention to ``encoder_hidden_states`` when given, else to
    the tokens themselves), a projection out and a residual."""

    def __init__(
        self,
        num_attention_heads: int = 16,
        attention_head_dim: int = 88,
        in_channels: int = 1024,
        num_layers: int = 16,
        norm_num_groups: int = 32,
        cross_attention_dim: Optional[int] = None,
        attention_bias: bool = False,
    ):
        super().__init__()
        inner = num_attention_heads * attention_head_dim
        self.norm = nn.GroupNorm(norm_num_groups, in_channels, eps=1e-6)
        self.proj_in = nn.Linear(in_channels, inner)
        self.transformer_blocks = nn.ModuleList(
            BasicBlock(inner, cross_attention_dim or inner, num_attention_heads, attention_bias)
            for _ in range(num_layers)
        )
        self.proj_out = nn.Linear(inner, in_channels)

    def forward(self, hidden_states: torch.Tensor, encoder_hidden_states: Optional[torch.Tensor] = None):
        """hidden_states: (B, C, N) channels-first tokens -> the same shape."""
        residual = hidden_states
        x = self.proj_in(self.norm(hidden_states).transpose(1, 2))
        for block in self.transformer_blocks:
            x = block(x, encoder_hidden_states)
        return (self.proj_out(x).transpose(1, 2) + residual).to(residual.dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        _reset_linear_norm(self, generator)


@functools.lru_cache(maxsize=2)
def _triplane_mask(res: int) -> np.ndarray:
    mask = np.zeros((3, res, res, 3, res, res), bool)
    i, j = np.meshgrid(np.arange(res), np.arange(res), indexing="ij")
    mask[0, i, j, 1, i, :] = True
    mask[0, i, j, 2, j, :] = True
    mask[1, i, j, 0, i, :] = True
    mask[1, i, j, 2, :, j] = True
    mask[2, i, j, 0, :, i] = True
    mask[2, i, j, 1, :, j] = True
    return mask.reshape(3 * res * res, 3 * res * res)


def triplane_attention_bias(res: int, device=None) -> torch.Tensor:
    """(3 res^2, 3 res^2) f32 additive bias, 0 where a token may attend (the
    intersection lines of the other two planes) and -inf elsewhere
    (``backbone.py:251-272``). O(N^2) memory: for small plane resolutions."""
    bias = torch.full((3 * res * res,) * 2, -torch.inf, device=device)
    return bias.masked_fill_(torch.from_numpy(_triplane_mask(res)).to(bias.device), 0.0)


class TriplaneAttention(nn.Module):
    """Self-attention over the 3 res^2 triplane tokens: full (on K1 on the
    card) or masked to the plane-intersection lines."""

    def __init__(self, dim: int, resolution: int, num_heads: int = 16, qkv_bias: bool = False,
                 full_attention: bool = False):
        super().__init__()
        self.resolution, self.num_heads, self.full_attention = resolution, num_heads, full_attention
        self.wq = nn.Linear(dim, dim, bias=qkv_bias)
        self.wk = nn.Linear(dim, dim, bias=qkv_bias)
        self.wv = nn.Linear(dim, dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, 3 res^2, dim) -> the same shape."""
        B, N, C = x.shape
        if N != 3 * self.resolution**2:
            raise ValueError(f"{N} tokens, not 3 x {self.resolution}^2")
        d = C // self.num_heads
        q, k, v = (w(x).reshape(B, N, self.num_heads, d) for w in (self.wq, self.wk, self.wv))
        if self.full_attention:
            out = dot_product_attention(q, k, v)
        else:  # scores in f32 with the bias, the product back in the input dtype
            with torch.autocast(x.device.type, enabled=False):
                s = q.float().transpose(1, 2) @ k.float().permute(0, 2, 3, 1) / d**0.5
                p = torch.softmax(s + triplane_attention_bias(self.resolution, x.device), dim=-1)
                out = (p @ v.float().transpose(1, 2)).transpose(1, 2).to(q.dtype)
        return self.proj(out.reshape(B, N, C))

    def reset_parameters(self, generator: torch.Generator) -> None:
        _reset_linear_norm(self, generator)
