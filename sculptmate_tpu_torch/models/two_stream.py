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
``ops.attention``, so on the card it runs on kernel K1. The reference's
unused ``SingleStreamTransformer`` and ``TriplaneAttention`` are not ported.
"""

from __future__ import annotations

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

    def forward(self, z: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        h = self.norm1(z)
        z = z + self.attn1(h, h)
        z = z + self.attn2(self.norm2(z), x)
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
