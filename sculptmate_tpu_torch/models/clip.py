"""CLIP ViT-B/32 visual tower, for SF3D's material estimator.

Counterpart of ``sculptmate_tpu/models/clip.py``, with the module names of
open_clip's visual tower as the reference checkpoint holds it
(``image_estimator.model.visual.*``): patch convolution (32, no bias), class
embedding, learned position table, ``ln_pre``, pre-LN residual blocks
(packed ``in_proj`` q/k/v, exact-erf GELU MLP x4), ``ln_post`` on the class
token and the projection to 512-d features. LayerNorms use eps 1e-6, as the
JAX package's do. Attention goes through ``ops.attention``, so on the card
it runs on kernel K1.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from sculptmate_tpu_torch.ops.attention import dot_product_attention

OPENAI_DATASET_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_DATASET_STD = (0.26862954, 0.26130258, 0.27577711)


class CLIPAttention(nn.Module):
    """open_clip's ``attn`` parameters (``in_proj_weight``/``in_proj_bias``
    and ``out_proj``) computed through the port's attention."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, W = x.shape
        qkv = F.linear(x, self.in_proj_weight, self.in_proj_bias)
        q, k, v = (t.reshape(B, N, self.heads, W // self.heads) for t in qkv.chunk(3, dim=-1))
        return self.out_proj(dot_product_attention(q, k, v).reshape(B, N, W))


class CLIPMLP(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.c_fc = nn.Linear(width, 4 * width)
        self.c_proj = nn.Linear(4 * width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c_proj(F.gelu(self.c_fc(x)))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width, eps=1e-6)
        self.attn = CLIPAttention(width, heads)
        self.ln_2 = nn.LayerNorm(width, eps=1e-6)
        self.mlp = CLIPMLP(width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class CLIPVisual(nn.Module):
    """ViT-B/32 visual tower -> (B, embed_dim) image features."""

    def __init__(self, width: int = 768, layers: int = 12, heads: int = 12, patch_size: int = 32,
                 image_size: int = 224, embed_dim: int = 512):
        super().__init__()
        grid = image_size // patch_size
        self.conv1 = nn.Conv2d(3, width, patch_size, stride=patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(width))
        self.positional_embedding = nn.Parameter(torch.zeros(1 + grid * grid, width))
        self.ln_pre = nn.LayerNorm(width, eps=1e-6)
        self.transformer = nn.Module()
        self.transformer.resblocks = nn.ModuleList(ResidualAttentionBlock(width, heads) for _ in range(layers))
        self.ln_post = nn.LayerNorm(width, eps=1e-6)
        self.proj = nn.Parameter(torch.zeros(width, embed_dim))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images: (B, 224, 224, 3), already CLIP-normalized."""
        x = self.conv1(images.permute(0, 3, 1, 2))  # (B, W, g, g)
        B, W = x.shape[:2]
        x = x.flatten(2).transpose(1, 2)
        x = torch.cat([self.class_embedding.to(x.dtype).expand(B, 1, W), x], dim=1)
        x = self.ln_pre(x + self.positional_embedding.to(x.dtype)[None])
        for block in self.transformer.resblocks:
            x = block(x)
        cls = self.ln_post(x[:, 0])
        return cls @ self.proj.to(cls.dtype)
