"""ViT-B/16 image encoder (DINO), TripoSR's image tokenizer.

Counterpart of ``sculptmate_tpu/models/vit.py``, with the module names of
the HF ``ViTModel`` the reference checkpoint holds
(``image_tokenizer.model.*``, ``runtime/checkpoint.py:80-103`` in the JAX
package): patch-conv embedding, a learned CLS token, a 14x14 position table
resized torch-bicubic to the actual grid (32x32 at 512^2), 12 pre-LN layers
(LayerNorm eps 1e-12, exact-erf GELU) and a final LayerNorm. The tokenizer
applies the ImageNet normalisation itself and returns channels-first
(B, C, Nt) tokens.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from sculptmate_tpu_torch.ops.attention import dot_product_attention
from sculptmate_tpu_torch.ops.resize import interpolate_pos_table, torch_bicubic_matrix

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class _Dense(nn.Module):
    """A Linear under the attribute name ``dense``, as the HF modules hold it."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.dense = nn.Linear(d_in, d_out)

    def forward(self, x):
        return self.dense(x)


class ViTSelfAttention(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.query = nn.Linear(hidden_size, hidden_size)
        self.key = nn.Linear(hidden_size, hidden_size)
        self.value = nn.Linear(hidden_size, hidden_size)

    def forward(self, x):
        B, N, C = x.shape
        shape = (B, N, self.num_heads, C // self.num_heads)
        q = self.query(x).reshape(shape)
        k = self.key(x).reshape(shape)
        v = self.value(x).reshape(shape)
        return dot_product_attention(q, k, v).reshape(B, N, C)


class ViTAttention(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int):
        super().__init__()
        self.attention = ViTSelfAttention(hidden_size, num_heads)
        self.output = _Dense(hidden_size, hidden_size)

    def forward(self, x):
        return self.output(self.attention(x))


class ViTLayer(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int, intermediate_size: int, layer_norm_eps: float = 1e-12):
        super().__init__()
        self.layernorm_before = nn.LayerNorm(hidden_size, eps=layer_norm_eps)
        self.attention = ViTAttention(hidden_size, num_heads)
        self.layernorm_after = nn.LayerNorm(hidden_size, eps=layer_norm_eps)
        self.intermediate = _Dense(hidden_size, intermediate_size)
        self.output = _Dense(intermediate_size, hidden_size)

    def forward(self, x):
        x = x + self.attention(self.layernorm_before(x))
        h = F.gelu(self.intermediate(self.layernorm_after(x)))
        return x + self.output(h)


class ViTEmbeddings(nn.Module):
    def __init__(self, hidden_size: int, patch_size: int, base_image_size: int):
        super().__init__()
        base_grid = base_image_size // patch_size
        self.cls_token = nn.Parameter(torch.zeros(1, 1, hidden_size))
        self.position_embeddings = nn.Parameter(torch.zeros(1, 1 + base_grid * base_grid, hidden_size))
        self.patch_embeddings = nn.Module()
        self.patch_embeddings.projection = nn.Conv2d(3, hidden_size, patch_size, stride=patch_size)
        # the position-table resize matrices per (grid, device), built and
        # uploaded once: an upload on every forward would wait for the device
        self._pos_mats = {}

    def forward(self, images):
        """images (B, 3, H, W) normalized -> (B, 1 + grid^2, hidden)."""
        x = self.patch_embeddings.projection(images)  # (B, C, g, g)
        B, C, grid, _ = x.shape
        x = x.flatten(2).transpose(1, 2)
        cls = self.cls_token.expand(B, 1, C).to(x.dtype)
        x = torch.cat([cls, x], dim=1)
        pos = self.position_embeddings
        key = (grid, pos.device)
        if key not in self._pos_mats:
            base = int(round((pos.shape[1] - 1) ** 0.5))
            # a normal tensor even when built under inference mode, so a
            # later forward with autograd on can use it
            with torch.inference_mode(False):
                m = torch.from_numpy(torch_bicubic_matrix(base, grid)).to(pos.device)
            self._pos_mats[key] = (m, m)
        return x + interpolate_pos_embed(pos, grid, self._pos_mats[key]).to(x.dtype)


def interpolate_pos_embed(pos_embed: torch.Tensor, grid_size: int, mats=None) -> torch.Tensor:
    """(1, 1 + P^2, C) position table -> (1, 1 + grid^2, C), torch-exact
    bicubic (``mats`` as ``interpolate_pos_table`` takes them)."""
    cls_pos, patch_pos = pos_embed[:, :1], pos_embed[:, 1:]
    if int(round(patch_pos.shape[1] ** 0.5)) == grid_size:
        return pos_embed
    patch_pos = interpolate_pos_table(patch_pos[0], grid_size, grid_size, mats)[None]
    return torch.cat([cls_pos, patch_pos], dim=1)


class ViTEncoder(nn.Module):
    """The ViT backbone (HF ``ViTModel``), returning last_hidden_state
    (B, 1 + grid^2, hidden)."""

    def __init__(
        self,
        hidden_size: int = 768,
        num_layers: int = 12,
        num_heads: int = 12,
        intermediate_size: int = 3072,
        patch_size: int = 16,
        base_image_size: int = 224,
        layer_norm_eps: float = 1e-12,
    ):
        super().__init__()
        self.embeddings = ViTEmbeddings(hidden_size, patch_size, base_image_size)
        self.encoder = nn.Module()
        self.encoder.layer = nn.ModuleList(
            ViTLayer(hidden_size, num_heads, intermediate_size, layer_norm_eps) for _ in range(num_layers)
        )
        self.layernorm = nn.LayerNorm(hidden_size, eps=layer_norm_eps)

    def forward(self, images):
        """images (B, 3, H, W), already normalized."""
        x = self.embeddings(images)
        for layer in self.encoder.layer:
            x = layer(x)
        return self.layernorm(x)


class DINOSingleImageTokenizer(nn.Module):
    """ImageNet-normalize + ViT encode: (B, H, W, 3) in [0, 1] -> (B, C, Nt)."""

    def __init__(self, **vit_kwargs):
        super().__init__()
        self.model = ViTEncoder(**vit_kwargs)
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN), persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD), persistent=False)

    def forward(self, images):
        x = (images - self.mean.to(images.dtype)) / self.std.to(images.dtype)
        tokens = self.model(x.permute(0, 3, 1, 2))
        return tokens.transpose(1, 2)
