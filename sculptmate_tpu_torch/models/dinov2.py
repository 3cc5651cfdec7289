"""DINOv2 image encoder with AdaLN camera modulation (SF3D's tokenizer).

Counterpart of ``sculptmate_tpu/models/dinov2.py``, with the module names of
the reference checkpoint's vendored ``Dinov2Model``
(``image_tokenizer.model.*``, ``sf3d/models/tokenizers/dinov2.py``): patch
convolution (14), CLS token, a 37^2 position table resized torch-bicubic
with the reference's "+0.1" scale factor, 24 pre-LN layers (LayerNorm eps
1e-6, exact-erf GELU, LayerScale) whose norm1/norm2 outputs are modulated by
the camera embedding (x (1 + scale) + shift, zero-initialised projection),
and a final LayerNorm. Every attention call goes through ``ops.attention``,
so on the card it runs on kernel K1.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from sculptmate_tpu_torch.models.vit import IMAGENET_MEAN, IMAGENET_STD, _Dense
from sculptmate_tpu_torch.ops.attention import dot_product_attention
from sculptmate_tpu_torch.ops.resize import interpolate_pos_table, torch_bicubic_matrix


class Modulation(nn.Module):
    """AdaLN scale and shift from a condition vector."""

    def __init__(self, embedding_dim: int, condition_dim: int):
        super().__init__()
        self.linear2 = nn.Linear(condition_dim, 2 * embedding_dim)

    def forward(self, x: torch.Tensor, condition: torch.Tensor) -> torch.Tensor:
        scale, shift = self.linear2(F.silu(condition)).chunk(2, dim=-1)
        return x * (1.0 + scale[:, None, :]) + shift[:, None, :]


class LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.lambda1 = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.lambda1.to(x.dtype)


class Dinov2SelfAttention(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.query = nn.Linear(hidden_size, hidden_size)
        self.key = nn.Linear(hidden_size, hidden_size)
        self.value = nn.Linear(hidden_size, hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, C = x.shape
        shape = (B, N, self.num_heads, C // self.num_heads)
        q, k, v = (m(x).reshape(shape) for m in (self.query, self.key, self.value))
        return dot_product_attention(q, k, v).reshape(B, N, C)


class Dinov2Attention(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int):
        super().__init__()
        self.attention = Dinov2SelfAttention(hidden_size, num_heads)
        self.output = _Dense(hidden_size, hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.output(self.attention(x))


class Dinov2MLP(nn.Module):
    def __init__(self, hidden_size: int, intermediate_size: int):
        super().__init__()
        self.fc1 = nn.Linear(hidden_size, intermediate_size)
        self.fc2 = nn.Linear(intermediate_size, hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))  # exact erf form


class Dinov2Layer(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int, intermediate_size: int, condition_dim: int,
                 layer_norm_eps: float = 1e-6):
        super().__init__()
        self.norm1 = nn.LayerNorm(hidden_size, eps=layer_norm_eps)
        self.norm1_modulation = Modulation(hidden_size, condition_dim)
        self.attention = Dinov2Attention(hidden_size, num_heads)
        self.layer_scale1 = LayerScale(hidden_size)
        self.norm2 = nn.LayerNorm(hidden_size, eps=layer_norm_eps)
        self.norm2_modulation = Modulation(hidden_size, condition_dim)
        self.mlp = Dinov2MLP(hidden_size, intermediate_size)
        self.layer_scale2 = LayerScale(hidden_size)

    def forward(self, x: torch.Tensor, modulation_cond: torch.Tensor) -> torch.Tensor:
        h = self.norm1_modulation(self.norm1(x), modulation_cond)
        x = x + self.layer_scale1(self.attention(h))
        h = self.norm2_modulation(self.norm2(x), modulation_cond)
        return x + self.layer_scale2(self.mlp(h))


class Dinov2Embeddings(nn.Module):
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

    def _pos_table(self, gh: int, gw: int) -> torch.Tensor:
        """The (1, 1 + gh * gw, C) position table; torch-exact bicubic with
        the reference's scale factor (grid + 0.1) / base."""
        pos = self.position_embeddings
        base = int(round((pos.shape[1] - 1) ** 0.5))
        if base == gh == gw:
            return pos
        key = (gh, gw, pos.device)
        if key not in self._pos_mats:
            # normal tensors even when built under inference mode
            with torch.inference_mode(False):
                self._pos_mats[key] = tuple(
                    torch.from_numpy(torch_bicubic_matrix(base, g, scale=(g + 0.1) / base)).to(pos.device)
                    for g in (gh, gw)
                )
        patch = interpolate_pos_table(pos[0, 1:], gh, gw, self._pos_mats[key])
        return torch.cat([pos[:, :1], patch[None]], dim=1)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images (B, 3, H, W) normalized -> (B, 1 + gh * gw, C)."""
        x = self.patch_embeddings.projection(images)  # (B, C, gh, gw)
        B, C, gh, gw = x.shape
        x = torch.cat([self.cls_token.expand(B, 1, C).to(x.dtype), x.flatten(2).transpose(1, 2)], dim=1)
        return x + self._pos_table(gh, gw).to(x.dtype)


class Dinov2Model(nn.Module):
    """The DINOv2 backbone (defaults: facebook/dinov2-large), returning
    last_hidden_state (B, 1 + grid^2, hidden)."""

    def __init__(self, hidden_size: int = 1024, num_layers: int = 24, num_heads: int = 16,
                 intermediate_size: int = 4096, condition_dim: int = 768, patch_size: int = 14,
                 base_image_size: int = 518, layer_norm_eps: float = 1e-6):
        super().__init__()
        self.embeddings = Dinov2Embeddings(hidden_size, patch_size, base_image_size)
        self.encoder = nn.Module()
        self.encoder.layer = nn.ModuleList(
            Dinov2Layer(hidden_size, num_heads, intermediate_size, condition_dim, layer_norm_eps)
            for _ in range(num_layers)
        )
        self.layernorm = nn.LayerNorm(hidden_size, eps=layer_norm_eps)

    def forward(self, images: torch.Tensor, modulation_cond: torch.Tensor) -> torch.Tensor:
        x = self.embeddings(images)
        for layer in self.encoder.layer:
            x = layer(x, modulation_cond)
        return self.layernorm(x)


class DINOV2SingleImageTokenizer(nn.Module):
    """ImageNet-normalize + camera-modulated DINOv2:
    (B, H, W, 3) in [0, 1] -> (B, C, Nt)."""

    def __init__(self, **dinov2_kwargs):
        super().__init__()
        self.model = Dinov2Model(**dinov2_kwargs)
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN), persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD), persistent=False)

    def forward(self, images: torch.Tensor, modulation_cond: torch.Tensor) -> torch.Tensor:
        x = (images - self.mean.to(images.dtype)) / self.std.to(images.dtype)
        return self.model(x.permute(0, 3, 1, 2), modulation_cond).transpose(1, 2)
