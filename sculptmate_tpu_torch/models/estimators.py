"""Global material and illumination estimators (SF3D).

Counterpart of ``sculptmate_tpu/models/estimators.py``, with the reference
checkpoint's module names:

- ``ClipBasedHeadEstimator`` (``image_estimator.*``): CLIP ViT-B/32 features
  -> per head a shared ReLU stack and two parameter stacks -> Beta(a, b) at
  its mode: the global roughness and metallic scalars, under
  ``decoder_``-prefixed keys for the decoder
  (``sf3d/models/image_estimator/clip_based_estimator.py:90-168``).
- ``MultiHeadEstimator`` (``global_estimator.*``): two strided convolutions
  over the concatenated raw triplanes -> global max pool -> ReLU stacks ->
  the illumination's spherical-gaussian amplitudes
  (``sf3d/models/global_estimator/``).
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import torch
import torch.nn as nn

from sculptmate_tpu_torch.models.clip import OPENAI_DATASET_MEAN, OPENAI_DATASET_STD, CLIPVisual
from sculptmate_tpu_torch.ops.activations import get_activation
from sculptmate_tpu_torch.ops.resize import resize_bilinear_antialias

CLIP_HEADS = tuple(
    {"name": name, "out_channels": 1, "n_hidden_layers": 3, "output_activation": "linear",
     "add_to_decoder_features": True, "output_bias": 1.0, "shape": (-1, 1, 1)}
    for name in ("roughness", "metallic")
)
ILLUMINATION_HEADS = (
    {"name": "sg_amplitudes", "out_channels": 24, "n_hidden_layers": 3, "output_activation": "softplus",
     "output_bias": 1.0, "shape": (-1, 24, 1)},
)


def beta_mode(alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """Mode of Beta(a, b) as ``torch.distributions.Beta.mode`` defines it
    for a, b > 1, clamped into [0, 1] otherwise."""
    return ((alpha - 1.0) / torch.clamp(alpha + beta - 2.0, min=1e-6)).clamp(0.0, 1.0)


def _relu_stack(d_in: int, hidden: int, n_layers: int) -> nn.Sequential:
    layers = []
    for i in range(n_layers):
        layers += [nn.Linear(d_in if i == 0 else hidden, hidden), nn.ReLU()]
    return nn.Sequential(*layers)


class ClipBasedHeadEstimator(nn.Module):
    def __init__(self, heads: Sequence[Dict[str, Any]] = CLIP_HEADS, hidden_features: int = 512,
                 clip_width: int = 768, clip_layers: int = 12, clip_heads: int = 12):
        super().__init__()
        self.head_specs = tuple(dict(h) for h in heads)
        self.model = nn.Module()
        self.model.visual = CLIPVisual(width=clip_width, layers=clip_layers, heads=clip_heads, embed_dim=hidden_features)
        self.heads = nn.ModuleDict()
        for h in self.head_specs:
            # [shared stack, then one Linear-ReLU-Linear stack per Beta parameter]
            self.heads[h["name"]] = nn.ModuleList(
                [_relu_stack(hidden_features, hidden_features, int(h.get("n_hidden_layers", 3)))]
                + [nn.Sequential(*_relu_stack(hidden_features, hidden_features, 1), nn.Linear(hidden_features, 1))
                   for _ in range(2)]
            )
        self.register_buffer("mean", torch.tensor(OPENAI_DATASET_MEAN), persistent=False)
        self.register_buffer("std", torch.tensor(OPENAI_DATASET_STD), persistent=False)

    def forward(self, cond_image: torch.Tensor) -> Dict[str, torch.Tensor]:
        """cond_image: (B, H, W, 3) masked rgb in [0, 1]."""
        x = resize_bilinear_antialias(cond_image, 224, 224, antialias=False)
        x = (x - self.mean.to(x.dtype)) / self.std.to(x.dtype)
        feats = self.model.visual(x)
        out = {}
        for head in self.head_specs:
            shared, p0, p1 = self.heads[head["name"]]
            s = shared(feats)
            bias = float(head.get("output_bias", 0.0))
            a, b = (nn.functional.softplus(p(s)[..., 0] + bias) for p in (p0, p1))
            val = get_activation(head.get("output_activation"))(beta_mode(a, b))
            if head.get("shape"):
                val = val.reshape(tuple(head["shape"]))
            out[f"decoder_{head['name']}" if head.get("add_to_decoder_features") else head["name"]] = val
        return out


class MultiHeadEstimator(nn.Module):
    def __init__(self, heads: Sequence[Dict[str, Any]] = ILLUMINATION_HEADS, triplane_features: int = 1024,
                 pool_features: int = 512, hidden_features: int = 512):
        super().__init__()
        self.head_specs = tuple(dict(h) for h in heads)
        self.layers = nn.Sequential(
            nn.Conv2d(3 * triplane_features, pool_features, 3, stride=2), nn.ReLU(),
            nn.Conv2d(pool_features, pool_features, 3, stride=2), nn.ReLU(),
        )
        self.heads = nn.ModuleDict()
        for h in self.head_specs:
            stack = _relu_stack(pool_features, hidden_features, int(h.get("n_hidden_layers", 3)))
            self.heads[h["name"]] = nn.Sequential(*stack, nn.Linear(hidden_features, int(h["out_channels"])))

    def forward(self, triplane: torch.Tensor) -> Dict[str, torch.Tensor]:
        """triplane: (B, 3, C, H, W) raw (not upsampled) codes."""
        B, Np, C, H, W = triplane.shape
        x = self.layers(triplane.reshape(B, Np * C, H, W)).amax(dim=(2, 3))
        out = {}
        for head in self.head_specs:
            h = self.heads[head["name"]](x) + float(head.get("output_bias", 0.0))
            h = get_activation(head.get("output_activation"))(h)
            out[head["name"]] = h.reshape(tuple(head["shape"])) if head.get("shape") else h
        return out
