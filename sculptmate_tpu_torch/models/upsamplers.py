"""Triplane upsampling heads, on the (B, 3, C, H, W) triplane layout.

Counterpart of ``sculptmate_tpu/models/upsamplers.py``:
``TriplaneUpsampleNetwork`` (TripoSR, ``tsr/models/network_utils.py:11-32``
in the reference), a ConvTranspose2d with kernel 2 and stride 2 per plane,
1024 ch 32^2 -> 40 ch 64^2; and ``PixelShuffleUpsampleNetwork`` (SF3D).
"""

from __future__ import annotations

import torch
import torch.nn as nn


class TriplaneUpsampleNetwork(nn.Module):
    def __init__(self, in_channels: int = 1024, out_channels: int = 40):
        super().__init__()
        self.upsample = nn.ConvTranspose2d(in_channels, out_channels, kernel_size=2, stride=2)

    def forward(self, triplanes: torch.Tensor) -> torch.Tensor:
        B, Np, C, H, W = triplanes.shape
        x = self.upsample(triplanes.reshape(B * Np, C, H, W))
        return x.reshape(B, Np, *x.shape[1:])


class PixelShuffleUpsampleNetwork(nn.Module):
    """SF3D's upsampler (``sf3d/models/network.py:29-74``): per plane,
    ``conv_layers`` 3x3 convolutions (ReLU between them, the width kept at
    ``in_channels`` until the last one) and a pixel shuffle by
    ``scale_factor``: 1024 ch 96^2 -> 40 ch 384^2. The convolutions are
    cuDNN's, as the JAX package leaves them to XLA."""

    def __init__(self, in_channels: int = 1024, out_channels: int = 40, scale_factor: int = 4, conv_layers: int = 4):
        super().__init__()
        layers = []
        for i in range(conv_layers):
            last = i == conv_layers - 1
            layers.append(nn.Conv2d(in_channels, out_channels * scale_factor**2 if last else in_channels, 3, padding=1))
            layers.append(nn.PixelShuffle(scale_factor) if last else nn.ReLU())
        self.upsample = nn.Sequential(*layers)

    def forward(self, triplanes: torch.Tensor) -> torch.Tensor:
        B, Np, C, H, W = triplanes.shape
        x = self.upsample(triplanes.reshape(B * Np, C, H, W))
        return x.reshape(B, Np, *x.shape[1:])
