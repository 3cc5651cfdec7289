"""Triplane upsampling head (TripoSR).

Counterpart of ``sculptmate_tpu/models/upsamplers.py:TriplaneUpsampleNetwork``
(``tsr/models/network_utils.py:11-32`` in the reference): a ConvTranspose2d
with kernel 2 and stride 2 per plane, 1024 ch 32^2 -> 40 ch 64^2, on the
(B, 3, C, H, W) triplane layout.
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
