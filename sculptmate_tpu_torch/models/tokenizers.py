"""Learned triplane tokens.

Counterpart of ``sculptmate_tpu/models/tokenizers.py``:
``Triplane1DTokenizer`` (TripoSR, ``tsr/models/tokenizers/triplane.py:11-45``
in the reference), a (3, C, H, W) embedding broadcast to the batch as a
(B, C, 3*H*W) token stream, and ``TriplaneLearnablePositionalEmbedding``
(SF3D), the same as a channels-last (B, 3*H*W, C) stream.
"""

from __future__ import annotations

import torch
import torch.nn as nn


class Triplane1DTokenizer(nn.Module):
    def __init__(self, plane_size: int = 32, num_channels: int = 1024):
        super().__init__()
        self.plane_size = plane_size
        self.num_channels = num_channels
        self.embeddings = nn.Parameter(torch.zeros(3, num_channels, plane_size, plane_size))

    def forward(self, batch_size: int) -> torch.Tensor:
        """Returns the (B, C, 3*H*W) token stream."""
        tokens = self.embeddings.reshape(3, self.num_channels, -1).transpose(0, 1)
        return tokens.reshape(1, self.num_channels, -1).expand(batch_size, -1, -1)

    def detokenize(self, tokens: torch.Tensor) -> torch.Tensor:
        """(B, C, 3*H*W) -> (B, 3, C, H, W)."""
        B, C, _ = tokens.shape
        x = tokens.reshape(B, C, 3, self.plane_size, self.plane_size)
        return x.transpose(1, 2)


class TriplaneLearnablePositionalEmbedding(nn.Module):
    """SF3D's learned triplane tokens (``sf3d/models/tokenizers/triplane.py``):
    the same (3, C, H, W) embedding at 96^2, as a channels-last (B, 3*H*W, C)
    stream."""

    def __init__(self, plane_size: int = 96, num_channels: int = 1024):
        super().__init__()
        self.plane_size = plane_size
        self.num_channels = num_channels
        self.embeddings = nn.Parameter(torch.zeros(3, num_channels, plane_size, plane_size))

    def forward(self, batch_size: int) -> torch.Tensor:
        """Returns the (B, 3*H*W, C) token stream."""
        tokens = self.embeddings.reshape(3, self.num_channels, -1).permute(0, 2, 1)
        return tokens.reshape(1, -1, self.num_channels).expand(batch_size, -1, -1)

    def detokenize(self, tokens: torch.Tensor) -> torch.Tensor:
        """(B, 3*H*W, C) -> (B, 3, C, H, W)."""
        B, _, C = tokens.shape
        x = tokens.transpose(1, 2).reshape(B, C, 3, self.plane_size, self.plane_size)
        return x.transpose(1, 2)
