"""Learned triplane tokens (TripoSR).

Counterpart of ``sculptmate_tpu/models/tokenizers.py:Triplane1DTokenizer``
(``tsr/models/tokenizers/triplane.py:11-45`` in the reference): a (3, C, H, W)
embedding broadcast to the batch as a (B, C, 3*H*W) token stream.
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
