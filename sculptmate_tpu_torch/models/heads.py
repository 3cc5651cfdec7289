"""NeRF MLP decoder over triplane features (TripoSR).

Counterpart of ``sculptmate_tpu/models/heads.py:MLPStack`` and ``NeRFMLP``
(``tsr/models/network_utils.py:35-124`` in the reference): 120 -> 64, 9
hidden layers, SiLU, out 4 = density (1) + features (3). ``MLPStack`` is the
reference's ``nn.Sequential`` of Linear and activation modules, so the
Linears sit at indices 0, 2, ..., 2 n (``decoder.layers.<i>``).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from sculptmate_tpu_torch.ops.activations import get_activation


class Activation(nn.Module):
    def __init__(self, name: str):
        super().__init__()
        self.fn = get_activation(name)

    def forward(self, x):
        return self.fn(x)


class MLPStack(nn.Sequential):
    """Linear/activation alternating: in -> n_neurons x n_hidden_layers -> out."""

    def __init__(self, in_channels: int, n_neurons: int, n_hidden_layers: int, out_channels: int, activation: str = "silu"):
        layers = []
        for i in range(n_hidden_layers):
            layers += [nn.Linear(in_channels if i == 0 else n_neurons, n_neurons), Activation(activation)]
        layers.append(nn.Linear(n_neurons, out_channels))
        super().__init__(*layers)


class NeRFMLP(nn.Module):
    def __init__(self, in_channels: int = 120, n_neurons: int = 64, n_hidden_layers: int = 9, activation: str = "silu"):
        super().__init__()
        self.layers = MLPStack(in_channels, n_neurons, n_hidden_layers, 4, activation)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        feats = self.layers(x)
        return {"density": feats[..., 0:1], "features": feats[..., 1:4]}
