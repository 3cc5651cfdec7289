"""Activation registry: the names the model configs dispatch on.

Counterpart of ``sculptmate_tpu/ops/activations.py:get_activation``
(``tsr/utils.py:234-252`` and ``sf3d/models/network.py:98-136`` in the
reference). ``trunc_exp`` differs from ``exp`` only in its gradient, which
the port, inference only, never takes.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

_REGISTRY = {
    "none": lambda x: x,
    "linear": lambda x: x,
    "identity": lambda x: x,
    "exp": torch.exp,
    "shifted_exp": lambda x: torch.exp(x - 1.0),
    "trunc_exp": torch.exp,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softplus": F.softplus,
    "relu": F.relu,
    "silu": F.silu,
    "gelu": F.gelu,  # exact erf form, as torch's default
    "normalize_channel_last": lambda x: x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12),
}


def get_activation(name: Optional[str]) -> Callable[[torch.Tensor], torch.Tensor]:
    if name is None:
        return lambda x: x
    key = name.lower()
    if key not in _REGISTRY:
        raise ValueError(f"Unknown activation: {name}")
    return _REGISTRY[key]
