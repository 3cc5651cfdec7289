"""Activation registry: the names ``TSRConfig`` dispatches on.

Counterpart of ``sculptmate_tpu/ops/activations.py:get_activation`` for the
Lean path (``tsr/utils.py:234-252`` in the reference).
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
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softplus": F.softplus,
    "relu": F.relu,
    "silu": F.silu,
    "gelu": F.gelu,  # exact erf form, as torch's default
}


def get_activation(name: Optional[str]) -> Callable[[torch.Tensor], torch.Tensor]:
    if name is None:
        return lambda x: x
    key = name.lower()
    if key not in _REGISTRY:
        raise ValueError(f"Unknown activation: {name}")
    return _REGISTRY[key]
