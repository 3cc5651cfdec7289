"""Activation registry: the names the model configs dispatch on.

Counterpart of ``sculptmate_tpu/ops/activations.py:get_activation``
(``tsr/utils.py:234-252`` and ``sf3d/models/network.py:98-136`` in the
reference), every name of its registry with its semantics. ``trunc_exp``
is ``exp`` forward; its gradient clamps the exponent to [-15, 15] (the
torch-ngp op), so a large input does not overflow it.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F


class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x, -15.0, 15.0))


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    return _TruncExp.apply(x)


def normalize_channel_last(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=eps)


def normalize_channel_first(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=1, keepdim=True), min=eps)


def lin2srgb(x: torch.Tensor) -> torch.Tensor:
    x = torch.clamp(x, 0.0, 1.0)
    return torch.where(x <= 0.0031308, 12.92 * x, 1.055 * torch.pow(torch.clamp(x, min=1e-8), 1 / 2.4) - 0.055)


_REGISTRY = {
    "none": lambda x: x,
    "linear": lambda x: x,
    "identity": lambda x: x,
    "exp": torch.exp,
    "shifted_exp": lambda x: torch.exp(x - 1.0),
    "trunc_exp": trunc_exp,
    "shifted_trunc_exp": lambda x: trunc_exp(x - 1.0),
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softplus": F.softplus,
    "shifted_softplus": lambda x: F.softplus(x - 1.0),
    "scale_-11_01": lambda x: x * 0.5 + 0.5,
    "negative": lambda x: -x,
    "relu": F.relu,
    "silu": F.silu,
    "gelu": F.gelu,  # exact erf form, as torch's default
    "normalize_channel_last": normalize_channel_last,
    "normalize_channel_first": normalize_channel_first,
    "lin2srgb": lin2srgb,
}


def get_activation(name: Optional[str]) -> Callable[[torch.Tensor], torch.Tensor]:
    if name is None:
        return lambda x: x
    key = name.lower()
    if key not in _REGISTRY:
        raise ValueError(f"Unknown activation: {name}")
    return _REGISTRY[key]
