"""Seeded weights made on the device in a few large calls.

A configuration's parameter list (``reference/*.param_specs``: name, shape,
initialisation) is drawn as one flat normal tensor and one flat uniform
tensor from a ``torch.Generator`` on the device, cut into views and scaled
leaf by leaf; the truncated normals come from the uniform draw through the
inverse normal CDF.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch


def _phi(x: float) -> float:
    return 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))


def init_tensors(specs: List[tuple], generator: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """``specs``: (name, shape, init) with init ("normal", std),
    ("trunc_normal", std) (truncated at +-2 std), ("zeros",), ("ones",) or
    ("count",) (a zero int64 scalar) -> {name: float32 tensor on device}."""
    sizes = {kind: sum(math.prod(s) for _, s, init in specs if init[0] == kind)
             for kind in ("normal", "trunc_normal")}
    flat = {"normal": torch.randn(sizes["normal"], generator=generator, device=device),
            "trunc_normal": torch.rand(sizes["trunc_normal"], generator=generator, device=device)}
    lo, hi = _phi(-2.0), _phi(2.0)
    u = flat["trunc_normal"]
    # uniform in [Phi(-2), Phi(2)] -> the inverse normal CDF: N(0, 1) cut at +-2
    flat["trunc_normal"] = torch.erfinv(2.0 * (lo + (hi - lo) * u) - 1.0).mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)
    at = {"normal": 0, "trunc_normal": 0}
    out = {}
    for name, shape, init in specs:
        kind = init[0]
        if kind in flat:
            k = math.prod(shape)
            out[name] = flat[kind][at[kind] : at[kind] + k].view(shape).mul_(init[1])
            at[kind] += k
        elif kind == "ones":
            out[name] = torch.ones(shape, device=device)
        elif kind == "count":
            out[name] = torch.zeros(shape, dtype=torch.long, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out
