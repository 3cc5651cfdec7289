"""The one seeded generator of the benchmark's input images.

Each image is an object "photo": one smooth closed object (a superquadric
silhouette, shaded as a bulging surface lit from a seeded direction, with a
seeded low-frequency texture) filling a seeded share of the frame, on a
seeded plain or linear-gradient background. Image ``i`` of seed ``s``
depends on (s, i) alone, so a run regenerates any request's image after
its window. The parameters come from the traffic file's ``photo`` group:

- ``size``: [height, width] in pixels;
- ``object_share``: [lo, hi] share of the frame's area the object covers;
- ``exponent``: [lo, hi] superquadric exponent (2 an ellipse, larger
  squarer, smaller starrier);
- ``aspect``: [lo, hi] ratio of the object's two radii;
- ``texture_cycles``: [lo, hi] cycles of the texture across the object;
- ``gradient_share``: share of backgrounds that are gradients;
- ``channels``: 3 (RGB) or 4 (RGBA, alpha 1 everywhere);
- ``pool``, ``pool_seed``: the traffic's photos are the ``pool`` images
  of ``pool_seed``; request ``i`` of run seed ``s`` takes pool entry
  ``perm_c[i mod pool]``, ``perm_c`` a permutation drawn from (s, c) for
  each cycle c = i // pool through the pool. Every seed sends the same
  photos, in another order, so the seed changes the order and not the
  work (with random weights a photo's mesh size swings from thousands of
  vertices to millions from one photo to the next).

Everything is drawn on the device in float32 and returned as uint8.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch

_MIX = 0x9E3779B97F4A7C15


def image_seed(seed: int, index: int) -> int:
    """A 63-bit generator seed for image ``index`` of run seed ``seed``
    (any whole numbers, the run seed up to 2**64 and beyond)."""
    x = (int(seed) * _MIX + (int(index) + 1) * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
    x ^= x >> 31
    x = (x * 0x94D049BB133111EB) & ((1 << 64) - 1)
    return (x ^ (x >> 29)) & ((1 << 63) - 1)


def _area_factor(n: float, aspect: float) -> float:
    """Area of the superellipse |x/a|^n + |y/b|^n <= 1 with a = 1, b =
    aspect."""
    return 4.0 * aspect * math.exp(2 * math.lgamma(1 + 1 / n) - math.lgamma(1 + 2 / n))


def photo(params: Dict, seed: int, index: int, device) -> torch.Tensor:
    """Image ``index`` of seed ``seed`` -> (H, W, channels) uint8 on
    ``device``."""
    H, W = params["size"]
    g = torch.Generator(device=device).manual_seed(image_seed(seed, index))
    # the scalars are drawn on the device and read once, together
    draws = torch.rand(16, generator=g, device=device).tolist()

    def pick(key, u):
        lo, hi = params[key]
        return lo + (hi - lo) * u

    share = pick("object_share", draws[0])
    n = pick("exponent", draws[1])
    aspect = pick("aspect", draws[2])
    theta = math.pi * draws[3]
    # radii in units of the frame's shorter side, so that the object covers
    # ``share`` of the frame; its centre keeps it inside the frame
    side = min(H, W)
    a = math.sqrt(share * H * W / _area_factor(n, aspect)) / side
    b = a * aspect
    extent = max(a, b)
    if extent > 0.49:  # the squarer shapes: cut to what fits
        a, b = a * 0.49 / extent, b * 0.49 / extent
        extent = 0.49
    cy = 0.5 + (draws[4] - 0.5) * max(0.0, H / side - 2 * extent) * 0.9
    cx = 0.5 + (draws[5] - 0.5) * max(0.0, W / side - 2 * extent) * 0.9
    ys = (torch.arange(H, device=device, dtype=torch.float32) + 0.5) / side
    xs = (torch.arange(W, device=device, dtype=torch.float32) + 0.5) / side
    y, x = torch.meshgrid(ys - cy * H / side, xs - cx * W / side, indexing="ij")
    c, s = math.cos(theta), math.sin(theta)
    u, v = (c * x + s * y) / a, (-s * x + c * y) / b
    rho = (u.abs() ** n + v.abs() ** n) ** (1.0 / n)  # 1 on the silhouette
    inside = (rho < 1.0).float()
    # a bulging surface: height sqrt(1 - rho^2), lit from a seeded direction
    hgt = torch.sqrt((1.0 - rho.clamp(max=1.0) ** 2).clamp(min=0.0))
    gy, gx = torch.gradient(hgt)
    light = torch.tensor([draws[6] - 0.5, draws[7] - 0.5, 1.0], device=device)
    light = light / light.norm()
    normal = torch.stack([-gx * side * 0.02, -gy * side * 0.02, torch.ones_like(hgt)], -1)
    shade = (normal / normal.norm(dim=-1, keepdim=True) @ light).clamp(min=0.0)
    cycles = pick("texture_cycles", draws[8])
    phase = 2 * math.pi * torch.rand(3, 3, generator=g, device=device)
    tex = 0.5 + 0.5 * torch.stack([
        torch.sin(cycles * math.pi * (u * math.cos(phase[k, 0]) + v * math.sin(phase[k, 0])) + phase[k, 1])
        for k in range(3)
    ], -1)
    base = torch.rand(3, generator=g, device=device)
    obj = (0.35 * base + 0.45 * tex * base + 0.2) * (0.35 + 0.65 * shade[..., None])
    bg0, bg1 = torch.rand(3, generator=g, device=device), torch.rand(3, generator=g, device=device)
    if draws[9] < params["gradient_share"]:
        ang = 2 * math.pi * draws[10]
        ramp = ((math.cos(ang) * x + math.sin(ang) * y) / (2 * extent + 1) + 0.5).clamp(0.0, 1.0)[..., None]
        bg = bg0 * (1 - ramp) + bg1 * ramp
    else:
        bg = bg0.expand(H, W, 3)
    img = obj * inside[..., None] + bg * (1.0 - inside[..., None])
    img = (img + 0.01 * torch.randn(H, W, 3, generator=g, device=device)).clamp(0.0, 1.0)
    out = torch.round(img * 255.0).to(torch.uint8)
    if params.get("channels", 3) == 4:
        out = torch.cat([out, torch.full((H, W, 1), 255, dtype=torch.uint8, device=device)], -1)
    return out


def pool_entry(params: Dict, seed: int, i: int) -> int:
    """The pool entry of request ``i`` of run seed ``seed``; a negative
    ``i`` (calibration, warm-up) is an image of its own, outside the pool."""
    if i < 0:
        return i
    cycle, k = divmod(i, params["pool"])
    g = torch.Generator().manual_seed(image_seed(seed, -1000 - cycle))
    return int(torch.randperm(params["pool"], generator=g)[k])


def request_photo(params: Dict, seed: int, i: int, device) -> torch.Tensor:
    """The photo of request ``i`` of run seed ``seed`` -> (H, W, channels)
    uint8 on ``device``."""
    return photo(params, params["pool_seed"], pool_entry(params, seed, i), device)


def request_photos(params: Dict, seed: int, indices: Sequence[int], device) -> torch.Tensor:
    return torch.stack([request_photo(params, seed, i, device) for i in indices])
