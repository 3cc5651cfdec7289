"""Image and position-table resizing.

Counterpart of ``sculptmate_tpu/ops/resize.py``:

- ``torch_bicubic_matrix`` / ``interpolate_pos_table``: the ViT position
  table resize as two dense matrices reproducing torch's bicubic
  (A = -0.75, half-pixel centers, replicate borders), the same arithmetic the
  JAX package does.
- ``resize_bilinear_antialias``: torch's antialiased bilinear resize used by
  the reference's image preprocessor (``tsr/utils.py:82-88``), on the JAX
  package's channels-last (B, H, W, C) layout.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def torch_bicubic_matrix(in_size: int, out_size: int, scale: float = 0.0) -> np.ndarray:
    """Dense (out_size, in_size) matrix of ``F.interpolate(mode="bicubic",
    align_corners=False)`` along one axis. ``scale`` (out / in), when
    nonzero, maps source coordinates by that explicit factor, as
    ``interpolate(scale_factor=...)`` does: DINOv2 passes (grid + 0.1) / base
    (``sf3d/models/tokenizers/dinov2.py:111-124``), which is not the mapping
    of ``size=`` for a non-integer ratio."""
    if in_size == out_size and not scale:
        return np.eye(in_size, dtype=np.float32)
    A = -0.75

    def w0(t):
        return A * ((t + 1) ** 3) - 5 * A * ((t + 1) ** 2) + 8 * A * (t + 1) - 4 * A

    def w1(t):
        return (A + 2) * t**3 - (A + 3) * t**2 + 1

    inv_scale = (1.0 / scale) if scale else (in_size / out_size)
    M = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        src = (i + 0.5) * inv_scale - 0.5
        i0 = int(np.floor(src))
        t = src - i0
        for k, w in zip(range(i0 - 1, i0 + 3), [w0(t), w1(t), w1(1 - t), w0(1 - t)]):
            M[i, min(max(k, 0), in_size - 1)] += w
    return M.astype(np.float32)


def interpolate_pos_table(patch_pos: torch.Tensor, grid_h: int, grid_w: int, mats=None) -> torch.Tensor:
    """(P*P, C) position table -> (grid_h * grid_w, C), torch-bicubic
    semantics. ``mats``: the (grid_h, P) and (grid_w, P) matrices already on
    the table's device (built here when absent, an upload that waits for the
    device)."""
    base = int(round(patch_pos.shape[0] ** 0.5))
    C = patch_pos.shape[-1]
    x = patch_pos.reshape(base, base, C)
    if mats is None:
        mats = tuple(torch.from_numpy(torch_bicubic_matrix(base, g)).to(x.device) for g in (grid_h, grid_w))
    Mh, Mw = (m.to(x.dtype) for m in mats)
    x = torch.einsum("hH,HWc->hWc", Mh, x)
    x = torch.einsum("wW,hWc->hwc", Mw, x)
    return x.reshape(grid_h * grid_w, C)


def resize_bilinear_antialias(image: torch.Tensor, height: int, width: int, antialias: bool = True) -> torch.Tensor:
    """(B, H, W, C) -> (B, height, width, C), bilinear with half-pixel
    centers; antialiased (the filter widened when shrinking) unless asked
    otherwise, which is ``resize_bilinear`` of the JAX package."""
    x = image.permute(0, 3, 1, 2)
    x = F.interpolate(x, size=(height, width), mode="bilinear", align_corners=False, antialias=antialias)
    return x.permute(0, 2, 3, 1)
