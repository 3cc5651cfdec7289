"""Camera conditioning for SF3D: the linear embedder and the default camera.

Counterpart of ``sculptmate_tpu/models/camera.py`` (``sf3d/models/camera.py``
and ``sf3d/utils.py:24-48`` in the reference): the flattened c2w (16) and
normalized intrinsics (9) through one Linear to 768, and the fixed
condition camera looking down -x from ``distance``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn as nn


class LinearCameraEmbedder(nn.Module):
    def __init__(self, in_channels: int = 25, out_channels: int = 768):
        super().__init__()
        self.in_channels = in_channels
        self.linear = nn.Linear(in_channels, out_channels)

    def forward(self, *conds: torch.Tensor) -> torch.Tensor:
        """conds: (B, ...) tensors, concatenated flat in the reference's order
        (c2w, then normalized intrinsics)."""
        x = torch.cat([c.reshape(c.shape[0], -1) for c in conds], dim=-1)
        if x.shape[-1] != self.in_channels:
            raise ValueError(f"camera condition has {x.shape[-1]} channels, expected {self.in_channels}")
        return self.linear(x)


def default_cond_c2w(distance: float) -> np.ndarray:
    """The reference's fixed condition camera (``sf3d/utils.py:39-48``)."""
    return np.array(
        [[0, 0, 1, distance], [1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, 1]],
        dtype=np.float32,
    )


def intrinsic_from_fov_deg(fov_deg: float, height: int, width: int) -> Tuple[np.ndarray, np.ndarray]:
    """(intrinsic, intrinsic_normed) from a vertical field of view."""
    focal = 0.5 * height / np.tan(0.5 * np.deg2rad(fov_deg))
    K = np.eye(3, dtype=np.float32)
    K[0, 0] = K[1, 1] = focal
    K[0, 2] = width / 2.0
    K[1, 2] = height / 2.0
    Kn = K.copy()
    Kn[0, 2] /= width
    Kn[1, 2] /= height
    Kn[0, 0] /= width
    Kn[1, 1] /= height
    return K, Kn
