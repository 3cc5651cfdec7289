"""Bilinear triplane sampling, ``F.grid_sample(mode="bilinear",
padding_mode="zeros")`` semantics.

Counterpart of ``sculptmate_tpu/ops/grid_sample.py``:

- ``sample_triplane_regular_grid``: the lattice is separable, so sampling a
  plane at every lattice point is two small interpolation matrices per
  plane (``Wv @ P @ Wu^T``) with no gathers.
- ``grid_sample_2d`` / ``sample_triplane``: scattered points (mesh-vertex
  color queries), four gathered taps per point.

Coordinates are flat (N,) tensors in [-1, 1]; x indexes W, y indexes H.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _unnormalize(coords: torch.Tensor, size: int, align_corners: bool) -> torch.Tensor:
    """Normalized [-1, 1] coords -> float pixel indices (torch convention)."""
    if align_corners:
        return (coords + 1.0) * 0.5 * (size - 1)
    return ((coords + 1.0) * size - 1.0) * 0.5


def interp_matrix_1d(coords: torch.Tensor, size: int, align_corners: bool) -> torch.Tensor:
    """(N, size) two-tap bilinear weights along one axis; taps outside
    [0, size) get weight zero (zero padding)."""
    fx = _unnormalize(coords.float(), size, align_corners)
    x0 = torch.floor(fx)
    w1 = fx - x0
    x0i = x0.long()
    taps = torch.arange(size, device=coords.device)[None, :]
    m0 = (taps == x0i[:, None]).float() * (1.0 - w1)[:, None]
    m1 = (taps == (x0i + 1)[:, None]).float() * w1[:, None]
    return m0 + m1


def resample_plane(
    plane: torch.Tensor, u: torch.Tensor, v: torch.Tensor, align_corners: bool
) -> torch.Tensor:
    """Sample a (C, H, W) plane on the separable grid (v x u) -> (C, Nv, Nu) f32."""
    Wu = interp_matrix_1d(u, plane.shape[-1], align_corners)  # (Nu, W)
    Wv = interp_matrix_1d(v, plane.shape[-2], align_corners)  # (Nv, H)
    return torch.einsum("vh,chw,uw->cvu", Wv, plane.float(), Wu)


def sample_triplane_regular_grid(
    triplane: torch.Tensor,
    coords_x: torch.Tensor,
    coords_y: torch.Tensor,
    coords_z: torch.Tensor,
    align_corners: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(3, C, H, W) planes ordered (xy, xz, yz) -> (Fxy, Fxz, Fyz) with
    Fxy[c, j, i] = plane0 at (x_i, y_j), Fxz[c, k, i] = plane1 at (x_i, z_k),
    Fyz[c, k, j] = plane2 at (y_j, z_k)."""
    Fxy = resample_plane(triplane[0], coords_x, coords_y, align_corners)
    Fxz = resample_plane(triplane[1], coords_x, coords_z, align_corners)
    Fyz = resample_plane(triplane[2], coords_y, coords_z, align_corners)
    return Fxy, Fxz, Fyz


def grid_sample_2d(
    input: torch.Tensor, px: torch.Tensor, py: torch.Tensor, align_corners: bool = False
) -> torch.Tensor:
    """Gather-based bilinear sample of (C, H, W) at flat (N,) points -> (C, N)."""
    C, H, W = input.shape
    fx = _unnormalize(px.float(), W, align_corners)
    fy = _unnormalize(py.float(), H, align_corners)
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    wx1 = fx - x0
    wy1 = fy - y0
    x0i = x0.long()
    y0i = y0.long()
    flat = input.reshape(C, H * W)

    def tap(xi, yi, w):
        valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        idx = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
        return flat[:, idx] * (w * valid.float())[None, :]

    return (
        tap(x0i, y0i, (1 - wx1) * (1 - wy1))
        + tap(x0i + 1, y0i, wx1 * (1 - wy1))
        + tap(x0i, y0i + 1, (1 - wx1) * wy1)
        + tap(x0i + 1, y0i + 1, wx1 * wy1)
    )


def sample_triplane(
    triplane: torch.Tensor,
    px: torch.Tensor,
    py: torch.Tensor,
    pz: torch.Tensor,
    align_corners: bool = False,
) -> torch.Tensor:
    """(3, C, H, W) triplane at flat (N,) points in [-1, 1] -> (3C, N),
    features ordered (xy, xz, yz)."""
    return torch.cat(
        [
            grid_sample_2d(triplane[0], px, py, align_corners),
            grid_sample_2d(triplane[1], px, pz, align_corners),
            grid_sample_2d(triplane[2], py, pz, align_corners),
        ],
        dim=0,
    )
