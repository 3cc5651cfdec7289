"""Cameras and rays for the novel-view renderer.

Counterpart of ``sculptmate_tpu/ops/rays.py`` (the reference's
``tsr/utils.py:255-397``: ``get_ray_directions``, ``get_rays``,
``get_spherical_cameras``; and ``tsr/utils.py:115-149``:
``rays_intersect_bbox``), used by ``TSR.render_views``. Everything is f32 on
``device`` (the CPU when None).
"""

from __future__ import annotations

import math
from typing import Tuple, Union

import torch


def _normalize(v: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    return v / torch.clamp(torch.sqrt((v * v).sum(dim=dim, keepdim=True)), min=eps)


def get_ray_directions(
    H: int,
    W: int,
    focal: Union[float, Tuple[float, float]],
    principal: Tuple[float, float] = None,
    use_pixel_centers: bool = True,
    normalize: bool = True,
    device=None,
) -> torch.Tensor:
    """(H, W, 3) camera-space ray directions (x right, y up, looking -z)."""
    center = 0.5 if use_pixel_centers else 0.0
    if isinstance(focal, (int, float)):
        fx = fy = float(focal)
        cx, cy = W / 2, H / 2
    else:
        fx, fy = focal
        cx, cy = principal
    i, j = torch.meshgrid(
        torch.arange(W, dtype=torch.float32, device=device) + center,
        torch.arange(H, dtype=torch.float32, device=device) + center,
        indexing="xy",
    )
    directions = torch.stack([(i - cx) / fx, -(j - cy) / fy, -torch.ones_like(i)], -1)
    return _normalize(directions) if normalize else directions


def get_rays(directions: torch.Tensor, c2w: torch.Tensor, normalize: bool = False):
    """directions (..., 3) camera-space, c2w (4, 4) -> (rays_o, rays_d)."""
    rays_d = torch.einsum("...j,ij->...i", directions, c2w[:3, :3])
    rays_o = c2w[:3, 3].expand(rays_d.shape)
    return rays_o, (_normalize(rays_d) if normalize else rays_d)


def get_spherical_cameras(
    n_views: int,
    elevation_deg: float,
    camera_distance: float,
    fovy_deg: float,
    height: int,
    width: int,
    device=None,
):
    """A ring of cameras around the +z-up origin -> (rays_o, rays_d), each
    (n_views, H, W, 3)."""
    azimuth = torch.linspace(0, 2 * math.pi, n_views + 1, device=device)[:n_views]
    elevation = torch.full_like(azimuth, elevation_deg * math.pi / 180)
    dist = torch.full_like(azimuth, camera_distance)
    positions = torch.stack(
        [
            dist * torch.cos(elevation) * torch.cos(azimuth),
            dist * torch.cos(elevation) * torch.sin(azimuth),
            dist * torch.sin(elevation),
        ],
        -1,
    )
    up = torch.zeros_like(positions)
    up[:, 2] = 1.0
    lookat = _normalize(-positions)
    right = _normalize(torch.linalg.cross(lookat, up))
    cam_up = _normalize(torch.linalg.cross(right, lookat))
    c2w = torch.cat([torch.stack([right, cam_up, -lookat], dim=-1), positions[..., None]], dim=-1)  # (n, 3, 4)

    focal = 0.5 * height / math.tan(0.5 * fovy_deg * math.pi / 180)
    directions = get_ray_directions(height, width, focal=1.0, device=device)
    directions = torch.cat([directions[..., :2] * (1.0 / focal), directions[..., 2:]], dim=-1)
    bottom = torch.zeros(1, 4, device=device)
    bottom[0, 3] = 1.0
    rays = [get_rays(directions, torch.cat([c2w[v], bottom]), normalize=True) for v in range(n_views)]
    return torch.stack([o for o, _ in rays]), torch.stack([d for _, d in rays])


def rays_intersect_bbox(
    rays_o: torch.Tensor, rays_d: torch.Tensor, radius: float, near: float = 0.0, valid_thresh: float = 0.01
):
    """Slab test of (N, 3) rays against the [-radius, radius]^3 box ->
    (t_near, t_far, valid), each (N,); both t are 0 where a ray misses."""
    rd = torch.where(rays_d.abs() < 1e-6, 1e-6, rays_d)
    r = (1.0 - 1e-3) * radius
    t0 = (r - rays_o) / rd
    t1 = (-r - rays_o) / rd
    t_near = torch.clamp(torch.minimum(t0, t1).amax(-1), min=near)
    t_far = torch.maximum(t0, t1).amin(-1)
    valid = (t_far - t_near) > valid_thresh
    zero = torch.zeros((), device=rays_o.device)
    return torch.where(valid, t_near, zero), torch.where(valid, t_far, zero), valid
