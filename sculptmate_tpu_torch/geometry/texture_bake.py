"""Texture baking: UV rasterization, attribute interpolation, island padding.

Counterpart of ``sculptmate_tpu/geometry/texture_bake.py`` (the reference's
``texture_baker`` spec, ``texture_baker/common.py:144-211``): for every
texel, barycentric point-in-triangle tests against the faces that may cover
it; the face with the lowest key wins; the result is the winner's
barycentrics and its face id.

The winner pass is kernel K8 (``csrc/raster_winner.cu`` on
``csrc/raster.cuh``) on a CUDA tensor and ``binned_winner_plain`` on a CPU
tensor. K8 is an ``atomicMin`` rasterizer in one launch: each warp takes 32
faces and walks their (face, texel) candidates 32 at a time, so a face of
any size goes through the same loop. The JAX package's fine and coarse
(face, tile) pair lists, their capacities, overflow counters and retry
loops were workarounds for the TPU's scatter and have no counterpart here.
The device unwrap's two visibility rasters run K8's unwrap form, which
forms each face's corners and key from K9's state
(``uv_unwrap_device.unwrap_core``).

Texel x has its centre at u = x / (res - 1), computed as x * (1 / (res - 1))
in f32 as XLA computes the JAX program's division by that constant; every
other product, sum and quotient is the JAX program's, in its order, without
contracted multiply-adds. The winner is thus bit-equal between the kernel
and the plain version, and ``atomicMin`` makes it independent of launch
order. The interpolation, the bump compose and ``dilate_fill`` are plain
torch.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from sculptmate_tpu_torch.runtime import kernels
from sculptmate_tpu_torch.runtime.device import resolve_device

WINNER_SINK = 2**31 - 1  # empty-texel key (the scatter-min identity)
_CANDIDATES = 1 << 22  # (face, texel) candidates per step of the plain version


def _f32(x: float) -> float:
    return float(np.float32(x))


def texel_scale(resolution: int) -> float:
    """The f32 factor that maps a texel index to its UV centre."""
    return _f32(np.float32(1.0) / np.float32(resolution - 1))


def _face_terms(u0, v0, u1, v1, u2, v2):
    e1u, e1v, e2u, e2v = u1 - u0, v1 - v0, u2 - u0, v2 - v0
    d00 = e1u * e1u + e1v * e1v
    d01 = e1u * e2u + e1v * e2v
    d11 = e2u * e2u + e2v * e2v
    den = d00 * d11 - d01 * d01
    return e1u, e1v, e2u, e2v, d00, d01, d11, den


def _barycentrics(gx, gy, u0, v0, e1u, e1v, e2u, e2v, d00, d01, d11, den_safe):
    pu, pv = gx - u0, gy - v0
    d20 = pu * e1u + pv * e1v
    d21 = pu * e2u + pv * e2v
    bv = (d11 * d20 - d01 * d21) / den_safe
    bw = (d00 * d21 - d01 * d20) / den_safe
    return 1.0 - bv - bw, bv, bw


def _face_boxes(u0, v0, u1, v1, u2, v2, resolution: int, margin: float = 0.0):
    """Each face's texel bbox (xlo, xhi, ylo, yhi) as the JAX package's
    ``binned_winner`` computes it (widened by the slack of ``margin``), and
    whether the face can cover a texel at all."""
    s = float(resolution - 1)
    umin = torch.minimum(torch.minimum(u0, u1), u2) * s
    umax = torch.maximum(torch.maximum(u0, u1), u2) * s
    vmin = torch.minimum(torch.minimum(v0, v1), v2) * s
    vmax = torch.maximum(torch.maximum(v0, v1), v2) * s
    e1u, e1v, e2u, e2v, _, _, _, den = _face_terms(u0, v0, u1, v1, u2, v2)
    if margin > 0.0:
        slack = _f32(margin * s) * (torch.sqrt(e1u * e1u + e1v * e1v) + torch.sqrt(e2u * e2u + e2v * e2v))
    else:
        slack = torch.zeros_like(umin)
    hi = resolution - 1
    xlo = torch.ceil(umin - slack - 1e-3).clamp(-1, resolution).to(torch.int32).clamp(0, hi)
    xhi = torch.floor(umax + slack + 1e-3).clamp(-1, resolution).to(torch.int32).clamp(-1, hi)
    ylo = torch.ceil(vmin - slack - 1e-3).clamp(-1, resolution).to(torch.int32).clamp(0, hi)
    yhi = torch.floor(vmax + slack + 1e-3).clamp(-1, resolution).to(torch.int32).clamp(-1, hi)
    finite = torch.stack([u0, v0, u1, v1, u2, v2]).isfinite().all(0)
    covers = (xhi >= xlo) & (yhi >= ylo) & (den.abs() >= 1e-12) & finite
    return xlo, xhi, ylo, yhi, covers


def binned_winner_plain(u0, v0, u1, v1, u2, v2, key_f, resolution: int, margin: float = 0.0) -> torch.Tensor:
    """Plain version of kernel K8: every (face, texel) candidate of each
    face's bbox, in steps of ``_CANDIDATES``, tested and reduced with
    ``scatter_reduce_(..., "amin")``. Per-corner UVs are flat (F,) f32,
    ``key_f`` (F,) int32 below WINNER_SINK. Returns the (res * res,) int32
    winner: the lowest key covering each texel, or WINNER_SINK."""
    dev = u0.device
    winner = torch.full((resolution * resolution,), WINNER_SINK, dtype=torch.int32, device=dev)
    xlo, xhi, ylo, yhi, covers = _face_boxes(u0, v0, u1, v1, u2, v2, resolution, margin)
    faces = torch.nonzero(covers).flatten()
    if faces.numel() == 0:
        return winner
    w = (xhi - xlo + 1).long()[faces]
    n = w * (yhi - ylo + 1).long()[faces]
    ends = torch.cumsum(n, 0)
    rcp, mg = texel_scale(resolution), _f32(margin)
    start, total = 0, int(ends[-1])
    while start < total:
        # the faces whose candidates start in [start, start + _CANDIDATES)
        lo = int(torch.searchsorted(ends, start, right=True))
        hi = max(lo + 1, int(torch.searchsorted(ends, start + _CANDIDATES, right=True)))
        sel, cnt = faces[lo:hi], n[lo:hi]
        start = int(ends[hi - 1])
        rep = torch.repeat_interleave(torch.arange(len(sel), device=dev), cnt)
        local = torch.arange(int(cnt.sum()), device=dev) - torch.repeat_interleave(torch.cumsum(cnt, 0) - cnt, cnt)
        f = sel[rep]
        wf = w[lo:hi][rep]
        x = xlo[f].long() + local % wf
        y = ylo[f].long() + local // wf
        fu0, fv0, fu1, fv1, fu2, fv2 = (t[f] for t in (u0, v0, u1, v1, u2, v2))
        e1u, e1v, e2u, e2v, d00, d01, d11, den = _face_terms(fu0, fv0, fu1, fv1, fu2, fv2)
        bu, bv, bw = _barycentrics(x.float() * rcp, y.float() * rcp, fu0, fv0, e1u, e1v, e2u, e2v, d00, d01, d11, den)
        inside = (bu >= -mg) & (bv >= -mg) & (bw >= -mg)
        key = torch.where(inside, key_f[f], WINNER_SINK)
        winner.scatter_reduce_(0, y * resolution + x, key, "amin")
    return winner


_MAX_RES = 8191  # K8 counts a warp's candidates (32 faces of up to res^2 texels) in an int


def _winner_lib():
    fn = kernels.load("raster_winner").raster_winner_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2 + [ctypes.c_float] * 3 + [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
    return fn


def binned_winner(u0, v0, u1, v1, u2, v2, key_f, resolution: int, margin: float = 0.0) -> torch.Tensor:
    """Kernel K8 on CUDA tensors, its plain version on CPU tensors (same
    arguments and result as ``binned_winner_plain``)."""
    if not u0.is_cuda:
        return binned_winner_plain(u0, v0, u1, v1, u2, v2, key_f, resolution, margin)
    corners = [t.contiguous() for t in (u0, v0, u1, v1, u2, v2)]  # scalar loads: any 4-byte alignment
    F = u0.shape[0]
    if any(t.dtype != torch.float32 or t.shape != (F,) for t in corners):
        raise TypeError("K8 takes six flat (F,) float32 corner arrays")
    if key_f.dtype != torch.int32 or key_f.shape != (F,):
        raise TypeError(f"K8 takes (F,) int32 keys, got {tuple(key_f.shape)} {key_f.dtype}")
    if not 2 <= resolution <= _MAX_RES:
        raise ValueError(f"K8 takes a resolution from 2 to {_MAX_RES}, got {resolution}")
    dev = u0.device
    key_f = key_f.contiguous()
    winner = torch.full((resolution * resolution,), WINNER_SINK, dtype=torch.int32, device=dev)
    err = _winner_lib()(
        *(t.data_ptr() for t in corners), key_f.data_ptr(), F, resolution, texel_scale(resolution),
        _f32(margin), _f32(margin * (resolution - 1)), winner.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    kernels.check(err, "raster_winner_fwd")
    binned_winner.launches += 1
    return winner


binned_winner.launches = 0


def rasterize_device(u0, v0, u1, v1, u2, v2, resolution: int) -> torch.Tensor:
    """Per-corner UVs (flat (F,) f32 each) -> (4, res, res) f32 [bu, bv,
    bw, face id], face id -1 and zeros where no face covers the texel: the
    winner pass with face-id keys (the lowest covering face wins, the
    reference's rule), then the winner's barycentrics at each texel."""
    F = u0.shape[0]
    dev = u0.device
    if F == 0:
        empty = torch.zeros(4, resolution, resolution, device=dev)
        empty[3] = -1.0
        return empty
    winner = binned_winner(u0, v0, u1, v1, u2, v2, torch.arange(F, dtype=torch.int32, device=dev), resolution)
    hit = winner < WINNER_SINK
    wf = torch.where(hit, winner, 0).long()
    fu0, fv0, fu1, fv1, fu2, fv2 = (t[wf] for t in (u0, v0, u1, v1, u2, v2))
    idx = torch.arange(resolution * resolution, device=dev)
    rcp = texel_scale(resolution)
    xs = (idx % resolution).float() * rcp
    ys = (idx // resolution).float() * rcp
    e1u, e1v, e2u, e2v, d00, d01, d11, den = _face_terms(fu0, fv0, fu1, fv1, fu2, fv2)
    den_safe = torch.where(den.abs() < 1e-12, 1.0, den)
    bu, bv, bw = _barycentrics(xs, ys, fu0, fv0, e1u, e1v, e2u, e2v, d00, d01, d11, den_safe)
    zero = torch.zeros((), device=dev)
    rast = torch.stack(
        [torch.where(hit, bu, zero), torch.where(hit, bv, zero), torch.where(hit, bw, zero),
         torch.where(hit, wf.float(), -1.0)]
    )
    return rast.reshape(4, resolution, resolution)


def rasterize(uv: np.ndarray, faces: np.ndarray, resolution: int, device=None) -> torch.Tensor:
    """uv (Nv, 2), faces (F, 3) host arrays -> (4, res, res) on ``device``
    (the card by default; it raises without one)."""
    device = resolve_device(device)
    tri = np.asarray(uv, np.float32)[np.asarray(faces)]  # (F, 3, 2)
    corners = [torch.from_numpy(np.ascontiguousarray(tri[:, c, d])).to(device) for c in range(3) for d in range(2)]
    return rasterize_device(*corners, resolution)


def get_mask(rast: torch.Tensor) -> torch.Tensor:
    """(res, res) bool: texels covered by any face (``baker.py:59-69``)."""
    return rast[3] >= 0


def interpolate_device(attr_cf: torch.Tensor, rast: torch.Tensor, fa, fb, fc) -> torch.Tensor:
    """attr (K, Nv) channels first, face corner ids as flat tensors ->
    (K, res, res); uncovered texels are 0."""
    res = rast.shape[-1]
    tid = rast[3].to(torch.int64).clamp_min(0).flatten()
    valid = (rast[3] >= 0).flatten()
    out = (
        attr_cf[:, fa[tid]] * rast[0].flatten()[None, :]
        + attr_cf[:, fb[tid]] * rast[1].flatten()[None, :]
        + attr_cf[:, fc[tid]] * rast[2].flatten()[None, :]
    )
    return torch.where(valid[None, :], out, 0.0).reshape(-1, res, res)


def interpolate(attr: np.ndarray, rast: torch.Tensor, faces: np.ndarray) -> torch.Tensor:
    """Per-vertex attributes (Nv, K) and faces (F, 3) on the host ->
    (K, res, res) on the rast's device; uncovered texels are 0."""
    dev = rast.device
    attr_cf = torch.from_numpy(np.ascontiguousarray(np.asarray(attr, np.float32).T)).to(dev)
    f = torch.from_numpy(np.asarray(faces, np.int64)).to(dev)
    return interpolate_device(attr_cf, rast, f[:, 0], f[:, 1], f[:, 2])


def _box3_sum(x: torch.Tensor) -> torch.Tensor:
    """3x3 neighbourhood sums of (K, H, W), zero outside (a ones-kernel
    convolution, written as shifted adds so no TF32 path can round it)."""
    H, W = x.shape[-2:]
    p = torch.nn.functional.pad(x, (1, 1, 1, 1))
    out = torch.zeros_like(x)
    for dy in range(3):
        for dx in range(3):
            out = out + p[..., dy : dy + H, dx : dx + W]
    return out


def dilate_fill(img: torch.Tensor, mask: torch.Tensor, iterations: int) -> torch.Tensor:
    """UV island edge padding (``sf3d/models/utils.py:96-133``): each
    iteration fills the empty texels beside valid ones with the mean of
    their valid 3x3 neighbours. img (K, res, res), mask (res, res) bool."""
    for _ in range(max(int(iterations), 1)):
        m = mask.to(img.dtype)[None]
        neigh_sum = _box3_sum(img * m)
        neigh_cnt = _box3_sum(m)[0]
        fill = neigh_sum / torch.clamp(neigh_cnt, min=1.0)[None]
        img = torch.where(mask[None], img, fill)
        mask = mask | (neigh_cnt > 0)
    return img


def float32_to_uint8(
    arr: np.ndarray, dither: bool = True, dither_mask: Optional[np.ndarray] = None, seed: int = 0,
    noise: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Quantize a [0, 1] float image to uint8 with optional dithering
    (``sf3d/models/utils.py:136-149``); the dither noise is numpy's
    ``default_rng(seed)`` uniform unless ``noise`` is given."""
    arr = np.clip(np.asarray(arr, np.float32), 0.0, 1.0)
    if dither:
        if noise is None:
            noise = (np.random.default_rng(seed).random(arr.shape, dtype=np.float32) - 0.5) / 255.0
        if dither_mask is not None:
            noise = noise * (1.0 - dither_mask)
        arr = np.clip(arr + noise, 0.0, 1.0)
    return (arr * 255.0 + 0.5).astype(np.uint8)
