"""Cube-projection UV unwrap on the device.

Counterpart of ``sculptmate_tpu/geometry/uv_unwrap_device.py``: the per-face
unwrap (box assignment, slice rotation, overlap resolution, atlas packing)
with only the 3x3 PCA rotation on the host. Kernel K9
(``csrc/uv_unwrap.cu``) on CUDA tensors, ``unwrap_core_plain`` on CPU
tensors; both return per-corner f32 UVs, which the host uses as they come
(no u16 wire, no host reconstruction).

The stages, each a pass over the faces:

1. the vertex bbox; each face's geometric normal, its cube slice (the
   argmax over the six signed axes), its depth along the slice's axis, and
   the per-corner-slot max of the projection axis over all faces (the
   reference's quirk);
2. the projected corner UVs, and per slice the sums of the faces' tangents
   and of their expected tangents, reduced in a fixed order (no order of
   atomics enters a result) into each slice's rotation angle;
3. each slice rotated by that angle, then normalised by its min/max over
   both UV components (``atomicMin`` / ``atomicMax`` on sortable ints);
4. two depth-visibility rounds, each a K8 raster of the participating faces
   into a 4x4 grid of slice cells (key ~sortable(depth): the deepest face
   wins) and a test of each face at its own centroid texel with a per-slice
   depth tolerance of 0.02 of the participants' depth range (round 0: all
   faces; round 1: the faces round 0 hid);
5. placement: primary slices on a 3x2 grid, demoted ones rescaled into the
   half-scale overlap cells, twice-demoted faces into individual squares of
   the pool (its running index is a prefix sum over the pool flags).

On the card (``csrc/uv_unwrap.cu``) one call launches the whole chain:
about ten passes, the angles and the pool's prefix among them, and the two
rasters as K8's unwrap form, which forms each face's corners and key from
the rotated UVs, the face's slice and that slice's lo/hi. Nothing between
the passes is a PyTorch op, and nothing waits for the host.
``unwrap_slices_plain`` and ``unwrap_round`` hold that decomposition to
``unwrap_core_plain``.

Two choices differ from the JAX program, both deliberately:

- a slice's lo/hi are gathered by the face's slice index. The JAX program
  looks them up with a one-hot product, where an empty slice's +-inf times
  0 makes every face's UV NaN (``uv_unwrap_device.py:306-325`` there);
- the UVs are not quantized to u16 on the device.

Divisions of the JAX program by a Python constant are products with the
f32 reciprocal here, as XLA computes them.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from sculptmate_tpu_torch.geometry.texture_bake import WINNER_SINK, binned_winner, binned_winner_plain
from sculptmate_tpu_torch.geometry.uv_unwrap import _FACE_RULES, _main_axis_rotation
from sculptmate_tpu_torch.runtime import kernels
from sculptmate_tpu_torch.runtime.device import resolve_device

RASTER_RES = 1024  # 4x4 grid of slice cells, 256^2 each
_CELL_INSET = 0.05  # keeps the barycentric margin's coverage inside each cell
_MARGIN = 0.05  # barycentric slack of the visibility raster
_DEPTH_TOL = 0.02  # share of a slice's depth range a face may lie behind the winner


def _f32(x: float) -> float:
    return float(np.float32(x))


_THIRD = _f32(np.float32(1.0) / np.float32(3.0))
_SPAN = _f32(1.0 - 2.0 * _CELL_INSET)


def _sortable(d: torch.Tensor) -> torch.Tensor:
    """f32 -> int32, monotonic in the float ordering."""
    i = d.float().contiguous().view(torch.int32)
    return torch.where(i >= 0, i, i ^ 0x7FFFFFFF)


def _unsortable(s: torch.Tensor) -> torch.Tensor:
    return torch.where(s >= 0, s, s ^ 0x7FFFFFFF).contiguous().view(torch.float32)


def _warp(c: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """A slice's [0, 1] UV into its cell of the 4x4 raster grid."""
    return (c.clamp(0.0, 1.0) * _SPAN + _CELL_INSET + g) * 0.25


def _angles(sums: torch.Tensor) -> torch.Tensor:
    """Per-slice sums (6, 7) [tangent xyz, expected tangent xyz, count] ->
    (2, 6) [cos, sin] of each slice's rotation angle."""
    cnt = sums[:, 6].clamp_min(1e-12)
    am = [sums[:, d] / cnt for d in range(3)]
    em = [sums[:, 3 + d] / cnt for d in range(3)]
    dot = am[0] * em[0] + am[1] * em[1] + am[2] * em[2]
    cross2 = am[0] * em[1] - am[1] * em[0]
    ang = torch.atan2(cross2, dot)
    return torch.stack([torch.cos(ang), torch.sin(ang)])


def _pool_grid(n_rem: torch.Tensor):
    """The individual-square pool's grid from its face count (a device
    scalar): (columns, rows, cell width, cell height, size floor)."""
    ratio = 0.5 * (1.0 / 3.0)
    mult = torch.sqrt(n_rem.float().clamp_min(1.0) * _f32(np.float32(1.0) / np.float32(ratio)))
    nw = torch.ceil(0.5 * mult).to(torch.int64).clamp_min(1)
    nh = torch.div(n_rem + nw - 1, nw, rounding_mode="floor").clamp_min(1)
    nwf, nhf = nw.float(), nh.float()
    width, height = 1.0 / nwf, 1.0 / nhf
    return nwf, nhf, width, height, torch.minimum(width, height) * 1.5


def unwrap_core_plain(
    px: torch.Tensor, py: torch.Tensor, pz: torch.Tensor, fa: torch.Tensor, fb: torch.Tensor, fc: torch.Tensor,
    island_padding: float = 0.02, angles: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of kernel K9, its visibility rasters on the plain
    version of K8 (so no kernel runs in it). Rotated vertex positions as three flat
    (Nv,) f32 rows and the faces' corner ids as flat (F,) int rows ->
    (uv (6, F) f32 rows [u0, v0, u1, v1, u2, v2], atlas_index (F,) int32 =
    slice + 6 x visibility class, angles (2, 6) f32 [cos, sin]).

    ``angles``, when given, replaces the slices' rotation (the one result
    that depends on the order of a sum), so that a check can hold every
    other stage of the kernel to this version exactly."""
    index, depth, r6, lo6, hi6, angles = unwrap_slices_plain(px, py, pz, fa, fb, fc, angles)
    lo, hi = lo6[index.long()], hi6[index.long()]  # a gather: an empty slice is never looked up
    scale = (hi - lo).clamp_min(1e-12)
    uc = [(c - lo) / scale for c in r6[:3]]
    vc = [(c - lo) / scale for c in r6[3:]]

    # -- overlap resolution: two depth-visibility rounds --------------------
    everyone = torch.ones_like(depth, dtype=torch.bool)
    vis1 = _depth_round_plain(uc, vc, index, depth, everyone)
    vis2 = _depth_round_plain(uc, vc, index, depth, ~vis1)
    atlas = torch.where(vis1, index, torch.where(vis2, index + 6, index + 12))
    return _place_plain(uc, vc, atlas, island_padding), atlas, angles


def unwrap_slices_plain(
    px: torch.Tensor, py: torch.Tensor, pz: torch.Tensor, fa: torch.Tensor, fb: torch.Tensor, fc: torch.Tensor,
    angles: Optional[torch.Tensor] = None,
):
    """``unwrap_core_plain``'s stages before the visibility rounds (K9's
    passes up to ``faces_rotate``), same arguments -> (index (F,) int32,
    depth (F,) f32, the rotated UVs (6, F) f32 rows [u0, u1, u2, v0, v1,
    v2], not yet normalised, each slice's lo (6,) and hi (6,) over both
    components, angles (2, 6))."""
    dev = px.device
    fa, fb, fc = (f.long() for f in (fa, fb, fc))
    P = torch.stack([px, py, pz]).float()
    bb_min, bb_max = P.amin(1), P.amax(1)
    rngs = torch.clamp(bb_max - bb_min, min=1e-12)
    vp = 2.0 * (P - bb_min[:, None]) / rngs[:, None] - 1.0
    tri = [vp[:, f] for f in (fa, fb, fc)]  # corner -> (3 axes, F)
    half = rngs * 0.5
    e1 = [(tri[1][d] - tri[0][d]) * half[d] for d in range(3)]
    e2 = [(tri[2][d] - tri[0][d]) * half[d] for d in range(3)]
    n = [e1[1] * e2[2] - e1[2] * e2[1], e1[2] * e2[0] - e1[0] * e2[2], e1[0] * e2[1] - e1[1] * e2[0]]
    n_len = torch.sqrt(n[0] * n[0] + n[1] * n[1] + n[2] * n[2]).clamp_min(1e-12)
    n = [c / n_len for c in n]
    index = torch.argmax(torch.stack([n[0], -n[0], n[1], -n[1], n[2], -n[2]]), dim=0).to(torch.int32)

    rules = torch.tensor(_FACE_RULES, dtype=torch.int64, device=dev)[index.long()]  # (F, 6)
    ax, ua, va = rules[:, 0], rules[:, 2], rules[:, 4]
    sgn, us, vs = (rules[:, k].float() for k in (1, 3, 5))

    def pick(corner, axis):
        return tri[corner].gather(0, axis[None])[0]

    mdd = [pick(c, ax).abs().amax() for c in range(3)]  # the reference's per-corner-slot max
    uc = [((us * pick(c, ua) / mdd[c] + 1.0) * 0.5).clamp(0.0, 1.0) for c in range(3)]
    vc = [((vs * pick(c, va) / mdd[c] + 1.0) * 0.5).clamp(0.0, 1.0) for c in range(3)]

    # -- slice rotation: per-face tangents against the expected ones -------
    du1, dv1, du2, dv2 = uc[1] - uc[0], vc[1] - vc[0], uc[2] - uc[0], vc[2] - vc[0]
    denom_t = (du1 * dv2 - dv1 * du2).clamp_min(1e-6)
    t = [((tri[1][d] - tri[0][d]) * dv2 - (tri[2][d] - tri[0][d]) * dv1) / denom_t for d in range(3)]
    t_len = torch.sqrt(t[0] * t[0] + t[1] * t[1] + t[2] * t[2]).clamp_min(1e-12)
    t = [c / t_len for c in t]
    ndot = t[0] * n[0] + t[1] * n[1] + t[2] * n[2]
    t = [c - ndot * nc for c, nc in zip(t, n)]
    t_len = torch.sqrt(t[0] * t[0] + t[1] * t[1] + t[2] * t[2]).clamp_min(1e-12)
    t = [c / t_len for c in t]

    def expected(corner):
        praw = [(tri[corner][d] + 1.0) * half[d] + bb_min[d] for d in range(3)]
        prx, pry = -praw[1], praw[0]
        cx, cy, cz = pry * n[2], -prx * n[2], prx * n[1] - pry * n[0]
        ex, ey, ez = n[1] * cz - n[2] * cy, n[2] * cx - n[0] * cz, n[0] * cy - n[1] * cx
        e_len = torch.sqrt(ex * ex + ey * ey + ez * ez).clamp_min(1e-12)
        return [ex / e_len, ey / e_len, ez / e_len]

    e_c = [expected(c) for c in range(3)]
    em = [(e_c[0][d] + e_c[1][d] + e_c[2][d]) * _THIRD for d in range(3)]
    vals = torch.stack(t + em + [torch.ones_like(t[0])])  # (7, F)
    sums = torch.zeros(6, 7, device=dev).index_add_(0, index.long(), vals.t())
    angles = _angles(sums) if angles is None else angles
    ca, sa = angles[0][index.long()], angles[1][index.long()]
    cu = [c * 2.0 - 1.0 for c in uc]
    cv = [c * 2.0 - 1.0 for c in vc]
    ru = [ca * cu[c] - sa * cv[c] for c in range(3)]
    rv = [sa * cu[c] + ca * cv[c] for c in range(3)]
    r6 = torch.stack(ru + rv)  # (6, F)
    inf = torch.full((6,), float("inf"), device=dev)
    lo6 = inf.scatter_reduce(0, index.long(), r6.amin(0), "amin")
    hi6 = (-inf).scatter_reduce(0, index.long(), r6.amax(0), "amax")
    depth = sgn * (pick(0, ax) + pick(1, ax) + pick(2, ax)) * _THIRD
    return index, depth, r6, lo6, hi6, angles


def _depth_round_plain(uc, vc, index, depth, participate) -> torch.Tensor:
    """One visibility round (``_depth_round`` in the JAX package)."""
    dev = depth.device
    gx, gy = (index % 4).float(), (index // 4).float()
    zero = torch.zeros((), device=dev)
    u = [torch.where(participate, _warp(c, gx), zero) for c in uc]
    v = [torch.where(participate, _warp(c, gy), zero) for c in vc]
    key = torch.where(participate, ~_sortable(depth), WINNER_SINK - 1)
    winner = binned_winner_plain(u[0], v[0], u[1], v[1], u[2], v[2], key, RASTER_RES, _MARGIN)
    slot = torch.where(participate, index.long(), 6)  # non-participants land in a 7th, unused slot
    inf = torch.full((7,), float("inf"), device=dev)
    dmax = (-inf).scatter_reduce(0, slot, depth, "amax")[:6]
    dmin = inf.scatter_reduce(0, slot, depth, "amin")[:6]
    eps = (_DEPTH_TOL * (dmax - dmin).clamp_min(1e-6))[index.long()]
    s = float(RASTER_RES - 1)
    cen_u = _warp((uc[0] + uc[1] + uc[2]) * _THIRD, gx)
    cen_v = _warp((vc[0] + vc[1] + vc[2]) * _THIRD, gy)
    cx = torch.round(cen_u * s).to(torch.int64).clamp(0, RASTER_RES - 1)
    cy = torch.round(cen_v * s).to(torch.int64).clamp(0, RASTER_RES - 1)
    wkey = winner[cy * RASTER_RES + cx]
    covered = wkey < WINNER_SINK - 1
    return ~covered | (_unsortable(~wkey) <= depth + eps)


def _place_plain(uc, vc, atlas, pad: float) -> torch.Tensor:
    """Atlas placement -> (6, F) rows [u0, v0, u1, v1, u2, v2]."""
    dev = atlas.device
    idx6 = (atlas % 6).long()
    block = atlas // 6
    pool = atlas >= 12
    xs = torch.tensor([0.0, 1.0, 2.0, 0.0, 1.0, 2.0], device=dev)
    ys = torch.tensor([0.0, 0.0, 0.0, 1.0, 1.0, 1.0], device=dev)
    zero = torch.zeros((), device=dev)
    xv, yv = torch.where(pool, zero, xs[idx6]), torch.where(pool, zero, ys[idx6])
    off, dupl = _f32(1.0 / 3.0), _f32(1.0 / 6.0)
    offset_x = torch.where(block == 0, off * xv, dupl * xv + torch.clamp(block - 1, max=1).float() * 0.5)
    offset_y = torch.where(block == 0, off * yv, dupl * yv + _f32(off * 2))
    div_x = torch.where(pool, 2.0, torch.where(atlas >= 6, 6.0, 3.0))
    div_y = torch.where(pool, 3.0, torch.where(atlas >= 6, 6.0, 3.0))

    # overlap slices 6..11: rescaled to fill their cell, at most 2x
    inf = torch.full((13,), float("inf"), device=dev)
    slot = torch.where((atlas >= 6) & ~pool, atlas - 6, 12).long()
    u3, v3 = torch.stack(uc), torch.stack(vc)
    ulo = inf.scatter_reduce(0, slot, u3.amin(0), "amin")[slot]
    uhi = (-inf).scatter_reduce(0, slot, u3.amax(0), "amax")[slot]
    vlo = inf.scatter_reduce(0, slot, v3.amin(0), "amin")[slot]
    vhi = (-inf).scatter_reduce(0, slot, v3.amax(0), "amax")[slot]
    over = slot < 12
    uc = [torch.where(over, (c - ulo) / torch.clamp(uhi - ulo, min=0.5), c) for c in uc]
    vc = [torch.where(over, (c - vlo) / torch.clamp(vhi - vlo, min=0.5), c) for c in vc]
    uc = [(c * _f32(1 - 2 * pad) + _f32(pad)).clamp(0.0, 1.0) for c in uc]
    vc = [(c * _f32(1 - 2 * pad) + _f32(pad)).clamp(0.0, 1.0) for c in vc]

    # individual squares (atlas >= 12), the reference's pool layout
    rem = pool.to(torch.int32)
    nwf, nhf, width, height, clip_val = _pool_grid(rem.sum())
    ids = (torch.cumsum(rem, 0) - 1).float()
    col = torch.remainder(ids, nwf) * width
    row = torch.floor(ids / nwf) * height
    ulo = torch.minimum(torch.minimum(uc[0], uc[1]), uc[2])
    uhi = torch.maximum(torch.maximum(uc[0], uc[1]), uc[2])
    vlo = torch.minimum(torch.minimum(vc[0], vc[1]), vc[2])
    vhi = torch.maximum(torch.maximum(vc[0], vc[1]), vc[2])

    def place(c, lo, hi, nf, w, cell_off):
        r = (c - lo) / torch.maximum(hi - lo, clip_val)
        r = (r * (1.0 - _f32(pad) * nf * 0.5) + _f32(pad) * nf * 0.25).clamp(0.0, 1.0)
        r = r * w + cell_off
        return (r * _f32(1 - pad) + _f32(pad * 0.5)).clamp(0.0, 1.0)

    uc = [torch.where(pool, place(c, ulo, uhi, nwf, width, col), c) for c in uc]
    vc = [torch.where(pool, place(c, vlo, vhi, nhf, height, row), c) for c in vc]
    rows = []
    for c in range(3):
        rows += [uc[c] / div_x + offset_x, vc[c] / div_y + offset_y]
    return torch.stack(rows)


def round_inputs_plain(uv_rot, index, depth, lo6, hi6, participate):
    """Plain version of K8's unwrap-form loader: the corners and keys of
    one visibility round from the rotated, not yet normalised UVs (6, F)
    rows [u0, u1, u2, v0, v1, v2], each face's slice and depth, and the
    slices' lo/hi -> (corners (6, F) f32 rows [u0, v0, u1, v1, u2, v2],
    keys (F,) int32). A face outside ``participate`` gets zero corners (it
    covers nothing) and the key WINNER_SINK - 1, as in
    ``_depth_round_plain``."""
    ix = index.long()
    lo, hi = lo6[ix], hi6[ix]
    scale = (hi - lo).clamp_min(1e-12)
    gx, gy = (index % 4).float(), (index // 4).float()
    zero = torch.zeros((), device=depth.device)
    rows = []
    for c in range(3):
        rows.append(torch.where(participate, _warp((uv_rot[c] - lo) / scale, gx), zero))
        rows.append(torch.where(participate, _warp((uv_rot[3 + c] - lo) / scale, gy), zero))
    return torch.stack(rows), torch.where(participate, ~_sortable(depth), WINNER_SINK - 1)


# -- kernel K9 -----------------------------------------------------------------

_STATS = 72  # int32 slots of K9's stats; the slices' lo at 9, hi at 15 (sortable)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _fn(name: str, argtypes, restype=ctypes.c_int):
    fn = getattr(kernels.load("uv_unwrap"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = restype
    return fn


def unwrap_round(uv_rot, index, depth, lo6, hi6, vis0=None):
    """One visibility round's raster alone: K8's unwrap form on CUDA
    tensors, ``round_inputs_plain`` and ``binned_winner_plain`` on CPU
    ones. Round 0 (``vis0`` None) takes every face, round 1 the faces
    hidden in round 0 (``vis0`` (F,) bool). Arguments as
    ``round_inputs_plain``'s -> (corners (6, F), keys (F,), the 1024^2
    winner). ``unwrap_core`` runs the same loader and raster inside its
    chain; this entry lets a check hold them to the plain version."""
    part = torch.ones_like(depth, dtype=torch.bool) if vis0 is None else ~vis0
    if not depth.is_cuda:
        corners, key = round_inputs_plain(uv_rot, index, depth, lo6, hi6, part)
        return corners, key, binned_winner_plain(*corners, key, RASTER_RES, _MARGIN)
    dev, F = depth.device, depth.shape[0]
    stats = torch.zeros(_STATS, dtype=torch.int32, device=dev)
    stats[9:15] = _sortable(lo6)
    stats[15:21] = _sortable(hi6)
    nw = -(-F // 32)
    bits = torch.zeros(nw * 32, dtype=torch.int64, device=dev)
    if vis0 is not None:
        bits[:F] = vis0.long()
    words = (bits.view(nw, 32) << torch.arange(32, device=dev)).sum(1).to(torch.int32)
    corners = torch.empty(6, F, dtype=torch.float32, device=dev)
    key = torch.empty(F, dtype=torch.int32, device=dev)
    winner = torch.full((RASTER_RES * RASTER_RES,), WINNER_SINK, dtype=torch.int32, device=dev)
    inputs = [uv_rot.float().contiguous(), index.to(torch.int32).contiguous(), depth.float().contiguous()]
    err = _fn("uw_round", [_P] * 5 + [_I, _I] + [_P] * 4)(
        *(t.data_ptr() for t in inputs), stats.data_ptr(), words.data_ptr(), F, 0 if vis0 is None else 1,
        corners.data_ptr(), key.data_ptr(), winner.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(err, "uw_round")
    binned_winner.launches += 1
    return corners, key, winner


def unwrap_core(px, py, pz, fa, fb, fc, island_padding: float = 0.02):
    """Kernel K9 on CUDA tensors (``unwrap_core_plain``'s stages as one
    chain of passes over the faces, its two visibility rasters K8's unwrap
    form), its plain version on CPU tensors; same arguments and results.
    No host sync: the whole chain is launched by one call."""
    if not px.is_cuda:
        return unwrap_core_plain(px, py, pz, fa, fb, fc, island_padding)
    dev = px.device
    Nv, F = px.shape[0], fa.shape[0]
    out = torch.empty(F, 6, dtype=torch.float32, device=dev)
    atlas = torch.empty(F, dtype=torch.int32, device=dev)
    if F == 0:  # no face, no slice to rotate
        return out.t(), atlas, torch.stack([torch.ones(6, device=dev), torch.zeros(6, device=dev)])
    angles = torch.empty(2, 6, dtype=torch.float32, device=dev)
    pos = [t.float().contiguous() for t in (px, py, pz)]
    corners = [t.to(torch.int32).contiguous() for t in (fa, fb, fc)]
    ws = torch.empty(_fn("uw_workspace_words", [_I], ctypes.c_longlong)(F), dtype=torch.int32, device=dev)
    pad = island_padding
    err = _fn("uw_unwrap", [_P] * 3 + [_I] + [_P] * 3 + [_I] + [_F] * 4 + [_P] * 5)(
        *(t.data_ptr() for t in pos), Nv, *(t.data_ptr() for t in corners), F, _f32(pad), _f32(1 - 2 * pad),
        _f32(1 - pad), _f32(pad * 0.5), ws.data_ptr(), out.data_ptr(), atlas.data_ptr(), angles.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(err, "uw_unwrap")
    unwrap_core.launches += 1
    binned_winner.launches += 2  # the two visibility rasters are K8's
    return out.t(), atlas, angles


unwrap_core.launches = 0


def unwrap_device(
    v_pos: np.ndarray,
    faces: np.ndarray,
    island_padding: float = 0.02,
    return_flat: bool = False,
    device=None,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Device unwrap of a host mesh on ``device`` (the card by default; it
    raises without one, ``device="cpu"`` runs the plain version). Returns
    (unique_uv (U, 2) f32, vtex_idx (F, 3)) like ``uv_unwrap.unwrap``, or
    with ``return_flat`` the per-corner UVs (F, 3, 2) f32 and None. The
    host applies the PCA rotation only."""
    dev = resolve_device(device)
    v_pos = np.asarray(v_pos, np.float32)
    faces = np.asarray(faces, np.int64)
    rp = v_pos @ _main_axis_rotation(v_pos).T
    pos = torch.from_numpy(np.ascontiguousarray(rp.T)).to(dev)
    f = torch.from_numpy(np.ascontiguousarray(faces.T, np.int32)).to(dev)
    uv6, _, _ = unwrap_core(pos[0], pos[1], pos[2], f[0], f[1], f[2], island_padding)
    uv_flat = uv6.t().reshape(-1, 3, 2).cpu().numpy()
    if return_flat:
        return uv_flat, None
    if len(faces) == 0:
        return np.zeros((0, 2), np.float32), np.zeros((0, 3), np.int64)
    unique_uv, inverse = np.unique(uv_flat.reshape(-1, 2) + 0.0, axis=0, return_inverse=True)
    return unique_uv.astype(np.float32), inverse.reshape(-1, 3)

