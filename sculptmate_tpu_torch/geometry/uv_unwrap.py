"""Cube-projection UV unwrapping (host).

A copy of ``sculptmate_tpu/geometry/uv_unwrap.py``; the overlap painter is
``native/unwrap_overlap.cpp``, built on first use.

Reimplements the reference ``sf3d/uv_unwrapper/unwrap.py:643-697`` pipeline in
vectorized numpy, including the part the reference hides in a closed-source
Windows DLL (``assign_faces_uv_to_atlas_index``, ``unwrap.py:144-175``):

1. PCA-align the mesh with the canonical axes (``unwrap.py:565-641``).
2. Assign each face to one of 6 cube faces by dominant averaged normal;
   project the two in-plane coords to UV (``unwrap.py:16-123``).
3. Rotate each cube-face slice into a consistent tangent space
   (``unwrap.py:307-382``).
4. Resolve projection overlaps: faces occluded along the projection axis move
   to a secondary slice, twice-occluded faces get individual squares. The DLL
   is replaced by a depth-buffer visibility test: rasterize each slice with a
   max-depth buffer (reusing the texture-bake rasterizer's math) and demote
   faces that never win their own centroid texel.
5. Pack the atlas: 3x2 grid of primary slices, half-scale overlap slices
   along the top of the bottom third, individual squares in the bottom-right
   block (``unwrap.py:177-237,384-503``).
6. Dedup identical UVs (``unwrap.py:545-563``).

Returns (unique_uv (U, 2), vtex_idx (F, 3)) like the reference forward.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

# per cube face: (projection axis, sign, u coord axis, u sign, v coord axis, v sign)
# from unwrap.py:86-116
_FACE_RULES = [
    (0, +1, 1, +1, 2, -1),  # +x
    (0, -1, 1, +1, 2, -1),  # -x
    (1, +1, 0, +1, 2, -1),  # +y
    (1, -1, 0, +1, 2, -1),  # -y
    (2, +1, 0, +1, 1, +1),  # +z
    (2, -1, 0, +1, 1, -1),  # -z
]


def _align_with_main_axis(v_pos: np.ndarray, v_nrm: np.ndarray):
    rot = _main_axis_rotation(v_pos)
    return v_pos @ rot.T, v_nrm @ rot.T


def _main_axis_rotation(v_pos: np.ndarray) -> np.ndarray:
    """The PCA axis-alignment rotation (``unwrap.py:565-641`` semantics):
    returns ``rot`` with rotated = v @ rot.T (so world = rotated @ rot)."""
    centered = v_pos - v_pos.mean(0, keepdims=True)
    # top-2 principal directions via the 3x3 covariance eigendecomposition —
    # same axes as the reference's (randomized) torch.pca_lowrank, O(N)
    # instead of a full (N, 3) SVD on the single host core
    cov = (centered.T.astype(np.float64) @ centered.astype(np.float64))
    evals, evecs = np.linalg.eigh(cov)  # ascending
    vt = evecs[:, ::-1].T.astype(np.float32)  # rows = descending components
    main_axis = vt[0]
    second = vt[1]
    main_axis = main_axis / max(np.linalg.norm(main_axis), 1e-6)
    second = second - (second @ main_axis) * main_axis
    second = second / max(np.linalg.norm(second), 1e-6)
    third = np.cross(main_axis, second)
    third = third / max(np.linalg.norm(third), 1e-6)

    idxs = [int(np.abs(a).argmax()) for a in (main_axis, second, third)]
    # resolve collisions like the reference (assign missing axis to the
    # least-important vector first)
    cur = 1
    while len(set(idxs)) != 3:
        missing = ({0, 1, 2} - set(idxs)).pop()
        if cur == 1:
            idxs[2] = missing
        elif cur == 2:
            idxs[1] = missing
        else:
            raise ValueError("could not find 3 unique axes")
        cur += 1

    axes = [None] * 3
    for a, i in zip((main_axis, second, third), idxs):
        axes[i] = a
    rot = np.stack(axes, axis=1).T.astype(np.float32)
    # force a PROPER rotation (det +1): eigh's arbitrary eigenvector signs
    # and the axis-slot permutation can yield a reflection, under which
    # cross products flip relative to rotated vectors — the device unwrap
    # derives geometric face normals in the rotated frame and needs the
    # winding orientation preserved (the reference's randomized PCA basis
    # is orientation-arbitrary too, so flipping one axis is free)
    if float(np.linalg.det(rot.astype(np.float64))) < 0.0:
        rot[2] = -rot[2]
    return rot


def _box_assign(v_pos, v_nrm, faces):
    bbox_min = v_pos.min(0)
    bbox_max = v_pos.max(0)
    vp = 2.0 * (v_pos - bbox_min) / np.maximum(bbox_max - bbox_min, 1e-12) - 1.0

    tri = vp[faces]  # (F, 3, 3)
    tri_nrm = v_nrm[faces]
    face_normal = tri_nrm.sum(1)
    face_normal = face_normal / np.maximum(
        np.linalg.norm(face_normal, axis=-1, keepdims=True), 1e-6
    )

    axes = np.array(
        [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
        np.float32,
    )
    index = (face_normal @ axes.T).argmax(-1)  # (F,)

    # gather per-face rule components (one pass; the 6x boolean-mask loop
    # copied whole (F, 3, 3) arrays per rule and cost ~2 s at 700K faces)
    rules = np.asarray(_FACE_RULES, np.int64)  # (6, 6)
    F = len(faces)
    ar = np.arange(F)
    ax_f = rules[index, 0]
    ua_f, us_f = rules[index, 2], rules[index, 3].astype(np.float32)
    va_f, vs_f = rules[index, 4], rules[index, 5].astype(np.float32)
    max_axis = np.abs(tri[ar[:, None], np.arange(3)[None, :], ax_f[:, None]])
    uc = us_f[:, None] * tri[ar[:, None], np.arange(3)[None, :], ua_f[:, None]]
    vc = vs_f[:, None] * tri[ar[:, None], np.arange(3)[None, :], va_f[:, None]]

    # reference quirk: normalization by the per-corner-slot max over all faces
    max_dim_div = max_axis.max(axis=0, keepdims=True)
    uc = np.clip((uc / max_dim_div + 1.0) * 0.5, 0, 1)
    vc = np.clip((vc / max_dim_div + 1.0) * 0.5, 0, 1)
    return np.stack([uc, vc], axis=-1), index, vp


def _face_tangents_from_uv(v_pos, v_nrm, faces, face_uv):
    pos = [v_pos[faces[:, i]] for i in range(3)]
    tex = [face_uv[:, i] for i in range(3)]
    duv1 = tex[1] - tex[0]
    duv2 = tex[2] - tex[0]
    dpos1 = pos[1] - pos[0]
    dpos2 = pos[2] - pos[0]
    tng_nom = dpos1 * duv2[:, 1:2] - dpos2 * duv1[:, 1:2]
    denom = duv1[:, 0:1] * duv2[:, 1:2] - duv1[:, 1:2] * duv2[:, 0:1]
    tang = tng_nom / np.clip(denom, 1e-6, None)

    from sculptmate_tpu_torch.geometry.mesh import _scatter_add_rows

    tangents = np.zeros_like(v_nrm)
    tansum = np.zeros_like(v_nrm)
    ones = np.ones_like(tang)
    for c in range(3):
        _scatter_add_rows(tangents, faces[:, c], tang)
        _scatter_add_rows(tansum, faces[:, c], ones)
    tangents = tangents / np.maximum(tansum, 1e-12)
    tangents = tangents / np.maximum(np.linalg.norm(tangents, axis=1, keepdims=True), 1e-12)
    tangents = tangents - (tangents * v_nrm).sum(-1, keepdims=True) * v_nrm
    return tangents / np.maximum(np.linalg.norm(tangents, axis=1, keepdims=True), 1e-12)


def _rotate_slices(v_pos, v_nrm, faces, uv, index):
    tangents = _face_tangents_from_uv(v_pos, v_nrm, faces, uv)
    pos_rot = np.stack(
        [-v_pos[:, 1], v_pos[:, 0], np.zeros_like(v_pos[:, 0])], axis=-1
    )
    expected = np.cross(v_nrm, np.cross(pos_rot, v_nrm))
    expected = expected / np.maximum(np.linalg.norm(expected, axis=-1, keepdims=True), 1e-12)

    actual_f = tangents[faces]  # (F, 3, 3)
    expected_f = expected[faces]

    uv = uv.copy()
    for i in range(6):
        m = (index % 6) == i
        if not m.any():
            continue
        am = actual_f[m].mean(axis=(0, 1))
        em = expected_f[m].mean(axis=(0, 1))
        dot = float(am @ em)
        cross = float(am[0] * em[1] - am[1] * em[0])
        ang = math.atan2(cross, dot)
        c, s = math.cos(ang), math.sin(ang)
        R = np.array([[c, -s], [s, c]], np.float32)
        cur = uv[m] * 2.0 - 1.0
        cur = cur @ R.T
        lo, hi = cur.min(), cur.max()
        uv[m] = (cur - lo) / max(hi - lo, 1e-12)
    return uv


def assign_atlas_index(
    vp_normalized: np.ndarray,
    faces: np.ndarray,
    face_uv: np.ndarray,
    face_index: np.ndarray,
    depth_res: int = 256,
) -> np.ndarray:
    """Overlap resolution (replaces the reference's closed-source DLL).

    For each cube-face slice: rasterize all of its faces into a max-depth
    buffer (depth = signed coordinate toward that cube face) with conservative
    bbox coverage; a face stays primary if it wins the depth contest at its
    own centroid texel, is demoted to the overlap slice (+6) otherwise, and
    to the individual-squares pool (12) if occluded again.
    """
    F = len(faces)
    out = np.asarray(face_index, np.int64).copy()
    tri_depth_all = vp_normalized[faces]  # (F, 3, 3) normalized positions

    # native painter's loop (the per-face Python loop costs ~10s+ at 700K
    # faces); numpy fallback below keeps identical semantics
    from sculptmate_tpu_torch.geometry.native import load_native

    lib = load_native("unwrap_overlap")
    if lib is not None:
        import ctypes

        depth_all = np.empty(F, np.float32)
        for g in range(6):
            ax, sgn = _FACE_RULES[g][0], _FACE_RULES[g][1]
            sel = face_index == g
            depth_all[sel] = sgn * tri_depth_all[sel][..., ax].mean(-1)
        fn = lib.assign_faces_uv_to_atlas_index
        fn.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int64),
        ]
        fn.restype = None
        uv_c = np.ascontiguousarray(face_uv, np.float32)
        fi_c = np.ascontiguousarray(face_index, np.int64)
        fn(
            uv_c.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            depth_all.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            fi_c.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            F, depth_res,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        return out

    for g in range(6):
        ax, sgn = _FACE_RULES[g][0], _FACE_RULES[g][1]
        sel = np.flatnonzero(face_index == g)
        if len(sel) <= 1:
            continue
        uv = face_uv[sel]  # (n, 3, 2)
        depth = sgn * tri_depth_all[sel][..., ax].mean(-1)  # (n,) higher = closer

        remaining = sel
        uv_r = uv
        depth_r = depth
        for round_i in range(2):
            winner = _depth_visibility(uv_r, depth_r, depth_res)
            occluded = ~winner
            if not occluded.any():
                break
            if round_i == 0:
                out[remaining[occluded]] = g + 6
            else:
                out[remaining[occluded]] = 12
            remaining = remaining[occluded]
            uv_r = uv_r[occluded]
            depth_r = depth_r[occluded]
    return out


def _depth_visibility(uv: np.ndarray, depth: np.ndarray, res: int) -> np.ndarray:
    """uv (n, 3, 2), depth (n,). True where a face wins (or is within a
    depth tolerance of the winner at) its centroid texel. Exact triangle
    rasterization with a small barycentric margin — conservative bbox
    painting spuriously occludes neighboring faces' centroids."""
    n = len(uv)
    buf_depth = np.full((res, res), -np.inf, np.float32)
    buf_id = np.full((res, res), -1, np.int64)
    eps = 0.02 * max(float(depth.max() - depth.min()), 1e-6)

    pix = uv * res
    lo = np.clip(pix.min(1).astype(np.int32), 0, res - 1)  # (n, 2)
    hi = np.clip(np.ceil(pix.max(1)).astype(np.int32) + 1, 1, res)

    order = np.argsort(depth)  # back to front; later (closer) overwrite
    for i in order:
        x0, y0 = lo[i]
        x1, y1 = hi[i]
        a, b, c = pix[i]
        yy, xx = np.mgrid[y0:y1, x0:x1]
        px = xx + 0.5 - a[0]
        py = yy + 0.5 - a[1]
        d1 = b - a
        d2 = c - a
        det = d1[0] * d2[1] - d1[1] * d2[0]
        if abs(det) > 1e-12:
            w1 = (px * d2[1] - py * d2[0]) / det
            w2 = (d1[0] * py - d1[1] * px) / det
            inside = (w1 >= -0.05) & (w2 >= -0.05) & (w1 + w2 <= 1.05)
        else:
            inside = np.ones_like(px, bool)
        region = buf_depth[y0:y1, x0:x1]
        m = inside & (region < depth[i])
        region[m] = depth[i]
        buf_id[y0:y1, x0:x1][m] = i

    cen = np.clip((uv.mean(1) * res).astype(np.int32), 0, res - 1)
    winner = buf_id[cen[:, 1], cen[:, 0]]
    wdepth = buf_depth[cen[:, 1], cen[:, 0]]
    return (winner == np.arange(n)) | (wdepth <= depth + eps)


def _find_slice_offset_and_scale(index: np.ndarray):
    off = 1.0 / 3.0
    dupl_off = 1.0 / 6.0
    x_vals = np.array([0, 1, 2, 0, 1, 2], np.float32)
    y_vals = np.array([0, 0, 0, 1, 1, 1], np.float32)

    block = index // 6
    xv = x_vals[index % 6]
    yv = y_vals[index % 6]
    offset_x = np.where(
        block == 0, off * xv, dupl_off * xv + np.minimum(block - 1, 1) * 0.5
    ).astype(np.float32)
    offset_y = np.where(block == 0, off * yv, dupl_off * yv + off * 2).astype(np.float32)

    div_x = np.full(index.shape, 3.0, np.float32)
    div_x[index >= 6] = 6.0
    div_y = div_x.copy()
    div_x[index >= 12] = 2.0
    div_y[index >= 12] = 3.0
    return offset_x, offset_y, div_x, div_y


def _handle_slice_uvs(uv, index, island_padding, max_index=12):
    uv = uv.copy()
    uc, vc = uv[..., 0], uv[..., 1]
    for i in range(6, max_index):
        m = index == i
        if m.sum() > 0:
            # rescale overlap slices to fill their patch, capped at 2x
            ur = uc[m]
            vr = vc[m]
            uc[m] = (ur - ur.min()) / max(ur.max() - ur.min(), 0.5)
            vc[m] = (vr - vr.min()) / max(vr.max() - vr.min(), 0.5)
    uc = np.clip(uc * (1 - 2 * island_padding) + island_padding, 0, 1)
    vc = np.clip(vc * (1 - 2 * island_padding) + island_padding, 0, 1)
    return np.stack([uc, vc], axis=-1)


def _handle_remaining_uvs(uv, index, island_padding):
    uv = uv.copy()
    rem = index >= 12
    n = int(rem.sum())
    if n == 0:
        return uv
    uc = uv[rem, :, 0]
    vc = uv[rem, :, 1]

    ratio = 0.5 * (1.0 / 3.0)
    mult = math.sqrt(n / ratio)
    nw = int(math.ceil(0.5 * mult))
    nh = int(math.ceil(n / nw))
    width = 1.0 / nw
    height = 1.0 / nh
    clip_val = min(width, height) * 1.5

    uc = (uc - uc.min(1, keepdims=True)) / np.clip(
        uc.max(1, keepdims=True) - uc.min(1, keepdims=True), clip_val, None
    )
    vc = (vc - vc.min(1, keepdims=True)) / np.clip(
        vc.max(1, keepdims=True) - vc.min(1, keepdims=True), clip_val, None
    )
    uc = np.clip(uc * (1 - island_padding * nw * 0.5) + island_padding * nw * 0.25, 0, 1)
    vc = np.clip(vc * (1 - island_padding * nh * 0.5) + island_padding * nh * 0.25, 0, 1)
    uc = uc * width
    vc = vc * height

    ids = np.arange(n)
    uc = uc + (ids % nw)[:, None] * width
    vc = vc + (ids // nw)[:, None] * height
    uc = np.clip(uc * (1 - island_padding) + island_padding * 0.5, 0, 1)
    vc = np.clip(vc * (1 - island_padding) + island_padding * 0.5, 0, 1)

    uv[rem] = np.stack([uc, vc], axis=-1)
    return uv


def unwrap(
    v_pos: np.ndarray,
    v_nrm: np.ndarray,
    faces: np.ndarray,
    island_padding: float = 0.02,
) -> Tuple[np.ndarray, np.ndarray]:
    """Full pipeline. Returns (unique_uv (U, 2), vtex_idx (F, 3))."""
    v_pos = np.asarray(v_pos, np.float32)
    v_nrm = np.asarray(v_nrm, np.float32)
    faces = np.asarray(faces, np.int64)

    v_pos, v_nrm = _align_with_main_axis(v_pos, v_nrm)
    face_uv, face_index, vp_normalized = _box_assign(v_pos, v_nrm, faces)
    face_uv = _rotate_slices(v_pos, v_nrm, faces, face_uv, face_index)
    atlas_index = assign_atlas_index(vp_normalized, faces, face_uv, face_index)
    offset_x, offset_y, div_x, div_y = _find_slice_offset_and_scale(atlas_index)

    placed = _handle_slice_uvs(face_uv, atlas_index, island_padding)
    placed = _handle_remaining_uvs(placed, atlas_index, island_padding)
    uc = placed[..., 0] / div_x[:, None] + offset_x[:, None]
    vc = placed[..., 1] / div_y[:, None] + offset_y[:, None]
    uv_flat = np.stack([uc, vc], axis=-1).reshape(-1, 2)

    # 1D unique over a packed uint64 key: int sort is ~4x faster than the
    # complex64 lexicographic compare (and np.unique(axis=0) is worse still).
    # +0.0 normalizes any -0.0 so the bit pack can't split equal UVs.
    if len(uv_flat) == 0:
        return np.zeros((0, 2), np.float32), np.zeros((0, 3), np.int64)
    bits = (
        np.ascontiguousarray(uv_flat + 0.0, np.float32).view(np.uint32).astype(np.uint64)
    )
    packed = (bits[:, 0] << np.uint64(32)) | bits[:, 1]
    order = np.argsort(packed, kind="stable")
    sp = packed[order]
    new = np.empty(len(sp), bool)
    new[0] = True
    np.not_equal(sp[1:], sp[:-1], out=new[1:])
    gid = np.cumsum(new) - 1
    unique_idx = np.empty(len(sp), np.int64)
    unique_idx[order] = gid
    unique_uv = uv_flat[order[new]]
    return unique_uv.astype(np.float32), unique_idx.reshape(-1, 3)
