"""Host decoder for the marching-cubes wire format.

A copy of ``sculptmate_tpu/geometry/mc_wire.py``, the counterpart of
``geometry/marching_cubes.py:mc_wire_device``: the device ships occupancy
bits + per-cut-edge t (uint16) + uint8 colors; faces and vertex ids are pure
table logic on the occupancy field, rebuilt here by ``native/mc_wire.cpp``
(bit-parallel, surface-proportional). A numpy decoder covers hosts without
a compiler, with one warning, since it is ~10x slower.
"""

from __future__ import annotations

import ctypes
import warnings
from typing import Tuple

import numpy as np

from sculptmate_tpu_torch.geometry.mc_tables import EDGE_AXIS, EDGE_OFFSET, build_tables
from sculptmate_tpu_torch.geometry.native import load_native

N_WIRE_COUNTS = 2  # num_verts, n_vblocks (callers may append extras)


class WireCorruptError(ValueError):
    """The wire buffer is internally inconsistent (counts vs occupancy)."""


class WireCapacityError(OverflowError):
    """A fixed-capacity output buffer inside the native decoder overflowed."""


def _native_error(fn: str, code: int) -> Exception:
    """Map the native decoders' negative return codes to typed exceptions.

    -1 bad arguments, -2 occupancy/vertex-count mismatch (corrupt wire),
    -3 face-buffer overflow (internal capacity error)."""
    if code == -1:
        return ValueError(f"{fn}: bad arguments (shape/limit out of range)")
    if code == -2:
        return WireCorruptError(
            f"{fn}: occupancy-derived vertex count disagrees with the wire "
            "counter (corrupt wire buffer)"
        )
    if code == -3:
        return WireCapacityError(f"{fn}: output face buffer overflowed")
    return ValueError(f"{fn}: unknown native error code {code}")


def wire_layout(
    shape: Tuple[int, int, int], max_verts: int, n_counts: int,
    has_colors: bool = True,
):
    """Byte offsets of the wire sections: (occ, t_lo, t_hi, r, g, b, counts,
    total). Without colors the r/g/b sections are empty (same offsets)."""
    n3 = shape[0] * shape[1] * shape[2]
    occ = n3 // 8
    offs = [0, occ]
    offs.append(offs[-1] + max_verts)  # t_lo -> t_hi
    offs.append(offs[-1] + max_verts)  # t_hi -> r
    step = max_verts if has_colors else 0
    for _ in range(3):
        offs.append(offs[-1] + step)
    total = offs[-1] + 4 * n_counts
    return (*offs, total)


def wire_counts(wire: np.ndarray, n_counts: int) -> np.ndarray:
    """Decode the trailing little-endian uint32 counters."""
    tail = np.asarray(wire[-4 * n_counts :], np.uint8)
    return tail.reshape(n_counts, 4).astype(np.uint32) @ (
        np.uint32(1) << np.arange(0, 32, 8, dtype=np.uint32)
    )


_TABLES = None


def _tables():
    global _TABLES
    if _TABLES is None:
        tri_table, tri_count, maxtri = build_tables()
        _TABLES = (
            np.ascontiguousarray(tri_table.reshape(-1), np.int32),
            np.ascontiguousarray(tri_count, np.int32),
            np.ascontiguousarray(EDGE_AXIS, np.int32),
            np.ascontiguousarray(EDGE_OFFSET.reshape(-1), np.int32),
            int(maxtri),
        )
    return _TABLES


ORDER_VERSION = 2  # block-major vertex numbering (see mc_wire_device)


def _lib():
    lib = load_native("mc_wire")
    if lib is None:
        return None
    # a stale binary with a different vertex-numbering convention would
    # silently scramble every vertex's t/color — refuse it instead
    try:
        if lib.mc_wire_order_version() != ORDER_VERSION:
            return None
    except AttributeError:
        return None  # pre-versioning binary: z-order numbering
    if not getattr(lib, "_mc_wire_configured", False):
        u8 = ctypes.POINTER(ctypes.c_uint8)
        i32 = ctypes.POINTER(ctypes.c_int32)
        f32 = ctypes.POINTER(ctypes.c_float)
        lib.mc_wire_count_faces.restype = ctypes.c_longlong
        lib.mc_wire_count_faces.argtypes = [
            u8, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, i32
        ]
        lib.mc_wire_build.restype = ctypes.c_longlong
        lib.mc_wire_build.argtypes = [
            u8, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            u8, u8, u8, u8, u8,
            ctypes.c_longlong,
            i32, i32, i32, i32,
            ctypes.c_int, ctypes.c_longlong,
            f32, f32, i32,
        ]
        lib._mc_wire_configured = True
    return lib


def _ptr(a, typ):
    return a.ctypes.data_as(ctypes.POINTER(typ))


def decode_wire(
    wire: np.ndarray,
    shape: Tuple[int, int, int],
    max_verts: int,
    n_counts: int = N_WIRE_COUNTS,
    has_colors: bool = True,
    valid_x_limit: int = -1,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """wire (W,) uint8 -> (verts (nv,3) f32 lattice coords, faces (nf,3) i32,
    colors (nv,3) f32, counts (n_counts,) u32). Raises on malformed input.

    ``valid_x_limit``: cells/x-cuts valid at x < limit (default RX-1) — must
    match the ``valid_x`` mask the device packer ran with (the SP sharded
    path passes its slab width)."""
    wire = np.ascontiguousarray(wire, np.uint8)
    o_occ, o_tlo, o_thi, o_r, o_g, o_b, o_counts, total = wire_layout(
        shape, max_verts, n_counts, has_colors
    )
    if wire.size != total:
        raise ValueError(f"wire size {wire.size} != expected {total}")
    counts = wire_counts(wire, n_counts)
    nv = int(counts[0])
    if nv > max_verts:
        raise OverflowError(f"num_verts {nv} > capacity {max_verts}")
    RX, RY, RZ = shape
    if valid_x_limit < 0:
        valid_x_limit = RX - 1
    occ = wire[o_occ:o_tlo]
    t_lo = wire[o_tlo:o_thi]
    t_hi = wire[o_thi:o_r]
    if has_colors:
        cr = wire[o_r:o_g]
        cg = wire[o_g:o_b]
        cb = wire[o_b:o_counts]
    else:
        cr = cg = cb = np.zeros(max_verts, np.uint8)

    if nv == 0:
        return (
            np.zeros((0, 3), np.float32),
            np.zeros((0, 3), np.int32),
            np.zeros((0, 3), np.float32),
            counts,
        )

    tri_table, tri_count, edge_axis, edge_offset, maxtri = _tables()
    lib = _lib()
    if lib is not None:
        nf = int(
            lib.mc_wire_count_faces(
                _ptr(occ, ctypes.c_uint8), RX, RY, RZ, valid_x_limit,
                _ptr(tri_count, ctypes.c_int32),
            )
        )
        if nf < 0:
            raise _native_error("mc_wire_count_faces", nf)
        verts = np.empty((nv, 3), np.float32)
        colors = np.empty((nv, 3), np.float32)
        faces = np.empty((max(nf, 1), 3), np.int32)
        wrote = int(
            lib.mc_wire_build(
                _ptr(occ, ctypes.c_uint8), RX, RY, RZ, valid_x_limit,
                _ptr(t_lo, ctypes.c_uint8), _ptr(t_hi, ctypes.c_uint8),
                _ptr(cr, ctypes.c_uint8), _ptr(cg, ctypes.c_uint8),
                _ptr(cb, ctypes.c_uint8),
                nv,
                _ptr(tri_table, ctypes.c_int32), _ptr(tri_count, ctypes.c_int32),
                _ptr(edge_axis, ctypes.c_int32), _ptr(edge_offset, ctypes.c_int32),
                maxtri, nf,
                _ptr(verts, ctypes.c_float), _ptr(colors, ctypes.c_float),
                _ptr(faces, ctypes.c_int32),
            )
        )
        if wrote < 0:
            raise _native_error("mc_wire_build", wrote)
        if wrote != nf:
            raise WireCorruptError(
                f"mc_wire_build wrote {wrote} faces, expected {nf}"
            )
        return verts, faces[:nf], colors, counts

    warnings.warn(
        "native mc_wire unavailable - falling back to the ~10x slower numpy "
        "wire decoder (check that g++ can build sculptmate_tpu_torch/geometry/native/mc_wire.cpp)",
        RuntimeWarning,
        stacklevel=2,
    )
    return _decode_numpy(
        occ, t_lo, t_hi, cr, cg, cb, shape, nv, counts, valid_x_limit
    )


def _decode_numpy(occ, t_lo, t_hi, cr, cg, cb, shape, nv, counts, vxlim=-1):
    """Vectorized numpy fallback (same conventions as the C++)."""
    RX, RY, RZ = shape
    if vxlim < 0:
        vxlim = RX - 1
    inside = np.unpackbits(occ, bitorder="little").astype(bool).reshape(RX, RY, RZ)

    masks = []
    mx = np.zeros((RX, RY, RZ), bool)
    mx[: RX - 1] = inside[:-1] != inside[1:]
    mx[vxlim:] = False
    masks.append(mx)
    my = np.zeros((RX, RY, RZ), bool)
    my[:, : RY - 1] = inside[:, :-1] != inside[:, 1:]
    masks.append(my)
    mz = np.zeros((RX, RY, RZ), bool)
    mz[:, :, : RZ - 1] = inside[:, :, :-1] != inside[:, :, 1:]
    masks.append(mz)
    # block-major numbering (ORDER_VERSION 2, same as the C++ decoder and
    # the device packer): (axis, 8^3 block bi/bj/bk, in-block ox/oy/oz)
    assert RX % 8 == 0 and RY % 8 == 0 and RZ % 8 == 0, shape
    n3 = RX * RY * RZ
    nbx, nby, nbz = RX // 8, RY // 8, RZ // 8
    NB = nbx * nby * nbz

    def blocked(m):
        return (
            m.reshape(nbx, 8, nby, 8, nbz, 8)
            .transpose(0, 2, 4, 1, 3, 5)
            .reshape(NB, 512)
        )

    flat = np.concatenate([blocked(m) for m in masks]).ravel()
    assert int(flat.sum()) == nv, (int(flat.sum()), nv)
    rank = np.cumsum(flat) - 1  # vid at cut slots, block-major order
    vid3 = [
        rank[a * NB * 512 : (a + 1) * NB * 512]
        .reshape(nbx, nby, nbz, 8, 8, 8)
        .transpose(0, 3, 1, 4, 2, 5)
        .reshape(RX, RY, RZ)
        for a in range(3)
    ]
    vid = np.concatenate([v.ravel() for v in vid3])

    (slot,) = np.nonzero(flat)  # ascending = block-major vertex order
    arow, acol = slot // 512, slot % 512
    axis = arow // NB
    blk = arow % NB
    bi, bj, bk = blk // (nby * nbz), (blk // nbz) % nby, blk % nbz
    ox, oy, oz = acol // 64, (acol // 8) % 8, acol % 8
    i = bi * 8 + ox
    j = bj * 8 + oy
    k = bk * 8 + oz
    t = (
        t_lo[:nv].astype(np.float32) + t_hi[:nv].astype(np.float32) * 256.0
    ) / 65535.0
    verts = np.stack(
        [
            i.astype(np.float32) + t * (axis == 0),
            j.astype(np.float32) + t * (axis == 1),
            k.astype(np.float32) + t * (axis == 2),
        ],
        axis=-1,
    )
    colors = (
        np.stack([cr[:nv], cg[:nv], cb[:nv]], axis=-1).astype(np.float32) / 255.0
    )

    tri_table, tri_count, maxtri = build_tables()
    pad = np.pad(inside.astype(np.int32), ((0, 1), (0, 1), (0, 1)))
    case = np.zeros((RX, RY, RZ), np.int32)
    for c in range(8):
        ox, oy, oz = c & 1, (c >> 1) & 1, (c >> 2) & 1
        case += pad[ox : ox + RX, oy : oy + RY, oz : oz + RZ] << c
    cell_valid = np.zeros((RX, RY, RZ), bool)
    cell_valid[:vxlim, : RY - 1, : RZ - 1] = True
    ntri = np.where(cell_valid, tri_count[case], 0)
    ci, cj, ck = np.nonzero(ntri)
    cs = case[ci, cj, ck]
    nt = ntri[ci, cj, ck]

    faces = []
    for s in range(maxtri):
        sel = nt > s
        if not sel.any():
            break
        tri = tri_table[cs[sel], s]  # (m, 3) local edges
        corner_vids = []
        for c in range(3):
            le = tri[:, c]
            ax = EDGE_AXIS[le]
            gi = ci[sel] + EDGE_OFFSET[le, 0]
            gj = cj[sel] + EDGE_OFFSET[le, 1]
            gk = ck[sel] + EDGE_OFFSET[le, 2]
            corner_vids.append(vid[ax * n3 + (gi * RY + gj) * RZ + gk])
        faces.append(np.stack(corner_vids, axis=-1))
    if faces:
        order = []  # interleave back to cell-major, slot-minor order
        faces_all = np.zeros((int(nt.sum()), 3), np.int64)
        first = np.cumsum(nt) - nt
        for s, fs in enumerate(faces):
            sel = nt > s
            faces_all[first[sel] + s] = fs
        faces_np = faces_all
    else:
        faces_np = np.zeros((0, 3), np.int64)
    return verts, faces_np.astype(np.int32), colors, counts
