"""Host decoder for the marching-tetrahedra wire format.

A copy of ``sculptmate_tpu/geometry/mt_wire.py``, the counterpart of
``geometry/marching_tets.py:mt_wire_device``: the device ships the padded
occupancy bitmask + per-cut-edge deformed positions (3x uint16) in one
~4.3 MB uint8 buffer at res 160 (vs ~22 MB of packed f32 mesh); faces and
vertex ids are Freudenthal-table logic on the occupancy field, rebuilt by
``native/mt_wire.cpp`` (bit-parallel, surface-proportional). Positions
reconstruct to |err| <= (1 + 2/res) * 2^-16 lattice units.

Replaces the device-side MT face machinery + f32 transfer on the SF3D hot
path (``sf3d/models/isosurface.py:24-229`` territory).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from sculptmate_tpu_torch.geometry.marching_tets import lattice_size
from sculptmate_tpu_torch.geometry.mc_wire import (
    WireCorruptError,
    _native_error,
)
from sculptmate_tpu_torch.geometry.mt_tables import build_tet_tables
from sculptmate_tpu_torch.geometry.native import load_native

N_WIRE_COUNTS = 2  # num_verts, n_vblocks (callers may append extras)


def wire_layout(resolution: int, max_verts: int, n_counts: int):
    """Byte offsets: (occ, px_lo, px_hi, py_lo, py_hi, pz_lo, pz_hi, counts,
    total)."""
    N = lattice_size(resolution)
    Np = -(-N // 8) * 8
    occ = Np * Np * Np // 8
    offs = [0, occ]
    for _ in range(6):
        offs.append(offs[-1] + max_verts)
    total = offs[-1] + 4 * n_counts
    return (*offs, total)


def wire_counts(wire: np.ndarray, n_counts: int) -> np.ndarray:
    tail = np.asarray(wire[-4 * n_counts :], np.uint8)
    return tail.reshape(n_counts, 4).astype(np.uint32) @ (
        np.uint32(1) << np.arange(0, 32, 8, dtype=np.uint32)
    )


_TABLES = None


def _tables():
    global _TABLES
    if _TABLES is None:
        edge_class, edge_anchor, tri_table, tri_count, tet_corners = (
            build_tet_tables()
        )
        # per-tet corner bit index (ox + 2*oy + 4*oz), appended after counts
        corner_idx = (
            tet_corners[:, :, 0] + 2 * tet_corners[:, :, 1] + 4 * tet_corners[:, :, 2]
        )
        counts_plus = np.concatenate(
            [tri_count.reshape(-1), corner_idx.reshape(-1)]
        )
        _TABLES = (
            np.ascontiguousarray(counts_plus, np.int32),
            np.ascontiguousarray(tri_table.reshape(-1), np.int32),
            np.ascontiguousarray(edge_class.reshape(-1), np.int32),
            np.ascontiguousarray(edge_anchor.reshape(-1), np.int32),
        )
    return _TABLES


ORDER_VERSION = 2  # block-major vertex numbering (see mt_wire_device)


def _lib():
    lib = load_native("mt_wire")
    if lib is None:
        return None
    # a stale binary with a different vertex-numbering convention would
    # silently scramble every vertex's position — refuse it instead
    try:
        if lib.mt_wire_order_version() != ORDER_VERSION:
            return None
    except AttributeError:
        return None  # pre-versioning binary: z-order numbering
    if not getattr(lib, "_mt_wire_configured", False):
        u8 = ctypes.POINTER(ctypes.c_uint8)
        i32 = ctypes.POINTER(ctypes.c_int32)
        f32 = ctypes.POINTER(ctypes.c_float)
        lib.mt_wire_count_faces.restype = ctypes.c_longlong
        lib.mt_wire_count_faces.argtypes = [u8, ctypes.c_int, ctypes.c_int, i32]
        lib.mt_wire_build.restype = ctypes.c_longlong
        lib.mt_wire_build.argtypes = [
            u8, ctypes.c_int, ctypes.c_int,
            u8, u8, u8, u8, u8, u8,
            ctypes.c_longlong,
            i32, i32, i32, i32,
            ctypes.c_longlong,
            f32, i32,
        ]
        if hasattr(lib, "mt_wire_build_weld"):
            lib.mt_wire_build_weld.restype = ctypes.c_longlong
            lib.mt_wire_build_weld.argtypes = lib.mt_wire_build.argtypes + [
                ctypes.POINTER(ctypes.c_longlong)
            ]
        lib._mt_wire_configured = True
    return lib


def _ptr(a, typ):
    return a.ctypes.data_as(ctypes.POINTER(typ))


def decode_wire(
    wire: np.ndarray,
    resolution: int,
    max_verts: int,
    n_counts: int = N_WIRE_COUNTS,
    weld: bool = False,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """wire (W,) uint8 -> (verts (nv,3) f32 in [0,1] lattice coords,
    faces (nf,3) i32, counts (n_counts,) u32). Raises on malformed input or
    when the native decoder is unavailable (no numpy fallback here — the SF3D
    path requires the toolchain that also builds its other native kernels).

    ``weld=True`` merges vertices with identical quantized positions and
    drops the triangles that degenerate under the merge — pair with the
    device's ``snap_eps`` (``marching_tets.mt_wire_device``), which parks
    near-endpoint vertices exactly on the shared deformed lattice point.
    counts[0] still reports the RAW pre-weld vertex count (the capacity /
    budget-semantics number); the returned arrays are the welded mesh."""
    wire = np.ascontiguousarray(wire, np.uint8)
    offs = wire_layout(resolution, max_verts, n_counts)
    if wire.size != offs[-1]:
        raise ValueError(f"wire size {wire.size} != expected {offs[-1]}")
    counts = wire_counts(wire, n_counts)
    nv = int(counts[0])
    if nv > max_verts:
        raise OverflowError(f"num_verts {nv} > capacity {max_verts}")
    if nv == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32), counts

    lib = _lib()
    if lib is None:
        raise RuntimeError(
            "native mt_wire unavailable (g++ build of "
            "geometry/native/mt_wire.cpp failed)"
        )

    N = lattice_size(resolution)
    Np = -(-N // 8) * 8
    occ = wire[offs[0] : offs[1]]
    sect = [wire[offs[i] : offs[i + 1]] for i in range(1, 7)]
    counts_plus, tri_table, edge_class, edge_anchor = _tables()

    nf = int(
        lib.mt_wire_count_faces(
            _ptr(occ, ctypes.c_uint8), N, Np, _ptr(counts_plus, ctypes.c_int32)
        )
    )
    if nf < 0:
        raise _native_error("mt_wire_count_faces", nf)
    verts = np.empty((nv, 3), np.float32)
    faces = np.empty((max(nf, 1), 3), np.int32)
    args = (
        _ptr(occ, ctypes.c_uint8), N, Np,
        *(_ptr(s, ctypes.c_uint8) for s in sect),
        nv,
        _ptr(counts_plus, ctypes.c_int32), _ptr(tri_table, ctypes.c_int32),
        _ptr(edge_class, ctypes.c_int32), _ptr(edge_anchor, ctypes.c_int32),
        nf,
        _ptr(verts, ctypes.c_float), _ptr(faces, ctypes.c_int32),
    )
    if weld:
        if not hasattr(lib, "mt_wire_build_weld"):
            raise RuntimeError(
                "native mt_wire predates weld support - rebuild "
                "geometry/native/mt_wire.cpp (delete the stale lib*.so)"
            )
        out_nv = ctypes.c_longlong(0)
        wrote = int(lib.mt_wire_build_weld(*args, ctypes.byref(out_nv)))
        if wrote < 0:
            raise _native_error("mt_wire_build_weld", wrote)
        if wrote > nf:
            raise WireCorruptError(
                f"mt_wire_build_weld wrote {wrote} faces, expected <= {nf}"
            )
        return verts[: out_nv.value], faces[:wrote], counts
    wrote = int(lib.mt_wire_build(*args))
    if wrote < 0:
        raise _native_error("mt_wire_build", wrote)
    if wrote != nf:
        raise WireCorruptError(
            f"mt_wire_build wrote {wrote} faces, expected {nf}"
        )
    return verts, faces[:nf], counts
