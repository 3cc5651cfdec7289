"""Isotropic remeshing (the reference's gpytoolbox.remesh_botsch role at
``sf3d/models/mesh.py:225-230``): C++ edge split/collapse + tangential
smoothing, no-op fallback when the native build is unavailable.

Counterpart of ``sculptmate_tpu/geometry/remesh.py`` on the port's copy of
``native/isotropic_remesh.cpp``: host code, not a device path. Unlike the
JAX package's, it reruns a remesh that outgrows its output's 6x headroom
rather than return it cut.
"""

from __future__ import annotations

import ctypes
import warnings
from typing import Optional, Tuple

import numpy as np

from sculptmate_tpu_torch.geometry.native import load_native


def isotropic_remesh(
    verts: np.ndarray,
    faces: np.ndarray,
    target_edge_length: Optional[float] = None,
    iterations: int = 10,
) -> Tuple[np.ndarray, np.ndarray]:
    """(verts (V, 3) f32, faces (F, 3) int64) remeshed toward edges of
    ``target_edge_length`` (0 or None: the mean edge length)."""
    verts = np.ascontiguousarray(verts, np.float32)
    faces = np.ascontiguousarray(faces, np.int32)
    lib = load_native("isotropic_remesh")
    if lib is None:
        warnings.warn(
            "native isotropic_remesh unavailable - remesh is a NO-OP (check "
            "that g++ can build geometry/native/isotropic_remesh.cpp)",
            RuntimeWarning,
            stacklevel=2,
        )
        return verts, faces.astype(np.int64)
    if len(faces) == 0:
        return verts, faces.astype(np.int64)

    fn = lib.isotropic_remesh
    fn.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.c_double, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
    ]
    fn.restype = None

    # splitting can grow the mesh: allocate 6x headroom. The library writes
    # at most a capacity's rows and reports what it wrote, so an output
    # that fills a capacity may have been cut (the JAX package returns it
    # so, its faces pointing past the vertices): it is run again with 4x
    # the room, never returned truncated
    vcap = max(len(verts) * 6, 1024)
    fcap = max(len(faces) * 6, 2048)
    while True:
        out_v = np.empty((vcap, 3), np.float32)
        out_f = np.empty((fcap, 3), np.int32)
        out_nv = ctypes.c_int64(0)
        out_nf = ctypes.c_int64(0)
        fn(
            verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(verts),
            faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(faces),
            float(target_edge_length or 0.0), int(iterations),
            out_v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), vcap,
            ctypes.byref(out_nv),
            out_f.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), fcap,
            ctypes.byref(out_nf),
        )
        if out_nv.value < vcap and out_nf.value < fcap:
            return out_v[: out_nv.value].copy(), out_f[: out_nf.value].astype(np.int64)
        vcap, fcap = 4 * vcap, 4 * fcap
