"""Triangle mesh container: normals, tangents, edges, UV plumbing (host).

Counterpart of ``sculptmate_tpu/geometry/mesh.py:Mesh`` (the reference's
``sf3d/models/mesh.py:19-277``), numpy on the host:

- vertex normals: area-weighted face-normal splat, zero-normal fallback to
  +z;
- vertex tangents: UV-derivative accumulation divided by counts, then
  Gram-Schmidt against the normal;
- ``unwrap_uv``: the cube-projection unwrap on the host (``uv_unwrap.py``)
  or on the device (``uv_unwrap_device.py``, kernel K9), then vertices
  duplicated per face with flat UVs;
- ``triangle_remesh``: subdivide-if-upsampling + quadric decimation
  (``decimate.py``), then optionally the isotropic remesher
  (``remesh.py``): gpytoolbox's role at ``mesh.py:175-237``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from sculptmate_tpu_torch.runtime.device import resolve_device


def _scatter_add_rows(out: np.ndarray, idx: np.ndarray, vals: np.ndarray) -> None:
    """out[idx] += vals via bincount (np.add.at is ~20x slower at 1M+ rows)."""
    n = len(out)
    for c in range(out.shape[1]):
        out[:, c] += np.bincount(idx, weights=vals[:, c], minlength=n)


class Mesh:
    def __init__(self, v_pos: np.ndarray, t_pos_idx: np.ndarray, **extras):
        self.v_pos = np.asarray(v_pos, np.float32)
        self.t_pos_idx = np.asarray(t_pos_idx, np.int64)
        self._v_nrm: Optional[np.ndarray] = None
        self._v_tng: Optional[np.ndarray] = None
        self._v_tex: Optional[np.ndarray] = None
        self._edges: Optional[np.ndarray] = None
        self._dup_face_nrm: Optional[np.ndarray] = None
        self.extras = dict(extras)

    # -- lazy attributes --------------------------------------------------
    @property
    def v_nrm(self) -> np.ndarray:
        if self._v_nrm is None:
            self._v_nrm = self._compute_vertex_normal()
        return self._v_nrm

    @property
    def v_tng(self) -> np.ndarray:
        if self._v_tng is None:
            if self._dup_face_nrm is not None:
                self._v_tng = self._per_face_tangents(self._dup_face_nrm)
            else:
                self._v_tng = self._compute_vertex_tangent()
        return self._v_tng

    def _per_face_tangents(self, fn: np.ndarray) -> np.ndarray:
        """Per-face tangents for a per-face-duplicated mesh (each vertex has
        one incident face; bit-identical to the scatter accumulation)."""
        tri = self.v_pos.reshape(-1, 3, 3)
        uvf = self.v_tex.reshape(-1, 3, 2)
        duv1 = uvf[:, 1] - uvf[:, 0]
        duv2 = uvf[:, 2] - uvf[:, 0]
        dpos1 = tri[:, 1] - tri[:, 0]
        dpos2 = tri[:, 2] - tri[:, 0]
        tang = (dpos1 * duv2[:, 1:2] - dpos2 * duv1[:, 1:2]) / np.clip(
            duv1[:, 0:1] * duv2[:, 1:2] - duv1[:, 1:2] * duv2[:, 0:1], 1e-6, None
        )
        tang = tang / np.maximum(np.linalg.norm(tang, axis=1, keepdims=True), 1e-12)
        tang = tang - (tang * fn).sum(-1, keepdims=True) * fn
        tang = tang / np.maximum(np.linalg.norm(tang, axis=1, keepdims=True), 1e-12)
        return np.repeat(tang, 3, axis=0).astype(np.float32)

    @property
    def v_tex(self) -> np.ndarray:
        if self._v_tex is None:
            self.unwrap_uv()
        return self._v_tex

    @property
    def edges(self) -> np.ndarray:
        if self._edges is None:
            e = np.concatenate(
                [self.t_pos_idx[:, [0, 1]], self.t_pos_idx[:, [1, 2]], self.t_pos_idx[:, [2, 0]]]
            )
            e = np.sort(e, axis=1)
            key = e[:, 0] * np.int64(len(self.v_pos)) + e[:, 1]
            _, first = np.unique(key, return_index=True)
            self._edges = e[first]
        return self._edges

    # -- geometry ---------------------------------------------------------
    def _face_corners(self):
        return tuple(self.v_pos[self.t_pos_idx[:, c]] for c in range(3))

    def _compute_vertex_normal(self) -> np.ndarray:
        v0, v1, v2 = self._face_corners()
        fn = np.cross(v1 - v0, v2 - v0)
        n = np.zeros_like(self.v_pos)
        for c in range(3):
            _scatter_add_rows(n, self.t_pos_idx[:, c], fn)
        bad = (n * n).sum(-1) <= 1e-20
        n[bad] = (0.0, 0.0, 1.0)
        return n / np.linalg.norm(n, axis=1, keepdims=True)

    def _compute_vertex_tangent(self) -> np.ndarray:
        idx = self.t_pos_idx
        pos = [self.v_pos[idx[:, i]] for i in range(3)]
        tex = [self.v_tex[idx[:, i]] for i in range(3)]
        duv1 = tex[1] - tex[0]
        duv2 = tex[2] - tex[0]
        dpos1 = pos[1] - pos[0]
        dpos2 = pos[2] - pos[0]
        tng_nom = dpos1 * duv2[:, 1:2] - dpos2 * duv1[:, 1:2]
        denom = duv1[:, 0:1] * duv2[:, 1:2] - duv1[:, 1:2] * duv2[:, 0:1]
        tang = tng_nom / np.clip(denom, 1e-6, None)

        tangents = np.zeros_like(self.v_pos)
        for c in range(3):
            _scatter_add_rows(tangents, idx[:, c], tang)
        counts = np.bincount(idx.reshape(-1), minlength=len(self.v_pos))
        tangents = tangents / np.maximum(counts, 1e-12)[:, None]
        tangents = tangents / np.maximum(np.linalg.norm(tangents, axis=1, keepdims=True), 1e-12)
        n = self.v_nrm
        tangents = tangents - (tangents * n).sum(-1, keepdims=True) * n
        return tangents / np.maximum(np.linalg.norm(tangents, axis=1, keepdims=True), 1e-12)

    # -- remeshing --------------------------------------------------------
    def subdivide(self, iters: int = 1) -> "Mesh":
        """Loop-style midpoint subdivision (positions averaged, no smoothing):
        the upsampling role of gpytoolbox.subdivide at ``mesh.py:187-191``."""
        v, f = self.v_pos, self.t_pos_idx
        for _ in range(iters):
            e = np.sort(np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]]), axis=1)
            key = e[:, 0] * np.int64(len(v)) + e[:, 1]
            _, first, inv = np.unique(key, return_index=True, return_inverse=True)
            uniq = e[first]
            mid = (v[uniq[:, 0]] + v[uniq[:, 1]]) / 2
            mid_id = len(v) + inv.reshape(3, -1)  # (3, F) edge midpoint ids
            a, b, c = f[:, 0], f[:, 1], f[:, 2]
            mab, mbc, mca = mid_id[0], mid_id[1], mid_id[2]
            v = np.concatenate([v, mid])
            f = np.concatenate([
                np.stack([a, mab, mca], 1),
                np.stack([mab, b, mbc], 1),
                np.stack([mca, mbc, c], 1),
                np.stack([mab, mbc, mca], 1),
            ])
        return Mesh(v, f)

    def triangle_remesh(
        self,
        triangle_vertex_count: int = -1,
        triangle_average_edge_length_multiplier: Optional[float] = None,
        triangle_remesh_steps: int = 10,
        isotropic: bool = False,
    ) -> "Mesh":
        """Adjust the vertex budget by subdivision + quadric decimation, with
        optional isotropic remeshing: the gpytoolbox decimate/remesh_botsch
        path at ``sf3d/models/mesh.py:175-237``. ``isotropic=False`` skips the
        remesh pass unless an edge-length multiplier is given."""
        from sculptmate_tpu_torch.geometry.decimate import decimate

        mesh = self
        if triangle_vertex_count > 0:
            reduction = triangle_vertex_count / mesh.v_pos.shape[0]
            if reduction > 1.0:
                mesh = mesh.subdivide(int(np.ceil(np.log(reduction) / np.log(4))))
                reduction = triangle_vertex_count / mesh.v_pos.shape[0]
            mesh = Mesh(*decimate(mesh.v_pos, mesh.t_pos_idx, target_ratio=reduction))
        if isotropic or triangle_average_edge_length_multiplier is not None:
            from sculptmate_tpu_torch.geometry.remesh import isotropic_remesh

            h = None
            if triangle_average_edge_length_multiplier is not None:
                e = mesh.edges
                h = float(np.linalg.norm(mesh.v_pos[e[:, 0]] - mesh.v_pos[e[:, 1]], axis=1).mean()
                          * triangle_average_edge_length_multiplier)
            mesh = Mesh(*isotropic_remesh(mesh.v_pos, mesh.t_pos_idx, h, triangle_remesh_steps))
        return mesh

    def quad_remesh(self, quad_vertex_count: int = -1, **_kwargs) -> "Mesh":
        """Quad remeshing is stubbed in the reference too (pynim commented
        out, ``sf3d/models/mesh.py:141-173``): the mesh unchanged."""
        return Mesh(self.v_pos, self.t_pos_idx)

    # -- UVs --------------------------------------------------------------
    def unwrap_uv(self, island_padding: float = 0.02, backend: str = "host", device=None) -> "Mesh":
        """Cube-projection unwrap, then vertices duplicated per face.
        ``backend``: "host" (numpy and the C++ overlap painter), "device"
        (``uv_unwrap_device.unwrap_device`` on ``device``: kernel K9 on the
        card, its plain version on the CPU) or "auto" (the device backend on
        a CUDA device, the host one on ``device="cpu"``). For "device" and
        "auto", ``device`` defaults to the card and raises without one."""
        if backend in ("auto", "device"):
            device = resolve_device(device)
        if backend == "auto":
            backend = "device" if device.type == "cuda" else "host"
        if backend == "device":
            from sculptmate_tpu_torch.geometry.uv_unwrap_device import unwrap_device

            uv_flat, _ = unwrap_device(self.v_pos, self.t_pos_idx, island_padding, return_flat=True, device=device)
            return self.apply_flat_uv(uv_flat)
        if backend != "host":
            raise ValueError(f"unwrap backend {backend!r}: 'host', 'device' or 'auto'")
        from sculptmate_tpu_torch.geometry.uv_unwrap import unwrap

        uv, indices = unwrap(self.v_pos, self.v_nrm, self.t_pos_idx, island_padding)
        return self.apply_flat_uv(uv[indices].reshape(-1, 2))

    def apply_flat_uv(self, uv_flat: np.ndarray) -> "Mesh":
        """Install per-corner UVs (F, 3, 2)/(3F, 2) by duplicating vertices
        per face, as the reference's ``unwrap_uv`` does; normals collapse to
        the per-face values."""
        uv_flat = np.asarray(uv_flat, np.float32).reshape(-1, 2)
        individual_vertices = self.v_pos[self.t_pos_idx].reshape(-1, 3)
        self.v_pos = individual_vertices
        self.t_pos_idx = np.arange(len(individual_vertices), dtype=np.int64).reshape(-1, 3)
        self._v_tex = uv_flat
        # every vertex now has exactly one incident face, so the scattered
        # vertex normals reduce to the face normal repeated three times
        tri = individual_vertices.reshape(-1, 3, 3)
        fn = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
        bad = (fn * fn).sum(-1) <= 1e-20
        fn[bad] = (0.0, 0.0, 1.0)
        fn = fn / np.linalg.norm(fn, axis=1, keepdims=True)
        self._v_nrm = np.repeat(fn, 3, axis=0)
        self._dup_face_nrm = fn
        self._v_tng = None
        self._edges = None
        return self
