"""Batched SF3D ("Pro") generation on one card.

Counterpart of ``sculptmate_tpu/parallel/sf3d_farm.py:SF3DFarm`` for a
single device (the JAX farm's ``dp`` axis has size 1 here):

- one batched front: prepare, encode and the material estimate over the B
  images;
- the extraction of every asset (K5 and the marching-tets wire), each
  enqueued with its wire's copy to pinned host memory before the first is
  decoded;
- the round-robin tail: the host decode and decimation of asset i+1 run
  while asset i's fused unwrap and bake (``SF3D.unwrap_bake_async``: K9, K8,
  K6) runs on the device.

Each stage runs inside a ``torch.profiler`` span (``sf3d_farm.front``,
``sf3d_farm.extract``, ``sf3d_farm.decode``, ``sf3d_farm.bake_dispatch``,
``sf3d_farm.bake_wait``) beside the SF3D's ``sf3d.*`` spans. Meshes,
device-mesh axes and tensor parallelism are multi-device work, ROADMAP item
9, and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.profiler import record_function

from sculptmate_tpu_torch.geometry.mesh import Mesh
from sculptmate_tpu_torch.runtime.device import resolve_device
from sculptmate_tpu_torch.systems.sf3d import mesh_arrays
from sculptmate_tpu_torch.systems.tsr import upload

_LATER = "is multi-device work, not ported yet (ROADMAP item 9)"


class SF3DFarm:
    """Batched SF3D generation on one card. ``sf3d`` is a
    ``systems.sf3d.SF3D``; ``device`` defaults to the card and must be the
    model's (pass ``device="cpu"`` for a model on the CPU)."""

    def __init__(self, sf3d, mesh=None, dp_axis: Optional[str] = None, tp_axis: Optional[str] = None, device=None):
        if mesh is not None or dp_axis is not None or tp_axis is not None:
            raise NotImplementedError(f"SF3DFarm over a device mesh (mesh, dp_axis, tp_axis) {_LATER}")
        self.device = resolve_device(device)
        if self.device != sf3d.device:
            raise ValueError(f"the farm's device {self.device} is not the model's {sf3d.device}")
        self.sf3d = sf3d

    @torch.inference_mode()
    def generate_batch(
        self,
        images,
        bake_resolution: int = 512,
        vertex_simplification_factor: str = "high",
        enable_texture: bool = True,
        threshold: Optional[float] = None,
    ):
        """images: (B, H, W, 3|4) float in [0, 1]. Returns B mesh dicts in
        ``SF3D.run_image``'s layout (None for an empty surface); with
        ``enable_texture`` each is unwrapped and baked by the fused path."""
        sf3d = self.sf3d
        c = sf3d.config
        thr = float(c.isosurface_threshold if threshold is None else threshold)
        with record_function("sf3d_farm.front"):
            mask, rgb = sf3d.prepare_image(upload(images, self.device))
            codes, _ = sf3d.get_scene_codes(rgb)
            materials = sf3d.estimate_materials(rgb * mask)
        with record_function("sf3d_farm.extract"):
            mv = sf3d._capacity(c.isosurface_resolution)
            wires = [sf3d.extract_wire_async(code, thr, mv) for code in codes]

        def decode(i):
            """Host tail of asset i: the wire (re-extracted on overflow),
            then the decimation; and the dispatch of its fused bake."""
            with record_function("sf3d_farm.decode"):
                extracted = sf3d.extract_mesh(codes[i], thr, pending=(wires[i], mv))
                if extracted is None:
                    return None, None
                verts, faces, nv = extracted
                verts, faces, v_nrm = sf3d.decimate_mesh(verts, faces, nv, vertex_simplification_factor,
                                                         not enable_texture)
                mesh = Mesh(verts, faces)
                if v_nrm is not None:
                    mesh._v_nrm = v_nrm
            if not enable_texture:
                return mesh, None
            with record_function("sf3d_farm.bake_dispatch"):
                mats = {k: v[i] for k, v in materials.items()}
                return mesh, sf3d.unwrap_bake_async(mesh.v_pos, mesh.t_pos_idx, codes[i], mats, bake_resolution)

        def finish(mesh, handle):
            if mesh is None:
                return None
            if handle is None:
                mesh.unwrap_uv(backend="auto", device=self.device)
                return {**mesh_arrays(mesh), "textures": None, "texture_pngs": None, "roughness": None,
                        "metallic": None}
            with record_function("sf3d_farm.bake_wait"):
                uv_flat, textures = sf3d.unwrap_bake_wait(handle)
                mesh.apply_flat_uv(uv_flat)
            return {**mesh_arrays(mesh), **textures}

        results, prev = [], None
        for i in range(len(codes)):
            entry = decode(i)  # asset i-1's bake runs on the device meanwhile
            if prev is not None:
                results.append(finish(*prev))
            prev = entry
        if prev is not None:
            results.append(finish(*prev))
        return results
