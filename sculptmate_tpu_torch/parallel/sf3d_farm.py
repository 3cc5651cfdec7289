"""Batched SF3D ("Pro") generation over a device mesh.

Counterpart of ``sculptmate_tpu/parallel/sf3d_farm.py:SF3DFarm``, on the
port's single-controller mesh (``parallel/mesh.py``: one process driving a
``DeviceMesh`` of ``torch.device``; NCCL puts one rank on one card, so a
process group could not split anything on a one-card machine, where one
device named several times can). The batch is split over the ``dp`` axis;
each dp row runs its own SF3D replica (made once in the constructor,
shared where mesh devices repeat), its two-stream backbone tensor-parallel
over the row's devices when ``tp_axis`` is given:

- the front per dp shard: prepare, encode and the material estimate of
  its images;
- the extraction of every asset on its shard's device (K5 and the
  marching-tets wire), each enqueued with its wire's copy to pinned host
  memory before the first is decoded;
- the round-robin tail, in batch order: the host decode and decimation of
  asset i+1 run while asset i's fused unwrap and bake
  (``SF3D.unwrap_bake_async``: K9, K8, K6) runs on its device.

Without a mesh it is a one-device farm on ``device``. Each stage runs
inside a ``torch.profiler`` span (``sf3d_farm.front``,
``sf3d_farm.extract``, ``sf3d_farm.decode``, ``sf3d_farm.bake_dispatch``,
``sf3d_farm.bake_wait``) beside the SF3D's ``sf3d.*`` spans.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.profiler import record_function

from sculptmate_tpu_torch.geometry.mesh import Mesh
from sculptmate_tpu_torch.parallel.mesh import DeviceMesh, make_mesh, replicate, shard_batch
from sculptmate_tpu_torch.runtime.device import canonical, device_scope, resolve_device
from sculptmate_tpu_torch.systems.sf3d import mesh_arrays
from sculptmate_tpu_torch.systems.tsr import upload


class SF3DFarm:
    """Batched SF3D generation over the ``dp`` axis of ``mesh``, the
    backbone tensor-parallel over ``tp_axis`` when given. ``sf3d`` is a
    ``systems.sf3d.SF3D``. Without a mesh the farm runs on ``device``,
    which defaults to the card and must be the model's (pass
    ``device="cpu"`` for a model on the CPU); ``tp_axis`` then raises."""

    def __init__(self, sf3d, mesh: Optional[DeviceMesh] = None, dp_axis: str = "dp", tp_axis: Optional[str] = None,
                 device=None):
        if mesh is None:
            if tp_axis is not None:
                raise ValueError("tp_axis needs a mesh with that axis: SF3DFarm(sf3d, mesh, tp_axis=...)")
            device = resolve_device(device)
            if device != sf3d.device:
                raise ValueError(f"the farm's device {device} is not the model's {sf3d.device}")
            mesh = make_mesh((1,), (dp_axis,), devices=[device])
        elif device is not None:
            raise ValueError("a farm over a mesh takes its devices from the mesh, not from device=")
        groups = mesh.groups(dp_axis, tp_axis)
        self.sf3d, self.mesh, self.dp_axis = sf3d, mesh, dp_axis
        self.device = groups[0][0]
        self._replicas = replicate([g[0] for g in groups], sf3d)
        self._tp = [g if tp_axis is not None else None for g in groups]

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
        c = self.sf3d.config
        thr = float(c.isosurface_threshold if threshold is None else threshold)
        x = upload(images, self.device)
        assets = []  # (replica, code, materials) per asset, in batch order
        with record_function("sf3d_farm.front"):
            for s, part in enumerate(shard_batch(self.mesh, x, self.dp_axis)):
                if not len(part):
                    continue
                sf3d = self._replicas[canonical(part.device)]
                with device_scope(part.device):
                    mask, rgb = sf3d.prepare_image(part)
                    codes, _ = sf3d.get_scene_codes(rgb, self._tp[s])
                    materials = sf3d.estimate_materials(rgb * mask)
                assets += [(sf3d, code, {k: v[i] for k, v in materials.items()}) for i, code in enumerate(codes)]
        with record_function("sf3d_farm.extract"):
            wires = []
            for sf3d, code, _ in assets:
                with device_scope(code.device):
                    wires.append(sf3d.extract_wire_async(code, thr))

        def decode(i):
            """Host tail of asset i: the wire (re-extracted on overflow),
            then the decimation; and the dispatch of its fused bake."""
            sf3d, code, mats = assets[i]
            with record_function("sf3d_farm.decode"), device_scope(code.device):
                extracted = sf3d.extract_mesh(code, thr, pending=wires[i])
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
            with record_function("sf3d_farm.bake_dispatch"), device_scope(code.device):
                return mesh, sf3d.unwrap_bake_async(mesh.v_pos, mesh.t_pos_idx, code, mats, bake_resolution)

        def finish(i, mesh, handle):
            if mesh is None:
                return None
            sf3d, code, _ = assets[i]
            if handle is None:
                mesh.unwrap_uv(backend="auto", device=code.device)
                return {**mesh_arrays(mesh), "textures": None, "texture_pngs": None, "roughness": None,
                        "metallic": None}
            with record_function("sf3d_farm.bake_wait"), device_scope(code.device):
                uv_flat, textures = sf3d.unwrap_bake_wait(handle)
                mesh.apply_flat_uv(uv_flat)
            return {**mesh_arrays(mesh), **textures}

        results, prev = [], None
        for i in range(len(assets)):
            entry = (i, *decode(i))  # asset i-1's bake runs on the device meanwhile
            if prev is not None:
                results.append(finish(*prev))
            prev = entry
        if prev is not None:
            results.append(finish(*prev))
        return results
