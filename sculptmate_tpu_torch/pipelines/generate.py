"""Generator facades, API-compatible with the reference.

Counterparts of ``sculptmate_tpu/pipelines/generate.py``: ``TripoGenerator``
(Lean, ``TripoSR/generate.py:8-43``) and ``Fast3DGenerator`` (SF3D,
``StableFast/generate.py:8-59``), each a lazy ``initiate_model`` +
``generate_mesh`` with the same return codes (0 ok / 1 not initialized / 2
error); ``initiate_model`` loads a checkpoint directory in the reference's
layout. The model runs on the card unless ``device="cpu"`` is passed to
``initiate_model``. Inside Blender (where ``bpy`` imports) ``generate_mesh``
imports the result into the scene through ``addon/blender_io.py``;
elsewhere it writes a GLB next to the input (or to ``output_path``).
"""

from __future__ import annotations

import os
import time
import traceback
from typing import Optional

import numpy as np


def _in_blender() -> bool:
    try:
        import bpy  # noqa: F401

        return True
    except ImportError:
        return False


class TripoGenerator:
    def __init__(self):
        self.model = None
        self.mc_resolution = 256

    def initiate_model(self, checkpoint_dir: Optional[str] = None, device: str = "cuda") -> int:
        """Build the model, from ``checkpoint_dir`` (the reference's
        ``config.yaml`` and torch ``model.ckpt``) when given, else with random
        weights. Returns 0, or 1 on failure."""
        try:
            import torch

            from sculptmate_tpu_torch.systems.tsr import TSR, TSRConfig

            config = state_dict = None
            if checkpoint_dir and os.path.isdir(checkpoint_dir):
                cfg_path = os.path.join(checkpoint_dir, "config.yaml")
                if os.path.isfile(cfg_path):
                    config = TSRConfig.from_yaml(cfg_path)
                ckpt_path = os.path.join(checkpoint_dir, "model.ckpt")
                if os.path.isfile(ckpt_path):
                    state_dict = torch.load(ckpt_path, map_location="cpu", weights_only=True)
                    state_dict = state_dict.get("state_dict", state_dict)
            self.model = TSR(config=config, state_dict=state_dict, device=device)
            return 0
        except Exception:
            print("[Model Initialization Error]", traceback.format_exc())
            return 1

    def generate_mesh(
        self,
        image,
        device: Optional[str] = None,
        enable_texture: bool = True,
        mesh_name: str = "NewMesh",
        output_path: Optional[str] = None,
        threshold: float = 25.0,
    ) -> int:
        """image: (H, W, 3|4) or (1, H, W, 3|4), uint8-range or [0, 1].
        ``device`` is accepted for the reference's signature; the model runs
        where ``initiate_model`` placed it."""
        if self.model is None:
            return 1
        try:
            from sculptmate_tpu_torch.io import write_glb

            t0 = time.time()
            arr = np.asarray(image, dtype=np.float32)
            if arr.max() > 1.5:
                arr = arr / 255.0
            if arr.ndim == 3:
                arr = arr[None]
            codes = self.model.scene_codes(arr[..., :3])
            verts, faces, colors = self.model.extract_mesh(
                codes,
                has_vertex_color=enable_texture,
                resolution=self.mc_resolution,
                threshold=threshold,
            )[0]
            print(f"[SculptMate Logging] Generation took {time.time() - t0:.2f}s")
            if len(verts) == 0:
                return 2
            if _in_blender():
                from sculptmate_tpu_torch.addon.blender_io import import_mesh

                import_mesh(verts, faces, vertex_colors=colors, name=mesh_name)
            else:
                write_glb(output_path or f"{mesh_name}.glb", verts, faces, vertex_colors=colors)
            return 0
        except Exception:
            print("[Generation Error]", traceback.format_exc())
            return 2


class Fast3DGenerator:
    """Counterpart of ``sculptmate_tpu/pipelines/generate.py:Fast3DGenerator``
    (``StableFast/generate.py:8-59``): a textured mesh by default, with the
    albedo, normal and metallic-roughness maps in the GLB."""

    def __init__(self):
        self.model = None
        self.texture_resolution = 512  # the baked maps' size

    def initiate_model(self, checkpoint_dir: Optional[str] = None, device: str = "cuda") -> int:
        """Build the model, from ``checkpoint_dir`` (the reference's
        ``config.yaml`` and ``model.safetensors``, each where present) when
        given, else with random weights. Returns 0, or 1 on failure."""
        try:
            from sculptmate_tpu_torch.runtime.checkpoint import load_sf3d_state_dict
            from sculptmate_tpu_torch.systems.sf3d import SF3D, SF3DConfig

            config = state_dict = None
            if checkpoint_dir and os.path.isdir(checkpoint_dir):
                cfg_path = os.path.join(checkpoint_dir, "config.yaml")
                if os.path.isfile(cfg_path):
                    config = SF3DConfig.from_yaml(cfg_path)
                st_path = os.path.join(checkpoint_dir, "model.safetensors")
                if os.path.isfile(st_path):
                    state_dict = load_sf3d_state_dict(st_path)
            self.model = SF3D(config=config, state_dict=state_dict, device=device)
            return 0
        except Exception:
            print("[Model Initialization Error]", traceback.format_exc())
            return 1

    def generate_mesh(
        self,
        image,
        device: Optional[str] = None,
        vertex_simplification_factor: str = "high",
        enable_texture: bool = True,
        mesh_name: str = "NewMesh",
        output_path: Optional[str] = None,
        threshold: Optional[float] = None,
    ) -> int:
        """image: (H, W, 4) RGBA (or 3 channels), uint8-range or [0, 1].
        Writes a GLB with normals and UVs and, with ``enable_texture``, the
        three baked textures (in Blender: the mesh, its UV layer and the
        albedo and bump images). ``threshold`` overrides the config's
        iso-level."""
        if self.model is None:
            return 1
        try:
            from sculptmate_tpu_torch.io import write_glb

            t0 = time.time()
            arr = np.asarray(image, dtype=np.float32)
            if arr.max() > 1.5:
                arr = arr / 255.0
            if arr.ndim == 3:
                arr = arr[None]
            mesh = self.model.run_image(
                arr,
                bake_resolution=self.texture_resolution,
                vertex_simplification_factor=vertex_simplification_factor,
                enable_texture=enable_texture,
                threshold=threshold,
            )
            print(f"[SculptMate Logging] Generation took {time.time() - t0:.2f}s")
            if mesh is None or len(mesh["verts"]) == 0:
                return 2
            if _in_blender():
                from sculptmate_tpu_torch.addon.blender_io import import_mesh

                import_mesh(mesh["verts"], mesh["faces"], uvs=mesh.get("uvs"), textures=mesh.get("textures"),
                            name=mesh_name)
            else:
                write_glb(output_path or f"{mesh_name}.glb", mesh["verts"], mesh["faces"], normals=mesh["normals"],
                          uvs=mesh["uvs"], textures=mesh["texture_pngs"])
            return 0
        except Exception:
            print("[Generation Error]", traceback.format_exc())
            return 2
