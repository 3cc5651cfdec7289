"""Generator facade, API-compatible with the reference.

Counterpart of ``sculptmate_tpu/pipelines/generate.py:TripoGenerator``
(``TripoSR/generate.py:8-43``): lazy ``initiate_model`` + ``generate_mesh``
with the same return codes (0 ok / 1 not initialized / 2 error). The model
runs on the card unless ``device="cpu"`` is passed to ``initiate_model``.
The result is written as GLB (importing into Blender is not ported yet).
"""

from __future__ import annotations

import os
import time
import traceback
from typing import Optional

import numpy as np


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
            write_glb(output_path or f"{mesh_name}.glb", verts, faces, vertex_colors=colors)
            return 0
        except Exception:
            print("[Generation Error]", traceback.format_exc())
            return 2
