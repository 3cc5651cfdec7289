"""Blender UI panel + operators (mirrors ``GUIPanel.py``).

Counterpart of ``sculptmate_tpu/addon/panel.py`` on the port's generators
(``sculptmate_tpu_torch.pipelines``) and preprocessing. Panel with model
selector (lean/fast), vertex-simplification enum (fast only), texture
toggle, image preview and a Generate button that runs the generation on a
worker thread so the Blender UI stays responsive (``GUIPanel.py:69-220``).
Without a CUDA device the Generate row is disabled, as the reference's
``torch.cuda`` check does (``GUIPanel.py:91-96``): the generators run on
the card.
"""

from __future__ import annotations

import os
import threading
import time
import traceback

import bpy  # type: ignore
import torch

from sculptmate_tpu_torch.pipelines import Fast3DGenerator, TripoGenerator

_generators = {"lean": None, "fast": None}


def _devices_available() -> bool:
    return torch.cuda.is_available()


class GenerationWorker(threading.Thread):
    def __init__(self, image, model_type, simplification, enable_texture, name):
        super().__init__()
        self.image = image
        self.model_type = model_type
        self.simplification = simplification
        self.enable_texture = enable_texture
        self.mesh_name = name

    def run(self):
        wm = bpy.context.window_manager
        try:
            t0 = time.time()
            if self.model_type == "lean":
                if _generators["lean"] is None:
                    gen = TripoGenerator()
                    gen.initiate_model()
                    _generators["lean"] = gen
                code = _generators["lean"].generate_mesh(
                    self.image,
                    enable_texture=self.enable_texture,
                    mesh_name=self.mesh_name,
                )
            else:
                if _generators["fast"] is None:
                    gen = Fast3DGenerator()
                    gen.initiate_model()
                    _generators["fast"] = gen
                code = _generators["fast"].generate_mesh(
                    self.image,
                    vertex_simplification_factor=self.simplification,
                    enable_texture=self.enable_texture,
                    mesh_name=self.mesh_name,
                )
            if code == 0:
                wm.sm_message = f"Done in {time.time() - t0:.1f}s"
            else:
                wm.sm_message = f"Generation failed (code {code})"
        except Exception:
            print("[SculptMate Logging]", traceback.format_exc())
            wm.sm_message = "Generation failed; see console"
        finally:
            wm.sm_buttons_enabled = True


class SM_OT_FileBrowser(bpy.types.Operator):
    bl_idname = "sculptmate.filebrowser"
    bl_label = "Select Image"

    filepath: bpy.props.StringProperty(subtype="FILE_PATH")

    def execute(self, context):
        context.window_manager.sm_image_path = self.filepath
        return {"FINISHED"}

    def invoke(self, context, event):
        context.window_manager.fileselect_add(self)
        return {"RUNNING_MODAL"}


class SM_OT_Generate(bpy.types.Operator):
    bl_idname = "sculptmate.generate"
    bl_label = "Generate"

    def execute(self, context):
        wm = context.window_manager
        path = wm.sm_image_path
        if not path or not os.path.isfile(path):
            wm.sm_message = "Select an image first"
            return {"CANCELLED"}
        import numpy as np
        from PIL import Image

        from sculptmate_tpu_torch.frontend import preprocess_image

        model = wm.sm_model_type
        ratio = 0.85 if model == "fast" else 0.75
        img = preprocess_image(
            Image.open(path), ratio=ratio, use_alpha=model == "fast"
        )
        if img is None:
            wm.sm_message = "Foreground too small; try another image"
            return {"CANCELLED"}
        arr = np.asarray(img, dtype=np.float32) / 255.0

        wm.sm_buttons_enabled = False
        wm.sm_message = "Generating..."
        name = os.path.splitext(os.path.basename(path))[0]
        GenerationWorker(
            arr, model, wm.sm_vertex_simplification, wm.sm_enable_textures, name
        ).start()
        return {"FINISHED"}


class SM_PT_Main(bpy.types.Panel):
    bl_label = "SculptMate"
    bl_idname = "SM_PT_main"
    bl_space_type = "VIEW_3D"
    bl_region_type = "UI"
    bl_category = "SculptMate"

    def draw(self, context):
        wm = context.window_manager
        layout = self.layout
        col = layout.column()
        col.prop(wm, "sm_model_type", text="Model")
        if wm.sm_model_type == "fast":
            col.prop(wm, "sm_vertex_simplification", text="Detail")
        col.prop(wm, "sm_enable_textures", text="Textures")
        col.operator(SM_OT_FileBrowser.bl_idname, text="Select Image")
        if wm.sm_image_path:
            col.label(text=os.path.basename(wm.sm_image_path))
        row = col.row()
        row.enabled = wm.sm_buttons_enabled and _devices_available()
        row.operator(SM_OT_Generate.bl_idname, text="Generate")
        if wm.sm_message:
            col.label(text=wm.sm_message)


_classes = (SM_OT_FileBrowser, SM_OT_Generate, SM_PT_Main)


def register():
    wm = bpy.types.WindowManager
    wm.sm_image_path = bpy.props.StringProperty(default="")
    wm.sm_message = bpy.props.StringProperty(default="")
    wm.sm_buttons_enabled = bpy.props.BoolProperty(default=True)
    wm.sm_model_type = bpy.props.EnumProperty(
        items=[("lean", "Lean", "TripoSR-class"), ("fast", "Pro", "SF3D-class")],
        default="lean",
    )
    wm.sm_vertex_simplification = bpy.props.EnumProperty(
        items=[
            ("high", "High detail", "75% of vertices"),
            ("medium", "Medium detail", "40% of vertices"),
            ("low", "Low detail", "10% of vertices"),
        ],
        default="high",
    )
    wm.sm_enable_textures = bpy.props.BoolProperty(default=True)
    for cls in _classes:
        bpy.utils.register_class(cls)


def unregister():
    for cls in reversed(_classes):
        bpy.utils.unregister_class(cls)
