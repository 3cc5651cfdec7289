"""Blender add-on shell of the PyTorch/CUDA port.

Counterpart of ``sculptmate_tpu/addon/__init__.py``: the reference's UX
surface (``__init__.py``/``GUIPanel.py``) on the port's generators, which
run on an NVIDIA card through CUDA. Importing this package is safe outside
Blender; ``panel`` and ``preferences`` import ``bpy``."""

bl_info = {
    "name": "SculptMate (CUDA)",
    "author": "SculptMate",
    "version": (0, 1, 0),
    "blender": (3, 2, 0),
    "location": "View3D > Sidebar > SculptMate",
    "description": "Generate a 3D model from an image (PyTorch engine with CUDA kernels for NVIDIA H100)",
    "category": "3D View",
}


def register():  # pragma: no cover - requires Blender
    from sculptmate_tpu_torch.addon import panel, preferences

    preferences.register()
    panel.register()


def unregister():  # pragma: no cover - requires Blender
    from sculptmate_tpu_torch.addon import panel, preferences

    panel.unregister()
    preferences.unregister()
