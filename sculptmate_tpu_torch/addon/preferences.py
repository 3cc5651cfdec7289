"""Add-on preferences: environment check, checkpoint downloads, updater UI.

Counterpart of ``sculptmate_tpu/addon/preferences.py``. The reference's L0
layer (``__init__.py``) pip-installs 14 packages and downloads checkpoints
from preference buttons. Here there is nothing to pip-install (PyTorch
ships with the host), so preferences reduce to: the CUDA device report,
checkpoint download buttons (worker threads + progress props, through
``runtime/downloads.py``), and the auto-update toggle.
"""

from __future__ import annotations

import os
import threading

import bpy  # type: ignore
import torch

from sculptmate_tpu_torch.runtime.checkpoint import CHECKPOINT_DIR
from sculptmate_tpu_torch.runtime.downloads import DEFAULT_ARTIFACTS, ensure_checkpoint


def _device_report() -> str:
    if not torch.cuda.is_available():
        return "no CUDA device"
    return f"{torch.cuda.device_count()} CUDA device(s): {torch.cuda.get_device_name(0)}"


class SM_OT_DownloadCheckpoints(bpy.types.Operator):
    bl_idname = "sculptmate.download_checkpoints"
    bl_label = "Download Checkpoints"
    bl_description = "Fetch u2net + model checkpoints (~1 GB)"

    def execute(self, context):
        wm = context.window_manager

        def work():
            total = len(DEFAULT_ARTIFACTS)
            for i, name in enumerate(DEFAULT_ARTIFACTS):
                wm.sm_download_progress = int(100 * i / total)
                res = ensure_checkpoint(name)
                if not res.ok:
                    wm.sm_download_progress = -2
                    print("[Download Error]", res.error)
                    return
            wm.sm_download_progress = 100

        wm.sm_download_progress = 0
        threading.Thread(target=work, daemon=True).start()
        return {"FINISHED"}


class SMPreferences(bpy.types.AddonPreferences):
    bl_idname = "sculptmate_tpu_torch"

    auto_check_update: bpy.props.BoolProperty(
        name="Auto-check for updates", default=False
    )

    def draw(self, context):
        wm = context.window_manager
        layout = self.layout
        layout.label(text=f"Compute: {_device_report()}")
        have = [
            n for n in DEFAULT_ARTIFACTS if os.path.isfile(os.path.join(CHECKPOINT_DIR, n))
        ]
        layout.label(text=f"Checkpoints: {len(have)}/{len(DEFAULT_ARTIFACTS)} present")
        layout.operator(SM_OT_DownloadCheckpoints.bl_idname)
        progress = wm.sm_download_progress
        if progress == -2:
            layout.label(text="Download failed; see console")
        elif 0 <= progress < 100:
            layout.label(text=f"Downloading... {progress}%")
        layout.prop(self, "auto_check_update")


def register():
    bpy.types.WindowManager.sm_download_progress = bpy.props.IntProperty(default=-1)
    bpy.utils.register_class(SM_OT_DownloadCheckpoints)
    bpy.utils.register_class(SMPreferences)


def unregister():
    bpy.utils.unregister_class(SMPreferences)
    bpy.utils.unregister_class(SM_OT_DownloadCheckpoints)
