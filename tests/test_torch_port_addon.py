"""The port's Blender add-on under a fake bpy (``fake_bpy.py``): the cases of
``test_addon_bpy.py`` on ``sculptmate_tpu_torch.addon``, the port's
``TripoGenerator`` importing into the scene what the JAX generator imports
from the same weights, and the cases of ``test_updater_and_downloads.py``
on the port's updater and download layer (``file://`` URLs and stubs)."""

import importlib
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fake_bpy
from sculptmate_tpu.ops.density_grid import mlp_weights_from_params, query_density_grid
from sculptmate_tpu.systems.tsr import TSR as JTSR
from sculptmate_tpu.systems.tsr import TSRConfig as JTSRConfig
from sculptmate_tpu_torch.addon.updater import AddonUpdater, _parse_version
from sculptmate_tpu_torch.runtime.checkpoint import tsr_params_from_jax
from sculptmate_tpu_torch.runtime.downloads import ensure_checkpoint, fetch
from sculptmate_tpu_torch.systems.tsr import TSR, TSRConfig

SMALL = dict(
    cond_image_size=64, plane_size=8, num_channels=64, num_attention_heads=4,
    attention_head_dim=16, num_layers=2, cross_attention_dim=64, vit_hidden_size=64,
    vit_num_layers=2, vit_num_heads=4, vit_intermediate_size=128,
)


@pytest.fixture()
def bpy_env():
    """A fresh fake bpy, the port's bpy-importing add-on modules (re)imported
    against it; the bpy module found before is put back afterwards."""
    prev = sys.modules.get("bpy")
    bpy = fake_bpy.install()
    for mod in ("panel", "preferences", "blender_io"):
        name = f"sculptmate_tpu_torch.addon.{mod}"
        if name in sys.modules:
            importlib.reload(sys.modules[name])
        else:
            importlib.import_module(name)
    yield bpy
    if prev is not None:
        sys.modules["bpy"] = prev
    else:
        sys.modules.pop("bpy", None)


def _wait_enabled(wm, flag="sm_buttons_enabled", value=True):
    deadline = time.time() + 30
    while getattr(wm, flag) != value and time.time() < deadline:
        time.sleep(0.05)


def test_panel_register_and_draw(bpy_env):
    from sculptmate_tpu_torch.addon import panel

    panel.register()
    assert len(bpy_env.utils.registered) == 3
    wm = bpy_env.context.window_manager
    assert wm.sm_model_type == "lean"
    assert wm.sm_buttons_enabled is True

    p = panel.SM_PT_Main()
    p.layout = fake_bpy._Layout()
    p.draw(bpy_env.context)
    kinds = [c[0] for c in p.layout.calls]
    assert "operator" in kinds and "prop" in kinds

    wm.sm_model_type = "fast"  # the simplification dropdown
    p2 = panel.SM_PT_Main()
    p2.layout = fake_bpy._Layout()
    p2.draw(bpy_env.context)
    assert len(p2.layout.calls) > len(p.layout.calls) - 2
    panel.unregister()
    assert not bpy_env.utils.registered


def test_panel_generate_row_follows_the_card(bpy_env, monkeypatch):
    """``_devices_available`` is ``torch.cuda.is_available()``: without a
    card the panel's Generate row is disabled."""
    from sculptmate_tpu_torch.addon import panel

    panel.register()
    rows, row = [], fake_bpy._Layout.row
    monkeypatch.setattr(fake_bpy._Layout, "row", lambda self, **kw: rows.append(row(self, **kw)) or rows[-1])
    enabled = {}
    for available in (False, True):
        monkeypatch.setattr(torch.cuda, "is_available", lambda a=available: a)
        p = panel.SM_PT_Main()
        p.layout = fake_bpy._Layout()
        p.draw(bpy_env.context)
        enabled[available] = rows[-1].enabled
    panel.unregister()
    assert enabled == {False: False, True: True}


def test_generate_operator_end_to_end(bpy_env, monkeypatch, tmp_path):
    from PIL import Image

    import sculptmate_tpu_torch.frontend as frontend
    from sculptmate_tpu_torch.addon import panel

    panel.register()
    wm = bpy_env.context.window_manager

    op = panel.SM_OT_Generate()  # no image selected: cancelled with a message
    assert op.execute(bpy_env.context) == {"CANCELLED"}
    assert "image" in wm.sm_message.lower()

    img_path = tmp_path / "input.png"
    Image.new("RGBA", (300, 300), (200, 40, 40, 255)).save(img_path)
    wm.sm_image_path = str(img_path)
    monkeypatch.setattr(frontend, "preprocess_image", lambda img, **kw: img)
    calls = {}

    class FakeGen:
        def initiate_model(self):
            calls["init"] = True

        def generate_mesh(self, image, **kw):
            calls["image_shape"] = np.asarray(image).shape
            calls["kw"] = kw
            return 0

    monkeypatch.setattr(panel, "TripoGenerator", FakeGen)
    monkeypatch.setitem(panel._generators, "lean", None)
    assert op.execute(bpy_env.context) == {"FINISHED"}
    _wait_enabled(wm)
    assert wm.sm_buttons_enabled, "worker thread never finished"
    assert wm.sm_message.startswith("Done"), wm.sm_message
    assert calls["init"] and calls["image_shape"] == (300, 300, 4)
    assert calls["kw"]["mesh_name"] == "input"

    class FailGen(FakeGen):  # a failure code reaches the UI
        def generate_mesh(self, image, **kw):
            return 2

    monkeypatch.setitem(panel._generators, "lean", FailGen())
    assert op.execute(bpy_env.context) == {"FINISHED"}
    _wait_enabled(wm)
    assert "failed" in wm.sm_message.lower()
    panel.unregister()


def test_file_browser_operator(bpy_env):
    from sculptmate_tpu_torch.addon import panel

    op = panel.SM_OT_FileBrowser()
    op.filepath = "/tmp/pic.png"
    assert op.execute(bpy_env.context) == {"FINISHED"}
    assert bpy_env.context.window_manager.sm_image_path == "/tmp/pic.png"
    assert op.invoke(bpy_env.context, None) == {"RUNNING_MODAL"}
    assert bpy_env.context.window_manager.fileselect_ops == [op]


def test_preferences_register_draw_download(bpy_env, monkeypatch):
    """The preferences report the CUDA devices (or that there is none) and
    drive the download progress to 100 through a stubbed download."""
    from sculptmate_tpu_torch.addon import preferences

    preferences.register()
    wm = bpy_env.context.window_manager
    assert wm.sm_download_progress == -1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prefs = preferences.SMPreferences()
    prefs.draw(bpy_env.context)
    labels = [c[2].get("text", "") for c in prefs.layout.calls if c[0] == "label"]
    assert "Compute: no CUDA device" in labels
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "NVIDIA H100 80GB HBM3")
    assert preferences._device_report() == "1 CUDA device(s): NVIDIA H100 80GB HBM3"

    class Res:
        ok = True
        error = None

    monkeypatch.setattr(preferences, "ensure_checkpoint", lambda name: Res())
    op = preferences.SM_OT_DownloadCheckpoints()
    assert op.execute(bpy_env.context) == {"FINISHED"}
    _wait_enabled(wm, "sm_download_progress", 100)
    assert wm.sm_download_progress == 100
    preferences.unregister()


def test_blender_io_import_mesh(bpy_env):
    from sculptmate_tpu_torch.addon import blender_io

    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32)
    faces = np.array([[0, 1, 2], [0, 2, 3]], np.int64)
    colors = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 1]], np.float32)
    obj = blender_io.import_mesh(verts, faces, vertex_colors=colors, name="m")
    assert bpy_env.context.linked_objects == [obj]
    mesh = obj.data
    assert len(mesh.verts) == 4 and len(mesh.faces) == 2
    assert len(mesh.loops) == 6 and len(mesh.materials) == 1
    layer = mesh.vertex_colors["m_VC"]
    assert [list(layer.data[li].color) for li in range(6)] == [
        list(colors[v]) + [1.0] for f in faces for v in f]

    uvs = np.random.default_rng(0).random((4, 2)).astype(np.float32)  # SF3D: a UV layer and baked images
    tex = {"albedo": np.zeros((8, 8, 3), np.float32), "bump": np.zeros((8, 8, 3), np.float32)}
    obj2 = blender_io.import_mesh(verts, faces, uvs=uvs, textures=tex, roughness=0.4, metallic=0.1, name="m2")
    assert len(bpy_env.data.images.items) == 2
    assert obj2.data is not mesh
    uv = obj2.data.uv_layers.active.data
    assert [uv[i].uv for i in range(6)] == [tuple(uvs[v]) for f in faces for v in f]


def _margin_threshold(density):
    """A threshold at least 1e-3 from every lattice value, so occupancy
    cannot flip between the two packages' codes."""
    d = np.sort(density.ravel())
    idx = [i for i in np.nonzero(np.diff(d) >= 2e-3)[0] if 0.5 * d.size <= i <= 0.98 * d.size]
    assert idx, "no threshold with a 1e-3 margin"
    return float(d[idx[0]] + d[idx[0] + 1]) / 2


def test_tripo_generator_imports_into_the_scene(bpy_env, monkeypatch, tmp_path):
    """Under bpy the port's ``TripoGenerator`` (narrow model on the CPU)
    hands ``import_mesh`` the mesh the JAX generator hands it from the same
    weights and image: equal faces, vertices within 1e-4 and colors within
    1/255 (as the Lean slice's parity test), the same name, and no GLB."""
    import sculptmate_tpu.addon.blender_io as j_blender_io
    import sculptmate_tpu_torch.addon.blender_io as blender_io
    from sculptmate_tpu.pipelines.generate import TripoGenerator as JTripoGenerator
    from sculptmate_tpu_torch.pipelines import TripoGenerator

    base = JTSR(JTSRConfig(**SMALL), dtype=jnp.float32)
    params = jax.tree.map(np.array, base.params)
    params["decoder"]["layers"]["dense_out"]["kernel"][:, 0] *= 1000.0  # a field with margin-safe gaps
    jgen, gen = JTripoGenerator(), TripoGenerator()
    jgen.model = JTSR(JTSRConfig(**SMALL), params=params, dtype=jnp.float32)
    gen.model = TSR(TSRConfig(**SMALL), state_dict=tsr_params_from_jax(params), dtype=torch.float32, device="cpu")
    jgen.mc_resolution = gen.mc_resolution = 16
    img = (np.random.default_rng(42).random((64, 64, 3)) * 255).astype(np.uint8)
    codes = jgen.model.scene_codes(jnp.asarray(img[None] / np.float32(255.0)))
    w = mlp_weights_from_params(jgen.model.params["decoder"]["layers"])
    thr = _margin_threshold(np.asarray(query_density_grid(codes[0], w, jgen.model.grid_spec(16))))

    got = {}
    for name, module in (("port", blender_io), ("jax", j_blender_io)):
        monkeypatch.setattr(module, "import_mesh", lambda v, f, *, _n=name, **kw: got.setdefault(_n, (v, f, kw)))
    monkeypatch.chdir(tmp_path)
    assert gen.generate_mesh(img, mesh_name="asset", threshold=thr) == 0
    assert jgen.generate_mesh(img, mesh_name="asset", threshold=thr) == 0
    assert os.listdir(tmp_path) == []
    (v, f, kw), (jv, jf, jkw) = got["port"], got["jax"]
    assert len(v) > 0 and v.shape == jv.shape and np.array_equal(f, jf)
    np.testing.assert_allclose(v, jv, rtol=0, atol=1e-4)
    np.testing.assert_allclose(kw["vertex_colors"], jkw["vertex_colors"], rtol=0, atol=1.0 / 255 + 1e-6)
    assert kw["name"] == jkw["name"] == "asset"


def test_parse_version():
    assert _parse_version("v1.2.3") == (1, 2, 3)
    assert _parse_version("0.5") == (0, 5)
    assert _parse_version("v2.0-rc1") == (2, 0)


def test_updater_check_and_apply(tmp_path, monkeypatch):
    install = tmp_path / "addon"
    install.mkdir()
    (install / "old.py").write_text("old = 1\n")
    updater = AddonUpdater(user="x", repo="y", current_version=(0, 1, 0), install_dir=str(install))
    monkeypatch.setattr(updater, "_fetch_json", lambda url: {"tag_name": "v0.2.0", "zipball_url": "http://example/zip"})
    newer, tag, _ = updater.check()
    assert newer and tag == "v0.2.0"

    staged = tmp_path / "staged"  # a fake release tree, applied
    staged.mkdir()
    (staged / "new.py").write_text("new = 2\n")
    backup = updater.apply(str(staged))
    assert (install / "new.py").exists()
    assert os.path.isdir(backup)
    assert (tmp_path / "addon_backup" / "old.py").exists()
    (install / "old.py").unlink()  # restore brings old.py back
    updater.restore(backup)
    assert (install / "old.py").exists()


def test_updater_not_newer(monkeypatch, tmp_path):
    updater = AddonUpdater(user="x", repo="y", current_version=(1, 0, 0), install_dir=str(tmp_path))
    monkeypatch.setattr(updater, "_fetch_json", lambda url: {"tag_name": "v0.9", "zipball_url": "u"})
    newer, _, _ = updater.check()
    assert not newer


def test_fetch_local_file(tmp_path):
    src = tmp_path / "blob.bin"
    src.write_bytes(b"x" * 1024)
    dest = tmp_path / "out" / "blob.bin"
    seen = []
    res = fetch(src.as_uri(), str(dest), progress=lambda d, t: seen.append((d, t)))
    assert res.ok and dest.read_bytes() == b"x" * 1024
    assert seen and seen[-1][0] == 1024


def test_fetch_failure_reports_error(tmp_path):
    res = fetch("file:///nonexistent/nope", str(tmp_path / "x"), retries=2)
    assert not res.ok and res.error


def test_ensure_checkpoint_existing(tmp_path):
    (tmp_path / "model.ckpt").write_bytes(b"ok")
    res = ensure_checkpoint("model.ckpt", checkpoint_dir=str(tmp_path))
    assert res.ok and res.path.endswith("model.ckpt")


def test_ensure_checkpoint_unknown(tmp_path):
    res = ensure_checkpoint("mystery.bin", checkpoint_dir=str(tmp_path))
    assert not res.ok and "no known URL" in res.error


def test_downloads_use_the_port_checkpoint_dir(tmp_path, monkeypatch):
    """``ensure_checkpoint`` defaults to the port's checkpoint directory."""
    from sculptmate_tpu_torch.runtime import downloads
    from sculptmate_tpu_torch.runtime.checkpoint import CHECKPOINT_DIR

    assert downloads.CHECKPOINT_DIR == CHECKPOINT_DIR
    monkeypatch.setattr(downloads, "CHECKPOINT_DIR", str(tmp_path))
    (tmp_path / "u2net.onnx").write_bytes(b"ok")
    assert downloads.ensure_checkpoint("u2net.onnx").path == str(tmp_path / "u2net.onnx")
