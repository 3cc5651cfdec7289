"""Port parity for the SF3D slice: the weight bridge, every module of the
encoder, the whole encoder, and ``run_image`` untextured from image to mesh,
each held against its ``sculptmate_tpu`` counterpart on the same weights
(handed over by ``sf3d_params_from_jax``) and the same numpy inputs. A tiny
config (``tests/test_sf3d_system.py``'s), f32 on the CPU, with nonzero AdaLN
modulation weights so the camera conditioning is exercised. Tolerances are
relative to max |reference|: 1e-4 for f32 module outputs unless stated."""

import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sculptmate_tpu.models import camera as jcam
from sculptmate_tpu.models.clip import CLIPVisual as JCLIP
from sculptmate_tpu.models.dinov2 import DINOV2SingleImageTokenizer as JDINOv2
from sculptmate_tpu.models.estimators import ClipBasedHeadEstimator as JClipEst
from sculptmate_tpu.models.estimators import MultiHeadEstimator as JMultiEst
from sculptmate_tpu.models.heads import MaterialMLP as JMaterialMLP
from sculptmate_tpu.models.tokenizers import TriplaneLearnablePositionalEmbedding as JTriplaneEmb
from sculptmate_tpu.models.two_stream import TwoStreamInterleaveTransformer as JTwoStream
from sculptmate_tpu.models.upsamplers import PixelShuffleUpsampleNetwork as JPixelShuffle
from sculptmate_tpu.ops.resize import torch_bicubic_matrix as j_bicubic
from sculptmate_tpu.runtime.checkpoint import convert_sf3d_state_dict
from sculptmate_tpu.systems.sf3d import SF3D as JSF3D
from sculptmate_tpu.systems.sf3d import SF3DConfig as JSF3DConfig
from sculptmate_tpu_torch.models import camera
from sculptmate_tpu_torch.ops.resize import torch_bicubic_matrix
from sculptmate_tpu_torch.runtime.checkpoint import sf3d_params_from_jax
from sculptmate_tpu_torch.systems.sf3d import SF3D, SF3DConfig, SF3DModule

TINY = dict(
    cond_image_size=56, isosurface_resolution=14, plane_size=8, num_channels=64, num_attention_heads=4,
    attention_head_dim=16, num_latents=32, num_blocks=1, num_basic_blocks=1, upsample_scale_factor=2,
    upsample_conv_layers=2, dinov2_hidden_size=64, dinov2_num_layers=2, dinov2_num_heads=4,
    dinov2_intermediate_size=128, clip_width=64, clip_layers=2, clip_heads=4,
)


@pytest.fixture(scope="module")
def jax_sf3d():
    """The JAX tiny SF3D, its zero-initialised AdaLN projections replaced
    by N(0, 0.3) weights and biases (numpy seed 5)."""
    base = JSF3D(JSF3DConfig(**TINY), dtype=jnp.float32)
    params = jax.tree.map(np.array, base.params)
    rng = np.random.default_rng(5)
    dv = params["image_tokenizer"]["dinov2"]
    for name, layer in dv.items():
        if name.startswith("layer_"):
            for mod in ("norm1_modulation", "norm2_modulation"):
                lin = layer[mod]["linear2"]
                lin["kernel"] = (0.3 * rng.standard_normal(lin["kernel"].shape)).astype(np.float32)
                lin["bias"] = (0.3 * rng.standard_normal(lin["bias"].shape)).astype(np.float32)
    return JSF3D(JSF3DConfig(**TINY), params=params, dtype=jnp.float32)


@pytest.fixture(scope="module")
def params(jax_sf3d):
    return jax.tree.map(np.asarray, jax_sf3d.params)


@pytest.fixture(scope="module")
def port(params):
    return SF3D(SF3DConfig(**TINY), state_dict=sf3d_params_from_jax(params), dtype=torch.float32, device="cpu")


def _close(got, ref, tol=1e-4):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= tol * scale, f"max |err| {err} > {tol} * {scale}"


def test_config_fields_match_jax():
    assert [(f.name, f.default) for f in dataclasses.fields(SF3DConfig)] == [
        (f.name, f.default) for f in dataclasses.fields(JSF3DConfig)
    ]


def test_weight_bridge_round_trip_is_exact(params):
    """flax -> state_dict -> convert_sf3d_state_dict gives the same tree,
    bitwise; the state dict loads strictly into the port's module, whose
    keys are the reference checkpoint's."""
    sd = sf3d_params_from_jax(params)
    back = convert_sf3d_state_dict({k: v.numpy() for k, v in sd.items()})
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        b = flat_b[path]
        assert a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b), path
    SF3DModule(SF3DConfig(**TINY)).load_state_dict(sd, strict=True)
    mod = params["image_tokenizer"]["dinov2"]["layer_0"]["norm1_modulation"]["linear2"]["kernel"]
    assert np.abs(mod).max() > 0  # the modulation is exercised


def test_camera_matches_jax(rng, params, port):
    assert np.array_equal(camera.default_cond_c2w(1.6), jcam.default_cond_c2w(1.6))
    for a, b in zip(camera.intrinsic_from_fov_deg(40.0, 512, 384), jcam.intrinsic_from_fov_deg(40.0, 512, 384)):
        assert np.array_equal(a, b)
    c2w = rng.standard_normal((2, 4, 4)).astype(np.float32)
    kn = rng.standard_normal((2, 3, 3)).astype(np.float32)
    ref = jcam.LinearCameraEmbedder(25, 768).apply({"params": params["camera_embedder"]}, jnp.asarray(c2w),
                                                    jnp.asarray(kn))
    _close(port.module.camera_embedder(torch.from_numpy(c2w), torch.from_numpy(kn)), ref)


@pytest.mark.parametrize("base,out", [(37, 36), (37, 4), (5, 9)])
def test_bicubic_matrix_with_scale_matches_jax(base, out):
    """DINOv2's position-table resize with the reference's (grid + 0.1) /
    base scale factor: the same matrix, exactly."""
    s = (out + 0.1) / base
    assert np.array_equal(torch_bicubic_matrix(base, out, scale=s), j_bicubic(base, out, scale=s))
    assert np.array_equal(torch_bicubic_matrix(base, out), j_bicubic(base, out))


def test_dinov2_matches_jax(rng, params, port):
    """Camera-modulated DINOv2 (position table resized 37 -> 4 with the
    +0.1 scale, nonzero modulations)."""
    c = TINY
    img = rng.random((2, 56, 56, 3)).astype(np.float32)
    cond = rng.standard_normal((2, 768)).astype(np.float32)
    jm = JDINOv2(hidden_size=c["dinov2_hidden_size"], num_layers=c["dinov2_num_layers"],
                 num_heads=c["dinov2_num_heads"], intermediate_size=c["dinov2_intermediate_size"])
    ref = jm.apply({"params": params["image_tokenizer"]}, jnp.asarray(img), jnp.asarray(cond))
    _close(port.module.image_tokenizer(torch.from_numpy(img), torch.from_numpy(cond)), ref)


def test_triplane_embedding_matches_jax(rng, params, port):
    jm = JTriplaneEmb(8, 64)
    ref = jm.apply({"params": params["tokenizer"]}, 2)
    tok = port.module.tokenizer
    _close(tok(2), ref, tol=0)
    stream = rng.standard_normal((2, 3 * 64, 64)).astype(np.float32)
    ref = jm.apply({"params": params["tokenizer"]}, jnp.asarray(stream), method=JTriplaneEmb.detokenize)
    _close(tok.detokenize(torch.from_numpy(stream)), ref, tol=0)


def test_two_stream_matches_jax(rng, params, port):
    tokens = rng.standard_normal((2, 64, 3 * 8 * 8)).astype(np.float32)
    image = rng.standard_normal((2, 17, 64)).astype(np.float32)
    jm = JTwoStream(num_attention_heads=4, attention_head_dim=16, raw_triplane_channels=64, triplane_channels=64,
                    num_latents=32, num_blocks=1, num_basic_blocks=1)
    ref = jm.apply({"params": params["backbone"]}, jnp.asarray(tokens), encoder_hidden_states=jnp.asarray(image))
    _close(port.module.backbone(torch.from_numpy(tokens), torch.from_numpy(image)), ref)


def test_pixel_shuffle_upsampler_matches_jax(rng, params, port):
    planes = rng.standard_normal((2, 3, 64, 8, 8)).astype(np.float32)
    ref = JPixelShuffle(64, 40, 2, 2).apply({"params": params["post_processor"]}, jnp.asarray(planes))
    _close(port.module.post_processor(torch.from_numpy(planes)), ref)


@pytest.mark.parametrize("include,exclude", [(None, None), (["density", "vertex_offset"], None), (None, ["features"])])
def test_material_mlp_matches_jax(rng, params, port, include, exclude):
    """Per-head output bias and activation (trunc_exp, sigmoid,
    normalize_channel_last, linear), head selection."""
    feats = rng.standard_normal((50, 120)).astype(np.float32)
    jm = JMaterialMLP(heads=JSF3DConfig().decoder_heads)
    ref = jm.apply({"params": params["decoder"]}, jnp.asarray(feats), include=include, exclude=exclude)
    got = port.module.decoder(torch.from_numpy(feats), include=include, exclude=exclude)
    assert set(got) == set(ref)
    for name in ref:
        _close(got[name], ref[name])


def test_clip_matches_jax(rng, params, port):
    img = rng.standard_normal((2, 224, 224, 3)).astype(np.float32)
    ref = JCLIP(width=64, layers=2, heads=4).apply({"params": params["image_estimator"]["clip"]}, jnp.asarray(img))
    _close(port.module.image_estimator.model.visual(torch.from_numpy(img)), ref)


def test_estimators_match_jax(rng, params, port):
    """Roughness and metallic (CLIP, bilinear resize to 224, Beta mode) and
    the illumination amplitudes, under the JAX package's keys."""
    img = rng.random((2, 56, 56, 3)).astype(np.float32)
    ref = JClipEst(clip_width=64, clip_layers=2, clip_heads=4).apply(
        {"params": params["image_estimator"]}, jnp.asarray(img))
    got = port.module.image_estimator(torch.from_numpy(img))
    assert set(got) == set(ref) == {"decoder_roughness", "decoder_metallic"}
    for key in ref:
        _close(got[key], ref[key])
    planes = rng.standard_normal((2, 3, 64, 8, 8)).astype(np.float32)
    ref = JMultiEst(triplane_features=64).apply({"params": params["global_estimator"]}, jnp.asarray(planes))
    got = port.module.global_estimator(torch.from_numpy(planes))
    _close(got["sg_amplitudes"], ref["sg_amplitudes"])


def test_scene_codes_match_jax(rng, jax_sf3d, port):
    """The whole encoder from an RGBA image of another size: the
    background composite and resize, the fixed camera, both outputs."""
    img = rng.random((1, 70, 70, 4)).astype(np.float32)
    jmask, jrgb = jax_sf3d.prepare_image(jnp.asarray(img))
    jcodes, jdirect = jax_sf3d.get_scene_codes(jrgb)
    mask, rgb = port.prepare_image(torch.from_numpy(img))
    _close(mask, jmask, tol=1e-5)
    _close(rgb, jrgb, tol=1e-5)
    codes, direct = port.get_scene_codes(rgb)
    assert codes.shape == (1, 3, 40, 16, 16) and direct.shape == (1, 3, 64, 8, 8)
    _close(codes, jcodes)
    _close(direct, jdirect)


def _threshold(jax_sf3d, img):
    """The mean density of the tiny model's lattice: a surface at any seed."""
    from sculptmate_tpu.ops.density_grid import lattice_coords_tets, query_grid_multihead

    codes, _ = jax_sf3d.get_scene_codes(jax_sf3d.prepare_image(jnp.asarray(img))[1])
    g = query_grid_multihead(codes[0], jax_sf3d._head_weights(["density"]),
                             lattice_coords_tets(jax_sf3d.config.isosurface_resolution), jax_sf3d.grid_spec(slab=1))
    return float(np.exp(np.asarray(g["density"][0]) - 1.0).mean())


def test_run_image_untextured_matches_jax(rng, jax_sf3d, port):
    """Image to mesh, port against the JAX package: vertex and face counts
    within 2 % (the decimator's collapse order can turn on f32 rounding of
    the encoder's outputs), UVs in [0, 1], unit normals, vertices in the
    bbox; the stage timings are reported."""
    img = rng.random((1, 56, 56, 4)).astype(np.float32)
    thr = _threshold(jax_sf3d, img)
    ref = jax_sf3d.run_image(jnp.asarray(img), enable_texture=False, threshold=thr)
    timings = {}
    got = port.run_image(img, enable_texture=False, threshold=thr, timings=timings)
    assert set(timings) == {"encode", "extract", "decimate", "unwrap"}
    assert set(got) == set(ref)
    for key in ("verts", "faces"):
        assert abs(len(got[key]) - len(ref[key])) <= 0.02 * len(ref[key]), key
    nv = len(got["verts"])
    assert nv > 0 and got["faces"].max() < nv and got["uvs"].shape == (nv, 2)
    assert got["uvs"].min() >= 0 and got["uvs"].max() <= 1
    assert np.abs(got["verts"]).max() <= port.config.radius * (1 + 2 / port.config.isosurface_resolution)
    np.testing.assert_allclose(np.linalg.norm(got["normals"], axis=1), 1.0, atol=1e-4)
    assert got["textures"] is None and got["texture_pngs"] is None


def test_fast3d_generator_writes_glb_on_cpu(tmp_path, rng, port, jax_sf3d, monkeypatch):
    """0 and a GLB with normals and UVs, untextured or (the default) with
    the three baked textures; 1 before initiate_model; 2 for an empty
    mesh. Outside Blender: a fake bpy that another test file installed is
    removed for the test, or the generator imports into its scene."""
    from sculptmate_tpu_torch.pipelines.generate import Fast3DGenerator

    monkeypatch.delitem(sys.modules, "bpy", raising=False)

    gen = Fast3DGenerator()
    img = (rng.random((56, 56, 4)) * 255).astype(np.uint8)
    assert gen.generate_mesh(img) == 1
    gen.model = port
    thr = _threshold(jax_sf3d, img[None].astype(np.float32) / 255.0)
    out = tmp_path / "m.glb"
    assert gen.generate_mesh(img, output_path=str(out), enable_texture=False, threshold=thr) == 0
    data = out.read_bytes()
    assert data[:4] == b"glTF"
    gltf = json.loads(data[20 : 20 + int.from_bytes(data[12:16], "little")])
    assert {"POSITION", "NORMAL", "TEXCOORD_0"} <= set(gltf["meshes"][0]["primitives"][0]["attributes"])
    assert "images" not in gltf
    assert gen.generate_mesh(img, output_path=str(out), enable_texture=False, threshold=1e9) == 2
    assert gen.generate_mesh(img, output_path=str(out), threshold=thr) == 0
    data = out.read_bytes()
    gltf = json.loads(data[20 : 20 + int.from_bytes(data[12:16], "little")])
    assert len(gltf["images"]) == 3 and gltf["meshes"][0]["primitives"][0]["material"] == 0


def test_cli_generate_fast_on_cpu(tmp_path, monkeypatch, capsys, rng, port, jax_sf3d):
    """``generate --model fast --device cpu`` on a PNG (host matting,
    ratio 0.85 with alpha): exit 0, a GLB, the JSON line; with
    ``--texture`` the GLB holds the three baked textures."""
    from PIL import Image

    from sculptmate_tpu_torch import cli
    from sculptmate_tpu_torch.frontend import matting

    class _AlphaSession:  # the image's own alpha as the matte
        def predict(self, img):
            return [img.getchannel("A")]

    monkeypatch.setattr(matting, "default_session", lambda device=None: _AlphaSession())
    monkeypatch.setattr(cli, "SF3D", lambda seed, device: port)
    img = np.zeros((300, 300, 4), np.uint8)
    img[60:250, 70:230] = rng.integers(60, 255, (190, 160, 4))
    img[60:250, 70:230, 3] = 255
    png = tmp_path / "in.png"
    Image.fromarray(img).save(png)
    thr = _threshold(jax_sf3d, rng.random((1, 56, 56, 4)).astype(np.float32))
    out = tmp_path / "out.glb"
    rc = cli.main(["generate", str(png), "-o", str(out), "--model", "fast", "--device", "cpu",
                   "--threshold", str(thr), "--vertex-simplification", "low"])
    assert rc == 0 and out.read_bytes()[:4] == b"glTF"
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["model"] == "fast" and line["verts"] > 0 and line["faces"] > 0
    rc = cli.main(["generate", str(png), "-o", str(out), "--model", "fast", "--device", "cpu", "--texture",
                   "--threshold", str(thr), "--vertex-simplification", "low"])
    data = out.read_bytes()
    gltf = json.loads(data[20 : 20 + int.from_bytes(data[12:16], "little")])
    assert rc == 0 and len(gltf["images"]) == 3
