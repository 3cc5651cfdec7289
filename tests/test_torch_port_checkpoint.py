"""Port parity for the checkpoint directory: the YAML loader with ``${...}``
interpolation, ``SF3DConfig.from_yaml`` and ``TSRConfig.from_yaml`` in the
reference's layouts, the safetensors reader against the ``safetensors``
package, and a tiny SF3D written as ``model.safetensors`` and loaded by both
packages (the same scene codes and the same untextured mesh), then
``Fast3DGenerator.initiate_model`` and the CLI's ``convert``. Tolerances
are stated per test."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file as st_load_numpy
from safetensors.numpy import save_file as st_save_numpy
from safetensors.torch import load_file as st_load_torch
from safetensors.torch import save_file as st_save_torch

from sculptmate_tpu.config import load_yaml_config as j_load_yaml_config
from sculptmate_tpu.config import parse_structured as j_parse_structured
from sculptmate_tpu.ops import density_grid as jdg
from sculptmate_tpu.runtime.checkpoint import load_sf3d_checkpoint
from sculptmate_tpu.systems.sf3d import SF3D as JSF3D
from sculptmate_tpu.systems.sf3d import SF3DConfig as JSF3DConfig
from sculptmate_tpu.systems.tsr import TSRConfig as JTSRConfig
from sculptmate_tpu_torch.config import load_yaml_config, parse_structured
from sculptmate_tpu_torch.runtime.checkpoint import (
    is_optional_sf3d_key,
    load_sf3d_state_dict,
    read_safetensors,
    sf3d_params_from_jax,
)
from sculptmate_tpu_torch.systems.sf3d import SF3D, SF3DConfig
from sculptmate_tpu_torch.systems.tsr import TSRConfig

TINY = dict(
    cond_image_size=56, isosurface_resolution=14, plane_size=8, num_channels=64, num_attention_heads=4,
    attention_head_dim=16, num_latents=32, num_blocks=1, num_basic_blocks=1, upsample_scale_factor=2,
    upsample_conv_layers=2, dinov2_hidden_size=64, dinov2_num_layers=2, dinov2_num_heads=4,
    dinov2_intermediate_size=128, clip_width=64, clip_layers=2, clip_heads=4,
)

# stabilityai/stable-fast-3d's config.yaml layout (the keys SF3DConfig reads
# and their neighbours), with whole and partial interpolations, some of them
# in fields the loader reads
SF3D_YAML = """
cond_image_size: 512
isosurface_resolution: 160
isosurface_threshold: 10.0
radius: 0.87
background_color: [0.5, 0.5, 0.5]
default_fovy_deg: 40.0
default_distance: 1.6
camera_embedder_cls: sf3d.models.camera.LinearCameraEmbedder
camera_embedder:
  in_channels: 25
  out_channels: 768
  conditions: [c2w_cond, intrinsic_normed_cond]
image_tokenizer_cls: sf3d.models.tokenizers.image.DINOV2SingleImageTokenizer
image_tokenizer:
  pretrained_model_name_or_path: "facebook/dinov2-large"
  width: ${cond_image_size}
  height: ${cond_image_size}
  modulation_cond_dim: ${camera_embedder.out_channels}
  note: "dinov2 at ${cond_image_size}px"
tokenizer_cls: sf3d.models.tokenizers.triplane.TriplaneLearnablePositionalEmbedding
tokenizer:
  plane_size: 96
  num_channels: 1024
backbone_cls: sf3d.models.transformers.backbone.TwoStreamInterleaveTransformer
backbone:
  num_attention_heads: 16
  attention_head_dim: 64
  raw_triplane_channels: ${tokenizer.num_channels}
  triplane_channels: ${tokenizer.num_channels}
  raw_image_channels: 1024
  num_latents: 1792
  num_blocks: 4
  num_basic_blocks: 3
post_processor_cls: sf3d.models.network.PixelShuffleUpsampleNetwork
post_processor:
  in_channels: ${tokenizer.num_channels}
  out_channels: 40
  scale_factor: 4
  conv_layers: ${backbone.num_blocks}
decoder_cls: sf3d.models.network.MaterialMLP
decoder:
  in_channels: 120
  n_neurons: ${backbone.attention_head_dim}
  activation: silu
  heads:
    - {name: density, out_channels: 1, out_bias: -1.0, n_hidden_layers: 2, output_activation: trunc_exp}
    - {name: features, out_channels: 3, n_hidden_layers: 3, output_activation: sigmoid}
    - {name: perturb_normal, out_channels: 3, n_hidden_layers: 3, output_activation: normalize_channel_last}
    - {name: vertex_offset, out_channels: 3, n_hidden_layers: 2}
"""

# TripoSR/checkpoints/config.yaml's layout, two read fields interpolated
TSR_YAML = """
cond_image_size: 512
shared: {radius: 0.87, planes: 40}
image_tokenizer_cls: tsr.models.tokenizers.image.DINOSingleImageTokenizer
image_tokenizer:
  pretrained_model_name_or_path: "facebook/dino-vitb${tokenizer.plane_size}"
tokenizer:
  plane_size: 32
  num_channels: 1024
backbone:
  in_channels: ${tokenizer.num_channels}
  num_attention_heads: 16
  attention_head_dim: 64
  num_layers: 16
  cross_attention_dim: 768
post_processor:
  in_channels: ${tokenizer.num_channels}
  out_channels: ${shared.planes}
decoder:
  in_channels: 120
  n_neurons: 64
  n_hidden_layers: 9
  activation: silu
renderer:
  radius: ${shared.radius}
  feature_reduction: concat
  density_activation: exp
  density_bias: -1.0
"""


def test_yaml_loader_matches_jax(tmp_path):
    """Whole and partial interpolations (nested, in lists, chained) resolve
    as the JAX package's loader resolves them; ``parse_structured`` binds
    and coerces as its does, and drops unknown keys unless strict."""
    text = SF3D_YAML + "chain: ${image_tokenizer.width}\nlisted: ['${radius}', 'r=${radius}']\n"
    (tmp_path / "c.yaml").write_text(text)
    got, ref = load_yaml_config(str(tmp_path / "c.yaml")), j_load_yaml_config(str(tmp_path / "c.yaml"))
    assert json.dumps(got, sort_keys=True) == json.dumps(ref, sort_keys=True)
    assert got.chain == 512 and got.listed == [0.87, "r=0.87"] and got.image_tokenizer.note == "dinov2 at 512px"
    assert load_yaml_config(text, from_string=True) == got

    @dataclasses.dataclass(frozen=True)
    class Inner:
        n: int = 1
        xs: tuple = ()

    @dataclasses.dataclass(frozen=True)
    class Outer:
        a: float = 0.0
        inner: Inner = Inner()

    cfg = {"a": 2, "inner": {"n": 3, "xs": [1, 2]}, "unknown": 5}
    assert parse_structured(Outer, cfg) == Outer(2.0, Inner(3, (1, 2))) == j_parse_structured(Outer, cfg)
    assert isinstance(parse_structured(Outer, cfg).a, float)
    for fn in (parse_structured, j_parse_structured):
        with pytest.raises(ValueError, match="unknown"):
            fn(Outer, cfg, strict=True)


@pytest.mark.parametrize("which", ["sf3d", "tsr"])
def test_config_from_yaml_matches_jax(tmp_path, which):
    """``SF3DConfig.from_yaml`` and ``TSRConfig.from_yaml`` against the JAX
    package's on interpolated YAMLs in the published layouts: every field
    equal (F3: the port's TSR loader resolves interpolation)."""
    path = tmp_path / "config.yaml"
    path.write_text(SF3D_YAML if which == "sf3d" else TSR_YAML)
    cls, jcls = (SF3DConfig, JSF3DConfig) if which == "sf3d" else (TSRConfig, JTSRConfig)
    got, ref = cls.from_yaml(str(path)), jcls.from_yaml(str(path))
    names = [f.name for f in dataclasses.fields(cls)]
    assert names == [f.name for f in dataclasses.fields(jcls)]
    for name in names:
        assert getattr(got, name) == getattr(ref, name), name
    if which == "sf3d":
        assert got.upsample_conv_layers == 4 and got.decoder_n_neurons == 64 and got == SF3DConfig()
    else:
        assert got.upsample_out_channels == 40 and got.radius == 0.87 and got == TSRConfig()


def test_read_safetensors_matches_the_package(tmp_path):
    """F32, F16, BF16, I64 and I32 tensors (and an empty one) read as the
    ``safetensors`` package reads them, bit for bit; a truncated file, an
    unread dtype and a header past the end raise, naming what is wrong."""
    rng = np.random.default_rng(0)
    tensors = {
        "f32": torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32)),
        "f16": torch.from_numpy(rng.standard_normal((7,)).astype(np.float16)),
        "bf16": torch.from_numpy(rng.standard_normal((2, 3, 4)).astype(np.float32)).to(torch.bfloat16),
        "i64": torch.from_numpy(rng.integers(-2**40, 2**40, (4, 2))),
        "i32": torch.from_numpy(rng.integers(-2**30, 2**30, (9,)).astype(np.int32)),
        "empty": torch.zeros((0, 3)),
    }
    path = tmp_path / "t.safetensors"
    st_save_torch(tensors, str(path), metadata={"format": "pt"})
    got = read_safetensors(str(path))
    ref_t = st_load_torch(str(path))
    assert set(got) == set(ref_t) == set(tensors)
    for k in tensors:
        assert got[k].dtype == ref_t[k].dtype and torch.equal(got[k], ref_t[k]), k
    np_path = tmp_path / "n.safetensors"
    st_save_numpy({k: v.numpy() for k, v in tensors.items() if k != "bf16"}, str(np_path))
    ref_np = st_load_numpy(str(np_path))
    for k, v in read_safetensors(str(np_path)).items():
        assert np.array_equal(v.numpy(), ref_np[k]) and v.numpy().dtype == ref_np[k].dtype, k

    data = path.read_bytes()
    last = max(json.loads(data[8 : 8 + int.from_bytes(data[:8], "little")]).items(),
               key=lambda kv: kv[1]["data_offsets"][1] if kv[0] != "__metadata__" else -1)[0]
    (tmp_path / "cut.safetensors").write_bytes(data[:-4])
    with pytest.raises(ValueError, match=f"tensor '{last}'.*outside"):
        read_safetensors(str(tmp_path / "cut.safetensors"))
    (tmp_path / "head.safetensors").write_bytes(data[:20])
    with pytest.raises(ValueError, match="header runs past"):
        read_safetensors(str(tmp_path / "head.safetensors"))
    st_save_numpy({"f64": np.zeros(3)}, str(tmp_path / "f64.safetensors"))
    with pytest.raises(ValueError, match="tensor 'f64' has dtype 'F64'"):
        read_safetensors(str(tmp_path / "f64.safetensors"))


@pytest.fixture(scope="module")
def jax_sf3d():
    """The JAX tiny SF3D with N(0, 0.3) AdaLN projections (numpy seed 5),
    as in ``test_torch_port_sf3d.py``."""
    base = JSF3D(JSF3DConfig(**TINY), dtype=jnp.float32)
    params = jax.tree.map(np.array, base.params)
    rng = np.random.default_rng(5)
    for name, layer in params["image_tokenizer"]["dinov2"].items():
        if name.startswith("layer_"):
            for mod in ("norm1_modulation", "norm2_modulation"):
                lin = layer[mod]["linear2"]
                lin["kernel"] = (0.3 * rng.standard_normal(lin["kernel"].shape)).astype(np.float32)
                lin["bias"] = (0.3 * rng.standard_normal(lin["bias"].shape)).astype(np.float32)
    return params


def _close(got, ref, tol=1e-4):
    got, ref = got.detach().float().numpy(), np.asarray(ref, np.float32)
    assert got.shape == ref.shape and np.abs(got - ref).max() <= tol * np.abs(ref).max()


@pytest.mark.parametrize("optional", ["present", "without the AdaLN projections"])
def test_sf3d_checkpoint_matches_jax(tmp_path, jax_sf3d, optional):
    """The bridged tiny SF3D written as ``model.safetensors`` (F32), read by
    the JAX package's ``load_sf3d_checkpoint`` and the port's
    ``load_sf3d_state_dict``: the port gives the same scene codes as the
    JAX package (1e-4 of max |codes|, f32) and its untextured ``run_image``
    mesh matches the JAX package's (vertex and face counts within 2 %, as
    ``test_torch_port_sf3d.py`` holds them) and equals, exactly, that of a
    port model handed the same weights directly. Without the optional AdaLN
    keys both loaders accept the file; the port keeps zero modulations, the
    value the JAX package initialises them to, and the JAX model runs with
    those zeros."""
    sd = {k: v.numpy() for k, v in sf3d_params_from_jax(jax_sf3d).items()}
    if optional != "present":
        sd = {k: v for k, v in sd.items() if ".linear2." not in k}
    sd["image_tokenizer.model.embeddings.mask_token"] = np.zeros((1, 64), np.float32)  # used by neither package
    path = tmp_path / "model.safetensors"
    st_save_numpy(sd, str(path))

    jparams = load_sf3d_checkpoint(str(path))
    if optional != "present":
        for name, layer in jparams["image_tokenizer"]["dinov2"].items():
            if name.startswith("layer_"):
                for mod in ("norm1_modulation", "norm2_modulation"):
                    ref_lin = jax_sf3d["image_tokenizer"]["dinov2"][name][mod]["linear2"]
                    layer[mod] = {"linear2": {k: np.zeros_like(v) for k, v in ref_lin.items()}}
    jm = JSF3D(JSF3DConfig(**TINY), params=jparams, dtype=jnp.float32)
    loaded = load_sf3d_state_dict(str(path))
    assert "image_tokenizer.model.embeddings.mask_token" not in loaded
    assert all(v.dtype == torch.float32 for v in loaded.values())
    port = SF3D(SF3DConfig(**TINY), state_dict=loaded, dtype=torch.float32, device="cpu")
    mods = [m.linear2.weight for layer in port.module.image_tokenizer.model.encoder.layer
            for m in (layer.norm1_modulation, layer.norm2_modulation)]
    assert all(bool(w.any()) == (optional == "present") for w in mods)

    img = np.random.default_rng(3).random((1, 56, 56, 4)).astype(np.float32)
    jcodes, _ = jm.get_scene_codes(jm.prepare_image(jnp.asarray(img))[1])
    codes, _ = port.get_scene_codes(port.prepare_image(torch.from_numpy(img))[1])
    _close(codes, jcodes)

    g = jdg.query_grid_multihead(jcodes[0], jm._head_weights(["density"]),
                                 jdg.lattice_coords_tets(jm.config.isosurface_resolution), jm.grid_spec(slab=1))
    thr = float(np.exp(np.asarray(g["density"][0]) - 1.0).mean())
    ref = jm.run_image(jnp.asarray(img), enable_texture=False, threshold=thr)
    got = port.run_image(img, enable_texture=False, threshold=thr)
    for key in ("verts", "faces"):
        assert abs(len(got[key]) - len(ref[key])) <= 0.02 * len(ref[key]), key
    direct = SF3D(SF3DConfig(**TINY), state_dict={k: torch.from_numpy(v) for k, v in sd.items() if "mask" not in k},
                  dtype=torch.float32, device="cpu").run_image(img, enable_texture=False, threshold=thr)
    assert all(np.array_equal(got[k], direct[k]) for k in ("verts", "faces", "uvs"))


def test_sf3d_checkpoint_optional_and_required_keys(tmp_path, jax_sf3d):
    """Both loaders accept a file without the backbone's image-token norm
    and projection and the CLIP encoder (read only when present); the port
    keeps its seeded values there. A missing required key raises in the
    port's loader and in the model, naming the key."""
    sd = {k: v.numpy() for k, v in sf3d_params_from_jax(jax_sf3d).items()}
    drop = [k for k in sd if k.startswith(("backbone.norm_image.", "backbone.proj_image.", "image_estimator.model."))]
    assert drop and all(is_optional_sf3d_key(k) for k in drop)
    path = tmp_path / "model.safetensors"
    st_save_numpy({k: v for k, v in sd.items() if k not in drop}, str(path))
    jparams = load_sf3d_checkpoint(str(path))
    assert "norm_image" not in jparams["backbone"] and "clip" not in jparams.get("image_estimator", {})
    loaded = load_sf3d_state_dict(str(path))
    assert not set(drop) & set(loaded)
    seeded = SF3D(SF3DConfig(**TINY), seed=4, dtype=torch.float32, device="cpu").module.state_dict()
    port = SF3D(SF3DConfig(**TINY), state_dict=loaded, seed=4, dtype=torch.float32, device="cpu")
    got = port.module.state_dict()
    assert all(torch.equal(got[k], seeded[k]) for k in drop)
    assert all(torch.equal(got[k], loaded[k]) for k in loaded)

    st_save_numpy({k: v for k, v in sd.items() if k != "backbone.latent_init"}, str(path))
    with pytest.raises(KeyError, match="backbone.latent_init"):
        load_sf3d_state_dict(str(path))
    with pytest.raises(KeyError, match="backbone.latent_init"):
        SF3D(SF3DConfig(**TINY), state_dict={k: torch.from_numpy(v) for k, v in sd.items()
                                             if k != "backbone.latent_init"}, dtype=torch.float32, device="cpu")


def test_fast3d_generator_reads_the_checkpoint_directory(tmp_path, monkeypatch, jax_sf3d):
    """``initiate_model(dir)`` hands ``SF3D`` the config of ``config.yaml``
    (``SF3DConfig.from_yaml``, DINOv2-L: too large for the CPU suite, so
    ``SF3D`` is replaced by a recorder) and the state dict of
    ``model.safetensors``; either file may be missing; 1 on a file it
    cannot read."""
    from sculptmate_tpu_torch.pipelines.generate import Fast3DGenerator
    from sculptmate_tpu_torch.systems import sf3d as sf3d_mod

    seen = []
    monkeypatch.setattr(sf3d_mod, "SF3D", lambda **kw: seen.append(kw) or "model")
    sd = {k: v.numpy() for k, v in sf3d_params_from_jax(jax_sf3d).items()}
    (tmp_path / "config.yaml").write_text(SF3D_YAML)
    st_save_numpy(sd, str(tmp_path / "model.safetensors"))
    gen = Fast3DGenerator()
    assert gen.initiate_model(str(tmp_path), device="cpu") == 0 and gen.model == "model"
    kw = seen[-1]
    assert kw["config"] == SF3DConfig.from_yaml(str(tmp_path / "config.yaml")) and kw["device"] == "cpu"
    assert set(kw["state_dict"]) == set(sd) and all(np.array_equal(kw["state_dict"][k].numpy(), sd[k]) for k in sd)
    (tmp_path / "config.yaml").unlink()
    assert gen.initiate_model(str(tmp_path), device="cpu") == 0 and seen[-1]["config"] is None
    (tmp_path / "model.safetensors").write_bytes(b"\x10")
    assert gen.initiate_model(str(tmp_path), device="cpu") == 1
    assert gen.initiate_model(None, device="cpu") == 0 and seen[-1]["state_dict"] is None


def test_cli_convert(tmp_path, capsys, jax_sf3d):
    """``convert`` of a ``.safetensors`` (the loader's state dict) and of a
    ``.ckpt`` (a Lean state dict under ``state_dict``, round trip), each
    written with ``torch.save`` with the JSON line; an unknown suffix is 1."""
    from sculptmate_tpu_torch import cli
    from sculptmate_tpu_torch.systems.tsr import TSR

    sd = {k: v.numpy() for k, v in sf3d_params_from_jax(jax_sf3d).items()}
    src, out = tmp_path / "model.safetensors", tmp_path / "sf3d.pt"
    st_save_numpy(sd, str(src))
    assert cli.main(["convert", str(src), str(out)]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == {"input": str(src), "output": str(out)}
    back = torch.load(out, weights_only=True)
    assert set(back) == set(sd) and all(np.array_equal(back[k].numpy(), sd[k]) for k in sd)

    cfg = TSRConfig(cond_image_size=32, plane_size=4, num_channels=32, num_attention_heads=2, attention_head_dim=16,
                    num_layers=1, cross_attention_dim=32, vit_hidden_size=32, vit_num_layers=1, vit_num_heads=2,
                    vit_intermediate_size=64)
    tsd = TSR(cfg, seed=2, dtype=torch.float32, device="cpu").module.state_dict()
    torch.save({"state_dict": tsd}, tmp_path / "model.ckpt")
    assert cli.main(["convert", str(tmp_path / "model.ckpt"), str(tmp_path / "tsr.pt")]) == 0
    back = torch.load(tmp_path / "tsr.pt", weights_only=True)
    assert set(back) == set(tsd) and all(torch.equal(back[k], tsd[k]) for k in tsd)
    TSR(cfg, state_dict=back, dtype=torch.float32, device="cpu")
    assert cli.main(["convert", str(tmp_path / "model.bin"), str(tmp_path / "x.pt")]) == 1
