"""Port parity: the weight bridge and every module of the TSR encoder, with
the JAX package's weights handed over by ``tsr_params_from_jax``. A narrow
config (ViT narrowed too), f32 on the CPU unless stated."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sculptmate_tpu.models.heads import NeRFMLP as JNeRFMLP
from sculptmate_tpu.models.transformer import Transformer1D as JTransformer1D
from sculptmate_tpu.models.upsamplers import TriplaneUpsampleNetwork as JUpsample
from sculptmate_tpu.models.vit import DINOSingleImageTokenizer as JDINO
from sculptmate_tpu.runtime.checkpoint import convert_tsr_state_dict
from sculptmate_tpu.systems.tsr import TSR as JTSR
from sculptmate_tpu.systems.tsr import TSRConfig as JTSRConfig
from sculptmate_tpu_torch.runtime.checkpoint import tsr_params_from_jax
from sculptmate_tpu_torch.systems.tsr import TSR, TSRConfig, TSRModule

SMALL = dict(
    cond_image_size=64, plane_size=8, num_channels=64, num_attention_heads=4,
    attention_head_dim=16, num_layers=2, cross_attention_dim=64, vit_hidden_size=64,
    vit_num_layers=2, vit_num_heads=4, vit_intermediate_size=128,
)


@pytest.fixture(scope="module")
def jax_tsr():
    return JTSR(JTSRConfig(**SMALL), dtype=jnp.float32)


@pytest.fixture(scope="module")
def params(jax_tsr):
    return jax.tree.map(np.asarray, jax_tsr.params)


@pytest.fixture(scope="module")
def port(params):
    return TSR(TSRConfig(**SMALL), state_dict=tsr_params_from_jax(params), dtype=torch.float32, device="cpu")


def test_config_fields_match_jax():
    import dataclasses

    assert [(f.name, f.default) for f in dataclasses.fields(TSRConfig)] == [
        (f.name, f.default) for f in dataclasses.fields(JTSRConfig)
    ]


def test_weight_bridge_round_trip_is_exact(params):
    """flax -> state_dict -> convert_tsr_state_dict gives the same tree,
    bitwise, the ConvTranspose flip included; the state dict loads strictly."""
    sd = tsr_params_from_jax(params)
    back = convert_tsr_state_dict({k: v.numpy() for k, v in sd.items()})
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        b = flat_b[path]
        assert a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b), path
    up = params["post_processor"]["upsample"]["kernel"]
    assert not np.array_equal(up, up[::-1, ::-1])  # the flip is exercised
    TSRModule(TSRConfig(**SMALL)).load_state_dict(sd, strict=True)


def _close(got, ref, tol=1e-4):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=tol, atol=tol)


def test_vit_tokenizer_matches_jax(rng, params, port):
    c = SMALL
    img = rng.random((2, 64, 64, 3)).astype(np.float32)
    jm = JDINO(hidden_size=c["vit_hidden_size"], num_layers=c["vit_num_layers"], num_heads=c["vit_num_heads"],
               intermediate_size=c["vit_intermediate_size"])
    ref = jm.apply({"params": params["image_tokenizer"]}, jnp.asarray(img))
    _close(port.module.image_tokenizer(torch.from_numpy(img)), ref)


def test_transformer_matches_jax(rng, params, port):
    c = SMALL
    tokens = rng.standard_normal((2, 64, 3 * 8 * 8)).astype(np.float32)
    ctx = rng.standard_normal((2, 17, 64)).astype(np.float32)
    jm = JTransformer1D(in_channels=64, num_attention_heads=4, attention_head_dim=16, num_layers=c["num_layers"],
                        cross_attention_dim=64)
    ref = jm.apply({"params": params["backbone"]}, jnp.asarray(tokens), encoder_hidden_states=jnp.asarray(ctx))
    _close(port.module.backbone(torch.from_numpy(tokens), torch.from_numpy(ctx)), ref)


def test_upsampler_and_decoder_match_jax(rng, params, port):
    planes = rng.standard_normal((2, 3, 64, 8, 8)).astype(np.float32)
    ref = JUpsample(64, 40).apply({"params": params["post_processor"]}, jnp.asarray(planes))
    _close(port.module.post_processor(torch.from_numpy(planes)), ref)
    feats = rng.standard_normal((50, 120)).astype(np.float32)
    ref = JNeRFMLP().apply({"params": params["decoder"]}, jnp.asarray(feats))
    got = port.module.decoder(torch.from_numpy(feats))
    for key in ("density", "features"):
        _close(got[key], ref[key])


def test_triplane_tokenizer_round_trip(port):
    tok = port.module.tokenizer
    stream = tok(2)
    assert stream.shape == (2, 64, 3 * 64)
    assert torch.equal(tok.detokenize(stream)[0], tok.embeddings)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 5e-2)])
def test_scene_codes_match_jax(rng, jax_tsr, params, dtype, tol):
    """Whole encoder, input resized on the way in; tolerance relative to
    max |codes|: f32 1e-4, bf16 5e-2 (the two frameworks round bf16 at
    different points)."""
    img = rng.random((1, 80, 80, 3)).astype(np.float32)
    jt = JTSR(jax_tsr.config, params=jax_tsr.params, dtype=getattr(jnp, dtype))
    ref = np.asarray(jt.scene_codes(jnp.asarray(img))).astype(np.float32)
    tt = TSR(TSRConfig(**SMALL), state_dict=tsr_params_from_jax(params), dtype=getattr(torch, dtype), device="cpu")
    got = tt.scene_codes(img).float().numpy()
    assert got.shape == ref.shape == (1, 3, 40, 16, 16)
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()
