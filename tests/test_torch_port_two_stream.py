"""Port parity for SF3D's two unused backbone modules: ``SingleStreamTransformer``,
``triplane_attention_bias`` and ``TriplaneAttention`` of
``sculptmate_tpu_torch.models.two_stream`` against ``sculptmate_tpu.models.two_stream``
on the same seeded weights and numpy inputs (CPU, f32; 1e-4 of max |ref|),
and kernel K1 at head dim 88 against its plain version on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sculptmate_tpu.models import two_stream as jts
from sculptmate_tpu_torch.models import two_stream as tts
from sculptmate_tpu_torch.runtime.checkpoint import _linear, _norm


def _close(got, ref, tol=1e-4):
    got, ref = got.detach().numpy(), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= tol * scale, f"max |err| {err} > {tol} * {scale}"


def _randomize(params, seed):
    """Every leaf of a flax param tree redrawn from N(0, 0.2) (norm scales
    around 1): the modules' zero biases and unit norms would hide a swapped
    or missing bias."""
    rng = np.random.default_rng(seed)

    def draw(path, x):
        x = np.asarray(x)
        base = 1.0 if path[-1].key == "scale" else 0.0
        return (base + 0.2 * rng.standard_normal(x.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, params)


def _attn(sd, prefix, p):
    for w in ("wq", "wk", "wv", "proj"):
        _linear(sd, f"{prefix}.{w}", p[w])


def _sst_state_dict(params):
    """Flax ``SingleStreamTransformer`` params -> the port's state dict
    (the reference's names)."""
    sd = {}
    _norm(sd, "norm", params["norm"])
    _linear(sd, "proj_in", params["proj_in"])
    _linear(sd, "proj_out", params["proj_out"])
    for i in range(sum(k.startswith("transformer_blocks_") for k in params)):
        fb, tb = params[f"transformer_blocks_{i}"], f"transformer_blocks.{i}"
        for n in ("norm1", "norm2", "norm3"):
            _norm(sd, f"{tb}.{n}", fb[n])
        _attn(sd, f"{tb}.attn1", fb["attn1"])
        _attn(sd, f"{tb}.attn2", fb["attn2"])
        _linear(sd, f"{tb}.ff.net.0.proj", fb["ff"]["net_0"]["proj"])
        _linear(sd, f"{tb}.ff.net.2", fb["ff"]["net_2"])
    return sd


@pytest.mark.parametrize("cross_dim", [None, 48])
def test_single_stream_transformer_matches_jax(rng, cross_dim):
    """2 heads x 88, 64 channels, 2 layers, over 3 x 4^2 tokens; with a
    cross-attention source of 48 channels, and without one (the blocks'
    cross-attention then attends to the tokens)."""
    x = rng.standard_normal((2, 64, 48)).astype(np.float32)
    enc = None if cross_dim is None else rng.standard_normal((2, 7, cross_dim)).astype(np.float32)
    jm = jts.SingleStreamTransformer(num_attention_heads=2, attention_head_dim=88, in_channels=64, num_layers=2,
                                     cross_attention_dim=cross_dim)
    jenc = None if enc is None else jnp.asarray(enc)
    params = _randomize(jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.asarray(x), jenc)["params"], 3)
    ref = jm.apply({"params": params}, jnp.asarray(x), jenc)
    port = tts.SingleStreamTransformer(num_attention_heads=2, attention_head_dim=88, in_channels=64, num_layers=2,
                                       cross_attention_dim=cross_dim)
    port.load_state_dict(_sst_state_dict(params))
    with torch.no_grad():
        got = port(torch.from_numpy(x), None if enc is None else torch.from_numpy(enc))
    _close(got, ref)


@pytest.mark.parametrize("res", [3, 4])
def test_triplane_attention_bias_matches_jax(res):
    ref = jts.triplane_attention_bias(res)
    got = tts.triplane_attention_bias(res).numpy()
    assert got.dtype == ref.dtype and np.array_equal(got, ref)


@pytest.mark.parametrize("full", [False, True])
def test_triplane_attention_matches_jax(rng, full):
    """dim 64, 4 heads, res 4 (48 tokens), with q/k/v biases; masked (the
    plain product with the bias) and full (``ops.attention``)."""
    x = rng.standard_normal((2, 48, 64)).astype(np.float32)
    jm = jts.TriplaneAttention(64, 4, num_heads=4, qkv_bias=True, full_attention=full)
    params = _randomize(jax.jit(jm.init)(jax.random.PRNGKey(2), jnp.asarray(x))["params"], 4)
    ref = jm.apply({"params": params}, jnp.asarray(x))
    port = tts.TriplaneAttention(64, 4, num_heads=4, qkv_bias=True, full_attention=full)
    sd = {}
    _attn(sd, "", params)
    port.load_state_dict({k[1:]: v for k, v in sd.items()})
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    _close(got, ref)


@pytest.mark.cuda
def test_flash_attention_d88_matches_plain_on_card(rng):
    """K1 at head dim 88 against its plain version on the card, at a ragged
    batched shape and a 1025-token one: bf16 within one bf16 ulp of max
    |ref| (f32 reference on the same bf16 inputs), f32 within 1e-5; another
    head width raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from sculptmate_tpu_torch.ops.attention import dot_product_attention_plain, flash_attention

    for B, Nq, Nk, H in ((2, 129, 77, 3), (1, 1025, 1025, 4)):
        for dt in (torch.bfloat16, torch.float32):
            q, k, v = (torch.from_numpy(rng.standard_normal((B, n, H, 88)).astype(np.float32)).cuda().to(dt)
                       for n in (Nq, Nk, Nk))
            out = flash_attention(q, k, v)
            ref = dot_product_attention_plain(q.float(), k.float(), v.float())
            limit = 2.0**-7 * ref.abs().max().item() if dt == torch.bfloat16 else 1e-5
            assert (out.float() - ref).abs().max().item() <= limit, (B, Nq, Nk, H, dt)
    q = torch.zeros(1, 8, 1, 96, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dims"):
        flash_attention(q, q, q)
