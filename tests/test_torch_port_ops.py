"""Port parity: attention, resize, grid sampling and the density queries of
``sculptmate_tpu_torch.ops`` against ``sculptmate_tpu.ops`` on the same
numpy inputs (CPU, f32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import sculptmate_tpu.ops.attention as jattn
from sculptmate_tpu.ops import density_grid as jdg
from sculptmate_tpu.ops import grid_sample as jgs
from sculptmate_tpu.ops import resize as jrs
from sculptmate_tpu_torch.ops import density_grid as tdg
from sculptmate_tpu_torch.ops import grid_sample as tgs
from sculptmate_tpu_torch.ops import resize as trs
from sculptmate_tpu_torch.ops.attention import dot_product_attention


@pytest.mark.parametrize(
    "B,Nq,Nk,H,D",
    [(1, 300, 77, 2, 16), (2, 130, 1025, 3, 64), (1, 512, 96, 4, 64)],
)
def test_attention_matches_jax_chunked(rng, monkeypatch, B, Nq, Nk, H, D):
    """Nk not a multiple of any tile; the JAX side forced onto its chunked
    path. Tolerance atol 1e-5 (f32, reassociated sums)."""
    q, k, v = (rng.standard_normal((B, n, H, D)).astype(np.float32) for n in (Nq, Nk, Nk))
    monkeypatch.setattr(jattn, "_FUSED_LIMIT", 1)
    ref = np.asarray(jattn.dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    got = dot_product_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


def test_pos_table_resize_is_torch_bicubic(rng):
    """14x14 -> 32x32 position table: equal to the JAX matrices and to
    torch's own bicubic (A = -0.75) within f32 rounding (1e-5)."""
    table = rng.standard_normal((14 * 14, 24)).astype(np.float32)
    got = trs.interpolate_pos_table(torch.from_numpy(table), 32, 32).numpy()
    ref = np.asarray(jrs.interpolate_pos_table(jnp.asarray(table), 32, 32))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    x = torch.from_numpy(table).reshape(1, 14, 14, 24).permute(0, 3, 1, 2)
    direct = F.interpolate(x, size=(32, 32), mode="bicubic", align_corners=False)
    np.testing.assert_allclose(got, direct.permute(0, 2, 3, 1).reshape(-1, 24).numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("size", [(100, 90), (48, 40)])
def test_resize_bilinear_antialias_matches_jax(rng, size):
    """Down- and upsampling to 64^2, channels-last; atol 1e-5 on [0, 1] data."""
    img = rng.random((2, *size, 3)).astype(np.float32)
    got = trs.resize_bilinear_antialias(torch.from_numpy(img), 64, 64).numpy()
    ref = np.asarray(jrs.resize_bilinear_antialias(jnp.asarray(img), 64, 64))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_triplane_sampling_matches_jax(rng):
    """Lattice and scattered bilinear samples, zero padding, points beyond
    [-1, 1] included; atol 1e-5."""
    tri = rng.standard_normal((3, 8, 10, 10)).astype(np.float32)
    coords = np.linspace(-1, 1, 13).astype(np.float32)
    got = tgs.sample_triplane_regular_grid(torch.from_numpy(tri), *(torch.from_numpy(coords),) * 3)
    ref = jgs.sample_triplane_regular_grid(jnp.asarray(tri), *(jnp.asarray(coords),) * 3)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=1e-5)
    p = rng.uniform(-1.2, 1.2, (3, 500)).astype(np.float32)
    got = tgs.sample_triplane(torch.from_numpy(tri), *map(torch.from_numpy, p))
    ref = jgs.sample_triplane(jnp.asarray(tri), *map(jnp.asarray, p))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def _decoder(rng, n_hidden=9, width=64, c_in=120):
    dims = [c_in] + [width] * n_hidden + [4]
    return [
        (
            (rng.standard_normal((a, b)) / np.sqrt(a)).astype(np.float32),
            (0.1 * rng.standard_normal(b)).astype(np.float32),
        )
        for a, b in zip(dims[:-1], dims[1:])
    ]


def _to_torch(ws):
    return [(torch.from_numpy(W), torch.from_numpy(b)) for W, b in ws]


def _to_jax(ws):
    return [(jnp.asarray(W), jnp.asarray(b)) for W, b in ws]


@pytest.mark.parametrize("R", [16, 24])
def test_query_density_grid_matches_jax(rng, R):
    """Plain path of K2 against the JAX lattice query, f32; 1e-4 relative
    to the field's max."""
    tri = rng.standard_normal((3, 40, 16, 16)).astype(np.float32)
    ws = _decoder(rng)
    jspec = jdg.DensityGridSpec(resolution=R, slab=8)
    ref = np.asarray(jdg.query_density_grid(jnp.asarray(tri), _to_jax(ws), jspec))
    tspec = tdg.DensityGridSpec(resolution=R, slab=8)
    got = tdg.query_density_grid(torch.from_numpy(tri), _to_torch(ws), tspec).numpy()
    assert got.shape == (R, R, R)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * np.abs(ref).max())


def test_query_triplane_points_matches_jax(rng):
    """Scattered density + colors, f32; 1e-4 relative."""
    tri = rng.standard_normal((3, 40, 16, 16)).astype(np.float32)
    ws = _decoder(rng)
    p = rng.uniform(-0.87, 0.87, (3, 700)).astype(np.float32)
    ref = jdg.query_triplane_points(jnp.asarray(tri), _to_jax(ws), *map(jnp.asarray, p), jdg.DensityGridSpec())
    got = tdg.query_triplane_points(torch.from_numpy(tri), _to_torch(ws), *map(torch.from_numpy, p), tdg.DensityGridSpec())
    for key in ("density", "density_act", "color"):
        r = np.asarray(ref[key])
        np.testing.assert_allclose(got[key].numpy(), r, rtol=0, atol=1e-4 * np.abs(r).max())


def test_swizzle_128b_moves_chunks_and_inverts(rng):
    """Chunk q of row r lands at q ^ (r % 8), and swizzling twice is the
    identity (exact)."""
    rows = torch.from_numpy(rng.standard_normal((2, 24, 64)).astype(np.float32))
    sw = tdg.swizzle_128b(rows)
    for r in (0, 5, 13, 23):
        for q in range(8):
            p = q ^ (r % 8)
            np.testing.assert_array_equal(sw[1, r, 8 * p : 8 * p + 8], rows[1, r, 8 * q : 8 * q + 8])
    np.testing.assert_array_equal(tdg.swizzle_128b(sw), rows)


def _bf16_exact(ws):
    """Decoder weights rounded to bf16, so the kernel's bf16 packing is exact."""
    return [tuple(torch.from_numpy(t).to(torch.bfloat16).float().numpy() for t in wb) for wb in ws]


@pytest.mark.parametrize("R", [16, 24])
def test_packed_density_weights_match_jax(rng, R):
    """K2's host-side packing (halved, swizzled hidden weights; output channel
    0; halved biases), run through the kernel's arithmetic in f32 on the CPU
    (silu(x) = h (1 + tanh h), h = x / 2), against the JAX lattice query on the
    same bf16-exact weights: 1e-5 of the field's max (f32 reassociation)."""
    tri = rng.standard_normal((3, 40, 16, 16)).astype(np.float32)
    ws = _bf16_exact(_decoder(rng))
    ref = np.asarray(jdg.query_density_grid(jnp.asarray(tri), _to_jax(ws), jdg.DensityGridSpec(resolution=R)))
    tws = _to_torch(ws)
    spec = tdg.DensityGridSpec(resolution=R)
    A, B, C = tdg.first_layer_partials(torch.from_numpy(tri), tws, spec)
    Wp, bias = tdg.pack_density_weights(tws, "cpu")
    L = len(ws) - 2
    assert Wp.dtype == torch.bfloat16 and Wp.shape == (L * 64 + 8, 64) and bias.shape == (L * 64 + 1,)
    rows = tdg.swizzle_128b(Wp.float())
    np.testing.assert_array_equal(2 * rows[64 : 128].t().numpy(), ws[2][0])
    h = 0.5 * (A[None] + B[:, :, None] + C[:, None, :])  # (k, i, j, 64)
    x = h * (1 + torch.tanh(h))
    for l in range(L):
        h = x @ rows[64 * l : 64 * (l + 1)].t() + bias[64 * l : 64 * (l + 1)]
        x = h * (1 + torch.tanh(h))
    d = x @ rows[64 * L] + bias[64 * L]
    got = torch.exp(d + spec.density_bias).permute(1, 2, 0).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


@pytest.mark.cuda
def test_kernels_match_plain_on_card(rng):
    """K1 and K2 against their plain versions on the card, at small and
    ragged shapes (K1 bf16: 2e-2 absolute on unit-scale attention outputs,
    f32 1e-5; K2: 5e-2 of the field's max, bf16 rounded at different points
    through 9 layers)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from sculptmate_tpu_torch.ops.attention import dot_product_attention_plain, flash_attention

    for B, Nq, Nk, H in ((2, 300, 77, 3), (2, 129, 77, 3), (1, 200, 1025, 2)):
        for dt, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-5)):
            q, k, v = (torch.from_numpy(rng.standard_normal((B, n, H, 64)).astype(np.float32)).cuda().to(dt)
                       for n in (Nq, Nk, Nk))
            out = flash_attention(q, k, v)
            ref = dot_product_attention_plain(q, k, v)
            assert (out.float() - ref.float()).abs().max().item() <= tol, (B, Nq, Nk, H, dt)
    ws = [(W.cuda(), b.cuda()) for W, b in _to_torch(_decoder(rng))]
    tri = torch.from_numpy(rng.standard_normal((3, 40, 16, 16)).astype(np.float32)).cuda()
    for R in (24, 64, 100):
        spec = tdg.DensityGridSpec(resolution=R, compute_dtype=torch.bfloat16)
        A, B, C = tdg.first_layer_partials(tri, ws, spec)
        got, ref = tdg.density_mlp(A, B, C, ws, spec), tdg.density_mlp_plain(A, B, C, ws, spec)
        assert (got - ref).abs().max().item() <= 5e-2 * ref.abs().max().item(), R
