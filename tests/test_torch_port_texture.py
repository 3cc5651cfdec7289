"""Port parity for the texture bake's building blocks: the plain version of
kernel K8 (the rasterizer's winner pass) against ``texture_bake``'s
``binned_winner`` and ``rasterize_device``, the interpolation, the island
dilation, the uint8 quantisation, the PNG writer, and the plain version of
kernel K6 (the texel material query) against ``query_points_multihead``,
each on the same numpy inputs. The kernels themselves run only on the card
(the ``cuda`` tests, which skip here)."""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sculptmate_tpu.geometry import texture_bake as jtb
from sculptmate_tpu.ops import density_grid as jdg
from sculptmate_tpu.systems.sf3d import SF3D as JSF3D
from sculptmate_tpu.systems.sf3d import SF3DConfig as JSF3DConfig
from sculptmate_tpu_torch.geometry import texture_bake as tb
from sculptmate_tpu_torch.io.png import encode_png
from sculptmate_tpu_torch.ops import density_grid as dg
from sculptmate_tpu_torch.runtime.checkpoint import sf3d_params_from_jax
from sculptmate_tpu_torch.systems.sf3d import SF3D, SF3DConfig

TINY = dict(
    cond_image_size=56, isosurface_resolution=14, plane_size=8, num_channels=64, num_attention_heads=4,
    attention_head_dim=16, num_latents=32, num_blocks=1, num_basic_blocks=1, upsample_scale_factor=2,
    upsample_conv_layers=2, dinov2_hidden_size=64, dinov2_num_layers=2, dinov2_num_heads=4,
    dinov2_intermediate_size=128, clip_width=64, clip_layers=2, clip_heads=4,
)
SINK = 2**31 - 1


def _atlas(seed, n, res, n_big=12):
    """Per-corner UV rows of ``n`` atlas-like faces (about 1.5 texels
    across) and ``n_big`` oversized right triangles (legs 0.15-0.45 of the
    atlas: the JAX package's coarse tier)."""
    rng = np.random.default_rng(seed)
    small = rng.random((n, 1, 2)) + rng.standard_normal((n, 3, 2)) * 1.5 / res
    o = rng.random((n_big, 2)) * 0.5
    legs = 0.15 + 0.3 * rng.random((n_big, 2))
    zero = np.zeros(n_big)
    big = np.stack([o, o + np.stack([legs[:, 0], zero], 1), o + np.stack([zero, legs[:, 1]], 1)], 1)
    tri = np.concatenate([small, big]).astype(np.float32)
    return [np.ascontiguousarray(tri[:, c, d]) for c in range(3) for d in range(2)]


def _keys(kind, n, seed):
    if kind == "id":
        return np.arange(n, dtype=np.int32)
    depth = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    i = depth.view(np.int32)
    return ~np.where(i >= 0, i, i ^ 0x7FFFFFFF).astype(np.int32)  # ~sortable(depth): the deepest face wins


@pytest.mark.parametrize("res,margin,kind", [(128, 0.0, "id"), (256, 0.05, "depth"), (256, 0.05, "id")])
def test_winner_matches_jax(res, margin, kind):
    """The plain winner pass against ``binned_winner`` (both tiers, its
    capacities large enough) on small and oversized faces: the same key on
    all but at most 1e-4 of the texels. XLA's CPU code contracts
    multiply-adds into FMAs, which can move a texel that lies on an edge to
    within one ulp; the port rounds each product and sum on its own."""
    corners = _atlas(1, 3000, res)
    key = _keys(kind, len(corners[0]), 2)
    fine = jtb.default_pair_capacity(len(key))
    got_j, n_fine, n_coarse, n_multi = jax.jit(jtb.binned_winner, static_argnums=(7, 8, 9, 10, 11))(
        *map(jnp.asarray, corners), jnp.asarray(key), res, fine, 1 << 14, 1 << 16, margin
    )
    assert int(n_fine) <= fine and int(n_coarse) <= 1 << 14 and int(n_multi) <= 1 << 16
    got = tb.binned_winner(*map(torch.from_numpy, corners), torch.from_numpy(key), res, margin).numpy()
    ref = np.asarray(got_j)
    assert (ref < SINK).sum() > 0.2 * res * res
    assert (got != ref).sum() <= 1e-4 * res * res


@pytest.mark.parametrize("res", [64, 100])
def test_rasterize_matches_jax(res):
    """``rasterize_device`` (face-id keys, then the winner's barycentrics)
    against the JAX package's binned path at 64 and its brute-force path at
    100 (not a multiple of 64): the same winner face on all but 1e-4 of the
    texels; where the winners agree, barycentrics within 1e-5 on 99 % of
    the texels and within 1e-3 on all. The JAX program's contracted
    multiply-adds shift d20/d21 by an ulp or two, which the quotients scale
    by the face's conditioning (the oversized faces' texels)."""
    corners = _atlas(3, 1500, res)
    cap = jtb.default_pair_capacity(len(corners[0])) if res % 64 == 0 else 0
    ref = np.asarray(jtb.rasterize_device(*map(jnp.asarray, corners), res, cap)[0])
    got = tb.rasterize_device(*map(torch.from_numpy, corners), res).numpy()
    same = got[3] == ref[3]
    assert (~same).sum() <= max(1e-4 * res * res, 0) and (got[3] >= 0).sum() > 0.2 * res * res
    err = np.abs(got[:3][:, same] - ref[:3][:, same]).max(0)
    assert (err <= 1e-5).mean() >= 0.99 and err.max() <= 1e-3
    assert (got[:3][:, got[3] < 0] == 0).all()


def test_interpolate_dilate_quantize_match_jax():
    """``interpolate_device`` on a JAX rast, ``dilate_fill`` and
    ``float32_to_uint8`` with the same noise: within 1e-6, bit-equal."""
    rng = np.random.default_rng(4)
    res = 64
    corners = _atlas(5, 800, res)
    rast = jtb.rasterize_device(*map(jnp.asarray, corners), res, jtb.default_pair_capacity(800 + 12))[0]
    F = len(corners[0])
    faces = rng.integers(0, 500, (F, 3)).astype(np.int32)
    attr = rng.standard_normal((3, 500)).astype(np.float32)
    ref = np.asarray(jtb.interpolate_device(jnp.asarray(attr), rast, *(jnp.asarray(faces[:, c]) for c in range(3))))
    rt = torch.from_numpy(np.array(rast))
    got = tb.interpolate_device(torch.from_numpy(attr), rt, *(torch.from_numpy(faces[:, c]).long() for c in range(3)))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)

    img = rng.random((3, res, res)).astype(np.float32)
    mask = rng.random((res, res)) < 0.3
    ref = np.asarray(jtb.dilate_fill(jnp.asarray(img), jnp.asarray(mask), 3))
    got = tb.dilate_fill(torch.from_numpy(img), torch.from_numpy(mask), 3).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)

    arr = rng.random((res, res, 3)).astype(np.float32) * 1.2 - 0.1
    flat = (rng.random((res, res, 1)) < 0.5).astype(np.float32)
    for kwargs in ({}, {"dither": False}, {"dither_mask": flat}):
        assert np.array_equal(tb.float32_to_uint8(arr, **kwargs), jtb.float32_to_uint8(arr, **kwargs))
    noise = (np.random.default_rng(7).random(arr.shape, dtype=np.float32) - 0.5) / 255.0  # the noise handed over
    assert np.array_equal(
        tb.float32_to_uint8(arr, noise=noise, dither_mask=flat), jtb.float32_to_uint8(arr, dither_mask=flat, seed=7)
    )


def test_png_decodes_to_the_array():
    """``io/png.py`` (zlib level 1, no PIL): PIL decodes it to the same
    8-bit RGB array."""
    from PIL import Image

    arr = np.random.default_rng(6).integers(0, 256, (37, 53, 3)).astype(np.uint8)
    png = encode_png(arr)
    img = Image.open(io.BytesIO(png))
    assert img.mode == "RGB" and np.array_equal(np.asarray(img), arr)
    with pytest.raises(ValueError):
        encode_png(arr.astype(np.float32))


@pytest.fixture(scope="module")
def texel_heads():
    """The tiny SF3D's features and perturb-normal heads (the JAX package's
    initialiser) as the port's model holds them after the weight bridge,
    every bias then replaced by N(0, 0.5) (numpy seed 8)."""
    jm = JSF3D(JSF3DConfig(**TINY), dtype=jnp.float32)
    port = SF3D(SF3DConfig(**TINY), state_dict=sf3d_params_from_jax(jax.tree.map(np.asarray, jm.params)),
                dtype=torch.float32, device="cpu")
    ref = jax.tree.map(np.array, jm._head_weights(["features", "perturb_normal"]))
    bridged = {n: [(w.numpy(), b.numpy()) for w, b in ws] for n, ws in port.texel_head_weights().items()}
    assert list(bridged) == list(ref)
    for n in ref:
        for (w, b), (rw, rb) in zip(bridged[n], ref[n]):
            assert np.array_equal(w, rw) and np.array_equal(b, rb)
    rng = np.random.default_rng(8)
    return {n: [(w, (0.5 * rng.standard_normal(b.shape)).astype(np.float32)) for w, b in ws]
            for n, ws in bridged.items()}


def _torch_heads(heads):
    return {n: [(torch.from_numpy(w), torch.from_numpy(b)) for w, b in ws] for n, ws in heads.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_points_multihead_matches_jax(texel_heads, dtype):
    """The plain version of K6 against ``query_points_multihead`` (the two
    heads packed as one block-diagonal MLP) at 3000 random points of random
    (3, 40, 16, 16) planes: in f32 every channel within 1e-5 of max |ref|;
    in bf16 within 0.1 of each channel's spread, the limit the K5 check
    uses (the two frameworks round bf16 products at other places)."""
    rng = np.random.default_rng(9)
    planes = rng.standard_normal((3, 40, 16, 16)).astype(np.float32)
    pts = [(rng.random(3000) * 1.8 - 0.9).astype(np.float32) * 0.87 for _ in range(3)]
    cd = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    spec = dg.DensityGridSpec(radius=0.87, align_corners=True, compute_dtype=cd[0])
    jspec = jdg.DensityGridSpec(radius=0.87, align_corners=True, compute_dtype=cd[1])
    ref = jdg.query_points_multihead(jnp.asarray(planes), texel_heads, *map(jnp.asarray, pts), jspec)
    got = dg.query_points_multihead(torch.from_numpy(planes), _torch_heads(texel_heads), *map(torch.from_numpy, pts),
                                    spec)
    assert list(got) == list(ref) == ["features", "perturb_normal"]
    for name in ref:
        r, g = np.asarray(ref[name], np.float32), got[name].numpy()
        assert g.shape == r.shape == (3, 3000) and g.dtype == np.float32
        for k in range(3):
            limit = 1e-5 * np.abs(r).max() if dtype == "float32" else 0.1 * np.abs(r[k] - r[k].mean()).max()
            assert np.abs(g[k] - r[k]).max() <= limit, (name, k)


def test_points_weights_pack_for_the_kernel(texel_heads):
    """K6's layout, 128-byte swizzled rows of 64: each head's first layer
    (its 120 inputs zero-padded to 128) as two 64-deep halves, then each
    head's hidden layers, all halved; then an 8-row output tile per head
    (not halved) with its channels at their place in the output. Biases
    halved likewise, layer by layer and head by head, then the output
    biases in channel order."""
    heads = list(_torch_heads(texel_heads).values())
    W, b = dg.pack_points_weights(heads, "cpu")
    rows = dg.swizzle_128b(W).float()  # the swizzle is its own inverse
    bf = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
    assert W.dtype == torch.bfloat16 and rows.shape == (528, 64) and b.shape == (392,)
    assert not torch.equal(W.float(), rows)
    for h in range(2):
        first = torch.cat([rows[128 * h : 128 * h + 64], rows[128 * h + 64 : 128 * h + 128]], dim=1)
        assert torch.equal(first[:, :120], 0.5 * bf(heads[h][0][0]).t()) and not first[:, 120:].any()
        for layer in range(2):
            r0 = 256 + 64 * (2 * h + layer)
            assert torch.equal(rows[r0 : r0 + 64], 0.5 * bf(heads[h][1 + layer][0]).t())
        for layer in range(3):
            i = 64 * (2 * layer + h)
            assert torch.equal(b[i : i + 64], 0.5 * bf(heads[h][layer][1]))
    assert torch.equal(rows[512:515], bf(heads[0][3][0]).t()) and not rows[515:523].any()
    assert torch.equal(rows[523:526], bf(heads[1][3][0]).t()) and not rows[526:].any()
    assert torch.equal(b[384:390], bf(torch.cat([heads[0][3][1], heads[1][3][1]]))) and not b[390:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_points_planes_relayout(dtype):
    """K6's planes relayout on the CPU (its plain version) is the codes in
    bf16, channels last: ``triplane.to(bf16).permute(0, 2, 3, 1)``."""
    planes = torch.from_numpy(np.random.default_rng(12).standard_normal((3, 40, 5, 67)).astype(np.float32)).to(dtype)
    got = dg.points_planes(planes)
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    assert torch.equal(got, planes.to(torch.bfloat16).permute(0, 2, 3, 1))


def _warp_mix(seed=12, res=256):
    """Per-corner UV rows of 4 warps of 32 faces: in each, one oversized
    face (legs 0.3-0.9 of the atlas) at a random lane among tiny ones, and
    every third face degenerate or off the atlas (no candidates), so faces
    with many candidates sit beside faces with none."""
    rng = np.random.default_rng(seed)
    tri = rng.random((128, 1, 2)) + rng.standard_normal((128, 3, 2)) * 1.5 / res
    tri[::3] = rng.random((1, 1, 2)) + np.zeros((3, 2))  # degenerate: a point
    tri[1::9] += 2.0  # off the atlas
    for w in range(4):
        lane = 32 * w + int(rng.integers(32))
        legs = 0.3 + 0.6 * rng.random(2)
        tri[lane] = np.array([[0.05, 0.05], [0.05 + legs[0], 0.05], [0.05, 0.05 + legs[1]]])
    tri = tri.astype(np.float32)
    return [np.ascontiguousarray(tri[:, c, d]) for c in range(3) for d in range(2)]


@pytest.mark.cuda
def test_winner_kernel_matches_plain():
    """K8 on the card against its plain version: bit-equal winners at 512^2
    (face ids, margin 0) and 100^2 (depth keys, margin 0.05); in warps that
    hold one oversized face among tiny ones and faces with no candidates;
    and K8's unwrap form (``uv_unwrap_device.unwrap_round``, both rounds)
    on a random unwrap state: its corners and keys equal to the plain
    loader's (``round_inputs_plain``, the corners and keys the plain round
    rasterizes), its winner to the plain raster's."""
    from sculptmate_tpu_torch.geometry import uv_unwrap_device as ud

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cases = [(_atlas(10, 20000, 512), 512, 0.0, "id"), (_atlas(10, 20000, 100), 100, 0.05, "depth"),
             (_warp_mix(), 256, 0.0, "id"), (_warp_mix(), 256, 0.05, "depth")]
    for rows, res, margin, kind in cases:
        corners = [torch.from_numpy(c).cuda() for c in rows]
        key = torch.from_numpy(_keys(kind, corners[0].shape[0], 11)).cuda()
        got = tb.binned_winner(*corners, key, res, margin)
        assert torch.equal(got, tb.binned_winner_plain(*corners, key, res, margin))
    rng = np.random.default_rng(13)
    F = 40000
    index = torch.from_numpy(rng.integers(0, 6, F).astype(np.int32)).cuda()
    base = rng.random((2, 1, F)) * 2 - 1  # atlas-like: a texel or two per face
    uv_rot = torch.from_numpy((base + 0.01 * rng.standard_normal((2, 3, F))).reshape(6, F).astype(np.float32)).cuda()
    depth = torch.from_numpy(rng.standard_normal(F).astype(np.float32)).cuda()
    lo6 = torch.stack([uv_rot[:, index == s].min() for s in range(6)])
    hi6 = torch.stack([uv_rot[:, index == s].max() for s in range(6)])
    for vis0 in (None, torch.from_numpy(rng.random(F) < 0.9).cuda()):
        corners, key, winner = ud.unwrap_round(uv_rot, index, depth, lo6, hi6, vis0)
        part = torch.ones(F, dtype=torch.bool, device="cuda") if vis0 is None else ~vis0
        ref_corners, ref_key = ud.round_inputs_plain(uv_rot, index, depth, lo6, hi6, part)
        assert torch.equal(corners, ref_corners) and torch.equal(key, ref_key)
        assert torch.equal(winner, tb.binned_winner_plain(*ref_corners, ref_key, 1024, 0.05))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["20000 points", "ragged 10007 points, a tenth outside the box"])
def test_points_kernel_matches_plain(texel_heads, case):
    """K6 on the card against its plain version in bf16 at 20 000 points
    and at a ragged N (not a multiple of the 64-point tile) with points
    outside the box: each channel within 0.1 of its spread. The planes'
    relayout kernel equals its plain version on f32 and bf16 codes, and
    on codes whose rows are not whole 16-byte loads."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(0)
    heads = [[(w.cuda(), b.cuda()) for w, b in ws] for ws in _torch_heads(texel_heads).values()]
    planes = torch.randn(3, 40, 64, 72, device="cuda", generator=g)
    n, scale = (20000, 2.0) if case.startswith("20000") else (10007, 2.2)
    pts = [(torch.rand(n, device="cuda", generator=g) * scale - scale / 2) * 0.87 for _ in range(3)]
    spec = dg.DensityGridSpec(radius=0.87, align_corners=True, compute_dtype=torch.bfloat16)
    for p in (planes, planes.to(torch.bfloat16), planes[..., :67]):  # 67: rows of no whole 16-byte loads
        assert torch.equal(dg.points_planes(p), dg.points_planes_plain(p))
    got = dg.points_multihead(planes, heads, *pts, spec)
    ref = dg.points_multihead_plain(planes, heads, *pts, spec)
    for k in range(6):
        assert (got[k] - ref[k]).abs().max() <= 0.1 * (ref[k] - ref[k].mean()).abs().max()
