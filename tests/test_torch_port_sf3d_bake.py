"""Port parity for SF3D's textured path: ``run_image(enable_texture=True)``
staged and fused, the fused ``unwrap_bake`` on one mesh, the 2^21-vertex
limit the port no longer has, and the one-card ``SF3DFarm``, each held
against the ``sculptmate_tpu`` package (tiny config, f32, CPU; the plain
versions of K6, K8 and K9). The port's encoder is handed the JAX package's
scene codes, so that each comparison starts at the lattice query (the
encoder's parity is ``test_torch_port_sf3d.py``'s)."""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from sculptmate_tpu.geometry import mt_wire as j_mt_wire
from sculptmate_tpu.ops import density_grid as jdg
from sculptmate_tpu.systems.sf3d import SF3D as JSF3D
from sculptmate_tpu.systems.sf3d import SF3DConfig as JSF3DConfig
from sculptmate_tpu_torch.geometry import texture_bake as tb
from sculptmate_tpu_torch.parallel.sf3d_farm import SF3DFarm
from sculptmate_tpu_torch.runtime.checkpoint import sf3d_params_from_jax
from sculptmate_tpu_torch.systems.sf3d import SF3D, SF3DConfig

RES = 14
BAKE = 64
TINY = dict(
    cond_image_size=56, isosurface_resolution=RES, plane_size=8, num_channels=64, num_attention_heads=4,
    attention_head_dim=16, num_latents=32, num_blocks=1, num_basic_blocks=1, upsample_scale_factor=2,
    upsample_conv_layers=2, dinov2_hidden_size=64, dinov2_num_layers=2, dinov2_num_heads=4,
    dinov2_intermediate_size=128, clip_width=64, clip_layers=2, clip_heads=4,
)


@pytest.fixture(scope="module")
def scene():
    """The JAX tiny SF3D, the port on its weights, one RGBA image, the JAX
    scene codes and material estimates, and the threshold at the mean
    density."""
    jm = JSF3D(JSF3DConfig(**TINY), dtype=jnp.float32)
    port = SF3D(SF3DConfig(**TINY), state_dict=sf3d_params_from_jax(jax.tree.map(np.asarray, jm.params)),
                dtype=torch.float32, device="cpu")
    img = np.random.default_rng(7).random((1, 56, 56, 4)).astype(np.float32)
    mask, rgb = jm.prepare_image(jnp.asarray(img))
    codes, _ = jm.get_scene_codes(rgb)
    materials = {k: np.asarray(v) for k, v in jm._estimate(jm.params, rgb * mask).items()}
    g = jdg.query_grid_multihead(codes[0], jm._head_weights(["density"]), jdg.lattice_coords_tets(RES),
                                 jm.grid_spec(slab=1))
    thr = float(np.exp(np.asarray(g["density"][0]) - 1.0).mean())
    return jm, port, img, np.array(codes), materials, thr


def _jax_noise(res):
    """The JAX fused bake's dither, handed to the port's quantizer."""
    return torch.from_numpy(np.asarray((jax.random.uniform(jax.random.PRNGKey(0), (3, res, res)) - 0.5) / 255.0))


@pytest.fixture
def port_on_jax_codes(scene, monkeypatch):
    jm, port, img, codes, _, _ = scene
    enc = port.get_scene_codes
    monkeypatch.setattr(port, "get_scene_codes", lambda rgb: (torch.from_numpy(codes), enc(rgb)[1]))
    monkeypatch.setattr(port, "_dither_noise", lambda shape: _jax_noise(shape[-1]))
    return port


def _jax_mesh(jm, code, threshold):
    """The JAX package's wire for one scene code, decoded and welded as its
    ``run_image`` does -> (world verts, faces, raw vertex count)."""
    wire = np.asarray(jm._extract_wire_jit(jnp.asarray(code), threshold, 16384, 0, 0.2))
    nv = int(j_mt_wire.wire_counts(wire, j_mt_wire.N_WIRE_COUNTS)[0])
    lverts, faces, _ = j_mt_wire.decode_wire(wire, RES, 16384, weld=True)
    return lverts * (2 * 0.87) - 0.87, faces, nv


def _png(data):
    return np.asarray(Image.open(io.BytesIO(data)))


def _winners(uv_flat, res):
    """The winner face of each texel for per-corner UVs as the bake
    rasterizes them."""
    tri = uv_flat.reshape(-1, 3, 2)
    return tb.rasterize_device(*(torch.from_numpy(np.ascontiguousarray(tri[:, c, d])) for c in range(3)
                                 for d in range(2)), res)[3].numpy()


def _maps_agree(got, ref, res, got_uv, ref_uv):
    """Albedo and bump (decoded from the PNGs) within one 8-bit step on
    every covered texel where both sides' winner faces agree; returns the
    share of covered texels compared."""
    wg, wr = _winners(got_uv, res), _winners(ref_uv, res)
    both = (wg >= 0) & (wg == wr)
    for key in ("baseColor", "normal"):
        a, b = _png(got["texture_pngs"][key]).astype(int), _png(ref["texture_pngs"][key]).astype(int)
        assert np.abs(a - b)[both].max() <= 1, key
    return both.sum() / max((wr >= 0).sum(), 1)


def _pngs_are_the_arrays(out, staged):
    """The three PNGs decode (PIL) to the port's own maps."""
    albedo, bump = out["textures"]["albedo"], out["textures"]["bump"]
    if staged:  # float maps, quantized with numpy's seeded dither
        flat = np.all(bump == np.array([0.5, 0.5, 1.0], np.float32), axis=-1, keepdims=True).astype(np.float32)
        albedo, bump = tb.float32_to_uint8(albedo), tb.float32_to_uint8(bump, dither_mask=flat)
    else:
        albedo, bump = (np.round(t * 255).astype(np.uint8) for t in (albedo, bump))
    assert np.array_equal(_png(out["texture_pngs"]["baseColor"]), albedo)
    assert np.array_equal(_png(out["texture_pngs"]["normal"]), bump)
    mr = _png(out["texture_pngs"]["metallicRoughness"])
    assert (mr[..., 1] == int(out["roughness"] * 255)).all() and (mr[..., 2] == int(out["metallic"] * 255)).all()


@pytest.mark.parametrize("fused", [False, True])
def test_run_image_textured_matches_jax(scene, port_on_jax_codes, monkeypatch, fused):
    """Image to textured mesh against the JAX package, staged (host unwrap,
    then the bake) and fused (device unwrap and bake in one dispatch): the
    same faces, vertices within 1e-4 (the lattice query's f32 rounding moves
    a wire position by one u16 step now and then), roughness and metallic
    within 2e-4, the PNGs decoding to the port's maps; the UVs within 1e-4
    on 99.9 % of the corners and the maps within one 8-bit step where the
    texels' winner faces agree, on at least 99 % of the covered texels.

    Fused, the bake quantizes the rotated positions to u16 over their bbox,
    so a vertex moved by one wire step moves every UV (on this mesh only
    ~12 % of the corners stay within 1e-4): the UVs and maps are compared on
    a second run whose extraction is handed the JAX package's wire, so that
    everything after it (decimation, the unwrap, the bake, the quantizers)
    is held to the JAX package's."""
    jm, _, img, codes, _, thr = scene
    port = port_on_jax_codes
    timings = {}
    got = port.run_image(img, bake_resolution=BAKE, threshold=thr, fused=fused, timings=timings)
    ref = jm.run_image(jnp.asarray(img), bake_resolution=BAKE, threshold=thr, fused=fused)
    stages = {"encode", "extract", "decimate"} | ({"unwrap_bake"} if fused else {"unwrap", "bake"})
    assert set(timings) == stages and set(got) == set(ref)
    assert np.array_equal(got["faces"], ref["faces"]) and np.abs(got["verts"] - ref["verts"]).max() <= 1e-4
    assert abs(got["roughness"] - ref["roughness"]) <= 2e-4 and abs(got["metallic"] - ref["metallic"]) <= 2e-4
    assert np.isfinite(got["uvs"]).all() and got["uvs"].min() >= 0 and got["uvs"].max() <= 1
    _pngs_are_the_arrays(got, staged=not fused)
    quantized = lambda uv: np.round(np.clip(uv, 0, 1) * 65535.0) / np.float32(65535.0)  # noqa: E731
    if fused:
        monkeypatch.setattr(port, "extract_mesh", lambda code, threshold, pending=None: _jax_mesh(jm, codes[0],
                                                                                                    threshold))
        got = port.run_image(img, bake_resolution=BAKE, threshold=thr, fused=True)
        assert np.array_equal(got["faces"], ref["faces"]) and np.array_equal(got["verts"], ref["verts"])
        _pngs_are_the_arrays(got, staged=False)
        got_raster_uv = got["uvs"]  # the port rasterizes the f32 UVs; the JAX device its u16 rows
    else:
        got_raster_uv = quantized(got["uvs"])
    assert (np.abs(got["uvs"] - ref["uvs"]).max(1) <= 1e-4).mean() >= 0.999
    assert _maps_agree(got, ref, BAKE, got_raster_uv, quantized(ref["uvs"])) >= 0.99


def test_unwrap_bake_matches_jax(scene, port_on_jax_codes):
    """The fused unwrap and bake of one mesh (the JAX wire's, decoded):
    UVs within 1e-4 of the JAX package's on 99.9 % of the corners (the u16
    rotated positions dequantized with one rounding, as XLA's fused
    multiply-add gives them), roughness and metallic within 2e-4, the
    maps within one 8-bit step where the texels' winner faces agree, the
    PNGs decoding to the port's maps."""
    jm, _, _, codes, materials, thr = scene
    port = port_on_jax_codes
    verts, faces, _ = _jax_mesh(jm, codes[0], thr)
    ref_uv, ref = jm.unwrap_bake(verts, faces, jnp.asarray(codes[0]), materials, BAKE)
    uv, got = port.unwrap_bake(verts, faces, torch.from_numpy(codes[0]), {k: torch.from_numpy(v) for k, v in
                                                                          materials.items()}, BAKE)
    assert uv.shape == ref_uv.shape == (len(faces), 3, 2)
    assert (np.abs(uv - ref_uv).reshape(len(faces), -1).max(1) <= 1e-4).mean() >= 0.999
    assert abs(got["roughness"] - ref["roughness"]) <= 2e-4 and abs(got["metallic"] - ref["metallic"]) <= 2e-4
    jax_raster_uv = np.round(np.clip(ref_uv, 0, 1) * 65535.0) / np.float32(65535.0)  # its device's u16 rows
    assert _maps_agree(got, ref, BAKE, uv, jax_raster_uv) >= 0.99
    _pngs_are_the_arrays(got, staged=False)


def test_unwrap_bake_past_2_21_vertices(scene):
    """A mesh of 2^21 + 8 vertices whose faces index the last ones: the
    JAX package's fused path packs face ids into 5-bit hi words and asserts
    (``sf3d.py:1030`` there); the port uploads int32 faces and bakes it."""
    jm, port, _, codes, materials, _ = scene
    n_top = 64
    rng = np.random.default_rng(3)
    top = rng.standard_normal((n_top, 3)).astype(np.float32)
    top = 0.5 * top / np.linalg.norm(top, axis=1, keepdims=True)
    verts = np.concatenate([np.repeat(top[:1], (1 << 21) + 8 - n_top, axis=0), top])
    base = (1 << 21) + 8 - n_top
    faces = base + np.array([rng.choice(n_top, 3, replace=False) for _ in range(300)])
    with pytest.raises(AssertionError, match="2\\^21"):
        jm.unwrap_bake(verts, faces, jnp.asarray(codes[0]), materials, 32)
    uv, tex = port.unwrap_bake(verts, faces, torch.from_numpy(codes[0]),
                               {k: torch.from_numpy(v) for k, v in materials.items()}, 32)
    assert uv.shape == (300, 3, 2) and np.isfinite(uv).all() and uv.min() >= 0 and uv.max() <= 1
    assert tex["textures"]["albedo"].shape == (32, 32, 3)


def test_sf3d_farm_matches_run_image(scene):
    """``SF3DFarm.generate_batch`` on two images (the batched front, each
    asset's extraction, the round-robin tail of fused bakes) against the
    port's ``run_image(fused=True)`` per image: the same faces, vertices,
    UVs, textures and materials. A tp axis without a mesh raises (the farm
    over a mesh: tests/test_torch_port_parallel.py)."""
    _, port, img, _, _, thr = scene
    images = np.concatenate([img, np.random.default_rng(8).random((1, 56, 56, 4)).astype(np.float32)])
    with pytest.raises(ValueError, match="tp_axis needs a mesh"):
        SF3DFarm(port, tp_axis="tp", device="cpu")
    farm = SF3DFarm(port, device="cpu")
    got = farm.generate_batch(images, bake_resolution=32, threshold=thr)
    assert len(got) == 2
    for i, out in enumerate(got):
        ref = port.run_image(images[i : i + 1], bake_resolution=32, threshold=thr, fused=True)
        assert np.array_equal(out["faces"], ref["faces"]) and np.abs(out["verts"] - ref["verts"]).max() <= 1e-5
        assert np.abs(out["uvs"] - ref["uvs"]).max() <= 1e-5
        assert abs(out["roughness"] - ref["roughness"]) <= 1e-6 and abs(out["metallic"] - ref["metallic"]) <= 1e-6
        for key in ("albedo", "bump"):
            assert np.abs(out["textures"][key] - ref["textures"][key]).max() <= 1.5 / 255
