"""The port's SF3D against the benchmark's plain reference of Stable Fast 3D
(``bench_port/reference/sf3d.py``) on the CPU: a tiny configuration with
nonzero camera modulation, seeded float32 weights drawn from the
reference's own parameter list, the same functions of the same weights.

The reference imports nothing of the port; ``bench_port`` goes on the path
only inside the fixture that loads it. Every tolerance is float32 rounding
of the same arithmetic done in another order (the port's bicubic position
table as a matrix product, its attention and convolutions through other
kernels): the readings at this size are 0 to 1.7e-6, and each limit sits
ten or more times above its reading. Each planted fault (the camera
modulation zeroed, the fuse blocks' directions swapped, the pixel shuffle's
channels in the wrong order) moves the codes by 0.45 to 1.4 of their
largest magnitude, far past the codes' limit.
"""

import json
import os
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "bench_port")
TINY = os.path.join(BENCH, "tests", "tiny", "tiny-pro.json")

# the codes' limit, relative to their largest magnitude (reading 7.5e-7)
CODES_RTOL = 1e-5
# the materials' limit (Beta modes in [0, 1]; reading 0)
MATERIAL_ATOL = 1e-6
# the lattice's densities, relative to their largest value (reading 4.5e-7),
# and the raw offsets, absolute (reading 1.5e-7)
DENSITY_RTOL = 5e-6
OFFSET_ATOL = 2e-6
# the texel heads' albedo in [0, 1] and unit normals (reading 1.7e-6)
TEXEL_ATOL = 2e-5


@pytest.fixture(scope="module")
def ref():
    """The reference modules and the tiny configuration, loaded with
    ``bench_port`` on the path for the import alone."""
    sys.path.insert(0, BENCH)
    try:
        from harness.weights import init_tensors
        from reference import sf3d
    finally:
        sys.path.remove(BENCH)
    with open(TINY) as f:
        cfg = json.load(f)
    sd = init_tensors(sf3d.param_specs(cfg), torch.Generator().manual_seed(5), "cpu")
    return sf3d, cfg, sd


def _port_config(cfg):
    from sculptmate_tpu_torch.systems.sf3d import SF3DConfig

    v, b, po, ie = cfg["image_tokenizer"], cfg["backbone"], cfg["post_processor"], cfg["image_estimator"]
    return SF3DConfig(
        cond_image_size=cfg["cond_image_size"], isosurface_resolution=cfg["isosurface_resolution"],
        plane_size=cfg["tokenizer"]["plane_size"], num_channels=cfg["tokenizer"]["num_channels"],
        num_attention_heads=b["num_attention_heads"], attention_head_dim=b["attention_head_dim"],
        num_latents=b["num_latents"], num_blocks=b["num_blocks"], num_basic_blocks=b["num_basic_blocks"],
        upsample_scale_factor=po["scale_factor"], upsample_conv_layers=po["conv_layers"],
        decoder_heads=tuple(dict(h) for h in cfg["decoder"]["heads"]), dinov2_hidden_size=v["hidden_size"],
        dinov2_num_layers=v["num_hidden_layers"], dinov2_num_heads=v["num_attention_heads"],
        dinov2_intermediate_size=v["intermediate_size"], clip_width=ie["clip_width"], clip_layers=ie["clip_layers"],
        clip_heads=ie["clip_heads"])


def _port(cfg, sd):
    from sculptmate_tpu_torch.systems.sf3d import SF3D

    return SF3D(_port_config(cfg), state_dict=sd, dtype=torch.float32, device="cpu")


@pytest.fixture(scope="module")
def port(ref):
    _, cfg, sd = ref
    return _port(cfg, sd)


@pytest.fixture(scope="module")
def scene(ref, port):
    """One RGBA image at another size than the condition size, its
    condition image on both sides, and the reference's codes."""
    sf3d, cfg, sd = ref
    img = torch.rand(1, 70, 70, 4, generator=torch.Generator().manual_seed(1))
    mask, rgb = port.prepare_image(img)
    rmask, rrgb = sf3d.prepare_image(cfg, img)
    return img, (mask, rgb), (rmask, rrgb), sf3d.scene_codes(sd, cfg, rrgb)


def _codes_gap(port, scene):
    _, (_, rgb), _, ref_codes = scene
    codes, _ = port.get_scene_codes(rgb)
    return float((codes - ref_codes).abs().max() / ref_codes.abs().max())


def test_param_specs_are_the_ports_state_dict(ref, port):
    sf3d, cfg, sd = ref
    ours = {n: tuple(s) for n, s, _ in sf3d.param_specs(cfg)}
    theirs = {k: tuple(v.shape) for k, v in port.module.state_dict().items()}
    assert ours == theirs
    # the camera path computes something: the modulations are seeded nonzero
    assert all(sd[k].abs().max() > 0 for k in sd if "modulation.linear2.weight" in k)


def test_condition_image_matches(scene):
    _, (mask, rgb), (rmask, rrgb), _ = scene
    assert torch.equal(mask, rmask) and float((rgb - rrgb).abs().max()) < 1e-6


def test_scene_codes_match(port, scene):
    assert _codes_gap(port, scene) < CODES_RTOL


def test_materials_match(ref, port, scene):
    sf3d, cfg, sd = ref
    _, (mask, rgb), (rmask, rrgb), _ = scene
    mine = port.estimate_materials(rgb * mask)
    rough, metal = sf3d.materials(sd, cfg, rrgb * rmask)
    assert abs(float(mine["decoder_roughness"].flatten()[0]) - float(rough[0])) < MATERIAL_ATOL
    assert abs(float(mine["decoder_metallic"].flatten()[0]) - float(metal[0])) < MATERIAL_ATOL


def test_lattice_matches(ref, port, scene):
    sf3d, cfg, sd = ref
    code = scene[3][0]
    grids = port.query_lattice(code)
    density, offsets = sf3d.lattice(sd, cfg, code)
    mine = torch.exp(grids["density"][0] - 1.0)  # the density head's bias and activation, as _extract_wire
    assert float((mine - density).abs().max() / density.abs().max()) < DENSITY_RTOL
    assert float((grids["vertex_offset"] - offsets).abs().max()) < OFFSET_ATOL


def test_raw_surface_is_the_ports_marching_tets(ref, port, scene):
    """The reference's raw vertices are the port's unwelded marching tets
    on the same lattice, vertex for vertex (their order aside)."""
    from sculptmate_tpu_torch.geometry.marching_tets import marching_tets

    sf3d, cfg, sd = ref
    density, offsets = sf3d.lattice(sd, cfg, scene[3][0])
    res, r = cfg["isosurface_resolution"], cfg["radius"]
    level = sf3d.threshold_for_vertices(density, 600)
    verts = sf3d.raw_surface(density - level, offsets, r)
    mt = marching_tets(density - level, *offsets, res, 8192, 16384)
    n = int(mt[6])
    assert n == verts.shape[0] == sf3d.cut_tet_edges(density, level) >= 600
    mine = mt.verts[:n] * (2 * r) - r
    gap = torch.cdist(mine.double(), verts.double()).amin(1).max()
    assert float(gap) < 1e-5


def test_texel_heads_match(ref, port, scene):
    sf3d, cfg, sd = ref
    code = scene[3][0]
    world = (torch.rand(500, 3, generator=torch.Generator().manual_seed(2)) * 2 - 1) * cfg["radius"]
    albedo, normal = port._surface_query(code, world[:, 0], world[:, 1], world[:, 2])
    ralbedo, rnormal = sf3d.surface_heads(sd, cfg, code, world)
    assert float((albedo.t() - ralbedo).abs().max()) < TEXEL_ATOL
    assert float((normal.t() - rnormal).abs().max()) < TEXEL_ATOL


def _zero_modulation(cfg, sd, monkeypatch):
    return _port(cfg, {k: torch.zeros_like(v) if "modulation" in k else v for k, v in sd.items()})


def _swap_fuse_directions(cfg, sd, monkeypatch):
    from sculptmate_tpu_torch.models import two_stream

    def forward(self, latent, input, cross_input, tp=None):
        input = self.fuse_block_out(input, latent, tp)
        latent = self.fuse_block_in(latent, input, tp)
        for block in self.transformer_block:
            latent = block(latent, cross_input, tp)
        return latent, input

    monkeypatch.setattr(two_stream.TwoStreamBlock, "forward", forward)
    return _port(cfg, sd)


def _shuffle_channels_wrong(cfg, sd, monkeypatch):
    from sculptmate_tpu_torch.models import upsamplers

    def forward(self, triplanes):
        B, Np, C, H, W = triplanes.shape
        x = triplanes.reshape(B * Np, C, H, W)
        for m in self.upsample[:-1]:
            x = m(x)
        s = self.upsample[-1].upscale_factor
        x = x.reshape(x.shape[0], -1, s * s, H, W).transpose(1, 2).reshape(x.shape[0], -1, H, W)
        x = self.upsample[-1](x)
        return x.reshape(B, Np, *x.shape[1:])

    monkeypatch.setattr(upsamplers.PixelShuffleUpsampleNetwork, "forward", forward)
    return _port(cfg, sd)


@pytest.mark.parametrize("fault", [_zero_modulation, _swap_fuse_directions, _shuffle_channels_wrong],
                         ids=["zero-camera-modulation", "fuse-directions-swapped", "pixel-shuffle-order"])
def test_a_planted_fault_fails_the_codes(ref, scene, monkeypatch, fault):
    _, cfg, sd = ref
    assert _codes_gap(fault(cfg, sd, monkeypatch), scene) > 100 * CODES_RTOL
