"""The plain reference (``bench_port/reference/``) against the port on the
CPU at tiny sizes, in float32: the same functions of the same weights. The
reference imports nothing of the port; these tests import both."""

import json
import os

import numpy as np
import pytest
import torch

from harness.weights import init_tensors
from reference import frontend as ref_frontend
from reference import tsr as ref_tsr
from reference import u2net as ref_u2net
from reference.judge import (cut_edge_count, face_gap, lattice_surface, lattice_vertices, mesh_numbers, mesh_surface,
                             surface_scale, trilinear)

TINY = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tiny")


@pytest.fixture(scope="module")
def tiny():
    with open(os.path.join(TINY, "tiny-lean.json")) as f:
        cfg = json.load(f)
    cfg["decoder"].update(init_gain=1.5, init_bias_std=0.5)
    sd = init_tensors(ref_tsr.param_specs(cfg), torch.Generator().manual_seed(3), "cpu")
    return cfg, sd


@pytest.fixture(scope="module")
def port_tsr(tiny):
    import importlib.util

    from sculptmate_tpu_torch.systems.tsr import TSR

    spec = importlib.util.spec_from_file_location("tiny_cfg", os.path.join(os.path.dirname(TINY), "..", "configs",
                                                                          "triposr-lean.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    cfg, sd = tiny
    return TSR(mod.tsr_config(cfg), state_dict=sd, dtype=torch.float32, device="cpu")


def test_param_specs_are_the_ports_state_dict(tiny, port_tsr):
    cfg, sd = tiny
    ours = {k: tuple(v.shape) for k, v in sd.items()}
    theirs = {k: tuple(v.shape) for k, v in port_tsr.module.state_dict().items()}
    assert ours == theirs


def test_u2net_specs_are_the_ports_state_dict():
    from sculptmate_tpu_torch.frontend.u2net import U2Net

    for cfg, variant in ((ref_u2net.FULL, "full"), (ref_u2net.SMALL, "small")):
        with torch.device("meta"):
            net = U2Net(variant)
        theirs = {k: tuple(v.shape) for k, v in net.state_dict().items()}
        assert {n: tuple(s) for n, s, _ in ref_u2net.param_specs(cfg)} == theirs


def test_scene_codes_lattice_and_colors_match_the_port(tiny, port_tsr):
    from sculptmate_tpu_torch.ops.density_grid import query_density_grid, query_triplane_points

    cfg, sd = tiny
    img = torch.rand(1, 96, 96, 3, generator=torch.Generator().manual_seed(1))
    ref = ref_tsr.scene_codes(sd, cfg, img)
    got = port_tsr.scene_codes(img.numpy())
    assert (ref - got).abs().max() <= 1e-4 * ref.abs().max()
    lat = ref_tsr.density_lattice(sd, cfg, ref[0], 24)
    spec = port_tsr.grid_spec(24)
    port_lat = query_density_grid(ref[0], port_tsr.decoder_weights(), spec)
    assert (lat.log() - port_lat.log()).abs().max() <= 1e-4 * (lat.log() - lat.log().mean()).abs().max()
    world = (torch.rand(500, 3, generator=torch.Generator().manual_seed(2)) * 2 - 1) * 0.8
    col = ref_tsr.colors_at(sd, cfg, ref[0], world)
    port_col = query_triplane_points(ref[0], port_tsr.decoder_weights(), world[:, 0], world[:, 1], world[:, 2],
                                     spec)["color"].t()
    assert (col - port_col).abs().max() <= 1e-5


def test_u2net_masks_match_the_port():
    from sculptmate_tpu_torch.frontend.matting import SessionBase
    from sculptmate_tpu_torch.frontend.u2net import U2Net

    sd = init_tensors(ref_u2net.param_specs(ref_u2net.SMALL), torch.Generator().manual_seed(4), "cpu")

    class Small(SessionBase):
        def build_module(self):
            return U2Net("small")

    session = Small(state_dict=sd, device="cpu")
    x = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(5))
    assert torch.allclose(ref_u2net.masks(sd, x, ref_u2net.SMALL), session.predict_mask_batch(x), atol=1e-5)


def test_frontends_match_the_port():
    from PIL import Image

    from harness.photos import photo
    from sculptmate_tpu_torch.frontend.preprocess import preprocess_batch_device, preprocess_image

    with open(os.path.join(TINY, "tiny-photo.json")) as f:
        params = json.load(f)["photo"]
    img = Image.fromarray(photo(params, 11, 0, "cpu").numpy())
    mask = lambda x: torch.sigmoid(8 * (x.mean(-1) - 0.5))  # noqa: E731

    class Session:
        def predict(self, image):
            small = image.convert("RGB").resize((320, 320), Image.Resampling.LANCZOS)
            m = mask(torch.from_numpy(np.asarray(small, np.float32) / 255.0)[None])[0].numpy()
            return [Image.fromarray((m * 255).astype(np.uint8), mode="L").resize(image.size,
                                                                                 Image.Resampling.LANCZOS)]

    ref = ref_frontend.preprocess_host(img, 0.75, False, mask)
    got = preprocess_image(img, ratio=0.75, use_alpha=False, session=Session())
    assert np.array_equal(np.asarray(ref), np.asarray(got))
    rgba = torch.rand(2, 48, 40, 4, generator=torch.Generator().manual_seed(6))
    rgba[..., 3] = (rgba[..., 3] > 0.3).float() * rgba[..., 3]
    assert torch.allclose(ref_frontend.preprocess_device(rgba, 0.75, 32), preprocess_batch_device(rgba, 0.75, 32),
                          atol=1e-5)


def test_judge_reads_a_sound_mesh_small_and_a_shifted_one_large():
    g = torch.Generator().manual_seed(7)
    x = torch.linspace(-1, 1, 20)
    level = (0.6 - (x[:, None, None] ** 2 + x[None, :, None] ** 2 + x[None, None, :] ** 2).sqrt()).contiguous()
    level += 0.01 * torch.randn(level.shape, generator=g)
    verts = lattice_vertices(level)
    assert verts.shape[0] == cut_edge_count(level)
    assert trilinear(level, verts).abs().max() < 1e-5
    scale = surface_scale(level)
    cols = torch.rand(verts.shape[0], 3, generator=g)
    surface = lattice_surface(level)
    good = mesh_numbers(level, scale, cut_edge_count(level), verts, cols, cols, surface)
    assert good["surface_gap"] < 1e-4 and good["vertex_count_gap"] == 0 and good["color_gap"] == 0
    assert good["face_gap"] == 0
    bad = mesh_numbers(level, scale, cut_edge_count(level), verts + 0.5, cols + 0.1, cols, surface)
    assert bad["surface_gap"] > 0.2 and bad["color_gap"] == pytest.approx(0.1, abs=1e-6)
    half = mesh_numbers(level, scale, cut_edge_count(level), verts[::2], cols[::2], cols[::2], surface)
    assert half["vertex_count_gap"] == pytest.approx(0.5, abs=0.01)


def _corner_level(case: int, values: np.ndarray) -> torch.Tensor:
    """A 2^3 lattice whose corner c (offset bits x, y, z) is inside (> 0)
    when bit c of ``case`` is set."""
    level = torch.zeros((2, 2, 2))
    for c in range(8):
        level[c & 1, (c >> 1) & 1, (c >> 2) & 1] = float(values[c] if (case >> c) & 1 else -values[c])
    return level


def test_lattice_surface_is_the_ports_table_in_every_case():
    """In a single cell, each of the 254 cut cases: the reference's vector
    area is that of the port's triangle table (``geometry/mc_tables.py``)
    on the same edge points."""
    from sculptmate_tpu_torch.geometry.mc_tables import EDGES, build_tables

    tri, count, _ = build_tables()
    rng = np.random.default_rng(8)
    for case in range(1, 255):
        level = _corner_level(case, rng.uniform(0.1, 1.0, 8))

        def point(e):
            axis, *lo = EDGES[e]
            hi = list(lo)
            hi[axis] += 1
            a, b = float(level[tuple(lo)]), float(level[tuple(hi)])
            p = np.array(lo, np.float64)
            p[axis] += a / (a - b)
            return p

        want = np.zeros(3)
        for k in range(count[case]):
            p0, p1, p2 = (point(e) for e in tri[case, k])
            want += 0.5 * np.cross(p1 - p0, p2 - p0)
        keys, areas = lattice_surface(level)
        assert keys.tolist() == [0] and np.allclose(areas[0].numpy(), want, atol=1e-6), case


@pytest.mark.parametrize("shape", [(16, 16, 16), (8, 24, 16)])
def test_face_gap_of_the_ports_mesh_and_of_its_faults(shape):
    """The port's plain K10 mesh of a noisy lattice (many ambiguous faces)
    reads 0 to rounding; its faces re-wound, half dropped or joined across
    the lattice read their share of the surface."""
    from sculptmate_tpu_torch.geometry.marching_cubes import marching_cubes_plain

    g = torch.Generator().manual_seed(9)
    x = [torch.linspace(-1, 1, n) for n in shape]
    r = (x[0][:, None, None] ** 2 + x[1][None, :, None] ** 2 + x[2][None, None, :] ** 2).sqrt()
    level = (0.7 - r + 0.3 * torch.randn(shape, generator=g)).contiguous()
    mc = marching_cubes_plain(level, 1 << 15, 1 << 16)
    nv, nf = int(mc.num_verts), int(mc.num_faces)
    pos = torch.stack([mc.vx[:nv], mc.vy[:nv], mc.vz[:nv]], 1)
    faces = torch.stack([mc.fa[:nf], mc.fb[:nf], mc.fc[:nf]], 1).long()
    ref = lattice_surface(level)
    assert face_gap(ref, mesh_surface(pos, faces, shape)) < 1e-5
    assert face_gap(ref, mesh_surface(pos, faces[:, [0, 2, 1]], shape)) > 1.5
    assert face_gap(ref, mesh_surface(pos, faces[::2], shape)) > 0.3
    assert face_gap(ref, mesh_surface(pos, torch.randperm(nv, generator=g)[faces], shape)) > 1.0
    assert face_gap(ref, mesh_surface(pos, faces + nv, shape)) == float("inf")
