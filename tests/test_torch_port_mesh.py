"""Port parity: wire-format marching cubes, its host decoder, and the whole
Lean slice (codes -> density grid -> wire -> mesh with vertex colors)
against the JAX package, on the CPU."""

import collections
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sculptmate_tpu.geometry import mc_wire as jwire
from sculptmate_tpu.geometry.marching_cubes import mc_wire_device as j_mc_wire
from sculptmate_tpu.ops.density_grid import mlp_weights_from_params, query_density_grid
from sculptmate_tpu.systems.tsr import TSR as JTSR
from sculptmate_tpu.systems.tsr import TSRConfig as JTSRConfig
from sculptmate_tpu_torch.geometry import mc_wire as twire
from sculptmate_tpu_torch.geometry.marching_cubes import mc_wire_device
from sculptmate_tpu_torch.runtime.capacity_cache import Capacities
from sculptmate_tpu_torch.runtime.checkpoint import tsr_params_from_jax
from sculptmate_tpu_torch.systems.tsr import TSR, TSRConfig

SMALL = dict(
    cond_image_size=64, plane_size=8, num_channels=64, num_attention_heads=4,
    attention_head_dim=16, num_layers=2, cross_attention_dim=64, vit_hidden_size=64,
    vit_num_layers=2, vit_num_heads=4, vit_intermediate_size=128,
)


def _grid(R):
    g = np.arange(R, dtype=np.float32)
    return np.meshgrid(g, g, g, indexing="ij")


def _sphere(rng, R=16):
    x, y, z = _grid(R)
    c = (R - 1) / 2
    return (0.35 * R - np.sqrt((x - c) ** 2 + (y - c) ** 2 + (z - c) ** 2)).astype(np.float32)


def _torus(rng, R=24):
    x, y, z = _grid(R)
    c = (R - 1) / 2
    q = np.sqrt((x - c) ** 2 + (y - c) ** 2) - 0.3 * R
    return (0.12 * R - np.sqrt(q**2 + (z - c) ** 2)).astype(np.float32)


def _noise(rng, R=32):
    return rng.standard_normal((R, R, R)).astype(np.float32)


def _sections(wire, shape, mv):
    o = jwire.wire_layout(shape, mv, jwire.N_WIRE_COUNTS, has_colors=False)
    t = wire[o[1] : o[2]].astype(np.int32) + 256 * wire[o[2] : o[3]].astype(np.int32)
    return wire[: o[1]], t, wire[o[6] :]


@pytest.mark.parametrize("field", [_sphere, _torus, _noise])
def test_mc_wire_matches_jax(rng, field):
    """Same f32 level array into both packers: occupancy bytes and counts
    identical, t within 1 LSB of u16, colors within 1 of u8, and both
    decoders return the same faces."""
    level = field(rng)
    R = level.shape[0]
    shape = level.shape
    mv = 3 * R**3  # every lattice edge: the noise field cuts ~half of them

    def jcolor(vx, vy, vz, valid):
        return vx / (R - 1), vy / (R - 1), vz / (R - 1)

    def tcolor(vx, vy, vz):
        return vx / (R - 1), vy / (R - 1), vz / (R - 1)

    pack = jax.jit(functools.partial(j_mc_wire, color_fn=jcolor, split_colors=True), static_argnums=(1,))
    ref, ref_rgb = (np.asarray(a) for a in pack(jnp.asarray(level), mv))
    got, got_rgb = (a.numpy() for a in mc_wire_device(torch.from_numpy(level), mv, tcolor))
    assert got.shape == ref.shape and got.dtype == np.uint8 and got_rgb.shape == ref_rgb.shape
    occ_g, t_g, cnt_g = _sections(got, shape, mv)
    occ_r, t_r, cnt_r = _sections(ref, shape, mv)
    assert np.array_equal(occ_g, occ_r) and np.array_equal(cnt_g, cnt_r)
    nv = int(jwire.wire_counts(ref, jwire.N_WIRE_COUNTS)[0])
    assert 0 < nv <= mv
    assert np.abs(t_g - t_r).max() <= 1
    rgb_g, rgb_r = (c.reshape(3, mv)[:, :nv].astype(np.int32) for c in (got_rgb, ref_rgb))
    assert np.abs(rgb_g - rgb_r).max() <= 1

    vg, fg, *_ = twire.decode_wire(got, shape, mv, has_colors=False)
    vr, fr, _, _ = jwire.decode_wire(ref, shape, mv, has_colors=False)
    assert len(fg) > 0 and np.array_equal(fg, fr)
    np.testing.assert_allclose(vg, vr, rtol=0, atol=2.0 / 65535)


def test_numpy_decoder_matches_native(rng):
    level = _torus(rng)
    mv = 8 * 24 * 24
    wire = mc_wire_device(torch.from_numpy(level), mv).numpy()
    o = twire.wire_layout(level.shape, mv, twire.N_WIRE_COUNTS, has_colors=False)
    zeros = np.zeros(mv, np.uint8)
    vn, fn, _, counts, _ = twire.decode_wire(wire, level.shape, mv, has_colors=False)
    vp, fp, *_ = twire._decode_numpy(
        wire[: o[1]], wire[o[1] : o[2]], wire[o[2] : o[3]], zeros, zeros, zeros,
        level.shape, int(counts[0]), counts,
    )
    assert np.array_equal(fn, fp)
    np.testing.assert_allclose(vn, vp, rtol=0, atol=1e-6)


def test_wire_counts_report_overflow(rng):
    """A capacity below the vertex count keeps the exact counter, so the
    caller can see the overflow."""
    level = _sphere(rng)
    full = mc_wire_device(torch.from_numpy(level), 8 * 16 * 16).numpy()
    nv = int(twire.wire_counts(full, 2)[0])
    small = mc_wire_device(torch.from_numpy(level), nv // 2).numpy()
    assert int(twire.wire_counts(small, 2)[0]) == nv


def _margin_threshold(density):
    """A threshold at least 1e-3 from every lattice value (so occupancy
    cannot flip between the two implementations), with >= 2 % of the
    points inside."""
    d = np.sort(density.ravel())
    gaps = np.diff(d)
    idx = [i for i in np.nonzero(gaps >= 2e-3)[0] if 0.5 * d.size <= i <= 0.98 * d.size]
    assert idx, "no threshold with a 1e-3 margin"
    return float(d[idx[0]] + d[idx[0] + 1]) / 2


@pytest.fixture(scope="module")
def slice_pair():
    """JAX and port TSRs with the same weights. The density output channel
    is scaled up so the random-weight field has the dynamic range that
    leaves gaps for a margin-safe threshold."""
    base = JTSR(JTSRConfig(**SMALL), dtype=jnp.float32)
    params = jax.tree.map(np.array, base.params)
    params["decoder"]["layers"]["dense_out"]["kernel"][:, 0] *= 1000.0
    jt = JTSR(JTSRConfig(**SMALL), params=params, dtype=jnp.float32)
    tt = TSR(TSRConfig(**SMALL), state_dict=tsr_params_from_jax(params), dtype=torch.float32, device="cpu")
    img = np.random.default_rng(42).random((1, 64, 64, 3)).astype(np.float32)
    return jt, tt, np.array(jt.scene_codes(jnp.asarray(img)))


@pytest.mark.parametrize("resolution", [16, 32])
def test_extract_mesh_matches_jax(slice_pair, resolution):
    """The slice end to end from the same codes, f32: equal vertex and
    face counts and faces, positions within 1e-4, colors within 1/255."""
    jt, tt, codes = slice_pair
    w = mlp_weights_from_params(jt.params["decoder"]["layers"])
    dens = np.asarray(query_density_grid(jnp.asarray(codes[0]), w, jt.grid_spec(resolution)))
    thr = _margin_threshold(dens)
    vr, fr, cr = jt.extract_mesh(jnp.asarray(codes), has_vertex_color=True, resolution=resolution, threshold=thr)[0]
    vg, fg, cg = tt.extract_mesh(torch.from_numpy(codes), has_vertex_color=True, resolution=resolution, threshold=thr)[0]
    assert len(vr) > 0 and vg.shape == vr.shape and fg.shape == fr.shape
    assert np.array_equal(fg, fr)
    np.testing.assert_allclose(vg, vr, rtol=0, atol=1e-4)
    np.testing.assert_allclose(cg, cr, rtol=0, atol=1.0 / 255 + 1e-6)


def _span_counts(fn):
    """``fn()`` under the CPU profiler -> (its result, the count of each
    event name)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, collections.Counter(e.name for e in prof.events())


def test_overflow_is_retried_not_truncated(slice_pair, tmp_path, monkeypatch):
    """An explicit capacity far below the vertex count still returns the
    whole mesh (grown and re-extracted), identical to the default run, and
    the grown capacity is kept; the re-extraction runs inside one
    ``tsr.capacity_retry`` span, the default run inside none."""
    _, tt, codes = slice_pair
    code = torch.from_numpy(codes)
    (v0, f0, c0), n0 = _span_counts(
        lambda: tt.extract_mesh(code, has_vertex_color=True, resolution=16, threshold=0.5)[0])
    assert len(v0) > 64
    # a policy with nothing kept, in an empty store: what is kept next is the retry's
    p = tt.wire_capacities
    monkeypatch.setattr(tt, "wire_capacities", Capacities(p.name, p.default, p.at_least_default))
    monkeypatch.setenv("SCULPTMATE_CAP_CACHE", str(tmp_path))
    (v1, f1, c1), n1 = _span_counts(
        lambda: tt.extract_mesh(code, has_vertex_color=True, resolution=16, threshold=0.5, max_verts=64)[0])
    assert np.array_equal(f0, f1) and np.array_equal(v0, v1) and np.array_equal(c0, c1)
    assert tt.wire_capacities.kept(16)[0] >= len(v0)
    assert tt.wire_capacities.kept(16) == (65536,)  # 64 grown to one bucket, then tightened
    assert n0["tsr.capacity_retry"] == 0 and n1["tsr.capacity_retry"] == 1
    assert n1["tsr.density_grid"] == 2


def test_extract_stages_are_profiled(slice_pair):
    """Every stage of an asset runs inside its ``tsr.*`` profiler span, the
    spans the card's profile reads its breakdown from."""
    _, tt, codes = slice_pair
    img = np.random.default_rng(42).random((1, 64, 64, 3)).astype(np.float32)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        tt.scene_codes(img)
        tt.extract_mesh(torch.from_numpy(codes), has_vertex_color=True, resolution=16, threshold=0.5)
    spans = {e.key for e in prof.key_averages() if e.key.startswith("tsr.")}
    assert spans == {"tsr.scene_codes", "tsr.density_grid", "tsr.marching_cubes", "tsr.color_query",
                     "tsr.wire_to_host", "tsr.wire_decode", "tsr.wire_faces", "tsr.colors_to_host"}
