"""Port parity of the multi-device paths on the CPU: the device mesh, the
x-slab arguments of the density grid (K2) and of the marching cubes (K3,
K10), the sharded extractions, the farms over dp and the tensor-parallel
backbones. The port runs on ``make_mesh(..., devices=["cpu"] * n)``, one
process driving n CPU shards; the JAX package on ``make_mesh`` over
conftest's 8 virtual CPU devices, on the same seeded weights
(``tsr_params_from_jax``, ``sf3d_params_from_jax``) and inputs."""

import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from sculptmate_tpu.geometry.marching_cubes import marching_cubes as j_mc
from sculptmate_tpu.geometry.marching_cubes import mc_wire_device as j_wire
from sculptmate_tpu.ops.density_grid import mlp_weights_from_params
from sculptmate_tpu.ops.density_grid import query_density_grid as j_query
from sculptmate_tpu.parallel import farm as jfarm_mod
from sculptmate_tpu.parallel.mesh import make_mesh as j_make_mesh
from sculptmate_tpu.systems.tsr import TSR as JTSR
from sculptmate_tpu.systems.tsr import TSRConfig as JTSRConfig
from sculptmate_tpu_torch.geometry import marching_cubes as mc
from sculptmate_tpu_torch.ops import density_grid as dg
from sculptmate_tpu_torch.parallel import farm as farm_mod
from sculptmate_tpu_torch.parallel.farm import AssetFarm
from sculptmate_tpu_torch.parallel.mesh import factor2, gather, make_mesh, replicate, shard_batch
from sculptmate_tpu_torch.parallel.sf3d_farm import SF3DFarm
from sculptmate_tpu_torch.runtime.checkpoint import tsr_params_from_jax
from sculptmate_tpu_torch.systems.sf3d import SF3D, SF3DConfig
from sculptmate_tpu_torch.systems.tsr import TSR, TSRConfig

SMALL = dict(
    cond_image_size=32, plane_size=8, num_channels=64, num_attention_heads=4, attention_head_dim=16,
    num_layers=2, cross_attention_dim=64, vit_hidden_size=64, vit_num_layers=2, vit_num_heads=4,
    vit_intermediate_size=128,
)
# tests/test_parallel.py's tiny SF3D
SF3D_TINY = dict(
    cond_image_size=56, isosurface_resolution=14, plane_size=8, num_channels=64, num_attention_heads=4,
    attention_head_dim=16, num_latents=32, num_blocks=1, num_basic_blocks=1, upsample_scale_factor=2,
    upsample_conv_layers=2, dinov2_hidden_size=64, dinov2_num_layers=2, dinov2_num_heads=4,
    dinov2_intermediate_size=128, clip_width=64, clip_layers=2, clip_heads=4,
)
R_SP = 64  # the sharded extractions' lattice, over 8 shards


def cpus(n):
    return ["cpu"] * n


def _margin_threshold(densities, lo, hi):
    """A threshold at least 2.5e-4 from every lattice value of every grid
    (the values are ~1: far past the two implementations' f32 rounding, so
    occupancy cannot flip between them), with a share of the points
    between ``lo`` and ``hi`` below it (the highest such)."""
    d = np.sort(np.concatenate([x.ravel() for x in densities]))
    idx = [i for i in np.nonzero(np.diff(d) >= 5e-4)[0] if lo * d.size <= i <= hi * d.size]
    assert idx, "no threshold with a 2.5e-4 margin"
    return float(d[idx[-1]] + d[idx[-1] + 1]) / 2


@pytest.fixture(scope="module")
def pair():
    """JAX and port TSRs with the same narrow weights (the density output
    channel scaled up, so the random-weight field leaves gaps for a
    margin-safe threshold), the JAX codes of one seeded image and the
    decoder's weights on both sides."""
    base = JTSR(JTSRConfig(**SMALL), dtype=jnp.float32)
    params = jax.tree.map(np.array, base.params)
    params["decoder"]["layers"]["dense_out"]["kernel"][:, 0] *= 300.0
    jt = JTSR(JTSRConfig(**SMALL), params=params, dtype=jnp.float32)
    tt = TSR(TSRConfig(**SMALL), state_dict=tsr_params_from_jax(params), dtype=torch.float32, device="cpu")
    img = np.random.default_rng(42).random((1, 32, 32, 3)).astype(np.float32)
    code = np.array(jt.scene_codes(jnp.asarray(img)))[0]
    return jt, tt, code, mlp_weights_from_params(jt.params["decoder"]["layers"]), tt.decoder_weights()


# -- the mesh --


@pytest.mark.parametrize("n,expected", [(8, (2, 4)), (4, (2, 2)), (7, (1, 7)), (1, (1, 1))])
def test_factor2(n, expected):
    assert factor2(n) == expected


def test_make_mesh_shapes_and_groups(monkeypatch, pair):
    """Shapes and axis names as the JAX mesh has them, the dp rows' tp
    groups, ``tensor_split`` shards in order, one replica per distinct
    device (the system itself on its own device); a shape that does not
    match the devices raises, and so does ``make_mesh()`` without a card."""
    mesh = make_mesh((2, 4), ("dp", "tp"), devices=cpus(8))
    jmesh = j_make_mesh((2, 4), ("dp", "tp"))
    assert mesh.shape == dict(jmesh.shape) == {"dp": 2, "tp": 4} and mesh.axis_names == jmesh.axis_names
    assert mesh.groups("dp", "tp") == [(torch.device("cpu"),) * 4] * 2
    assert mesh.groups("tp") == [(torch.device("cpu"),)] * 4
    assert make_mesh(axis_names=("sp", "tp"), devices=cpus(8)).shape == {"sp": 8, "tp": 1}
    x = torch.arange(10.0)
    parts = shard_batch(mesh, x, "dp")
    assert [len(p) for p in parts] == [5, 5] and torch.equal(gather(parts, "cpu"), x)
    tt = pair[1]
    assert replicate(mesh.devices.ravel(), tt) == {torch.device("cpu"): tt}
    with pytest.raises(ValueError, match="devices"):
        make_mesh((3, 3), ("dp", "tp"), devices=cpus(8))
    with pytest.raises(ValueError, match="no 'sp'"):
        mesh.groups("sp")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()


# -- the slab arguments of K2, K3 and K10 --


def test_query_density_grid_x_coords_matches_jax(pair):
    """An x-slab whose last row is clamped to the lattice's last (the last
    shard's halo), the rows at the lattice's own coordinates: the JAX
    slab, and the port's whole lattice at those rows."""
    jt, tt, code, jw, tw = pair
    R = 16
    rows = np.minimum(12 + np.arange(5), R - 1)
    cx = (2.0 * rows.astype(np.float32) / (R - 1) - 1.0).astype(np.float32)
    got = dg.query_density_grid(torch.from_numpy(code), tw, tt.grid_spec(R), x_coords=torch.from_numpy(cx))
    ref = np.asarray(j_query(jnp.asarray(code), jw, jt.grid_spec(R), x_coords=jnp.asarray(cx)))
    assert got.shape == (5, R, R)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)
    whole = dg.query_density_grid(torch.from_numpy(code), tw, tt.grid_spec(R))
    np.testing.assert_allclose(got.numpy(), whole[rows].numpy(), rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def slab_level(pair):
    """A padded slab as the sharded extraction makes it: 9 density rows
    (the 8 of a shard and its halo) of the R = 64 lattice, cut at their
    80th percentile, padded with -1 to 16 rows. Both packages take this
    same level, so no margin is needed."""
    jt, tt, code, jw, tw = pair
    cx = dg.lattice_coords(R_SP)[24:33]
    dens = dg.query_density_grid(torch.from_numpy(code), tw, tt.grid_spec(R_SP), x_coords=cx).numpy()
    level = np.full((16, R_SP, R_SP), -1.0, np.float32)
    level[:9] = dens - np.quantile(dens, 0.8)
    return level


@pytest.mark.parametrize("limit", [8, 7, 3])
def test_valid_x_limit_matches_jax(slab_level, limit):
    """K10's and K3's plain versions at an x limit against JAX's
    ``valid_x = arange(RX) < limit``: the four counters and the faces
    equal, positions within 1e-6; the wire byte-equal, and its decoded
    faces as JAX's."""
    level = slab_level
    valid_x = jnp.arange(level.shape[0]) < limit
    mv, mf = 3 * level.size // 4, 3 * level.size // 2
    got = mc.marching_cubes_plain(torch.from_numpy(level), mv, mf, valid_x_limit=limit)
    ref = jax.jit(j_mc, static_argnums=(1, 2))(jnp.asarray(level), mv, mf, valid_x=valid_x)
    for k in ("num_verts", "num_faces", "num_active_blocks", "num_active_cells"):
        assert int(getattr(got, k)) == int(getattr(ref, k)), k
    nf = int(ref.num_faces)
    assert nf > 0 and int(got.num_faces) < int(mc.marching_cubes_plain(torch.from_numpy(level), mv, mf).num_faces)
    for k in ("vx", "vy", "vz"):
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(ref, k)), rtol=0, atol=1e-6)
    for k in ("fa", "fb", "fc"):
        assert np.array_equal(getattr(got, k).numpy(), np.asarray(getattr(ref, k))), k

    from sculptmate_tpu.geometry import mc_wire as jwire
    from sculptmate_tpu_torch.geometry import mc_wire as twire

    wire = mc.mc_wire_device_plain(torch.from_numpy(level), mv, valid_x_limit=limit).numpy()
    jref = np.asarray(jax.jit(functools.partial(j_wire, valid_x=valid_x), static_argnums=(1,))(jnp.asarray(level), mv))
    assert wire.shape == jref.shape and np.array_equal(wire, jref)
    vg, fg, *_ = twire.decode_wire(wire, level.shape, mv, has_colors=False, valid_x_limit=limit)
    vr, fr, _, _ = jwire.decode_wire(jref, level.shape, mv, has_colors=False, valid_x_limit=limit)
    assert len(fg) == nf and np.array_equal(fg, fr)
    np.testing.assert_allclose(vg, vr, rtol=0, atol=2.0 / 65535)


# -- the sharded extractions (sp over 8 shards) --


def test_sharded_density_grid_matches_jax(pair):
    """R = 16 over 8 shards, one slab per shard joined by ``gather``,
    against JAX's ``sharded_density_grid`` at its test's tolerance."""
    jt, tt, code, jw, tw = pair
    slabs = farm_mod.sharded_density_grid(make_mesh((8,), ("sp",), devices=cpus(8)), torch.from_numpy(code), tw,
                                          tt.grid_spec(16))
    assert [tuple(s.shape) for s in slabs] == [(2, 16, 16)] * 8
    ref = jfarm_mod.sharded_density_grid(j_make_mesh((8,), ("sp",)), jnp.asarray(code), jw, jt.grid_spec(16))
    np.testing.assert_allclose(gather(slabs, "cpu").numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def sharded(pair):
    """The port's and JAX's sharded extractions at R = 64 over 8 shards,
    packed and wire, and the port's single-device K10 mesh (its plain
    version), at a margin-safe threshold near the 99th percentile."""
    jt, tt, code, jw, tw = pair
    spec = tt.grid_spec(R_SP)
    dens = dg.query_density_grid(torch.from_numpy(code), tw, spec).numpy()
    thr = _margin_threshold([dens, np.asarray(j_query(jnp.asarray(code), jw, jt.grid_spec(R_SP)))], 0.97, 0.995)
    mesh, jmesh = make_mesh((8,), ("sp",), devices=cpus(8)), j_make_mesh((8,), ("sp",))
    tcode = torch.from_numpy(code)
    sv, sf = mc.marching_cubes_host(dens - thr, device="cpu")
    used = np.zeros(len(sv), bool)
    used[sf.ravel()] = True
    return {
        "port": farm_mod.sharded_extract(mesh, tcode, tw, spec, thr),
        "port_wire": farm_mod.sharded_extract_wire(mesh, tcode, tw, spec, thr),
        "jax": jfarm_mod.sharded_extract(jmesh, jnp.asarray(code), jw, jt.grid_spec(R_SP), threshold=thr),
        "jax_wire": jfarm_mod.sharded_extract_wire(jmesh, jnp.asarray(code), jw, jt.grid_spec(R_SP), threshold=thr),
        "single": (sv[used], (np.cumsum(used) - 1)[sf]),
        "args": (mesh, tcode, tw, spec, thr),
    }


def edge_stats(faces):
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    fwd = set(map(tuple, e))
    return len(fwd), sum((b, a) not in fwd for a, b in fwd)


def edge_keyed(v):
    fr = v - np.floor(v)
    axis = np.argmax(fr, axis=1)
    base = np.floor(v + 1e-6).astype(np.int64)
    key = ((axis * 1000 + base[:, 0]) * 1000 + base[:, 1]) * 1000 + base[:, 2]
    order = np.argsort(key)
    return key[order], v[order]


def assert_same_mesh(a, b):
    """``tests/test_parallel.py``'s criteria: equal vertex and face counts,
    equal edge statistics (a failed weld leaves unpaired edges), the same
    cut lattice edges, each vertex within 1.0 and 99 % within 1e-2."""
    (av, af), (bv, bf) = a, b
    assert len(av) == len(bv) > 100 and len(af) == len(bf)
    assert edge_stats(af) == edge_stats(bf)
    ka, va = edge_keyed(av)
    kb, vb = edge_keyed(bv)
    np.testing.assert_array_equal(ka, kb)
    d = np.abs(va - vb).max(axis=1)
    assert (d <= 1.0).all() and np.quantile(d, 0.99) < 1e-2


def canon(verts, faces):
    order = np.lexsort((verts[:, 2], verts[:, 1], verts[:, 0]))
    remap = np.empty(len(verts), np.int64)
    remap[order] = np.arange(len(verts))
    f = remap[faces]
    k = np.argmin(f, axis=1)
    rot = np.stack([f[np.arange(len(f)), (k + s) % 3] for s in range(3)], axis=1)
    return verts[order], rot[np.lexsort((rot[:, 2], rot[:, 1], rot[:, 0]))]


@pytest.mark.parametrize("against", ["jax", "single"])
def test_sharded_extract_matches(sharded, against):
    """The port's 8-shard extraction against JAX's and against the
    single-device mesh, by JAX's criteria; its weld leaves no more
    unpaired edges than the single-device mesh has."""
    assert_same_mesh(sharded["port"], sharded[against])
    assert edge_stats(sharded["port"][1])[1] == edge_stats(sharded["single"][1])[1]


@pytest.mark.parametrize("against", ["port", "jax_wire"])
def test_sharded_extract_wire_matches(sharded, against):
    """The wire extraction against the port's packed one and against JAX's
    wire one: the same welded topology, positions within u16 t steps."""
    pv, pf = canon(*sharded[against])
    wv, wf = canon(*sharded["port_wire"])
    assert len(wv) > 100 and wv.shape == pv.shape and np.array_equal(wf, pf)
    assert np.max(np.abs(pv - wv)) < 2e-4


def test_sharded_extract_capacities(sharded):
    """A shard past its vertex or face capacity raises with the counts; a
    face capacity that just holds the largest shard gives the same mesh
    (the port's K10 has no block or cell capacity besides)."""
    mesh, code, w, spec, thr = sharded["args"]
    with pytest.raises(RuntimeError, match="capacity overflow on shard"):
        farm_mod.sharded_extract(mesh, code, w, spec, thr, max_verts_per_shard=64)
    with pytest.raises(RuntimeError, match="capacity overflow on shard"):
        farm_mod.sharded_extract_wire(mesh, code, w, spec, thr, max_verts_per_shard=64)
    slab = R_SP // 8
    partials = {}
    nf = [int(mc.marching_cubes_plain(farm_mod._slab_level(code, w, spec, thr, s, slab, 16, torch.device("cpu"),
                                                           partials),
                                      1 << 16, 1 << 17, slab - 1 if s == 7 else slab).num_faces) for s in range(8)]
    with pytest.raises(RuntimeError, match=f"nf={max(nf)}/{max(nf) - 1}"):
        farm_mod.sharded_extract(mesh, code, w, spec, thr, max_faces_per_shard=max(nf) - 1)
    v, f = farm_mod.sharded_extract(mesh, code, w, spec, thr, max_faces_per_shard=max(nf))
    assert np.array_equal(v, sharded["port"][0]) and np.array_equal(f, sharded["port"][1])


@functools.lru_cache(maxsize=None)
def smoke():
    """``chip_smoke``, whose mesh helpers the checks here share: its
    ``merge_exact_duplicates`` (the JAX package's weld, the planted weld
    fault there) and ``on_their_edges``."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    return chip_smoke


def directed_edges(faces):
    return set(map(tuple, np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]]).tolist()))


def assert_unwelded_single(got, single, wire=False):
    """``got`` is the single-device mesh as it comes: the same vertex count
    and order, the same directed edges, positions within one f32 ulp (for
    the wire a u16 t step and an ulp); the packed form's faces in the same
    order."""
    (gv, gf), (sv, sf) = got, single
    assert len(gv) == len(sv) and len(gf) == len(sf)
    assert directed_edges(gf) == directed_edges(sf)
    ulp = np.spacing(np.maximum(np.abs(gv), np.abs(sv)))
    if wire:
        assert (np.abs(gv - sv) <= 1.0 / 65535 + ulp).all()
    else:
        assert np.array_equal(gf, sf)
        assert (np.abs(gv - sv) <= ulp).all()


def test_sharded_extract_merges_the_cuts_of_a_lattice_value(pair):
    """A threshold equal to a lattice point's density, each package's own
    slab value there: the level is exactly 0 at that point, and the cut
    edges from it to its inside neighbours put their vertices on it. The
    port's seam weld matches vertices by edge identity, so its sharded mesh
    (packed and wire) is the unwelded single-device mesh; the JAX package's
    exact-duplicate weld merges the coincident vertices, so its sharded
    mesh has fewer vertices and equals the port's welded the same way."""
    jt, tt, code, jw, tw = pair
    R, slab = R_SP, R_SP // 8
    spec, jspec = tt.grid_spec(R), jt.grid_spec(R)
    dens = dg.query_density_grid(torch.from_numpy(code), tw, spec).numpy()
    jdens = np.asarray(j_query(jnp.asarray(code), jw, jspec))
    every = np.sort(np.concatenate([dens.ravel(), jdens.ravel()]))
    steps = [(1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1)]

    def candidate(p):
        """Inside the lattice, at least two neighbours denser, no other
        value of either package within 2.5e-4."""
        v = dens[p]
        if min(p) < 1 or max(p) > R - 2 or sum(dens[tuple(np.add(p, st))] > v for st in steps) < 2:
            return False
        return np.searchsorted(every, v + 2.5e-4) - np.searchsorted(every, v - 2.5e-4) <= 2

    order = np.argsort(dens.ravel())[::-1][int(0.005 * R**3) : int(0.05 * R**3)]
    p = next(q for q in map(lambda i: np.unravel_index(i, dens.shape), order) if candidate(q))
    mesh = make_mesh((8,), ("sp",), devices=cpus(8))
    thr = float(dens[p])
    got = farm_mod.sharded_extract(mesh, torch.from_numpy(code), tw, spec, thr)
    wire = farm_mod.sharded_extract_wire(mesh, torch.from_numpy(code), tw, spec, thr)
    single = mc.marching_cubes_host(dens - thr, device="cpu")
    single = single[0], single[1].astype(np.int64)
    welded = smoke().merge_exact_duplicates(*single)
    assert len(welded[0]) < len(single[0]) and len(directed_edges(welded[1])) < len(directed_edges(single[1]))
    assert_unwelded_single(got, single)
    assert_unwelded_single(wire, single, wire=True)
    # JAX's shards evaluate their slab from its x coordinates: its threshold
    # is the slab's value at p, as its shard program computes it
    s = p[0] // slab
    rows = np.minimum(s * slab + np.arange(slab + 1), R - 1)
    cx = (2.0 * rows.astype(np.float32) / (R - 1) - 1.0).astype(np.float32)
    jslab = np.asarray(jax.jit(lambda c, x: j_query(c, jw, jspec, x_coords=x))(jnp.asarray(code), jnp.asarray(cx)))
    jthr = float(jslab[p[0] - s * slab, p[1], p[2]])
    ref = jfarm_mod.sharded_extract(j_make_mesh((8,), ("sp",)), jnp.asarray(code), jw, jspec, threshold=jthr)
    assert len(ref[0]) < len(got[0])
    assert_same_mesh(welded, ref)


R_SEAM = 32  # the seam cases' lattice


@pytest.fixture(scope="module")
def seam_density(pair):
    jt, tt, code, jw, tw = pair
    spec = tt.grid_spec(R_SEAM)
    return dg.query_density_grid(torch.from_numpy(code), tw, spec).numpy(), spec


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("form", ["packed", "wire"])
def test_sharded_extract_at_a_zero_on_a_seam_plane(pair, seam_density, sp, form):
    """The level exactly 0 at a lattice point of the last seam plane x =
    (sp - 1) slab with at least two inside neighbours, so cut edges from
    both sides of the seam put coincident vertices on it: the sharded
    extraction over sp CPU shards gives the unwelded single-device K10 mesh
    (vertex count and order, directed edges, positions within one f32 ulp,
    a u16 t step for the wire), where an exact-duplicate weld would lose
    vertices."""
    jt, tt, code, jw, tw = pair
    dens, spec = seam_density
    R, slab = R_SEAM, R_SEAM // sp
    x = (sp - 1) * slab
    steps = [(1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1)]
    denser = [(j, k) for j in range(1, R - 1) for k in range(1, R - 1)
              if sum(dens[x + a, j + b, k + c] > dens[x, j, k] for a, b, c in steps) >= 2
              and (dens[x, j, k] < dens[x - 1, j, k]) and (dens[x, j, k] < dens[x + 1, j, k])]
    j, k = denser[len(denser) // 2]
    thr = float(dens[x, j, k])
    single = mc.marching_cubes_host(dens - thr, device="cpu")
    single = single[0], single[1].astype(np.int64)
    assert len(smoke().merge_exact_duplicates(*single)[0]) < len(single[0])
    fn = farm_mod.sharded_extract if form == "packed" else farm_mod.sharded_extract_wire
    got = fn(make_mesh((sp,), ("sp",), devices=cpus(sp)), torch.from_numpy(code), tw, spec, thr)
    assert_unwelded_single(got, single, wire=form == "wire")


def test_seam_weld_refuses_seams_that_differ():
    """Two shards whose seam rows disagree raise, as does a face on the
    last shard's halo row."""
    R, slab, RXp = 8, 4, 8
    plane, n3 = R * R, RXp * R * R
    v = np.zeros((2, 3), np.float32)
    f = np.zeros((1, 3), np.int64)
    halo = np.array([1 * n3 + 3 * plane + 5, 1 * n3 + slab * plane + 9])
    row0 = np.array([1 * n3 + 10, 1 * n3 + 2 * plane])
    with pytest.raises(RuntimeError, match="different cut edges"):
        farm_mod._seam_weld([(v, f, halo), (v, f, row0)], slab, R, RXp)
    with pytest.raises(RuntimeError, match="halo row"):
        farm_mod._seam_weld([(v, f + 1, halo)], slab, R, RXp)


@pytest.mark.parametrize("limit", [8, 7])
def test_vertex_edges_of_k10_and_the_wire_decoder(slab_level, limit):
    """Each vertex's cut edge: K10's plain version's ascending, the edges
    its positions lie on, zero past the count; the wire decoder's (native
    and numpy) the same edges in its block-major order, with the same
    positions within a u16 t step."""
    from sculptmate_tpu_torch.geometry import mc_wire as twire

    level = torch.from_numpy(slab_level)
    n3, plane = level.numel(), level.shape[1] * level.shape[2]
    mv, mf = 3 * n3 // 4, 3 * n3 // 2
    res = mc.marching_cubes_plain(level, mv, mf, valid_x_limit=limit, return_edges=True)
    without = mc.marching_cubes_plain(level, mv, mf, valid_x_limit=limit)
    assert without.edges is None and torch.equal(res.vx, without.vx)
    nv = int(res.num_verts)
    e = res.edges.numpy()
    assert nv > 100 and (np.diff(e[:nv]) > 0).all() and not e[nv:].any()
    pos = res.verts[:nv].numpy()
    assert smoke().on_their_edges(pos, e[:nv], level.shape)
    assert (e[:nv][e[:nv] < n3] // plane < limit).all()  # x-cut edges: x below the limit
    wire = mc.mc_wire_device_plain(level, mv, valid_x_limit=limit).numpy()
    got = twire.decode_wire(wire, level.shape, mv, has_colors=False, valid_x_limit=limit, return_edges=True)
    occ, lo, hi, *_ = twire.wire_layout(level.shape, mv, 2, has_colors=False)
    zeros = np.zeros(mv, np.uint8)
    numpy = twire._decode_numpy(wire[occ:lo], wire[lo:hi], wire[hi : hi + mv], zeros, zeros, zeros, level.shape,
                                nv, None, limit, return_edges=True)
    assert twire.decode_wire(wire, level.shape, mv, has_colors=False, valid_x_limit=limit).edges is None
    for verts, edges_w in ((got.verts, got.edges), (numpy.verts, numpy.edges)):
        order = np.argsort(edges_w)
        assert np.array_equal(edges_w[order], e[:nv])
        assert np.abs(verts[order] - pos).max() <= 1.0 / 65535


# -- the farms over dp, and tensor parallelism --


@pytest.fixture(scope="module")
def farm_inputs(pair):
    """Eight seeded images, the JAX dp = 8 farm's codes of them and a
    margin-safe threshold over their 16^3 grids."""
    jt, tt, code, jw, tw = pair
    images = np.random.default_rng(3).random((8, 32, 32, 3)).astype(np.float32)
    codes = np.array(jt.scene_codes(jnp.asarray(images)))
    thr = _margin_threshold([np.asarray(j_query(jnp.asarray(c), jw, jt.grid_spec(16))) for c in codes], 0.5, 0.98)
    return images, codes, thr


def test_asset_farm_dp8_packed_matches_jax(pair, farm_inputs):
    """``test_asset_farm_dp8``'s batch on the port's dp = 8 farm against the
    JAX one: every counter and face equal, positions within 1e-4."""
    jt, tt = pair[:2]
    images, _, thr = farm_inputs
    got = AssetFarm(tt, make_mesh((8,), ("dp",), devices=cpus(8))).generate_batch(images, 16, thr, mode="packed")
    ref = jfarm_mod.AssetFarm(jt, j_make_mesh((8,), ("dp",))).generate_batch(jnp.asarray(images), 16, thr,
                                                                           mode="packed")
    assert got.num_verts.shape == (8,) and int(got.num_verts.min()) > 0
    for k in ("num_verts", "num_faces", "fa", "fb", "fc"):
        assert np.array_equal(getattr(got, k).numpy(), np.asarray(getattr(ref, k))), k
    for k in ("vx", "vy", "vz"):
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(ref, k)), rtol=0, atol=1e-4)


def test_asset_farm_wire_matches_packed(pair, farm_inputs):
    """``test_asset_farm_wire_matches_packed`` on the port's dp = 8 farm: per
    asset the wire's counts equal the packed counters, its triangles are the
    packed ones under the vertex bijection, positions within u16 steps."""
    tt = pair[1]
    images, _, thr = farm_inputs
    farm = AssetFarm(tt, make_mesh((8,), ("dp",), devices=cpus(8)))
    packed = farm.generate_batch(images, 16, thr, 3 * 16**3, 6 * 16**3, mode="packed")  # room for every face
    wire = farm.generate_batch(images, 16, thr, has_vertex_color=True)
    scale = 2 * tt.config.radius / 15.0
    assert len(wire) == 8
    for b, (verts, faces, colors) in enumerate(wire):
        nv, nf = int(packed.num_verts[b]), int(packed.num_faces[b])
        assert len(verts) == nv > 0 and len(faces) == nf and colors.shape == (nv, 3)
        pv = packed.verts[b][:nv].numpy() * scale - tt.config.radius
        d = np.linalg.norm(verts[:, None, :] - pv[None, :, :], axis=-1)
        perm = d.argmin(axis=1)
        assert d[np.arange(nv), perm].max() < 2e-4 * scale * 16 and len(np.unique(perm)) == nv
        inv = np.empty(nv, np.int64)
        inv[perm] = np.arange(nv)
        tris = lambda f: sorted(map(tuple, f.tolist()))  # noqa: E731  (the wire's face order is its decoder's)
        assert tris(faces) == tris(inv[packed.faces[b][:nf].numpy().astype(np.int64)])


def test_asset_farm_rgba_chunked_over_dp(pair, farm_inputs):
    """``test_asset_farm_full_pipeline_rgba``: raw RGBA through the dp = 8
    farm in one chunk and through a dp = 2 farm in its default chunks of 2
    (four chunks, each split over dp) give the same meshes, as does the
    one-device farm; a chunk that dp does not divide raises."""
    tt = pair[1]
    thr = farm_inputs[2]
    rng = np.random.default_rng(4)
    rgba = np.zeros((8, 64, 64, 4), np.float32)
    rgba[:, 16:48, 20:44, :3] = rng.random((8, 32, 24, 3))
    rgba[:, 16:48, 20:44, 3] = 1.0
    runs = [AssetFarm(tt, make_mesh((n,), ("dp",), devices=cpus(n))).generate_batch_rgba(rgba, resolution=16,
                                                                                        threshold=thr)
            for n in (8, 2)]
    runs.append(AssetFarm(tt, device="cpu").generate_batch_rgba(rgba, resolution=16, threshold=thr))
    assert all(len(r) == 8 for r in runs) and sum(len(f) for _, f, _ in runs[0]) > 0
    for meshes in runs[1:]:
        for (v, f, _), (v2, f2, _) in zip(runs[0], meshes):
            np.testing.assert_allclose(v, v2, atol=2e-5)
            assert np.array_equal(f, f2)
    with pytest.raises(ValueError, match="dp-divisible"):
        AssetFarm(tt, make_mesh((2,), ("dp",), devices=cpus(2))).generate_batch_rgba(rgba, chunk=3)


def test_tp_backbone_matches_unsharded_and_jax(pair, farm_inputs):
    """The (dp 2, tp 4) farm's codes against the unsharded encode and
    against the JAX package's TP farm, at ``test_tp_backbone_matches_
    unsharded``'s tolerance; heads that tp does not divide raise."""
    jt, tt = pair[:2]
    images = farm_inputs[0][:2]
    farm = AssetFarm(tt, make_mesh((2, 4), ("dp", "tp"), devices=cpus(8)), tp_axis="tp")
    got = torch.cat([c for _, c in farm._encode(images)]).numpy()
    plain = tt.scene_codes(images).numpy()
    np.testing.assert_allclose(got, plain, rtol=2e-4, atol=2e-5)
    jmesh = j_make_mesh((2, 4), ("dp", "tp"))
    jf = jfarm_mod.AssetFarm(jt, jmesh, dp_axis="dp", tp_axis="tp")
    ref = np.asarray(jf._encode(jf.params, jax.device_put(jnp.asarray(images), NamedSharding(jmesh, PartitionSpec("dp")))))
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5)
    odd = AssetFarm(tt, make_mesh((2, 3), ("dp", "tp"), devices=cpus(6)), tp_axis="tp")
    with pytest.raises(ValueError, match="4 attention heads do not split over tp = 3"):
        odd.generate_batch(images, 16, farm_inputs[2])
    with pytest.raises(ValueError, match="tp_axis needs a mesh"):
        AssetFarm(tt, device="cpu", tp_axis="tp")


# -- SF3D --


@pytest.fixture(scope="module")
def sf3d():
    """The tiny SF3D on the CPU in f32, seeded, with nonzero AdaLN
    modulations (zero ones would leave the camera conditioning out)."""
    model = SF3D(SF3DConfig(**SF3D_TINY), seed=2, dtype=torch.float32, device="cpu")
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for layer in model.module.image_tokenizer.model.encoder.layer:
            for mod in (layer.norm1_modulation, layer.norm2_modulation):
                mod.linear2.weight.copy_(0.3 * torch.randn(mod.linear2.weight.shape, generator=g))
    return model


def test_tp_sf3d_encode_matches_unsharded(sf3d):
    """``test_tp_sf3d_encode_matches_unsharded``'s config: the two-stream
    backbone over a tp group of 4 against the unsharded encode, scene and
    direct codes at its tolerance."""
    rgb = torch.from_numpy(np.random.default_rng(6).random((2, 56, 56, 3)).astype(np.float32))
    tp = make_mesh((2, 4), ("dp", "tp"), devices=cpus(8)).groups("dp", "tp")[0]
    for a, b in zip(sf3d.get_scene_codes(rgb), sf3d.get_scene_codes(rgb, tp)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("texture", [True, False])
def test_sf3d_farm_dp8_matches_run_image(sf3d, texture):
    """``SF3DFarm`` over an 8-shard dp mesh against ``run_image`` per
    image, textured and not: the same faces, vertices and UVs, and the
    textured assets' maps and materials."""
    images = np.random.default_rng(8).random((8, 56, 56, 4)).astype(np.float32)
    codes, _ = sf3d.get_scene_codes(sf3d.prepare_image(torch.from_numpy(images[:1]))[1])
    thr = float(torch.exp(sf3d.query_lattice(codes[0])["density"][0] - 1.0).mean())
    farm = SF3DFarm(sf3d, make_mesh((8,), ("dp",), devices=cpus(8)))
    got = farm.generate_batch(images, bake_resolution=32, enable_texture=texture, threshold=thr)
    assert len(got) == 8 and sum(g is not None for g in got) >= 2
    for i, out in enumerate(got):
        ref = sf3d.run_image(images[i : i + 1], bake_resolution=32, enable_texture=texture, threshold=thr,
                             fused=texture)
        if out is None:
            assert ref is None
            continue
        assert np.array_equal(out["faces"], ref["faces"]) and np.abs(out["verts"] - ref["verts"]).max() <= 1e-5
        assert np.abs(out["uvs"] - ref["uvs"]).max() <= 1e-5
        if texture:
            assert abs(out["roughness"] - ref["roughness"]) <= 1e-6
            for key in ("albedo", "bump"):
                assert np.abs(out["textures"][key] - ref["textures"][key]).max() <= 1.5 / 255
        else:
            assert out["texture_pngs"] is None


# -- the kernels on the card at slab shapes (skip without one) --


@pytest.mark.cuda
def test_density_kernel_on_slabs_matches_plain():
    """K2 on (RX, R, R) slabs (129 x 512 x 512, a ragged 33 x 64 x 64)
    against its plain version, on d before the exp within a tenth of its
    spread, as the smoke holds it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tsr = TSR(TSRConfig(), device="cuda")
    w = tsr.decoder_weights()
    g = torch.Generator(device="cuda").manual_seed(0)
    for RX, R in ((129, 512), (33, 64)):
        spec = tsr.grid_spec(R, torch.bfloat16)
        codes = torch.randn(3, 40, 64, 64, device="cuda", generator=g).to(torch.bfloat16)
        A, B, C = dg.first_layer_partials(codes, w, spec, dg.lattice_coords(R, "cuda")[R - RX :])
        launches = dg.density_mlp.launches
        d = dg.density_mlp(A, B, C, w, spec).log()
        assert dg.density_mlp.launches == launches + 1 and d.shape == (RX, R, R)
        ref = dg.density_mlp_plain(A, B, C, w, spec).log()
        assert (d - ref).abs().max() <= 0.1 * (ref - ref.mean()).abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("limit", [-1, 8, 3])
def test_marching_cubes_kernels_at_x_limits_match_plain(limit):
    """K3's wire byte for byte and K10's every field, counter and vertex
    edge equal to their plain versions at an x limit on a padded slab."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(5)
    level = torch.full((16, 40, 48), -1.0)
    level[:9] = torch.from_numpy(rng.standard_normal((9, 40, 48)).astype(np.float32))
    level = level.cuda()
    assert torch.equal(mc.mc_wire_device(level, 1 << 16, valid_x_limit=limit),
                       mc.mc_wire_device_plain(level, 1 << 16, valid_x_limit=limit))
    got = mc.marching_cubes(level, 1 << 16, 1 << 17, valid_x_limit=limit, return_edges=True)
    ref = mc.marching_cubes_plain(level, 1 << 16, 1 << 17, valid_x_limit=limit, return_edges=True)
    for k in mc.MCResult._fields:
        assert torch.equal(getattr(got, k), getattr(ref, k)), k
