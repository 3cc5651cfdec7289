"""Port parity of the packed-extraction slice on the CPU: the plain version
of kernel K10 (face-emitting marching cubes), ``TSR.extract_mesh(mode=
"packed")`` and ``AssetFarm``'s packed mode against the JAX package; and the
command-line and facade options the JAX package has (``--simplify-faces``,
``--bake-resolution``, ``Fast3DGenerator.texture_resolution``)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from PIL import Image

from sculptmate_tpu.geometry.marching_cubes import marching_cubes as j_mc
from sculptmate_tpu.ops.density_grid import mlp_weights_from_params, query_density_grid
from sculptmate_tpu.parallel.farm import AssetFarm as JAssetFarm
from sculptmate_tpu.systems.tsr import TSR as JTSR
from sculptmate_tpu.systems.tsr import TSRConfig as JTSRConfig
from sculptmate_tpu_torch.geometry import marching_cubes as mc
from sculptmate_tpu_torch.parallel.farm import AssetFarm
from sculptmate_tpu_torch.runtime.capacity_cache import Capacities
from sculptmate_tpu_torch.runtime.checkpoint import tsr_params_from_jax
from sculptmate_tpu_torch.systems.tsr import TSR, TSRConfig

from mesh_match import assert_same_mesh, wire_to_packed

SMALL = dict(
    cond_image_size=64, plane_size=8, num_channels=64, num_attention_heads=4,
    attention_head_dim=16, num_layers=2, cross_attention_dim=64, vit_hidden_size=64,
    vit_num_layers=2, vit_num_heads=4, vit_intermediate_size=128,
)
FIELDS = ("vx", "vy", "vz", "fa", "fb", "fc")
COUNTERS = ("num_verts", "num_faces", "num_active_blocks", "num_active_cells")


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


def _noise(rng):
    return rng.standard_normal((16, 24, 32)).astype(np.float32)  # ragged: a rectangular lattice


def _jax_mc(level, mv, mf, dense):
    res = jax.jit(j_mc, static_argnums=(1, 2, 3, 4))(jnp.asarray(level), mv, mf, 0, dense)
    return {k: np.asarray(v) for k, v in res._asdict().items()}


@pytest.mark.parametrize("field", [_sphere, _torus, _noise])
def test_marching_cubes_plain_matches_jax(rng, field):
    """K10's plain version against JAX ``marching_cubes`` with room for
    everything: the same vertices in the same order within 1e-6, faces equal
    array for array to ``dense=False`` and as a multiset of triangles to
    ``dense=True``, and all four counters equal."""
    level = field(rng)
    mv, mf = 3 * level.size, 6 * level.size
    got = mc.marching_cubes_plain(torch.from_numpy(level), mv, mf)
    ref = _jax_mc(level, mv, mf, False)
    for k in COUNTERS:
        assert int(getattr(got, k)) == int(ref[k]), k
    nv, nf = int(ref["num_verts"]), int(ref["num_faces"])
    assert nv > 0 and nf > 0
    for k in ("vx", "vy", "vz"):
        np.testing.assert_allclose(getattr(got, k).numpy(), ref[k], rtol=0, atol=1e-6)
    for k in ("fa", "fb", "fc"):
        assert getattr(got, k).dtype == torch.int32 and np.array_equal(getattr(got, k).numpy(), ref[k]), k
    dense = _jax_mc(level, mv, mf, True)
    tris = lambda f: sorted(map(tuple, f[:nf].tolist()))  # noqa: E731
    assert tris(got.faces.numpy()) == tris(np.stack([dense["fa"], dense["fb"], dense["fc"]], -1))


def test_marching_cubes_undersized_capacities(rng):
    """Capacities below the counts: exact counters, the leading rows of the
    full result, zeros nowhere else than past the counts."""
    level = _torus(rng)
    full = mc.marching_cubes_plain(torch.from_numpy(level), 3 * level.size, 6 * level.size)
    nv, nf = int(full.num_verts), int(full.num_faces)
    mv, mf = nv // 3, nf // 2
    small = mc.marching_cubes_plain(torch.from_numpy(level), mv, mf)
    assert [int(getattr(small, k)) for k in COUNTERS] == [int(getattr(full, k)) for k in COUNTERS]
    for k in FIELDS:
        n = mv if k.startswith("v") else mf
        assert getattr(small, k).shape == (n,) and torch.equal(getattr(small, k), getattr(full, k)[:n]), k
    ref = _jax_mc(level, 3 * level.size, 6 * level.size, False)
    assert np.array_equal(small.fa.numpy(), ref["fa"][:mf])


def _margin_threshold(*densities):
    """A threshold at least 1e-3 from every lattice value (so occupancy
    cannot flip between the two implementations), with 50-98 % of the
    points below it."""
    d = np.sort(np.concatenate([x.ravel() for x in densities]))
    gaps = np.diff(d)
    idx = [i for i in np.nonzero(gaps >= 2e-3)[0] if 0.5 * d.size <= i <= 0.98 * d.size]
    assert idx, "no threshold with a 1e-3 margin"
    return float(d[idx[0]] + d[idx[0] + 1]) / 2


@pytest.fixture(scope="module")
def packed_pair():
    """JAX and port TSRs with the same narrow weights (the density output
    channel scaled up, so the random-weight field leaves gaps for a
    margin-safe threshold), and the JAX codes of one seeded image."""
    base = JTSR(JTSRConfig(**SMALL), dtype=jnp.float32)
    params = jax.tree.map(np.array, base.params)
    params["decoder"]["layers"]["dense_out"]["kernel"][:, 0] *= 1000.0
    jt = JTSR(JTSRConfig(**SMALL), params=params, dtype=jnp.float32)
    tt = TSR(TSRConfig(**SMALL), state_dict=tsr_params_from_jax(params), dtype=torch.float32, device="cpu")
    img = np.random.default_rng(42).random((1, 64, 64, 3)).astype(np.float32)
    return jt, tt, np.array(jt.scene_codes(jnp.asarray(img)))


@pytest.fixture
def cap_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("SCULPTMATE_CAP_CACHE", str(tmp_path))
    return tmp_path


def _threshold(jt, codes, resolution):
    w = mlp_weights_from_params(jt.params["decoder"]["layers"])
    return _margin_threshold(np.asarray(query_density_grid(jnp.asarray(codes[0]), w, jt.grid_spec(resolution))))


@pytest.mark.parametrize("resolution", [16, 32])
def test_extract_mesh_packed_matches_jax(cap_dir, packed_pair, resolution):
    """``extract_mesh(mode="packed", has_vertex_color=True)`` from the same
    codes, f32: vertices in the same order within 1e-4, exact-f32 colors
    within 1e-5, and the same triangles as the JAX package's packed mode.
    The triangles are compared as a multiset: on a lattice this small more
    than 3/5 of the blocks are active, and the JAX package then switches to
    its ``dense`` compaction, which orders faces by flat cell."""
    jt, tt, codes = packed_pair
    thr = _threshold(jt, codes, resolution)
    vr, fr, cr = jt.extract_mesh(jnp.asarray(codes), has_vertex_color=True, resolution=resolution, threshold=thr,
                                 mode="packed")[0]
    vg, fg, cg = tt.extract_mesh(torch.from_numpy(codes), has_vertex_color=True, resolution=resolution, threshold=thr,
                                 mode="packed")[0]
    assert len(vr) > 0 and vg.shape == vr.shape and vg.dtype == np.float32
    assert fg.dtype == np.int64 and fg.shape == fr.shape
    assert sorted(map(tuple, fg.tolist())) == sorted(map(tuple, fr.tolist()))
    np.testing.assert_allclose(vg, vr, rtol=0, atol=1e-4)
    assert cg.dtype == np.float32 and cg.shape == vg.shape
    np.testing.assert_allclose(cg, cr, rtol=0, atol=1e-5)


def test_packed_capacity_retry_and_wire_refusal(cap_dir, packed_pair, monkeypatch):
    """Capacities far below the counts are grown and the asset extracted
    again, never truncated: the same mesh as the default run, and the grown
    capacities remembered; the extraction again runs inside one
    ``tsr.capacity_retry`` span, the default run inside none. In wire mode
    ``max_faces`` raises."""
    jt, tt, codes = packed_pair
    code = torch.from_numpy(codes)
    thr = _threshold(jt, codes, 16)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as p0:
        v0, f0, c0 = tt.extract_mesh(code, has_vertex_color=True, resolution=16, threshold=thr, mode="packed")[0]
    assert len(v0) > 64 and len(f0) > 64
    # a policy with nothing kept, in an empty store: what is kept next is the retry's
    p = tt.packed_capacities
    monkeypatch.setattr(tt, "packed_capacities", Capacities(p.name, p.default, p.at_least_default))
    monkeypatch.setenv("SCULPTMATE_CAP_CACHE", str(cap_dir / "retry"))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as p1:
        v1, f1, c1 = tt.extract_mesh(code, has_vertex_color=True, resolution=16, threshold=thr, max_verts=64,
                                     max_faces=64, mode="packed")[0]
    retries = [sum(e.name == "tsr.capacity_retry" for e in p.events()) for p in (p0, p1)]
    assert retries == [0, 1]
    assert np.array_equal(v0, v1) and np.array_equal(f0, f1) and np.array_equal(c0, c1)
    mv, mf = tt.packed_capacities.kept(16)
    assert mv >= len(v0) and mf >= len(f0)
    assert (mv, mf) == (65536, 65536)  # 64 grown to one bucket each, then tightened
    with pytest.raises(ValueError, match="max_faces"):
        tt.extract_mesh(code, resolution=16, threshold=thr, max_faces=10)
    with pytest.raises(ValueError, match="mode"):
        tt.extract_mesh(code, resolution=16, threshold=thr, mode="dense")


def test_packed_handles_match_the_wire(cap_dir, packed_pair):
    """``extract_mesh(mode="packed")``, through the handles, against
    ``mode="wire"`` on the same codes at R = 16 with colors: the same
    vertices by cut edge, the same triangles, positions within one u16 step
    and colors within half a u8 step, in arrays that own their memory, and
    the stages in the spans the benchmark reads; capacities far below the
    counts give the same mesh after exactly one ``tsr.capacity_retry``."""
    from sculptmate_tpu_torch.ops.density_grid import query_density_grid as t_query

    jt, tt, codes = packed_pair
    code = torch.from_numpy(codes)
    thr = _threshold(jt, codes, 16)
    kw = dict(has_vertex_color=True, resolution=16, threshold=thr)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as p0:
        packed = tt.extract_mesh(code, mode="packed", **kw)[0]
    wire = tt.extract_mesh(code, mode="wire", **kw)[0]
    level = t_query(code[0], tt.decoder_weights(), tt.grid_spec(16, tt.extract_dtype)) - thr
    assert_same_mesh(packed, wire, wire_to_packed(level), 2 * tt.config.radius / 15)
    assert all(a.flags.owndata for a in packed)
    assert {e.key for e in p0.key_averages() if e.key.startswith("tsr.")} == {
        "tsr.density_grid", "tsr.marching_cubes", "tsr.color_query", "tsr.counts_to_host", "tsr.wire_decode",
        "tsr.wire_faces", "tsr.colors_to_host"}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as p1:
        retried = tt.extract_mesh(code, max_verts=64, max_faces=64, mode="packed", **kw)[0]
    assert sum(e.name == "tsr.capacity_retry" for e in p1.events()) == 1
    assert all(np.array_equal(a, b) for a, b in zip(packed, retried))


def test_farm_packed_matches_jax(packed_pair):
    """``AssetFarm.generate_batch(mode="packed")`` on 2 cond images at R = 16
    against the JAX farm's: one batched MCResult, (B, mv) and (B, mf)
    fields, faces equal, lattice positions within 1e-3 (1.2e-4 in world
    units at R = 16), counters equal."""
    jt, tt, _ = packed_pair
    images = np.random.default_rng(7).random((2, 64, 64, 3)).astype(np.float32)
    jfarm = JAssetFarm(jt, Mesh(np.array(jax.devices()[:1]), ("dp",)))
    codes = np.asarray(jt.scene_codes(jnp.asarray(images)))
    w = mlp_weights_from_params(jt.params["decoder"]["layers"])
    thr = _margin_threshold(*(np.asarray(query_density_grid(jnp.asarray(c), w, jt.grid_spec(16))) for c in codes))
    ref = jfarm.generate_batch(jnp.asarray(images), resolution=16, threshold=thr, mode="packed")
    got = AssetFarm(tt, device="cpu").generate_batch(images, resolution=16, threshold=thr, mode="packed")
    assert isinstance(got, mc.MCResult)
    assert got.vx.shape == (2, 8 * 16 * 16) and got.fa.shape == (2, 16 * 16 * 16) and got.num_verts.shape == (2,)
    for k in COUNTERS:
        assert np.array_equal(getattr(got, k).numpy(), np.asarray(getattr(ref, k))), k
    assert int(got.num_verts.min()) > 0
    for k in ("fa", "fb", "fc"):
        assert np.array_equal(getattr(got, k).numpy(), np.asarray(getattr(ref, k))), k
    for k in ("vx", "vy", "vz"):
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(ref, k)), rtol=0, atol=1e-3)


# -- the options the JAX package's command line and facade have --


def test_cli_simplify_faces(tmp_path, monkeypatch, capsys, packed_pair):
    """``generate --simplify-faces N`` decimates the Lean mesh to about N
    faces and drops its colors, as the JAX CLI does."""
    from sculptmate_tpu_torch import cli
    from sculptmate_tpu_torch.ops.density_grid import query_density_grid as t_query

    _, tt, _ = packed_pair
    monkeypatch.setattr(cli, "TSR", lambda seed, device: tt)
    png = tmp_path / "in.png"
    Image.fromarray(np.random.default_rng(3).integers(0, 255, (64, 64, 3), dtype=np.uint8)).save(png)
    codes = tt.scene_codes(np.asarray(Image.open(png), np.float32)[None] / 255.0)
    thr = float(t_query(codes[0], tt.decoder_weights(), tt.grid_spec(16)).median())
    args = ["generate", str(png), "--device", "cpu", "--resolution", "16", "--threshold", str(thr), "--texture",
            "--no-remove-bg"]
    assert cli.main(args + ["-o", str(tmp_path / "full.obj")]) == 0
    full = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["faces"]
    target = full // 4
    assert cli.main(args + ["-o", str(tmp_path / "small.obj"), "--simplify-faces", str(target)]) == 0
    faces = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["faces"]
    assert faces < full // 2 and abs(faces - target) <= 0.25 * target
    vlines = [ln.split() for ln in (tmp_path / "small.obj").read_text().splitlines() if ln.startswith("v ")]
    assert vlines and all(len(v) == 4 for v in vlines)  # no vertex colors
    assert len((tmp_path / "full.obj").read_text().splitlines()[1].split()) == 7  # colors without the option


class _RecordingSF3D:
    """Stands in for SF3D: records run_image's keyword arguments and
    returns no mesh."""

    calls = []

    def __init__(self, *args, **kwargs):
        pass

    def run_image(self, image, **kwargs):
        _RecordingSF3D.calls.append(kwargs)
        return None


def test_cli_bake_resolution_reaches_run_image(tmp_path, monkeypatch):
    from sculptmate_tpu_torch import cli

    monkeypatch.setattr(cli, "SF3D", _RecordingSF3D)
    _RecordingSF3D.calls.clear()
    png = tmp_path / "in.png"
    Image.fromarray(np.zeros((32, 32, 4), np.uint8)).save(png)
    rc = cli.main(["generate", str(png), "--model", "fast", "--texture", "--no-remove-bg", "--device", "cpu",
                   "--bake-resolution", "256"])
    assert rc == 2 and _RecordingSF3D.calls[-1]["bake_resolution"] == 256
    cli.main(["generate", str(png), "--model", "fast", "--no-remove-bg", "--device", "cpu"])
    assert _RecordingSF3D.calls[-1]["bake_resolution"] == 512


def test_fast3d_generator_bakes_at_its_texture_resolution():
    from sculptmate_tpu_torch.pipelines.generate import Fast3DGenerator

    gen = Fast3DGenerator()
    assert gen.texture_resolution == 512
    gen.model = _RecordingSF3D()
    _RecordingSF3D.calls.clear()
    assert gen.generate_mesh(np.zeros((32, 32, 4), np.float32)) == 2
    gen.texture_resolution = 128
    gen.generate_mesh(np.zeros((32, 32, 4), np.float32))
    assert [c["bake_resolution"] for c in _RecordingSF3D.calls] == [512, 128]


@pytest.mark.parametrize("shape", [(256, 256, 256), (72, 80, 96), (64, 72, 80), (8, 8, 8)])
def test_k3_scratch_sizes(shape):
    """K3's scratch, sized on the host: three 512-bit cut masks (16 words
    each) and three counts and bases per 8^3 block, and one scan status
    word per 2048 of the 3 NB counts, after the 2 counters, the tile counter
    and a pad word (so the status words are 8-byte aligned)."""
    RX, RY, RZ = shape
    NB = RX * RY * RZ // 512
    size = mc.k3_scratch(RX, RY, RZ)
    assert size["masks"] == 48 * NB and size["vcnt"] == size["vbase"] == 3 * NB
    assert size["status_tiles"] == -(-3 * NB // 2048) and size["zeroed"] == 4 + 2 * size["status_tiles"]
    if shape == (256, 256, 256):
        assert size["status_tiles"] == 48  # the Lean asset's level: 98 304 counts
    if shape == (72, 80, 96):
        assert size["status_tiles"] == 2 and 3 * NB % 2048  # a whole tile and a partial one


@pytest.mark.parametrize("shape", [(256, 256, 256), (64, 72, 80), (8, 8, 8)])
def test_k10_scratch_sizes(shape):
    """K10's scratch, sized on the host: a cut word per 32 z points of each
    (axis, x, y) row (the last word partly padding where RZ is not a
    multiple of 32), a case byte per cell, five counts and a face base per
    8^3 block, and one scan status word per 2048 counts of each of the
    scan's four arrays (cut words, face counts, active cells, axis flags),
    after the 4 counters, the tile counter and 3 pad words."""
    RX, RY, RZ = shape
    nwords = {256: 8, 80: 3, 8: 1}[RZ]
    NB = RX * RY * RZ // 512
    size = mc.k10_scratch(RX, RY, RZ)
    words = 3 * RX * RY * nwords
    assert size["cutbits"] == size["word_base"] == words and size["cases"] == RX * RY * RZ
    assert size["blocks"] == 5 * NB and size["fbase"] == NB
    tiles = [-(-n // 2048) for n in (words, NB, NB, 3 * NB)]
    assert size["status_tiles"] == sum(tiles) and size["zeroed"] == 8 + 2 * sum(tiles)
    if shape == (256, 256, 256):
        assert tiles == [768, 16, 16, 48]  # the Lean asset's level: 848 tiles in one launch


# -- the kernels on the card against their plain versions --


def _card_levels():
    rng = np.random.default_rng(5)
    yield torch.from_numpy(rng.standard_normal((16, 24, 40)).astype(np.float32)).cuda()
    yield torch.from_numpy(_torus(rng, 32)).cuda()
    # 3 NB = 3 240 block counts: one whole tile of the multi-block scan and a partial one
    coarse = torch.from_numpy(rng.standard_normal((1, 1, 9, 10, 11)).astype(np.float32))
    yield torch.nn.functional.interpolate(coarse, size=(72, 80, 96), mode="trilinear")[0, 0].contiguous().cuda()


@pytest.mark.cuda
def test_mc_wire_kernel_matches_plain():
    """K3 on the card: the wire byte for byte and the vertex positions bit
    for bit as its plain version gives them, with room and overflowing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for level in _card_levels():
        for mv in (3 * level.numel(), 100):
            rec = {}

            def colors(tag):
                def fn(vx, vy, vz):
                    rec[tag] = torch.stack([vx, vy, vz])
                    return vx * 0, vy * 0, vz * 0
                return fn

            launches = mc.mc_wire_device.launches
            wire, _ = mc.mc_wire_device(level, mv, colors("kernel"))
            assert mc.mc_wire_device.launches == launches + 1
            ref, _ = mc.mc_wire_device_plain(level, mv, colors("plain"))
            assert torch.equal(wire, ref) and torch.equal(rec["kernel"], rec["plain"])


@pytest.mark.cuda
def test_marching_cubes_kernel_matches_plain():
    """K10 on the card: every field and counter equal to its plain
    version's, with room and with undersized capacities."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for level in _card_levels():
        for mv, mf in ((3 * level.numel(), 6 * level.numel()), (100, 150)):
            got = mc.marching_cubes(level, mv, mf)
            ref = mc.marching_cubes_plain(level, mv, mf)
            for k in FIELDS + COUNTERS:
                assert torch.equal(getattr(got, k), getattr(ref, k)), k
