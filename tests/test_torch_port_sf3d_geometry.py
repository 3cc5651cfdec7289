"""Port parity for SF3D's extraction: the multi-head lattice query (the
plain version of kernel K5), the marching-tets wire, its decode and weld,
the quadric decimation and the host UV unwrap, each held against its
``sculptmate_tpu`` counterpart on the same inputs (numpy seeds; scene codes
from one tiny JAX SF3D). Kernel K5 itself runs only on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sculptmate_tpu.geometry import mt_wire as j_mt_wire
from sculptmate_tpu.geometry.decimate import decimate as j_decimate
from sculptmate_tpu.geometry.decimate import vertex_normals as j_vertex_normals
from sculptmate_tpu.geometry.marching_tets import mt_wire_device as j_mt_wire_device
from sculptmate_tpu.geometry.mesh import Mesh as JMesh
from sculptmate_tpu.ops import density_grid as jdg
from sculptmate_tpu.systems.sf3d import SF3D as JSF3D
from sculptmate_tpu.systems.sf3d import SF3DConfig as JSF3DConfig
from sculptmate_tpu_torch.geometry import mt_wire
from sculptmate_tpu_torch.geometry.decimate import decimate, vertex_normals
from sculptmate_tpu_torch.geometry.marching_tets import lattice_size, mt_wire_device
from sculptmate_tpu_torch.geometry.mesh import Mesh
from sculptmate_tpu_torch.ops import density_grid as dg

RES = 14  # tet lattice of 15^3 points (padded to 16^3)
TINY = dict(
    cond_image_size=56, isosurface_resolution=RES, plane_size=8, num_channels=64, num_attention_heads=4,
    attention_head_dim=16, num_latents=32, num_blocks=1, num_basic_blocks=1, upsample_scale_factor=2,
    upsample_conv_layers=2, dinov2_hidden_size=64, dinov2_num_layers=2, dinov2_num_heads=4,
    dinov2_intermediate_size=128, clip_width=64, clip_layers=2, clip_heads=4,
)


@pytest.fixture(scope="module")
def jax_sf3d():
    return JSF3D(JSF3DConfig(**TINY), dtype=jnp.float32)


@pytest.fixture(scope="module")
def scene(jax_sf3d):
    """Scene codes of a random RGBA image, the density+offset heads, and
    the threshold at the mean density."""
    img = np.random.default_rng(7).random((1, 56, 56, 4)).astype(np.float32)
    codes, _ = jax_sf3d.get_scene_codes(jax_sf3d.prepare_image(jnp.asarray(img))[1])
    heads = jax_sf3d._head_weights(["density", "vertex_offset"])
    grids = jdg.query_grid_multihead(codes[0], heads, jdg.lattice_coords_tets(RES), jax_sf3d.grid_spec(slab=1))
    thr = float(np.exp(np.asarray(grids["density"][0]) - 1.0).mean())
    return np.array(codes[0]), jax.tree.map(np.array, heads), thr


def _torch_heads(heads):
    return {n: [(torch.from_numpy(np.array(w)), torch.from_numpy(np.array(b))) for w, b in ws] for n, ws in heads.items()}


def test_lattice_matches_jax():
    from sculptmate_tpu.geometry.marching_tets import lattice_size as j_lattice_size

    assert lattice_size(160) == j_lattice_size(160) == 161
    np.testing.assert_array_equal(dg.lattice_coords_tets(160).numpy(), np.asarray(jdg.lattice_coords_tets(160)))


@pytest.mark.parametrize("res,slab", [(RES, 5), (8, 1)])
def test_query_grid_multihead_matches_jax(scene, res, slab):
    """The plain version of K5 (heads one after another, z-slabs of any
    size) against the JAX package's packed two-head query, f32: every
    output channel within 1e-5 of max |ref|, x-major."""
    code, heads, _ = scene
    spec = dg.DensityGridSpec(resolution=res + 1, align_corners=True, slab=slab)
    got = dg.query_grid_multihead(torch.from_numpy(code), _torch_heads(heads), dg.lattice_coords_tets(res), spec)
    jspec = jdg.DensityGridSpec(resolution=res + 1, align_corners=True, slab=res + 1 if (res + 1) % 2 else 1)
    ref = jdg.query_grid_multihead(jnp.asarray(code), heads, jdg.lattice_coords_tets(res), jspec)
    assert list(got) == list(ref) == ["density", "vertex_offset"]
    for name in ref:
        assert got[name].shape == (len(ref[name]), res + 1, res + 1, res + 1)
        for k, r in enumerate(ref[name]):
            r = np.asarray(r)
            err = np.abs(got[name][k].numpy().reshape(-1) - r).max()
            assert err <= 1e-5 * np.abs(r).max(), (name, k, err)


def test_multihead_weights_pack_for_the_kernel():
    """K5's weight rows, un-swizzled, are each head's hidden matrix halved
    (out, in) and the two 8-row output tiles holding the heads' channels at
    their place in the concatenated output; the biases likewise."""
    rng = np.random.default_rng(3)

    def lin(i, o):
        return (torch.from_numpy(rng.standard_normal((i, o)).astype(np.float32)),
                torch.from_numpy(rng.standard_normal(o).astype(np.float32)))

    heads = [[lin(120, 64), lin(64, 64), lin(64, 1)], [lin(120, 64), lin(64, 64), lin(64, 3)]]
    W, b = dg.pack_multihead_weights(heads, "cpu")
    rows = dg.swizzle_128b(W).float()  # the swizzle is its own inverse
    bf = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
    assert rows.shape == (144, 64) and b.shape == (136,)
    assert torch.equal(rows[:64], 0.5 * bf(heads[0][1][0].t())) and torch.equal(rows[64:128], 0.5 * bf(heads[1][1][0].t()))
    assert torch.equal(rows[128], bf(heads[0][2][0][:, 0])) and not rows[129:137].any()
    assert torch.equal(rows[137:140], bf(heads[1][2][0].t())) and not rows[136].any() and not rows[140:].any()
    assert torch.equal(b[:64], 0.5 * bf(heads[0][1][1])) and torch.equal(b[64:128], 0.5 * bf(heads[1][1][1]))
    assert torch.equal(b[128:132], bf(torch.cat([heads[0][2][1], heads[1][2][1]]))) and not b[132:].any()


def test_sf3d_packs_k5_weights_once():
    """``SF3D._k5_weights_packed``: the density and vertex-offset heads
    packed as ``pack_multihead_weights`` packs them, once; a second
    ``query_lattice`` on the same model hands out the same tensors, and an
    in-place update of a head parameter packs them anew."""
    from sculptmate_tpu_torch.systems.sf3d import SF3D, SF3DConfig

    sf = SF3D(SF3DConfig(**TINY), dtype=torch.float32, device="cpu")
    want_W, want_b = dg.pack_multihead_weights(list(sf.lattice_head_weights().values()), "cpu")
    W, b = sf._k5_weights_packed(torch.device("cpu"))
    assert torch.equal(W, want_W) and torch.equal(b, want_b)
    code = torch.from_numpy(np.random.default_rng(5).standard_normal((3, 40, 8, 8)).astype(np.float32))
    first = sf.query_lattice(code)
    W2, b2 = sf._k5_weights_packed(torch.device("cpu"))
    assert W2 is W and b2 is b
    again = sf.query_lattice(code)
    assert sf._k5_weights[1][0] is W and all(torch.equal(first[n], again[n]) for n in first)
    with torch.no_grad():
        sf.module.decoder.heads["vertex_offset"][-1].bias.add_(1.0)
    sf.query_lattice(code)
    W3, b3 = sf._k5_weights[1]
    want_W, want_b = dg.pack_multihead_weights(list(sf.lattice_head_weights().values()), "cpu")
    assert torch.equal(W3, want_W) and torch.equal(b3, want_b) and not torch.equal(b3, b)


def test_sf3d_packs_k6_weights_once():
    """``SF3D._k6_weights_packed``: the features and perturb-normal heads
    packed as ``pack_points_weights`` packs them, once; a second call hands
    out the same tensors, and an in-place update of a head parameter packs
    them anew."""
    from sculptmate_tpu_torch.systems.sf3d import SF3D, SF3DConfig

    sf = SF3D(SF3DConfig(**TINY), dtype=torch.float32, device="cpu")
    want_W, want_b = dg.pack_points_weights(list(sf.texel_head_weights().values()), "cpu")
    W, b = sf._k6_weights_packed(torch.device("cpu"))
    assert torch.equal(W, want_W) and torch.equal(b, want_b)
    W2, b2 = sf._k6_weights_packed(torch.device("cpu"))
    assert W2 is W and b2 is b
    with torch.no_grad():
        sf.module.decoder.heads["perturb_normal"][-1].bias.add_(1.0)
    W3, b3 = sf._k6_weights_packed(torch.device("cpu"))
    want_W, want_b = dg.pack_points_weights(list(sf.texel_head_weights().values()), "cpu")
    assert torch.equal(W3, want_W) and torch.equal(b3, want_b) and not torch.equal(b3, b)


def test_k7_scratch_spans_the_scan_tiles():
    """K7's scratch: seven 512-bit masks and seven counts per 8^3 block of
    the padded lattice, and one status word per 2 048-count tile of the
    scan (161^3: 21^3 blocks, 32 tiles; 101^3: 13^3 blocks, 8 tiles, the
    last partial)."""
    from sculptmate_tpu_torch.geometry.marching_tets import k7_scratch

    for N, nb, tiles in ((161, 21, 32), (101, 13, 8), (38, 5, 1)):
        size = k7_scratch(N)
        assert size["masks"] == 7 * 16 * nb**3 and size["vcnt"] == size["vbase"] == 7 * nb**3
        assert size["status_tiles"] == tiles and size["zeroed"] == 4 + 2 * tiles
        assert (tiles - 1) * 2048 < 7 * nb**3 <= tiles * 2048


@pytest.mark.cuda
@pytest.mark.parametrize("R", [33, 65])
def test_grid_multihead_kernel_matches_plain(R):
    """K5 on the card against its plain version on the same bf16 partials,
    at ragged lattices (R = 33; R = 65, whose last tile of each (i, j) row
    holds one point), with nonzero biases in every layer, the weights
    packed by the caller and inside the call: each channel within 0.1 of
    its spread."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(0)

    def lin(i, o):
        return (torch.randn(i, o, device="cuda", generator=g) * i**-0.5,
                0.5 * torch.randn(o, device="cuda", generator=g))

    heads = [[lin(120, 64), lin(64, 64), lin(64, 1)], [lin(120, 64), lin(64, 64), lin(64, 3)]]
    spec = dg.DensityGridSpec(resolution=R, align_corners=True, slab=3, compute_dtype=torch.bfloat16)
    codes = torch.randn(3, 40, 64, 64, device="cuda", generator=g).to(torch.bfloat16)
    A, B, C = dg.multihead_partials(codes, heads, dg.lattice_coords_tets(R - 1, "cuda"), spec)
    out = dg.grid_multihead(A, B, C, heads, spec)
    ref = dg.grid_multihead_plain(A, B, C, heads, spec)
    for k in range(4):
        spread = (ref[k] - ref[k].mean()).abs().max()
        assert (out[k] - ref[k]).abs().max() <= 0.1 * spread
    packed = dg.pack_multihead_weights(heads, "cuda")
    assert torch.equal(dg.grid_multihead(A, B, C, heads, spec, packed=packed), out)


def _ragged_border_lattice(res: int):
    """A smooth (res+1)^3 field (res + 1 not a multiple of 8) whose sdf is
    positive on all six faces of the lattice, so cut edges would reach past
    the last real point without the domain mask; offsets N(0, 1)."""
    rng = np.random.default_rng(11)
    N = res + 1
    x = np.linspace(-1, 1, N, dtype=np.float32)
    g = np.stack(np.meshgrid(x, x, x, indexing="ij"))
    sdf = np.sin(3 * g[0]) * np.cos(2 * g[1]) + 0.5 * g[2] + 0.1 * rng.standard_normal((N, N, N))
    border = np.zeros((N, N, N), bool)
    for a in range(3):
        border[(slice(None),) * a + (0,)] = border[(slice(None),) * a + (-1,)] = True
    sdf = np.where(border, np.abs(sdf) + 0.1, sdf).astype(np.float32)
    return sdf, [rng.standard_normal((N, N, N)).astype(np.float32) for _ in range(3)]


def _mt_case(scene, case):
    """(sdf, offsets, res, max_verts, snap_eps) of a wire case: the tiny
    scene's lattice at snap 0 and 0.2, the ragged 38^3 lattice with a
    surface on its border, and the scene at a third of its vertex count."""
    if case == "ragged border, res 37":
        sdf, offs = _ragged_border_lattice(37)
        return sdf.reshape(-1), [o.reshape(-1) for o in offs], 37, 1 << 17, 0.2
    code, heads, thr = scene
    grids = jdg.query_grid_multihead(jnp.asarray(code), heads, jdg.lattice_coords_tets(RES),
                                     jdg.DensityGridSpec(resolution=RES + 1, align_corners=True, slab=1))
    sdf = np.exp(np.asarray(grids["density"][0]) - 1.0) - thr
    offs = [np.asarray(o) for o in grids["vertex_offset"]]
    return sdf, offs, RES, {"undersized capacity": 1000}.get(case, 16384), 0.0 if case == "snap 0" else 0.2


@pytest.mark.parametrize("case", ["snap 0", "snap 0.2", "ragged border, res 37", "undersized capacity"])
def test_mt_wire_matches_jax(scene, case):
    """The same sdf and offsets through both wires (the port's plain
    version of K7): identical occupancy bytes and exact counts, every
    position slot within one u16 step (the JAX program contracts
    multiply-adds; tanh may differ by an ulp). Undersized, both keep the
    first ``max_verts`` ids and report the full count."""
    sdf, offs, res, mv, snap_eps = _mt_case(scene, case)
    ref = np.asarray(jax.jit(j_mt_wire_device, static_argnums=(4, 5))(
        jnp.asarray(sdf), *map(jnp.asarray, offs), res, mv, snap_eps=snap_eps))
    got = mt_wire_device(torch.from_numpy(sdf), *map(torch.from_numpy, offs), res, mv, snap_eps=snap_eps).numpy()
    assert got.shape == ref.shape and got.dtype == np.uint8
    lay = j_mt_wire.wire_layout(res, mv, j_mt_wire.N_WIRE_COUNTS)
    assert np.array_equal(got[: lay[1]], ref[: lay[1]])
    counts = j_mt_wire.wire_counts(ref, 2)
    assert np.array_equal(mt_wire.wire_counts(got, 2), counts) and counts[0] > 0
    assert (counts[0] > mv) == (case == "undersized capacity")
    for s in range(3):
        lo, hi = lay[1 + 2 * s], lay[2 + 2 * s]
        q = lambda w: w[lo:hi].astype(np.int32) | (w[hi : hi + mv].astype(np.int32) << 8)  # noqa: E731
        assert np.abs(q(got) - q(ref)).max() <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["snap 0.2", "ragged border, res 37", "undersized capacity", "multi-tile res 100"])
def test_mt_wire_kernel_matches_plain(case):
    """K7 on the card against its plain version on the same inputs: the
    wire byte for byte (bits, positions, counters). At res 100 the 7 NB =
    15 379 block counts fill 7 of the scan's 2 048-count tiles and end in
    a partial eighth."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from sculptmate_tpu_torch.geometry.marching_tets import mt_wire_device_plain

    rng = np.random.default_rng(2)
    res = {"ragged border, res 37": 37, "multi-tile res 100": 100}.get(case, 40)
    if case.startswith("ragged"):
        sdf, offs = _ragged_border_lattice(res)
    else:
        sdf = rng.standard_normal((res + 1,) * 3).astype(np.float32)
        offs = [rng.standard_normal((res + 1,) * 3).astype(np.float32) for _ in range(3)]
    mv = {"undersized capacity": 1000, "multi-tile res 100": 1 << 22}.get(case, 1 << 18)
    args = [torch.from_numpy(a).cuda() for a in (sdf, *offs)]
    got = mt_wire_device(*args, res, mv, 0.2)
    ref = mt_wire_device_plain(*args, res, mv, 0.2)
    assert torch.equal(got, ref)


@pytest.fixture(scope="module")
def decoded(jax_sf3d, scene):
    """The JAX package's wire of the tiny scene, decoded by both decoders
    with the weld."""
    code, _, thr = scene
    mv = 16384
    wire = np.asarray(jax_sf3d._extract_wire_jit(jnp.asarray(code), thr, mv, 0, 0.2))
    return wire, mv, mt_wire.decode_wire(wire, RES, mv, weld=True), j_mt_wire.decode_wire(wire, RES, mv, weld=True)


def test_wire_decode_matches_jax(decoded):
    _, _, got, ref = decoded
    for a, b in zip(got, ref):
        assert np.array_equal(a, b)
    assert len(got[1]) > 0


def _same_flags_decimator(tmp_path):
    """The port's decimator source built with the flags of the JAX
    package's loader (``-march=native``, which lets g++ contract
    multiply-adds into FMAs); the port builds it portable."""
    import ctypes
    import subprocess

    from sculptmate_tpu_torch.geometry import native

    out = tmp_path / "libquadric_decimate_native.so"
    subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-pthread", "-march=native", "-funroll-loops",
                    f"{native._DIR}/quadric_decimate.cpp", "-o", str(out)], check=True, capture_output=True)
    return ctypes.CDLL(str(out))


def test_decimate_and_normals_match_jax(decoded, tmp_path):
    """Quadric decimation of the decoded mesh to half its vertices, with
    normals. The port's copy built with the JAX package's flags gives the
    same faces, vertices and normals exactly; its portable build may round
    an FMA differently and so collapse another edge now and then: face and
    vertex counts within 1 %, normals alone within 1e-5."""
    from sculptmate_tpu_torch.geometry.decimate import _decimate_native

    _, _, (verts, faces, _), _ = decoded
    ratio = 0.5
    jv, jf, jn = j_decimate(verts, faces, target_ratio=ratio, return_normals=True)
    v, f, n = _decimate_native(_same_flags_decimator(tmp_path), np.ascontiguousarray(verts, np.float32),
                               np.ascontiguousarray(faces, np.int32), ratio, 7.0, True)
    assert np.array_equal(f, jf) and np.array_equal(v, jv) and np.array_equal(n, jn)
    v, f, n = decimate(verts, faces, target_ratio=ratio, return_normals=True)
    assert abs(len(f) - len(jf)) <= 0.01 * len(jf) and abs(len(v) - len(jv)) <= 0.01 * len(jv)
    np.testing.assert_allclose(np.linalg.norm(n, axis=1), 1.0, atol=1e-5)
    np.testing.assert_allclose(vertex_normals(verts, faces), j_vertex_normals(verts, faces), atol=1e-5)


def test_host_unwrap_matches_jax(decoded):
    """The host cube-projection unwrap of the decoded mesh: the same
    duplicated faces, UVs within 1e-5 and in [0, 1]; on a CPU mesh "auto"
    is the host unwrap and "device" the plain version of K9."""
    _, _, (verts, faces, _), _ = decoded
    m, jm = Mesh(verts, faces), JMesh(verts, faces)
    m.unwrap_uv(backend="host")
    jm.unwrap_uv(backend="host")
    assert np.array_equal(m.t_pos_idx, jm.t_pos_idx) and np.array_equal(m.v_pos, jm.v_pos)
    np.testing.assert_allclose(m.v_tex, jm.v_tex, atol=1e-5)
    np.testing.assert_allclose(m.v_nrm, jm.v_nrm, atol=1e-5)
    assert m.v_tex.min() >= 0 and m.v_tex.max() <= 1
    np.testing.assert_allclose(m.v_tng, jm.v_tng, atol=1e-4)
    auto = Mesh(verts, faces).unwrap_uv(backend="auto", device="cpu")
    np.testing.assert_array_equal(auto.v_tex, m.v_tex)
    dev = Mesh(verts, faces).unwrap_uv(backend="device", device="cpu")
    assert np.array_equal(dev.t_pos_idx, m.t_pos_idx) and np.isfinite(dev.v_tex).all()
    assert dev.v_tex.min() >= 0 and dev.v_tex.max() <= 1


def test_cli_decimate_matches_jax(tmp_path, decoded, capsys):
    """``decimate`` on an OBJ against the JAX package's ``decimate`` on the
    same mesh: face counts within 1 % (the builds' flags differ, see
    above), and the JSON line."""
    import json

    from sculptmate_tpu_torch import cli
    from sculptmate_tpu_torch.io import read_obj, write_obj

    _, _, (verts, faces, _), _ = decoded
    src, dst = tmp_path / "in.obj", tmp_path / "out.obj"
    write_obj(str(src), verts, faces)
    assert cli.main(["decimate", str(src), str(dst), "--ratio", "0.4"]) == 0
    v0, f0 = read_obj(str(src))
    _, jf = j_decimate(v0, f0, target_ratio=0.4)
    _, f = read_obj(str(dst))
    assert abs(len(f) - len(jf)) <= 0.01 * len(jf) and f.max() < len(v0)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["input_faces"] == len(faces) and line["output_faces"] == len(f)
