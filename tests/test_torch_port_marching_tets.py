"""Port parity of the packed marching tets (kernel K11) on the CPU: its plain
version ``marching_tets_plain`` against JAX ``marching_tets``, the per-cube
tables K11 reads against the per-tet ones, ``marching_tets_host`` and
``SF3D._extract_packed``/``_extract_packed_mesh`` against their JAX
counterparts. K11 itself runs only on the card (the ``cuda`` test)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sculptmate_tpu.geometry.marching_tets import marching_tets as j_marching_tets
from sculptmate_tpu.geometry.marching_tets import marching_tets_host as j_marching_tets_host
from sculptmate_tpu.ops import density_grid as jdg
from sculptmate_tpu.systems.sf3d import SF3D as JSF3D
from sculptmate_tpu.systems.sf3d import SF3DConfig as JSF3DConfig
from sculptmate_tpu_torch.geometry import marching_tets as mt
from sculptmate_tpu_torch.runtime.checkpoint import sf3d_params_from_jax
from sculptmate_tpu_torch.systems.sf3d import SF3D, SF3DConfig

RES = 13  # 14^3 lattice points, padded to 16^3
COUNTERS = ("num_verts", "num_faces", "num_active_vblocks", "num_active_fblocks", "num_active_cubes")
TINY = dict(
    cond_image_size=56, isosurface_resolution=14, plane_size=8, num_channels=64, num_attention_heads=4,
    attention_head_dim=16, num_latents=32, num_blocks=1, num_basic_blocks=1, upsample_scale_factor=2,
    upsample_conv_layers=2, dinov2_hidden_size=64, dinov2_num_layers=2, dinov2_num_heads=4,
    dinov2_intermediate_size=128, clip_width=64, clip_layers=2, clip_heads=4,
)


def _lattice(kind: str, res: int = RES, seed: int = 3):
    """sdf (N^3,) and raw offsets [3 x (N^3,)] or None, from a numpy seed:
    a sphere, the same sphere with N(0, 1) offsets, or N(0, 1) noise with
    offsets."""
    rng = np.random.default_rng(seed)
    N = res + 1
    x = np.linspace(-1, 1, N, dtype=np.float32)
    g = np.stack(np.meshgrid(x, x, x, indexing="ij"))
    sdf = 0.7 - np.sqrt((g**2).sum(0)) if kind != "noise" else rng.standard_normal((N, N, N))
    offs = None if kind == "sphere" else [rng.standard_normal(N**3).astype(np.float32) for _ in range(3)]
    return sdf.astype(np.float32).ravel(), offs


def _jax_mt(sdf, offs, res, mv, mf):
    fn = jax.jit(j_marching_tets, static_argnums=(4, 5, 6, 7, 8, 9))
    o = [None] * 3 if offs is None else [jnp.asarray(a) for a in offs]
    return {k: np.asarray(v) for k, v in fn(jnp.asarray(sdf), *o, res, mv, mf, 0, 0, 0)._asdict().items()}


def _torch(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("kind", ["sphere", "deformed sphere", "noise"])
def test_marching_tets_plain_matches_jax(kind):
    """K11's plain version against JAX ``marching_tets`` with room for
    everything: the five counters equal, the vertices in the same order
    within 1e-6 (the offsets' tanh may differ by an ulp), the faces equal
    array for array."""
    sdf, offs = _lattice(kind)
    N = RES + 1
    mv, mf = 7 * N**3, 12 * N**3
    got = mt.marching_tets_plain(_torch(sdf), *([None] * 3 if offs is None else map(_torch, offs)), RES, mv, mf)
    ref = _jax_mt(sdf, offs, RES, mv, mf)
    assert [int(getattr(got, k)) for k in COUNTERS] == [int(ref[k]) for k in COUNTERS]
    assert int(ref["num_faces"]) > 0
    for k in ("vx", "vy", "vz"):
        np.testing.assert_allclose(getattr(got, k).numpy(), ref[k], rtol=0, atol=1e-6)
    for k in ("fa", "fb", "fc"):
        assert getattr(got, k).dtype == torch.int32 and np.array_equal(getattr(got, k).numpy(), ref[k]), k


def test_marching_tets_undersized_capacities():
    """Capacities below the counts: exact counters, the leading rows of the
    full result and nothing else."""
    sdf, offs = _lattice("noise")
    N = RES + 1
    args = (_torch(sdf), *map(_torch, offs), RES)
    full = mt.marching_tets_plain(*args, 7 * N**3, 12 * N**3)
    nv, nf = int(full.num_verts), int(full.num_faces)
    small = mt.marching_tets_plain(*args, nv // 3, nf // 2)
    assert [int(getattr(small, k)) for k in COUNTERS] == [int(getattr(full, k)) for k in COUNTERS]
    for k in mt.MTResult._fields[:6]:
        n = nv // 3 if k.startswith("v") else nf // 2
        assert getattr(small, k).shape == (n,) and torch.equal(getattr(small, k), getattr(full, k)[:n]), k


@pytest.mark.parametrize("kind", ["deformed sphere", "noise"])
def test_cube_tables_give_the_plain_faces(kind):
    """K11 reads per-cube tables (``cube_tables``: the per-tet tables folded
    over a cube's six tets) and numbers a face corner by its (class, x, y)
    row's cut-word base plus a popcount. The same scheme in numpy gives the
    plain version's faces, in its order."""
    sdf, offs = _lattice(kind, res=20, seed=5)
    N = 21
    Np = 24
    ref = mt.marching_tets_plain(_torch(sdf), *map(_torch, offs), 20, 7 * N**3, 12 * N**3)
    occ = np.zeros((Np + 1,) * 3, bool)
    occ[:N, :N, :N] = sdf.reshape(N, N, N) > 0
    cut = mt._cut_masks(torch.from_numpy(occ[:Np, :Np, :Np]), N).numpy()  # (7, Np, Np, Np)
    vid = (np.cumsum(cut.reshape(-1)) - 1).reshape(cut.shape)
    cube = sum(occ[(c & 1) : (c & 1) + Np, (c >> 1 & 1) : (c >> 1 & 1) + Np, (c >> 2) : (c >> 2) + Np].astype(int) << c
               for c in range(8))
    cube[N - 1 :], cube[:, N - 1 :], cube[:, :, N - 1 :] = 0, 0, 0
    count, tris = mt.cube_tables()
    faces = []
    nb = Np // 8
    for b in range(nb**3):  # blocks (bx, by, bz), cubes (ox, oy, oz)
        bi, bj, bk = 8 * (b // nb**2), 8 * (b // nb % nb), 8 * (b % nb)
        for o in range(512):
            i, j, k = bi + o // 64, bj + o // 8 % 8, bk + o % 8
            for s in range(count[cube[i, j, k]]):
                codes = tris[cube[i, j, k], s]
                faces.append([vid[c >> 3, i + (c & 1), j + (c >> 1 & 1), k + (c >> 2 & 1)] for c in codes])
    faces = np.asarray(faces, np.int32)
    assert len(faces) == int(ref.num_faces) > 0
    assert np.array_equal(faces, ref.faces[: len(faces)].numpy())


def _nth_bit(b, r):
    """K11's ``nth_bit``: the place of the r-th (from 0) set bit of each
    32-bit b, by its five halving steps."""
    b, r, at = b.astype(np.int64), r.astype(np.int64), np.zeros(np.shape(r), np.int64)
    for s in (16, 8, 4, 2, 1):
        n = np.bitwise_count(b & ((1 << s) - 1)).astype(np.int64)
        up = r >= n
        r, b, at = np.where(up, r - n, r), np.where(up, b >> s, b), np.where(up, at + s, at)
    return at


def _vertex_walk(words):
    """K11's vertex pass on the flat cut words, warp by warp: 32 words, the
    inclusive scan of their popcounts, then windows of 32 cut edges, each
    lane's word from the ballots (the word open at the window's start, or
    the k-th nonzero word after it, k the words starting up to the lane's
    edge) and its bit from its rank in that word. Returns each vertex id's
    flat word index and bit, in id order."""
    nw = -(-len(words) // 32)
    w = np.zeros(nw * 32, np.int64)
    w[: len(words)] = words
    w = w.reshape(nw, 32)
    cnt = np.bitwise_count(w).astype(np.int64)
    incl = np.cumsum(cnt, axis=1)
    excl, total = incl - cnt, incl[:, -1]
    lane = np.arange(32)
    word_of, bit_of = [], []
    for q in np.nonzero(total)[0]:
        nonzero = int(((cnt[q] > 0).astype(np.int64) << lane).sum())
        for v0 in range(0, int(total[q]), 32):
            open_ = int((incl[q] <= v0).sum())
            starts = (cnt[q] > 0) & (excl[q] > v0) & (excl[q] < v0 + 32)
            at = int((np.ones(32, np.int64)[starts] << (excl[q][starts] - v0)).sum())
            k = np.bitwise_count(at & ((2 << lane) - 1))
            jw = np.where(k == 0, open_, _nth_bit(np.full(32, nonzero & (0xFFFFFFFE << open_) & 0xFFFFFFFF), k - 1))
            v = v0 + lane
            live = v < total[q]
            jw, v = jw[live], v[live]
            word_of.append(32 * q + jw)
            bit_of.append(_nth_bit(w[q][jw], v - excl[q][jw]))
    return np.concatenate(word_of), np.concatenate(bit_of)


def _face_walk(cube, words, word_base, Np):
    """K11's face pass: block by block, the cubes' triangle counts and
    their exclusive prefixes, and face r's cube by the binary search over
    the 512 prefixes, its slot the difference, each corner's id its (class,
    x, y) row's word base plus a popcount within the word."""
    count, tris = mt.cube_tables()
    nb, nwords = Np // 8, -(-Np // 32)
    w4, b4 = words.reshape(7, Np, Np, nwords).astype(np.int64), word_base.reshape(7, Np, Np, nwords)
    faces = []
    for blk in range(nb**3):
        bi, bj, bk = 8 * (blk // nb**2), 8 * (blk // nb % nb), 8 * (blk % nb)
        cs = cube[bi : bi + 8, bj : bj + 8, bk : bk + 8].reshape(512)
        n = count[cs].astype(np.int64)
        first, total = np.cumsum(n) - n, int(n.sum())
        if total == 0:
            continue
        r = np.arange(total)
        u = np.zeros(total, np.int64)
        for s in (256, 128, 64, 32, 16, 8, 4, 2, 1):
            u = np.where(first[u + s] <= r, u + s, u)
        code = tris[cs[u], r - first[u]]  # (faces, 3)
        cls, a = code >> 3, code & 7
        i, j = bi + (u >> 6)[:, None] + (a & 1), bj + ((u >> 3) & 7)[:, None] + ((a >> 1) & 1)
        k = bk + (u & 7)[:, None] + (a >> 2)
        word = (cls, i, j, k >> 5)
        faces.append(b4[word] + np.bitwise_count(w4[word] & ((1 << (k & 31)) - 1)))
    return np.concatenate(faces).astype(np.int32)


@pytest.mark.parametrize("kind, res", [("noise", 37), ("deformed sphere", 100)])
def test_kernel_walks_give_the_plain_mesh(kind, res):
    """K11's index math in numpy: the cut words along z, their scanned
    bases, the warp-balanced vertex walk and the block-balanced face walk
    rebuild the plain version's positions and faces entry for entry, at a
    ragged lattice (res 37: Np = 40, two words per row, z-blocks whose
    corners reach the next word) and at one whose 2 197 block counts span
    two scan tiles (res 100)."""
    sdf, offs = _lattice(kind, res=res, seed=5)
    N = res + 1
    Np = -(-N // 8) * 8
    ref = mt.marching_tets_plain(_torch(sdf), *map(_torch, offs), res, 7 * N**3, 12 * N**3)
    nv, nf = int(ref.num_verts), int(ref.num_faces)
    occ = np.zeros((Np + 1,) * 3, bool)
    occ[:N, :N, :N] = sdf.reshape(N, N, N) > 0
    cut = mt._cut_masks(torch.from_numpy(occ[:Np, :Np, :Np]), N).numpy()  # (7, Np, Np, Np)
    nwords = -(-Np // 32)
    z = np.zeros((7, Np, Np, 32 * nwords), np.int64)
    z[..., :Np] = cut
    words = (z.reshape(7, Np, Np, nwords, 32) << np.arange(32)).sum(-1).reshape(-1)
    cnt = np.bitwise_count(words).astype(np.int64)
    word_base = np.cumsum(cnt) - cnt  # the scan's first segment

    word, bit = _vertex_walk(words)
    assert len(word) == nv > 0
    c, rest = np.divmod(word, Np * Np * nwords)
    i, rest = np.divmod(rest, Np * nwords)
    j, zw = np.divmod(rest, nwords)
    k = 32 * zw + bit
    d = mt.EDGE_DIRS.astype(np.int64)[c]
    a0, a1 = (i * Np + j) * Np + k, ((i + d[:, 0]) * Np + j + d[:, 1]) * Np + k + d[:, 2]
    # the plain version's arithmetic at each walked edge
    s3 = torch.full((Np, Np, Np), -1.0)
    s3[:N, :N, :N] = torch.from_numpy(sdf).reshape(N, N, N)
    s0, s1 = s3.reshape(-1)[a0], s3.reshape(-1)[a1]
    denom = s0 - s1
    t = (s0 / torch.where(denom == 0, 1.0, denom)).clamp(0.0, 1.0)
    ax = torch.arange(Np, dtype=torch.float32) * (1.0 / res)
    for axis, (idx0, key) in enumerate(((i, "vx"), (j, "vy"), (k, "vz"))):
        off = torch.zeros((Np, Np, Np))
        off[:N, :N, :N] = torch.from_numpy(offs[axis]).reshape(N, N, N)
        dflat = ((1.0 / res) * torch.tanh(off)).reshape(-1)
        c0 = ax[idx0] + dflat[a0]
        c1 = ax[idx0 + d[:, axis]] + dflat[a1]
        assert torch.equal(c0 + t * (c1 - c0), getattr(ref, key)[:nv]), key

    cube = sum(occ[(q & 1) : (q & 1) + Np, (q >> 1 & 1) : (q >> 1 & 1) + Np, (q >> 2) : (q >> 2) + Np].astype(int) << q
               for q in range(8))
    cube[N - 1 :], cube[:, N - 1 :], cube[:, :, N - 1 :] = 0, 0, 0
    faces = _face_walk(cube, words, word_base, Np)
    assert len(faces) == nf > 0
    assert np.array_equal(faces, ref.faces[:nf].numpy())


@pytest.mark.parametrize("kind", ["sphere", "deformed sphere", "empty"])
def test_marching_tets_host_matches_jax(kind):
    """``marching_tets_host`` (on the CPU) against the JAX one: the same
    vertices within 1e-6 and the same faces, sliced to the counts, from
    capacities far too small (each retried); and JAX ``test_empty``'s case,
    an sdf of -1 everywhere, gives no vertex and no face."""
    if kind == "empty":
        sdf, offs = -np.ones((9**3,), np.float32), None
        res = 8
    else:
        sdf, offs = _lattice(kind)
        res = RES
    deform = None if offs is None else np.stack(offs, -1)
    v, f = mt.marching_tets_host(sdf, deform, res, max_verts=64, max_faces=64, device="cpu")
    jv, jf = j_marching_tets_host(sdf, deform, res, max_verts=64, max_faces=64)
    assert v.shape == jv.shape and f.shape == jf.shape and f.dtype == np.int32
    np.testing.assert_allclose(v, jv, rtol=0, atol=1e-6)
    assert np.array_equal(f, jf)
    assert (len(v) == 0) == (kind == "empty")


@pytest.fixture(scope="module")
def sf3d_pair():
    """A tiny JAX SF3D and the port with its weights, and one image's scene
    codes from the JAX model."""
    jm = JSF3D(JSF3DConfig(**TINY), dtype=jnp.float32)
    params = jax.tree.map(np.asarray, jm.params)
    port = SF3D(SF3DConfig(**TINY), state_dict=sf3d_params_from_jax(params), dtype=torch.float32, device="cpu")
    img = np.random.default_rng(7).random((1, 56, 56, 4)).astype(np.float32)
    codes, _ = jm.get_scene_codes(jm.prepare_image(jnp.asarray(img))[1])
    heads = jm._head_weights(["density", "vertex_offset"])
    grids = jdg.query_grid_multihead(codes[0], heads, jdg.lattice_coords_tets(14), jm.grid_spec(slab=1))
    # a threshold at least 1e-4 from every lattice density, so occupancy
    # cannot flip between the two packages' lattice queries
    d = np.sort(np.exp(np.asarray(grids["density"][0]) - 1.0).ravel())
    gaps = [i for i in np.nonzero(np.diff(d) > 2e-4)[0] if 0.4 * d.size < i < 0.9 * d.size]
    thr = float(d[gaps[0]] + d[gaps[0] + 1]) / 2
    return jm, port, np.array(codes[0]), thr


def test_extract_packed_matches_jax(sf3d_pair):
    """``SF3D._extract_packed`` (K5's and K11's plain versions) against JAX
    ``SF3D._extract_jit`` on the same weights and codes: counters equal,
    faces equal, vertices within 1e-4 lattice units (0.14 % of a lattice
    step at res 14: the two lattice queries differ by float
    rounding, ~1e-6 of the sdf, which t = s0 / (s0 - s1) amplifies where
    neighbouring values nearly agree; measured 2.5e-5)."""
    jm, port, code, thr = sf3d_pair
    mv, mf = 1 << 14, 1 << 15
    ref = {k: np.asarray(v) for k, v in jm._extract_jit(jnp.asarray(code), thr, mv, mf)._asdict().items()}
    got = port._extract_packed(torch.from_numpy(code), thr, mv, mf)
    assert [int(getattr(got, k)) for k in COUNTERS] == [int(ref[k]) for k in COUNTERS]
    assert int(ref["num_faces"]) > 0
    for k in ("vx", "vy", "vz"):
        np.testing.assert_allclose(getattr(got, k).numpy(), ref[k], rtol=0, atol=1e-4)
    for k in ("fa", "fb", "fc"):
        assert np.array_equal(getattr(got, k).numpy(), ref[k]), k


def test_extract_packed_mesh_matches_jax(sf3d_pair):
    """``SF3D._extract_packed_mesh`` against JAX ``_extract_packed_jit``'s
    one buffer, decoded: world vertices within 2e-4 (1e-4 lattice units
    times the bbox's 2r, as above), int32 faces equal,
    the five counters equal; at a vertex capacity under the count the
    counters still say so and the leading rows stay."""
    jm, port, code, thr = sf3d_pair
    mv, mf = 1 << 14, 1 << 15
    buf = np.asarray(jm._extract_packed_jit(jnp.asarray(code), thr, mv, mf))
    jv, jf, jc = buf[:, :mv].T, buf[:, mv : mv + mf].T.astype(np.int32), buf[0, mv + mf :].astype(np.int64)
    v, f, counts = port._extract_packed_mesh(torch.from_numpy(code), thr, mv, mf)
    assert np.array_equal(counts, jc) and f.dtype == np.int32
    nv, nf = int(jc[0]), int(jc[1])
    assert v.shape == (nv, 3) and f.shape == (nf, 3)
    np.testing.assert_allclose(v, jv[:nv], rtol=0, atol=2e-4)
    assert np.array_equal(f, jf[:nf])
    v2, f2, counts2 = port._extract_packed_mesh(torch.from_numpy(code), thr, nv // 2, mf)
    assert np.array_equal(counts2, counts) and len(v2) == nv // 2
    np.testing.assert_array_equal(v2, v[: nv // 2])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["deformed sphere", "noise", "ragged res 37", "undersized capacities"])
def test_marching_tets_kernel_matches_plain(case):
    """K11 on the card against its plain version on the same inputs: every
    position, face and counter equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    res = 37 if case == "ragged res 37" else 40
    sdf, offs = _lattice("noise" if case in ("noise", "undersized capacities") else "deformed sphere", res=res)
    args = [torch.from_numpy(a).cuda() for a in (sdf, *offs)]
    N = res + 1
    mv, mf = (5000, 9000) if case == "undersized capacities" else (7 * N**3, 12 * N**3)
    got = mt.marching_tets(*args, res, mv, mf)
    ref = mt.marching_tets_plain(*args, res, mv, mf)
    for k in mt.MTResult._fields:
        assert torch.equal(getattr(got, k), getattr(ref, k)), k
