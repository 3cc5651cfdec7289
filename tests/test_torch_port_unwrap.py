"""Port parity for the device UV unwrap: the plain version of kernel K9
against ``uv_unwrap_device._unwrap_core`` / ``unwrap_device`` on a decoded
tiny-SF3D mesh, K9's decomposition of the visibility rounds (the depth
ranges its passes reduce, K8's unwrap-form loader) against
``_depth_round``, and the JAX program's empty-slice fault, which the port
repairs. Kernel K9 itself runs only on the card (the ``cuda`` test)."""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sculptmate_tpu.geometry import mt_wire as j_mt_wire
from sculptmate_tpu.geometry import uv_unwrap_device as jud
from sculptmate_tpu.geometry.uv_unwrap import _main_axis_rotation as j_rotation
from sculptmate_tpu.ops import density_grid as jdg
from sculptmate_tpu.ops import size_bucket
from sculptmate_tpu.systems.sf3d import SF3D as JSF3D
from sculptmate_tpu.systems.sf3d import SF3DConfig as JSF3DConfig
from sculptmate_tpu_torch.geometry import uv_unwrap_device as ud
from sculptmate_tpu_torch.geometry.uv_unwrap import _main_axis_rotation

RES = 14
TINY = dict(
    cond_image_size=56, isosurface_resolution=RES, plane_size=8, num_channels=64, num_attention_heads=4,
    attention_head_dim=16, num_latents=32, num_blocks=1, num_basic_blocks=1, upsample_scale_factor=2,
    upsample_conv_layers=2, dinov2_hidden_size=64, dinov2_num_layers=2, dinov2_num_heads=4,
    dinov2_intermediate_size=128, clip_width=64, clip_layers=2, clip_heads=4,
)


@pytest.fixture(scope="module")
def mesh():
    """A tiny SF3D's surface (the JAX package's wire, decoded with the
    weld): ~6.6 K vertices, ~13 K faces."""
    jm = JSF3D(JSF3DConfig(**TINY), dtype=jnp.float32)
    img = np.random.default_rng(7).random((1, 56, 56, 4)).astype(np.float32)
    codes, _ = jm.get_scene_codes(jm.prepare_image(jnp.asarray(img))[1])
    g = jdg.query_grid_multihead(codes[0], jm._head_weights(["density"]), jdg.lattice_coords_tets(RES),
                                 jm.grid_spec(slab=1))
    thr = float(np.exp(np.asarray(g["density"][0]) - 1.0).mean())
    wire = np.asarray(jm._extract_wire_jit(codes[0], thr, 16384, 0, 0.2))
    verts, faces, _ = j_mt_wire.decode_wire(wire, RES, 16384, weld=True)
    return verts, faces


def _jax_unwrap(verts, faces):
    """``unwrap_device``'s program with its padding and retries, returning
    what it keeps to itself: (uv (F, 3, 2) from the u16 rows, atlas_index,
    angles (2, 6))."""
    rp = verts @ j_rotation(verts).T
    Nv, F = len(rp), len(faces)
    nb, fb = size_bucket(Nv), size_bucket(F)
    pos = np.zeros((3, nb), np.float32)
    pos[:, :Nv] = rp.T
    pos[:, Nv:] = rp[0][:, None]
    fc = np.zeros((3, fb), np.int32)
    fc[:, :F] = faces.T
    caps = [1 << max(16, int(4 * fb - 1).bit_length()), 1 << 16, 1 << 16]
    while True:
        uv6, atlas, counters, angles = jud._unwrap_jit(
            *(jnp.asarray(pos[c]) for c in range(3)), *(jnp.asarray(fc[c]) for c in range(3)), Nv, F, 0.02, tuple(caps)
        )
        over = [int(n) > cap for n, cap in zip(np.asarray(counters), caps)]
        if not any(over):
            break
        caps = [2 * cap if o else cap for cap, o in zip(caps, over)]
    uv = np.asarray(uv6).T.reshape(-1, 3, 2)[:F].astype(np.float32) / 65535.0
    return rp, uv, np.asarray(atlas)[:F], np.asarray(angles)


def _port_unwrap(rp, faces):
    pos = torch.from_numpy(np.ascontiguousarray(rp.T, np.float32))
    f = torch.from_numpy(np.ascontiguousarray(faces.T, np.int32))
    uv6, atlas, angles = ud.unwrap_core(pos[0], pos[1], pos[2], f[0], f[1], f[2], 0.02)
    return uv6.t().reshape(-1, 3, 2).numpy(), atlas.numpy(), angles.numpy()


def test_unwrap_core_matches_jax(mesh):
    """Every slice populated; the same atlas index (slice and visibility
    class) on at least 99.9 % of the faces, per-corner UVs within 1e-4 where
    it agrees (the JAX rows are u16), the slices' angles within 1e-5; and
    on every face the JAX package's host reconstruction from the port's
    atlas indices and angles within 1e-5."""
    verts, faces = mesh
    rp, ref_uv, ref_atlas, ref_angles = _jax_unwrap(verts, faces)
    assert np.array_equal(_main_axis_rotation(verts), j_rotation(verts))
    uv, atlas, angles = _port_unwrap(rp, faces)
    assert (np.bincount(atlas % 6, minlength=6) > 0).all() and (atlas >= 6).any() and (atlas >= 12).any()
    same = atlas == ref_atlas
    assert same.mean() >= 0.999
    assert np.abs(uv[same] - ref_uv[same]).max() <= 1e-4
    assert np.abs(angles - ref_angles).max() <= 1e-5
    rec = jud.reconstruct_uvs_numpy(rp, faces, atlas, angles[0], angles[1], 0.02)
    np.testing.assert_allclose(uv, rec, atol=1e-5)


def test_unwrap_device_matches_jax(mesh):
    """``unwrap_device`` end to end (PCA rotation on the host): flat UVs
    within 1e-4 of the JAX package's on 99.9 % of the corners, and the
    deduplicated form indexing back to the flat one."""
    verts, faces = mesh
    ref, _ = jud.unwrap_device(verts, faces, return_flat=True)
    flat, none = ud.unwrap_device(verts, faces, return_flat=True, device="cpu")
    assert none is None and flat.shape == (len(faces), 3, 2) and flat.dtype == np.float32
    assert (np.abs(flat - ref).max(-1) <= 1e-4).mean() >= 0.999
    uniq, idx = ud.unwrap_device(verts, faces, device="cpu")
    np.testing.assert_array_equal(uniq[idx], flat)


def _jax_round(uc, vc, index, depth, participate):
    """The JAX package's ``_depth_round`` on the port's normalised UVs,
    slices and depths (torch tensors), retried until its pair lists fit ->
    visible (F,) bool."""
    F = len(depth)
    args = ([jnp.asarray(c.numpy()) for c in uc], [jnp.asarray(c.numpy()) for c in vc], jnp.asarray(index.numpy()),
            jnp.asarray(depth.numpy()), jnp.asarray(participate.numpy()))
    caps = [1 << max(16, int(4 * size_bucket(F) - 1).bit_length()), 1 << 16, 1 << 16]
    while True:
        vis, fine, coarse, n_multi = jud._depth_round(*args, tuple(caps))
        over = [int(n) > cap for n, cap in zip((fine, coarse, n_multi), caps)]
        if not any(over):
            return np.asarray(vis)
        caps = [2 * cap if o else cap for cap, o in zip(caps, over)]


def test_round_decomposition_matches_jax(mesh, monkeypatch):
    """K9 splits each visibility round otherwise than ``_depth_round``:
    round 0's per-slice depth range is reduced over all faces (in the pass
    that finds the slices), round 1's over the faces round 0 hid (in round
    0's test), and K8's unwrap form forms the corners and keys from the
    rotated, not yet normalised UVs. On the tiny SF3D mesh: each range
    equals the JAX program's over the round's participants, the corners and
    keys ``unwrap_round`` forms (its plain loader here) equal those
    ``_depth_round_plain`` rasterizes, and the visibility from them equals
    the JAX ``_depth_round``'s in both rounds."""
    verts, faces = mesh
    rp = verts @ _main_axis_rotation(verts).T
    pos = torch.from_numpy(np.ascontiguousarray(rp.T, np.float32))
    f = torch.from_numpy(np.ascontiguousarray(faces.T, np.int32))
    recorded, plain = [], ud.binned_winner_plain
    monkeypatch.setattr(ud, "binned_winner_plain", lambda *a: recorded.append(a) or plain(*a))
    _, atlas, angles = ud.unwrap_core_plain(pos[0], pos[1], pos[2], f[0], f[1], f[2])
    monkeypatch.undo()
    index, depth, r6, lo6, hi6, _ = ud.unwrap_slices_plain(pos[0], pos[1], pos[2], f[0], f[1], f[2], angles)
    ix = index.long()
    scale = (hi6[ix] - lo6[ix]).clamp_min(1e-12)
    uc = [(r6[c] - lo6[ix]) / scale for c in range(3)]
    vc = [(r6[3 + c] - lo6[ix]) / scale for c in range(3)]
    vis0 = None
    for r in range(2):
        part = torch.ones_like(depth, dtype=torch.bool) if vis0 is None else ~vis0
        corners, key, winner = ud.unwrap_round(r6, index, depth, lo6, hi6, vis0)
        assert torch.equal(corners, torch.stack(recorded[r][:6])) and torch.equal(key, recorded[r][6])
        # the participants' per-slice range, as the kernel's passes reduce it
        slot = torch.where(part, ix, 6)
        inf = torch.full((7,), float("inf"))
        dmin = inf.scatter_reduce(0, slot, depth, "amin")[:6]
        dmax = (-inf).scatter_reduce(0, slot, depth, "amax")[:6]
        d, p = depth.numpy(), part.numpy()
        for s in range(6):
            m = p & (index.numpy() == s)
            assert float(dmin[s]) == float(jnp.min(jnp.where(m, d, jnp.inf)))
            assert float(dmax[s]) == float(jnp.max(jnp.where(m, d, -jnp.inf)))
        # each face at its centroid texel of the round's winner
        eps = (0.02 * (dmax - dmin).clamp_min(1e-6))[ix]
        gx, gy = (index % 4).float(), (index // 4).float()
        cu = ud._warp((uc[0] + uc[1] + uc[2]) * ud._THIRD, gx)
        cv = ud._warp((vc[0] + vc[1] + vc[2]) * ud._THIRD, gy)
        cx, cy = ((c * 1023.0).round().long().clamp(0, 1023) for c in (cu, cv))
        wkey = winner[cy * 1024 + cx]
        vis = (wkey >= ud.WINNER_SINK - 1) | (ud._unsortable(~wkey) <= depth + eps)
        np.testing.assert_array_equal(vis.numpy(), _jax_round(uc, vc, index, depth, part))
        kept = vis if vis0 is None else kept | (vis & part)
        vis0 = vis
    assert torch.equal(kept, atlas < 12)  # the faces the two rounds keep are the atlas's first two classes


def _terrain(n=24, x0=0.0):
    """A terrain patch whose faces all look one way along the thin axis, so
    one cube slice is empty; centred at x = ``x0``."""
    x, y = np.meshgrid(np.linspace(x0 - 1, x0 + 1, n), np.linspace(-0.6, 0.6, n))
    z = 0.15 * np.sin(2.5 * x) * np.cos(3 * y)
    verts = np.stack([x, y, z], -1).reshape(-1, 3).astype(np.float32)
    i, j = np.arange(n - 1)[:, None] * n, np.arange(n - 1)[None, :]
    a, b, c, d = i + j, i + j + 1, i + n + j, i + n + j + 1
    faces = np.concatenate([np.stack([a, b, c], -1).reshape(-1, 3), np.stack([b, d, c], -1).reshape(-1, 3)])
    return verts, faces


def test_empty_slice_gives_finite_uvs():
    """A terrain patch with an empty cube slice (``_terrain``). The JAX
    device program looks the slices' lo/hi up with a one-hot product, where
    the empty slice's +-inf times 0 is NaN for every face: its UVs (the NaN
    quantized to u16) disagree with the JAX package's own host
    reconstruction, which gathers, on every face (the reference's fault).
    The port gathers: its UVs are finite and equal that reconstruction from
    its atlas indices and angles."""
    verts, faces = _terrain()
    rp, ref_uv, ref_atlas, ref_angles = _jax_unwrap(verts, faces)
    rec = jud.reconstruct_uvs_numpy(rp, faces, ref_atlas, ref_angles[0], ref_angles[1], 0.02)
    assert (np.abs(ref_uv - rec).reshape(len(faces), -1).max(1) > 1e-3).all()  # the reference's fault

    uv, atlas, angles = _port_unwrap(rp, faces)
    assert (np.bincount(atlas % 6, minlength=6) == 0).any()  # an empty slice
    assert np.isfinite(uv).all() and uv.min() >= 0 and uv.max() <= 1
    rec = jud.reconstruct_uvs_numpy(rp, faces, atlas, angles[0], angles[1], 0.02)
    np.testing.assert_allclose(uv, rec, atol=1e-5)


@pytest.mark.cuda
def test_unwrap_kernel_matches_plain(mesh):
    """K9 on the card against its plain version given the kernel's slice
    angles (the one order-dependent sum, held to the plain sum within
    1e-5): the same atlas index on every face, UVs within 1e-5. On the
    tiny SF3D mesh, the terrain patch with an empty slice (moved off the z
    axis: centred on it, a slice's mean expected tangent is near zero and
    its angle turns with the order of the sum, by 1.4 rad between two face
    orders of the plain version itself), and ``chip_smoke.layered_sheets``
    (281 600 faces, ~0.26 M of them in the pool: its prefix spans five scan
    tiles; round 1's depth range decides which back sheet is kept)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)

    def rotated(verts, faces):
        rp = verts @ _main_axis_rotation(verts).T
        return (torch.from_numpy(np.ascontiguousarray(rp.T, np.float32)).cuda(),
                torch.from_numpy(np.ascontiguousarray(faces.T, np.int32)).cuda())

    for pos, f in (rotated(*mesh), rotated(*_terrain(x0=2.0)), chip_smoke.layered_sheets()):
        uv, atlas, angles = ud.unwrap_core(pos[0], pos[1], pos[2], f[0], f[1], f[2], 0.02)
        ref_uv, ref_atlas, ref_angles = ud.unwrap_core_plain(pos[0], pos[1], pos[2], f[0], f[1], f[2], 0.02)
        assert (angles - ref_angles).abs().max() <= 1e-5
        ref_uv, ref_atlas, _ = ud.unwrap_core_plain(pos[0], pos[1], pos[2], f[0], f[1], f[2], 0.02, angles=angles)
        assert torch.equal(atlas, ref_atlas) and (uv - ref_uv).abs().max() <= 1e-5
        assert bool(torch.isfinite(uv).all())
