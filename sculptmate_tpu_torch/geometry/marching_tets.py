"""Marching tetrahedra on the device: the wire (kernel K7) and the packed
mesh (kernel K11).

Counterpart of ``sculptmate_tpu/geometry/marching_tets.py:mt_wire_device``
(with ``_mt_vertex_side_wire`` and ``_mt_positions``). ``mt_wire_device``
runs the hand-written kernel ``csrc/marching_tets.cu`` on a CUDA tensor and
its plain version ``mt_wire_device_plain`` on a CPU tensor: marching tets on the
Freudenthal lattice of ``mt_tables.py``, whose tet edges fall into 7
direction classes anchored at a lattice point. Every cut edge gives one
vertex at the sdf-weighted interpolation of its two deformed endpoints
(lattice point v moves by tanh(offset) / res, the reference's
``normalize_grid_deformation``). Faces are table logic on the occupancy
field, so the device ships only what the host cannot rebuild, as one uint8
buffer (order version 2):

    [occupancy bits  Np^3/8 B][px lo][px hi][py lo][py hi][pz lo][pz hi  mv B each]
    [counts: num_verts, n_vblocks  4 B each, little-endian u32]

The lattice is padded to Np = 8 * ceil(N / 8) points per axis (sdf -1,
offsets 0). Vertices are numbered BLOCK-MAJOR: (edge class, 8^3 block,
in-block x/y/z), each id the exclusive prefix of the per-block cut counts
plus the in-block rank; the host decoder (``mt_wire.py`` and
``native/mt_wire.cpp``) re-derives the same order from the bits. Positions
are u16 over [-1/res, 1 + 1/res] in [0, 1] lattice units. The buffer has
``max_verts`` slots and the counters are exact, so a caller detects
overflow (num_verts > max_verts) and retries; there is no block capacity,
since the compaction scans every block. Nothing here syncs with the host.

The packed mesh (``MTResult``, kernel K11): counterpart of
``marching_tets`` and ``marching_tets_host`` of the same JAX module.
``marching_tets`` runs ``csrc/marching_tets.cu:marching_tets_fwd`` on a
CUDA tensor and ``marching_tets_plain`` on a CPU tensor. Vertices are the
cut edges numbered class-major, then in (x, y, z) raster order over the
padded lattice; each lies at t = clamp(s0 / (s0 - s1), 0, 1) between its
two deformed endpoints, in [0, 1] lattice units. Faces come block-major
(8^3 blocks of cubes in (bx, by, bz) order, cubes in (ox, oy, oz) order
within a block), then by the cube's six tets and each tet's one or two
triangles, wound so normals point away from the inside (sdf > 0). At most
``max_verts`` and ``max_faces`` rows are written, the rest are zero, and
the five counters are exact: a caller sees an overflow and retries.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sculptmate_tpu_torch.geometry.marching_cubes import _SCAN_TILE, BS, _to_blocks as _cells_to_blocks
from sculptmate_tpu_torch.geometry.marching_cubes import _u32_le_bytes, pack_bits_u8
from sculptmate_tpu_torch.geometry.mt_tables import EDGE_DIRS, build_tet_tables
from sculptmate_tpu_torch.runtime import kernels
from sculptmate_tpu_torch.runtime.device import resolve_device

N_WIRE_COUNTS = 2  # num_verts, n_vblocks
# bit c of _DIR_MASKS[a] is edge class c's step along axis a
_DIR_MASKS = tuple(sum(int(EDGE_DIRS[c][a]) << c for c in range(7)) for a in range(3))


def lattice_size(resolution: int) -> int:
    """Number of lattice points per axis: resolution cubes -> res + 1 points."""
    return resolution + 1


def _cut_masks(occ: torch.Tensor, N: int) -> torch.Tensor:
    """(7, Np, Np, Np): edge class d at anchor p is cut iff occupancy
    differs at p and p + d, both endpoints inside the real N^3 lattice."""
    Np = occ.shape[0]
    m = torch.zeros((7, Np, Np, Np), dtype=torch.bool, device=occ.device)
    for d, (dx, dy, dz) in enumerate(EDGE_DIRS.tolist()):
        m[d, : N - dx, : N - dy, : N - dz] = occ[: N - dx, : N - dy, : N - dz] != occ[dx:N, dy:N, dz:N]
    return m


def _to_blocks(m: torch.Tensor) -> torch.Tensor:
    """(7, Np, Np, Np) -> (7 * NB, 512) rows in block-major order."""
    nb = m.shape[1] // BS
    m = m.reshape(7, nb, BS, nb, BS, nb, BS).permute(0, 1, 3, 5, 2, 4, 6)
    return m.reshape(7 * nb**3, BS**3)


def mt_wire_device_plain(
    sdf: torch.Tensor,
    deform_x: torch.Tensor,
    deform_y: torch.Tensor,
    deform_z: torch.Tensor,
    resolution: int,
    max_verts: int,
    snap_eps: float = 0.0,
) -> torch.Tensor:
    """Plain version of kernel K7; ``mt_wire_device``'s arguments and
    result."""
    N = lattice_size(resolution)
    Np = -(-N // BS) * BS
    dev = sdf.device

    def pad3(a: torch.Tensor, fill: float) -> torch.Tensor:
        out = torch.full((Np, Np, Np), fill, dtype=torch.float32, device=dev)
        out[:N, :N, :N] = a.reshape(N, N, N)
        return out

    s3 = pad3(sdf, -1.0)
    occ = s3 > 0
    # deformed lattice points: p = i / res + tanh(offset) / res per axis
    ax = torch.arange(Np, dtype=torch.float32, device=dev) * (1.0 / resolution)
    dflat = [((1.0 / resolution) * torch.tanh(pad3(d, 0.0))).reshape(-1) for d in (deform_x, deform_y, deform_z)]

    rows = _to_blocks(_cut_masks(occ, N))  # (7 NB, 512)
    rows_i = rows.to(torch.int32)
    vcnt = rows_i.sum(dim=1, dtype=torch.int32)
    vbase = torch.cumsum(vcnt, dim=0, dtype=torch.int32) - vcnt
    within = torch.cumsum(rows_i, dim=1, dtype=torch.int32) - rows_i
    num_verts = vcnt.sum(dtype=torch.int32)
    n_vblocks = (vcnt > 0).sum(dtype=torch.int32)

    # compaction: the (row, column) slot of each vertex id < max_verts; ids
    # past the capacity go to a sink slot that is dropped
    vid = (vbase[:, None] + within).reshape(-1)
    dst = torch.where(rows.reshape(-1) & (vid < max_verts), vid, max_verts).long()
    slot = torch.full((max_verts + 1,), -1, dtype=torch.long, device=dev)
    slot.scatter_(0, dst, torch.arange(rows.numel(), device=dev))
    slot = slot[:max_verts]
    valid = slot >= 0

    nb = Np // BS
    NB = nb**3
    s = slot.clamp(min=0)
    row, col = s // BS**3, s % BS**3
    cls, blk = row // NB, row % NB
    i = (blk // (nb * nb)) * BS + col // (BS * BS)
    j = ((blk // nb) % nb) * BS + (col // BS) % BS
    k = (blk % nb) * BS + col % BS
    # the class's direction, axis by axis, from a bit mask over the classes
    # (a table uploaded from the host would wait for the device)
    i1, j1, k1 = (c + ((_DIR_MASKS[a] >> cls) & 1) for a, c in enumerate((i, j, k)))
    a0 = (i * Np + j) * Np + k
    a1 = ((i1 * Np + j1) * Np + k1).clamp(max=Np**3 - 1)

    flat = s3.reshape(-1)
    s0, s1 = flat[a0], flat[a1]
    denom = s0 - s1
    t = (s0 / torch.where(denom == 0, 1.0, denom)).clamp(0.0, 1.0)
    t = torch.where(t < snap_eps, 0.0, torch.where(t > 1.0 - snap_eps, 1.0, t))

    lo = -1.0 / resolution
    span = 1.0 + 2.0 / resolution
    parts = []
    for idx0, idx1, d in ((i, i1, dflat[0]), (j, j1, dflat[1]), (k, k1, dflat[2])):
        c0 = ax[idx0] + d[a0]
        c1 = ax[idx1.clamp(max=Np - 1)] + d[a1]
        v = c0 + t * (c1 - c0)
        q = torch.round((v - lo) / span * 65535.0).clamp(0, 65535).to(torch.int32)
        q = torch.where(valid, q, 0)
        parts += [(q & 0xFF).to(torch.uint8), (q >> 8).to(torch.uint8)]

    occ_bytes = pack_bits_u8(occ.reshape(-1))
    return torch.cat([occ_bytes, *parts, _u32_le_bytes(torch.stack([num_verts, n_vblocks]))])


def _mt_fn():
    fn = kernels.load("marching_tets").mt_wire_fwd  # the library of the sources in use (kernels.sources_from)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [ctypes.c_float] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def k7_scratch(N: int) -> dict:
    """Element counts of kernel K7's scratch for an N^3 lattice (NB 8^3
    blocks of the padded lattice): ``masks`` (each block's seven 512-bit
    cut masks, 112 NB 32-bit words), ``vcnt`` and ``vbase`` (7 NB per-class
    block counts and their scanned bases), and the int32 ``zeroed`` words
    (the 2 counters, the scan's tile counter, 1 pad word, then a u64 status
    word per tile of the scan of the 7 NB counts)."""
    NB = (-(-N // BS)) ** 3
    tiles = -(-7 * NB // _SCAN_TILE)
    return {"masks": 112 * NB, "vcnt": 7 * NB, "vbase": 7 * NB, "status_tiles": tiles, "zeroed": 4 + 2 * tiles}


def mt_wire_device(
    sdf: torch.Tensor,
    deform_x: torch.Tensor,
    deform_y: torch.Tensor,
    deform_z: torch.Tensor,
    resolution: int,
    max_verts: int,
    snap_eps: float = 0.0,
) -> torch.Tensor:
    """sdf and the raw offsets: (N, N, N) or flat (N^3,) f32 over the
    (res+1)^3 lattice, x-major -> the (W,) uint8 wire. Kernel K7 on a CUDA
    ``sdf`` (the offsets on the same device), its plain version on a CPU
    one.

    ``snap_eps`` > 0 snaps the interpolation parameter t to {0, 1} within
    eps, so such vertices land exactly on the deformed lattice point that
    every incident edge shares and the decoder can weld them
    (``mt_wire.decode_wire(weld=True)``)."""
    if not sdf.is_cuda:
        return mt_wire_device_plain(sdf, deform_x, deform_y, deform_z, resolution, max_verts, snap_eps)
    N = lattice_size(resolution)
    if max_verts < 1:
        raise ValueError(f"max_verts must be positive, got {max_verts}")
    if N**3 >= 2**31:
        raise ValueError(f"the MT kernel indexes the lattice with 32-bit ints: resolution {resolution} is too large")
    inputs = []
    for name, t in (("sdf", sdf), ("deform_x", deform_x), ("deform_y", deform_y), ("deform_z", deform_z)):
        if t.device != sdf.device or t.dtype != torch.float32 or t.numel() != N**3:
            raise ValueError(f"{name}: the MT kernel takes {N}^3 f32 values on {sdf.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
        inputs.append(t.reshape(-1).contiguous())  # scalar loads only: a view is read as it lies
    Np = -(-N // BS) * BS
    dev = sdf.device
    wire = torch.zeros(Np**3 // 8 + 6 * max_verts + 4 * N_WIRE_COUNTS, dtype=torch.uint8, device=dev)
    size = k7_scratch(N)
    # the counters, the scan's tile counter and status words, zeroed on the stream
    zeroed = torch.zeros(size["zeroed"], dtype=torch.int32, device=dev)
    scratch = [torch.empty(size[name], dtype=torch.int32, device=dev) for name in ("masks", "vcnt", "vbase")]
    # the scalars as the plain version's f32 arithmetic rounds them on the
    # card (ctypes rounds each double to f32); PyTorch divides a CUDA tensor
    # by a Python scalar as a product with the scalar's reciprocal, taken
    # in double and rounded to f32 (the f32 quotient 1.f / span differs by
    # an ulp at res 160 and moves ~0.2 % of the u16 positions a step)
    err = _mt_fn()(
        *(t.data_ptr() for t in inputs), wire.data_ptr(), *(t.data_ptr() for t in scratch), zeroed.data_ptr(), N,
        max_verts, size["status_tiles"], 1.0 / resolution, -1.0 / resolution, 1.0 / (1.0 + 2.0 / resolution),
        snap_eps, 1.0 - snap_eps, torch.cuda.current_stream(dev).cuda_stream,
    )
    kernels.check(err, "mt_wire_fwd")
    mt_wire_device.launches += 1
    return wire


mt_wire_device.launches = 0


# -- the packed mesh (kernel K11) --


class MTResult(NamedTuple):
    """Structure-of-arrays mesh with fixed capacities: (max_verts,) f32
    positions in [0, 1] lattice units, (max_faces,) int32 face corners, and
    0-d int32 counters."""

    vx: torch.Tensor
    vy: torch.Tensor
    vz: torch.Tensor
    fa: torch.Tensor
    fb: torch.Tensor
    fc: torch.Tensor
    num_verts: torch.Tensor
    num_faces: torch.Tensor
    num_active_vblocks: torch.Tensor  # (edge class, 8^3 block) pairs with a cut edge
    num_active_fblocks: torch.Tensor  # 8^3 blocks of cubes with a face
    num_active_cubes: torch.Tensor  # cubes with at least one face

    @property
    def verts(self) -> torch.Tensor:
        return torch.stack([self.vx, self.vy, self.vz], dim=-1)

    @property
    def faces(self) -> torch.Tensor:
        return torch.stack([self.fa, self.fb, self.fc], dim=-1)


def _offsets(deform: Optional[torch.Tensor], like: torch.Tensor) -> torch.Tensor:
    """A raw offset field, or zeros where there is none (tanh(0) moves no
    point)."""
    return torch.zeros_like(like) if deform is None else deform


def marching_tets_plain(
    sdf: torch.Tensor,
    deform_x: Optional[torch.Tensor],
    deform_y: Optional[torch.Tensor],
    deform_z: Optional[torch.Tensor],
    resolution: int,
    max_verts: int,
    max_faces: int,
) -> MTResult:
    """Plain version of kernel K11: the packed mesh's semantics (see the
    module docstring), written as torch over the whole lattice from the
    per-tet tables."""
    N = lattice_size(resolution)
    Np = -(-N // BS) * BS
    n3p = Np**3
    dev = sdf.device
    edge_class, edge_anchor, tri_table, tri_count, tet_corners = (
        torch.from_numpy(np.asarray(a, np.int64)).to(dev) for a in build_tet_tables()
    )

    def pad3(a: torch.Tensor, fill: float) -> torch.Tensor:
        out = torch.full((Np, Np, Np), fill, dtype=torch.float32, device=dev)
        out[:N, :N, :N] = a.reshape(N, N, N)
        return out

    s3 = pad3(sdf, -1.0)
    occ = s3 > 0
    ax = torch.arange(Np, dtype=torch.float32, device=dev) * (1.0 / resolution)
    dflat = [((1.0 / resolution) * torch.tanh(pad3(_offsets(d, sdf), 0.0))).reshape(-1)
             for d in (deform_x, deform_y, deform_z)]

    # vertices: the cut edges, class-major, then in raster order
    masks = _cut_masks(occ, N)
    flat_mask = masks.reshape(-1)
    vid = torch.cumsum(flat_mask, 0) - 1
    edges = torch.nonzero(flat_mask).reshape(-1)[:max_verts]
    cls, lin = edges // n3p, edges % n3p
    i, j, k = lin // (Np * Np), (lin // Np) % Np, lin % Np
    i1, j1, k1 = (c + ((_DIR_MASKS[a] >> cls) & 1) for a, c in enumerate((i, j, k)))
    a0, a1 = lin, (i1 * Np + j1) * Np + k1
    flat = s3.reshape(-1)
    s0, s1 = flat[a0], flat[a1]
    denom = s0 - s1
    t = (s0 / torch.where(denom == 0, 1.0, denom)).clamp(0.0, 1.0)
    pos = torch.zeros((3, max_verts), dtype=torch.float32, device=dev)
    for a, (idx0, idx1, d) in enumerate(((i, i1, dflat[0]), (j, j1, dflat[1]), (k, k1, dflat[2]))):
        c0 = ax[idx0] + d[a0]
        c1 = ax[idx1] + d[a1]
        pos[a, : len(edges)] = c0 + t * (c1 - c0)

    # faces: each cube's six tet cases from its corners' occupancy (cubes
    # past the real lattice emit nothing), in block-major cube order
    pad = F.pad(occ.to(torch.int64), (0, 1, 0, 1, 0, 1))
    case = torch.zeros((6, Np, Np, Np), dtype=torch.int64, device=dev)
    for tet in range(6):
        for bit in range(4):
            ox, oy, oz = tet_corners[tet, bit].tolist()
            case[tet] += pad[ox : ox + Np, oy : oy + Np, oz : oz + Np] << bit
    ntri = tri_count[torch.arange(6, device=dev)[:, None, None, None], case]
    ntri[:, N - 1 :], ntri[:, :, N - 1 :], ntri[:, :, :, N - 1 :] = 0, 0, 0
    cell_ids = _cells_to_blocks(torch.arange(n3p, device=dev).reshape(1, Np, Np, Np)).reshape(-1)
    ntri_b = ntri.reshape(6, -1)[:, cell_ids].T  # (n3p, 6) block-major cubes
    slots = torch.nonzero(torch.arange(2, device=dev) < ntri_b[..., None])[:max_faces]  # (cube, tet, slot)
    cube, tet, slot = cell_ids[slots[:, 0]], slots[:, 1], slots[:, 2]
    ci, cj, ck = cube // (Np * Np), (cube // Np) % Np, cube % Np
    fcase = case.reshape(6, -1)[tet, cube]
    corners = torch.zeros((3, max_faces), dtype=torch.int32, device=dev)
    for c in range(3):
        se = tri_table[tet, fcase, slot, c]
        anchor = edge_anchor[tet, se]
        g = edge_class[tet, se] * n3p + ((ci + anchor[:, 0]) * Np + cj + anchor[:, 1]) * Np + ck + anchor[:, 2]
        corners[c, : len(slots)] = vid[g].to(torch.int32)

    per_cube = ntri.sum(dim=0).reshape(-1)
    i32 = lambda x: x.to(torch.int32)  # noqa: E731
    return MTResult(
        pos[0], pos[1], pos[2], corners[0], corners[1], corners[2],
        i32(flat_mask.sum()), i32(per_cube.sum()), i32(_to_blocks(masks).any(dim=1).sum()),
        i32((per_cube[cell_ids].reshape(-1, BS**3).sum(dim=1) > 0).sum()), i32((per_cube > 0).sum()),
    )


MAX_CUBE_TRIS = 12  # six tets, up to two triangles each


def cube_tables() -> Tuple[np.ndarray, np.ndarray]:
    """K11's per-cube tables from the per-tet ones: for each of the 256
    occupancy bytes of a cube's corners (bit c: corner (c & 1, c >> 1 & 1,
    c >> 2 & 1)), its triangle count (256,) and its triangles (256, 12, 3)
    in (tet, slot) order, each corner an edge code class * 8 + the anchor
    corner's bit index (-1 past the count)."""
    edge_class, edge_anchor, tri_table, tri_count, tet_corners = build_tet_tables()
    corner = lambda p: int(p[0]) + 2 * int(p[1]) + 4 * int(p[2])  # noqa: E731
    count = np.zeros(256, np.int32)
    tris = np.full((256, MAX_CUBE_TRIS, 3), -1, np.int32)
    for cube in range(256):
        out = []
        for tet in range(6):
            case = sum(((cube >> corner(tet_corners[tet, bit])) & 1) << bit for bit in range(4))
            for s in range(tri_count[tet, case]):
                out.append([8 * edge_class[tet, se] + corner(edge_anchor[tet, se]) for se in tri_table[tet, case, s]])
        count[cube] = len(out)
        tris[cube, : len(out)] = np.reshape(out, (-1, 3))
    return count, tris


_TABLES = {}


def _cube_tables_on(device) -> torch.Tensor:
    """K11's tables on ``device``, uploaded once per device: int32
    [count (256)][triangles (256 * 12 * 3)]."""
    key = (device.type, device.index)
    if key not in _TABLES:
        count, tris = cube_tables()
        _TABLES[key] = torch.from_numpy(np.concatenate([count, tris.ravel()])).to(device)
    return _TABLES[key]


def k11_scratch(N: int) -> dict:
    """Element counts of kernel K11's scratch for an N^3 lattice padded to
    Np = 8 ceil(N / 8) (NB 8^3 blocks): int32 ``cutbits`` and ``word_base``
    (7 Np^2 ceil(Np / 32) words: each (class, x, y) row's cut flags along z,
    and their scanned bases), uint8 ``cases`` (a cube's corner byte, Np^3),
    int32 ``blocks`` (9 NB: faces, active cubes and seven class flags per
    block) and ``fbase`` (NB), and the int32 ``zeroed`` words (the 5
    counters, the scan's tile counter, 2 pad words, then a u64 status word
    per tile of the scan's four segments: the cut words, the face counts,
    the active cubes and the class flags)."""
    Np = -(-N // BS) * BS
    NB = (Np // BS) ** 3
    words = 7 * Np * Np * (-(-Np // 32))
    tiles = sum(-(-n // _SCAN_TILE) for n in (words, NB, NB, 7 * NB))
    return {"cutbits": words, "word_base": words, "cases": Np**3, "blocks": 9 * NB, "fbase": NB,
            "status_tiles": tiles, "zeroed": 8 + 2 * tiles}


def _k11_fn():
    fn = kernels.load("marching_tets").marching_tets_fwd  # the library of the sources in use (kernels.sources_from)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def marching_tets(
    sdf: torch.Tensor,
    deform_x: Optional[torch.Tensor],
    deform_y: Optional[torch.Tensor],
    deform_z: Optional[torch.Tensor],
    resolution: int,
    max_verts: int,
    max_faces: int,
) -> MTResult:
    """sdf and the raw offsets (or None): (N, N, N) or flat (N^3,) f32 over
    the (res+1)^3 lattice, x-major -> ``MTResult`` (see the module
    docstring). Kernel K11 on a CUDA ``sdf`` (the offsets on the same
    device), its plain version on a CPU one. Nothing here waits for the
    device (after the tables' first upload to it)."""
    if not sdf.is_cuda:
        return marching_tets_plain(sdf, deform_x, deform_y, deform_z, resolution, max_verts, max_faces)
    N = lattice_size(resolution)
    if max_verts < 1 or max_faces < 1:
        raise ValueError(f"capacities must be positive, got {max_verts} and {max_faces}")
    Np = -(-N // BS) * BS
    if Np**3 >= 2**31:
        raise ValueError(f"the MT kernel indexes the lattice with 32-bit ints: resolution {resolution} is too large")
    inputs = []
    for name, t in (("sdf", sdf), ("deform_x", deform_x), ("deform_y", deform_y), ("deform_z", deform_z)):
        t = _offsets(t, sdf)
        if t.device != sdf.device or t.dtype != torch.float32 or t.numel() != N**3:
            raise ValueError(f"{name}: the MT kernel takes {N}^3 f32 values on {sdf.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
        inputs.append(t.reshape(-1).contiguous())  # scalar loads only: a view is read as it lies
    dev = sdf.device
    # the kernel writes every row: the live ones, then zeros past the counts
    pos = torch.empty((3, max_verts), dtype=torch.float32, device=dev)
    corners = torch.empty((3, max_faces), dtype=torch.int32, device=dev)
    size = k11_scratch(N)
    # the counters, the scan's tile counter and status words, zeroed on the stream
    zeroed = torch.zeros(size["zeroed"], dtype=torch.int32, device=dev)
    scratch = [torch.empty(size[name], dtype=torch.uint8 if name == "cases" else torch.int32, device=dev)
               for name in ("cutbits", "word_base", "cases", "blocks", "fbase")]
    num_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # 1/res as the plain version's f32 arithmetic rounds it (ctypes rounds
    # the double to f32)
    err = _k11_fn()(
        *(t.data_ptr() for t in inputs), _cube_tables_on(dev).data_ptr(), pos.data_ptr(), corners.data_ptr(),
        zeroed.data_ptr(), *(t.data_ptr() for t in scratch), N, max_verts, max_faces, size["status_tiles"], num_sms,
        1.0 / resolution, torch.cuda.current_stream(dev).cuda_stream,
    )
    kernels.check(err, "marching_tets_fwd")
    marching_tets.launches += 1
    return MTResult(pos[0], pos[1], pos[2], corners[0], corners[1], corners[2], *zeroed[:5].unbind())


marching_tets.launches = 0


def marching_tets_host(
    sdf: np.ndarray,
    deform: Optional[np.ndarray],
    resolution: int,
    max_verts: int = 0,
    max_faces: int = 0,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Host wrapper: sdf (N^3,), deform (N^3, 3) or None -> verts in [0, 1]
    (nv, 3) f32 and faces (nf, 3) int32, sliced to the exact counts.
    ``device`` defaults to the card (K11); an overflow is retried with
    doubled capacities, never truncated."""
    dev = resolve_device(device)
    N = lattice_size(resolution)
    if max_verts <= 0:
        max_verts = 32 * N * N
    if max_faces <= 0:
        max_faces = 64 * N * N
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)  # noqa: E731
    s = up(sdf)
    offs = [None] * 3 if deform is None else [up(deform[:, a]) for a in range(3)]
    while True:
        res = marching_tets(s, *offs, resolution, max_verts, max_faces)
        nv, nf = int(res.num_verts), int(res.num_faces)
        if nv <= max_verts and nf <= max_faces:
            break
        max_verts = max(2 * max_verts, nv)
        max_faces = max(2 * max_faces, nf)
    verts = res.verts[:nv].cpu().numpy()
    faces = res.faces[:nf].cpu().numpy()
    return verts, faces
