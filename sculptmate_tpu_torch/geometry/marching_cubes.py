"""Marching cubes on the device: the wire format (kernel K3) and the
face-emitting extraction (kernel K10).

Counterpart of ``sculptmate_tpu/geometry/marching_cubes.py``:
``mc_wire_device``, ``marching_cubes`` and ``marching_cubes_host`` (the
packed mesh sliced to the host, on the card by default). Each device
function routes to its kernel in ``csrc/marching_cubes.cu`` on a CUDA
tensor and to its plain version (``mc_wire_device_plain``,
``marching_cubes_plain``) on a CPU tensor.

The wire. Faces are pure table logic on the occupancy field, so the device
ships only what the host cannot rebuild, as one uint8 buffer (order
version 2):

    [occupancy bits  n3/8 B][t lo  mv B][t hi  mv B]
    [counts: num_verts, n_vblocks  4 B each, little-endian u32]

plus, with a color query, a separate [r][g][b] (mv B each) buffer, so the
host can decode the geometry before it reads the colors.

Occupancy bits are little-endian within each byte (bit b of byte i is lattice
point 8 i + b, x-major flat order). Vertices are the cut lattice edges,
numbered BLOCK-MAJOR: (axis, 8^3 block bi/bj/bk, in-block ox/oy/oz), each id
the exclusive prefix of the per-block cut counts plus the in-block rank. The
host decoder (``geometry/mc_wire.py``) re-derives the same order from the
bits. The buffer has ``max_verts`` slots; the counters are exact, so a
caller detects overflow (num_verts > max_verts) and retries with a larger
capacity, never decoding a truncated mesh. Nothing here syncs with the host.

The packed mesh (``MCResult``). Vertices are the cut edges numbered
axis-major, then in flat x-major (i, j, k) order; faces are emitted
block-major (8^3 blocks in (bx, by, bz) order, cells in (ox, oy, oz) order
within a block, then the table's triangles). At most ``max_verts`` and
``max_faces`` rows are written, the rest are zero, and the four counters are
exact. ``level > 0`` is inside; positions are lattice index coords; faces
are wound so normals point away from the inside. On request
(``return_edges``) the result's ``edges`` holds each vertex's cut edge, the
int64 ``a * RX * RY * RZ + (i * RY + j) * RZ + k`` of the edge from lattice
point (i, j, k) along axis a: the identity by which the sharded extraction
(``parallel/farm.py``) welds its seams, since two vertices of different
edges can share a position; else it is None.

The x limit (``valid_x_limit``, default -1 meaning RX - 1): cells and
x-cut edges at x >= the limit emit nothing, y and z cut edges are never
x-masked (a cell's +x face uses them). It is the JAX package's ``valid_x``
mask for the prefix ``arange(RX) < limit`` that its every caller passes:
an x-slab of the sharded extraction (``parallel/farm.py``) holds its
neighbour's first row as a halo, whose cells the neighbour emits.
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from sculptmate_tpu_torch.geometry.mc_tables import EDGE_AXIS, EDGE_OFFSET, build_tables
from sculptmate_tpu_torch.runtime import kernels
from sculptmate_tpu_torch.runtime.device import resolve_device

BS = 8  # block side
N_WIRE_COUNTS = 2  # num_verts, n_vblocks


class MCResult(NamedTuple):
    """Structure-of-arrays mesh with fixed capacities: (max_verts,) f32
    lattice positions, (max_faces,) int32 face corners, and 0-d int32
    counters (a leading batch dimension on each for a farm batch)."""

    vx: torch.Tensor
    vy: torch.Tensor
    vz: torch.Tensor
    fa: torch.Tensor
    fb: torch.Tensor
    fc: torch.Tensor
    num_verts: torch.Tensor
    num_faces: torch.Tensor
    num_active_blocks: torch.Tensor  # max(active (axis, block) pairs of cut edges, blocks with faces)
    num_active_cells: torch.Tensor  # cells that emit at least one face
    edges: Optional[torch.Tensor] = None  # (max_verts,) int64 cut edge per vertex, with return_edges

    @property
    def verts(self) -> torch.Tensor:
        return torch.stack([self.vx, self.vy, self.vz], dim=-1)

    @property
    def faces(self) -> torch.Tensor:
        return torch.stack([self.fa, self.fb, self.fc], dim=-1)


def _check_shape(level: torch.Tensor) -> None:
    if level.dim() != 3 or any(s % BS or s < BS for s in level.shape):
        raise ValueError(f"lattice {tuple(level.shape)} must be a multiple of {BS} per axis")


def _x_limit(level: torch.Tensor, valid_x_limit: int) -> int:
    RX = level.shape[0]
    limit = RX - 1 if valid_x_limit < 0 else valid_x_limit
    if limit > RX - 1:
        raise ValueError(f"valid_x_limit {valid_x_limit} past the last cell row {RX - 2} of {RX} rows")
    return limit


def _cut_masks(inside: torch.Tensor, limit: Optional[int] = None) -> torch.Tensor:
    """(3, RX, RY, RZ) per-axis cut-edge masks: edge (a, i, j, k) joins
    lattice point (i, j, k) to its +a neighbour; x-cut edges at i >= limit
    (default RX - 1) are dropped."""
    if limit is None:
        limit = inside.shape[0] - 1
    m = torch.zeros((3,) + inside.shape, dtype=torch.bool, device=inside.device)
    m[0, :limit] = inside[:limit] != inside[1 : limit + 1]
    m[1, :, :-1] = inside[:, :-1] != inside[:, 1:]
    m[2, :, :, :-1] = inside[:, :, :-1] != inside[:, :, 1:]
    return m


def _to_blocks(m: torch.Tensor) -> torch.Tensor:
    """(K, RX, RY, RZ) -> (K * NB, 512) rows in block-major order."""
    K, RX, RY, RZ = m.shape
    nbx, nby, nbz = RX // BS, RY // BS, RZ // BS
    m = m.reshape(K, nbx, BS, nby, BS, nbz, BS).permute(0, 1, 3, 5, 2, 4, 6)
    return m.reshape(K * nbx * nby * nbz, BS**3)


def _edge_t(flat: torch.Tensor, lin: torch.Tensor, step: torch.Tensor) -> torch.Tensor:
    """Interpolation parameter of the edges from flat point ``lin`` to
    ``lin + step``: clamp(l0 / (l0 - l1, or 1 where that is 0), 0, 1)."""
    l0 = flat[lin]
    l1 = flat[(lin + step).clamp(max=flat.numel() - 1)]
    denom = l0 - l1
    return (l0 / torch.where(denom == 0, 1.0, denom)).clamp(0.0, 1.0)


def pack_bits_u8(flags: torch.Tensor) -> torch.Tensor:
    """(M,) bool, M % 8 == 0 -> (M/8,) uint8, bit b = element 8 i + b."""
    # bit weights made on the device: uploading a host list would wait for it
    w = (1 << torch.arange(8, dtype=torch.int32, device=flags.device)).to(torch.uint8)
    return (flags.reshape(-1, 8).to(torch.uint8) * w).sum(dim=1, dtype=torch.uint8)


def _u32_le_bytes(counts: torch.Tensor) -> torch.Tensor:
    shifts = torch.arange(0, 32, 8, device=counts.device)
    return ((counts.long()[:, None] >> shifts) & 0xFF).to(torch.uint8).reshape(-1)


def _quantize_colors(color_fn, vx, vy, vz) -> torch.Tensor:
    rgb = [torch.round(c * 255.0).clamp(0, 255).to(torch.uint8) for c in color_fn(vx, vy, vz)]
    return torch.cat(rgb)


def mc_wire_device_plain(level: torch.Tensor, max_verts: int, color_fn: Optional[Callable] = None,
                         valid_x_limit: int = -1):
    """Plain version of kernel K3; ``mc_wire_device``'s arguments and
    result."""
    _check_shape(level)
    limit = _x_limit(level, valid_x_limit)
    RX, RY, RZ = level.shape
    dev = level.device
    nby, nbz = RY // BS, RZ // BS
    NB = (RX // BS) * nby * nbz

    inside = level > 0
    rows = _to_blocks(_cut_masks(inside, limit))  # (3 NB, 512)
    rows_i = rows.to(torch.int32)
    vcnt = rows_i.sum(dim=1, dtype=torch.int32)  # cut edges per block row
    vbase = torch.cumsum(vcnt, dim=0, dtype=torch.int32) - vcnt
    within = torch.cumsum(rows_i, dim=1, dtype=torch.int32) - rows_i
    num_verts = vcnt.sum(dtype=torch.int32)
    n_vblocks = (vcnt > 0).sum(dtype=torch.int32)

    # compaction: slot index (block-major) of each vertex id < max_verts;
    # ids past the capacity go to a sink slot that is dropped
    vid = (vbase[:, None] + within).reshape(-1)
    dst = torch.where(rows.reshape(-1) & (vid < max_verts), vid, max_verts).long()
    slot = torch.full((max_verts + 1,), -1, dtype=torch.long, device=dev)
    slot.scatter_(0, dst, torch.arange(rows.numel(), device=dev))
    slot = slot[:max_verts]
    valid = slot >= 0

    s = slot.clamp(min=0)
    row, col = s // BS**3, s % BS**3
    axis, blk = row // NB, row % NB
    i = (blk // (nby * nbz)) * BS + col // (BS * BS)
    j = ((blk // nbz) % nby) * BS + (col // BS) % BS
    k = (blk % nbz) * BS + col % BS
    lin = (i * RY + j) * RZ + k
    step = torch.where(axis == 0, RY * RZ, torch.where(axis == 1, RZ, 1))
    t = torch.where(valid, _edge_t(level.reshape(-1), lin, step), 0.0)
    t16 = torch.round(t * 65535.0).to(torch.int32)

    zero = torch.zeros((), device=dev)
    vx = torch.where(valid, i.float() + t * (axis == 0), zero)
    vy = torch.where(valid, j.float() + t * (axis == 1), zero)
    vz = torch.where(valid, k.float() + t * (axis == 2), zero)

    occ = pack_bits_u8(inside.reshape(-1))
    t_lo = (t16 & 0xFF).to(torch.uint8)
    t_hi = (t16 >> 8).to(torch.uint8)
    wire = torch.cat([occ, t_lo, t_hi, _u32_le_bytes(torch.stack([num_verts, n_vblocks]))])
    if color_fn is None:
        return wire
    return wire, _quantize_colors(color_fn, vx, vy, vz)


def _mc_lib(name: str, nargs_ptr: int, nargs_int: int):
    fn = getattr(kernels.load("marching_cubes"), name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * nargs_ptr + [ctypes.c_int] * nargs_int + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check_level(level: torch.Tensor, what: str) -> torch.Tensor:
    _check_shape(level)
    if level.dtype != torch.float32:
        raise TypeError(f"{what} kernel takes an f32 level, got {level.dtype}")
    if level.numel() >= 2**31:
        raise ValueError(f"{what} kernel indexes the lattice with 32-bit ints: {tuple(level.shape)} is too large")
    return kernels.aligned(level)


_SCAN_TILE = 2048  # counts per tile of the multi-block scan (csrc/scan.cuh: MS_TILE)


def k3_scratch(RX: int, RY: int, RZ: int) -> dict:
    """Element counts of kernel K3's scratch for an (RX, RY, RZ) lattice:
    ``masks`` (each 8^3 block's three 512-bit cut masks, 48 NB 32-bit
    words), ``vcnt`` and ``vbase`` (3 NB per-axis block counts and their
    scanned bases), and the int32 ``zeroed`` words (the 2 counters, the
    scan's tile counter, 1 pad word, then a u64 status word per tile of the
    scan of the 3 NB counts)."""
    NB = RX * RY * RZ // BS**3
    tiles = -(-3 * NB // _SCAN_TILE)
    return {"masks": 48 * NB, "vcnt": 3 * NB, "vbase": 3 * NB, "status_tiles": tiles, "zeroed": 4 + 2 * tiles}


def mc_wire_device(level: torch.Tensor, max_verts: int, color_fn: Optional[Callable] = None,
                   valid_x_limit: int = -1):
    """level (RX, RY, RZ) f32, ``level > 0`` inside, each dim a multiple of 8
    -> the (W,) uint8 wire, or ``(wire, colors (3 * max_verts,) uint8)``
    with ``color_fn``. Kernel K3 on a CUDA tensor, its plain version on a
    CPU tensor. ``valid_x_limit``: see the module docstring.

    ``color_fn(vx, vy, vz) -> (r, g, b)``: color query at the (max_verts,)
    vertex positions in lattice index coords (unused slots sit at the
    origin); returns rows in [0, 1], quantized here to uint8.
    """
    if not level.is_cuda:
        return mc_wire_device_plain(level, max_verts, color_fn, valid_x_limit)
    level = _check_level(level, "wire marching cubes")
    limit = _x_limit(level, valid_x_limit)
    if max_verts < 1:
        raise ValueError(f"max_verts must be positive, got {max_verts}")
    RX, RY, RZ = level.shape
    dev = level.device
    n3 = RX * RY * RZ
    wire = torch.zeros(n3 // 8 + 2 * max_verts + 4 * N_WIRE_COUNTS, dtype=torch.uint8, device=dev)
    pos = torch.zeros((3, max_verts), dtype=torch.float32, device=dev) if color_fn is not None else None
    size = k3_scratch(RX, RY, RZ)
    # the counters, the scan's tile counter and status words, zeroed on the stream
    zeroed = torch.zeros(size["zeroed"], dtype=torch.int32, device=dev)
    scratch = [torch.empty(size[name], dtype=torch.int32, device=dev) for name in ("masks", "vcnt", "vbase")]
    err = _mc_lib("mc_wire_fwd", 7, 6)(
        level.data_ptr(), wire.data_ptr(), None if pos is None else pos.data_ptr(), *(t.data_ptr() for t in scratch),
        zeroed.data_ptr(), RX, RY, RZ, limit, max_verts, size["status_tiles"],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    kernels.check(err, "mc_wire_fwd")
    mc_wire_device.launches += 1
    if color_fn is None:
        return wire
    return wire, _quantize_colors(color_fn, pos[0], pos[1], pos[2])


mc_wire_device.launches = 0


# -- the face-emitting extraction (kernel K10) --


def _tables_torch(device):
    """(tri_table (256, maxtri, 3) long, tri_count (256,) long, maxtri,
    edge_axis (12,) long, edge_offset (12, 3) long) on ``device``."""
    tri, cnt, maxtri = build_tables()
    as_t = lambda a: torch.from_numpy(np.asarray(a, np.int64)).to(device)  # noqa: E731
    return as_t(tri), as_t(cnt), maxtri, as_t(EDGE_AXIS), as_t(EDGE_OFFSET)


def marching_cubes_plain(level: torch.Tensor, max_verts: int, max_faces: int, valid_x_limit: int = -1,
                         return_edges: bool = False) -> MCResult:
    """Plain version of kernel K10: the packed mesh's semantics (see the
    module docstring), written as torch over the whole lattice;
    ``marching_cubes``'s arguments and result."""
    _check_shape(level)
    limit = _x_limit(level, valid_x_limit)
    RX, RY, RZ = level.shape
    dev = level.device
    n3 = RX * RY * RZ
    tri, tri_count, maxtri, edge_axis, edge_off = _tables_torch(dev)

    inside = level > 0
    masks = _cut_masks(inside, limit)  # (3, RX, RY, RZ)
    flat_mask = masks.reshape(-1)
    vid = torch.cumsum(flat_mask, 0) - 1  # axis-major, flat x-major order
    num_verts = flat_mask.sum()
    edges = torch.nonzero(flat_mask).reshape(-1)[:max_verts]
    axis, lin = edges // n3, edges % n3
    i, j, k = lin // (RY * RZ), (lin // RZ) % RY, lin % RZ
    step = torch.where(axis == 0, RY * RZ, torch.where(axis == 1, RZ, 1))
    t = _edge_t(level.reshape(-1), lin, step)
    pos = torch.zeros((3, max_verts), dtype=torch.float32, device=dev)
    n = len(edges)
    pos[0, :n] = i.float() + t * (axis == 0)
    pos[1, :n] = j.float() + t * (axis == 1)
    pos[2, :n] = k.float() + t * (axis == 2)

    # cell cases; cells on the +y and +z boundary and at x >= limit emit nothing
    pad = F.pad(inside.to(torch.int64), (0, 1, 0, 1, 0, 1))
    case = torch.zeros((RX, RY, RZ), dtype=torch.int64, device=dev)
    for c in range(8):
        ox, oy, oz = c & 1, (c >> 1) & 1, (c >> 2) & 1
        case += pad[ox : ox + RX, oy : oy + RY, oz : oz + RZ] << c
    ntri = tri_count[case]
    ntri[limit:], ntri[:, -1], ntri[:, :, -1] = 0, 0, 0
    # block-major cell order: blocks (bx, by, bz), cells (ox, oy, oz)
    cell_ids = _to_blocks(torch.arange(n3, device=dev).reshape(1, RX, RY, RZ)).reshape(-1)
    ntri_b = ntri.reshape(-1)[cell_ids]
    active = ntri_b > 0
    face_cell = torch.repeat_interleave(cell_ids[active], ntri_b[active])
    first = torch.cumsum(ntri_b, 0) - ntri_b
    slot = torch.arange(len(face_cell), device=dev) - torch.repeat_interleave(first[active], ntri_b[active])
    face_cell, slot = face_cell[:max_faces], slot[:max_faces]
    ci, cj, ck = face_cell // (RY * RZ), (face_cell // RZ) % RY, face_cell % RZ
    fcase = case.reshape(-1)[face_cell]
    corners = torch.zeros((3, max_faces), dtype=torch.int32, device=dev)
    for c in range(3):
        le = tri[fcase, slot, c]
        g = edge_axis[le] * n3 + ((ci + edge_off[le, 0]) * RY + cj + edge_off[le, 1]) * RZ + ck + edge_off[le, 2]
        corners[c, : len(le)] = vid[g].to(torch.int32)

    n_vblocks = _to_blocks(masks).any(dim=1).sum()
    n_fblocks = (ntri_b.reshape(-1, BS**3).sum(dim=1) > 0).sum()
    i32 = lambda x: x.to(torch.int32)  # noqa: E731
    return MCResult(
        pos[0], pos[1], pos[2], corners[0], corners[1], corners[2],
        i32(num_verts), i32(ntri.sum()), i32(torch.maximum(n_vblocks, n_fblocks)), i32(active.sum()),
        F.pad(edges, (0, max_verts - n)) if return_edges else None,
    )


_TABLES = {}


def _tables_packed(device) -> tuple:
    """K10's tables on ``device``, uploaded once per device: int32
    [tri_count (256)][tri_table (256 * maxtri * 3)][edge_axis (12)]
    [edge_offset (12 * 3)], and maxtri."""
    key = (device.type, device.index)
    if key not in _TABLES:
        tri, cnt, maxtri = build_tables()
        buf = np.concatenate([cnt.ravel(), tri.ravel(), EDGE_AXIS.ravel(), EDGE_OFFSET.ravel()]).astype(np.int32)
        _TABLES[key] = (torch.from_numpy(buf).to(device), maxtri)
    return _TABLES[key]


def k10_scratch(RX: int, RY: int, RZ: int) -> dict:
    """Element counts of kernel K10's scratch for an (RX, RY, RZ) lattice:
    int32 ``cutbits`` and ``word_base`` (3 RX RY ceil(RZ / 32) words: each
    (axis, x, y) row's cut flags along z, and their scanned bases), uint8
    ``cases`` (a case byte per cell), int32 ``blocks`` (5 NB: faces, active
    cells, three axis flags per 8^3 block) and ``fbase`` (NB), and the int32
    ``zeroed`` words (the 4 counters, the scan's tile counter, 3 pad words,
    then a u64 status word per tile of the scan's four segments: the cut
    words, the face counts, the active cells and the axis flags)."""
    nwords = -(-RZ // 32)
    NB = RX * RY * RZ // BS**3
    words = 3 * RX * RY * nwords
    tiles = sum(-(-n // _SCAN_TILE) for n in (words, NB, NB, 3 * NB))
    return {"cutbits": words, "word_base": words, "cases": RX * RY * RZ, "blocks": 5 * NB, "fbase": NB,
            "status_tiles": tiles, "zeroed": 8 + 2 * tiles}


def marching_cubes(level: torch.Tensor, max_verts: int, max_faces: int, valid_x_limit: int = -1,
                   return_edges: bool = False) -> MCResult:
    """level (RX, RY, RZ) f32, ``level > 0`` inside, each dim a multiple of
    8 -> ``MCResult`` (see the module docstring; ``valid_x_limit`` there),
    with ``return_edges`` its ``edges`` each vertex's cut edge, zero past
    the count. Kernel K10 on a CUDA tensor, its plain version on a CPU
    tensor. Nothing here waits for the device (after the tables' first
    upload to it)."""
    if not level.is_cuda:
        return marching_cubes_plain(level, max_verts, max_faces, valid_x_limit, return_edges)
    level = _check_level(level, "marching cubes")
    limit = _x_limit(level, valid_x_limit)
    if max_verts < 1 or max_faces < 1:
        raise ValueError(f"capacities must be positive, got {max_verts} and {max_faces}")
    RX, RY, RZ = level.shape
    dev = level.device
    tables, maxtri = _tables_packed(dev)
    pos = torch.zeros((3, max_verts), dtype=torch.float32, device=dev)
    edges = torch.zeros(max_verts, dtype=torch.int64, device=dev) if return_edges else None
    corners = torch.zeros((3, max_faces), dtype=torch.int32, device=dev)
    size = k10_scratch(RX, RY, RZ)
    # the counters, the scan's tile counter and status words, zeroed on the stream
    zeroed = torch.zeros(size["zeroed"], dtype=torch.int32, device=dev)
    scratch = {name: torch.empty(size[name], dtype=torch.uint8 if name == "cases" else torch.int32, device=dev)
               for name in ("cutbits", "word_base", "cases", "blocks", "fbase")}
    num_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    err = _mc_lib("marching_cubes_fwd", 11, 9)(
        level.data_ptr(), tables.data_ptr(), pos.data_ptr(), None if edges is None else edges.data_ptr(),
        corners.data_ptr(), zeroed.data_ptr(),
        *(scratch[name].data_ptr() for name in ("cutbits", "word_base", "cases", "blocks", "fbase")),
        RX, RY, RZ, limit, max_verts, max_faces, maxtri, size["status_tiles"], num_sms,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    kernels.check(err, "marching_cubes_fwd")
    marching_cubes.launches += 1
    return MCResult(pos[0], pos[1], pos[2], corners[0], corners[1], corners[2], *zeroed[:4].unbind(), edges)


marching_cubes.launches = 0


def marching_cubes_host(level, max_verts: int = 0, max_faces: int = 0, device=None):
    """Host wrapper: a (RX, RY, RZ) level (array or tensor, any sizes) ->
    (verts (nv, 3) f32 lattice coords, faces (nf, 3) int32), sliced to the
    exact counts. Each dim is padded with -1 (outside) to a multiple of 8.
    ``device`` defaults to the card (K10); an overflow is retried with
    doubled capacities, never truncated."""
    dev = resolve_device(device)
    level = torch.as_tensor(np.asarray(level, np.float32) if not torch.is_tensor(level) else level,
                            dtype=torch.float32).to(dev)
    pads = [(-int(s)) % BS for s in level.shape]
    if any(pads):
        level = F.pad(level, (0, pads[2], 0, pads[1], 0, pads[0]), value=-1.0)
    R = int(max(level.shape))
    if max_verts <= 0:
        max_verts = 32 * R * R
    if max_faces <= 0:
        max_faces = 64 * R * R
    while True:
        res = marching_cubes(level, max_verts, max_faces)
        nv, nf = int(res.num_verts), int(res.num_faces)
        if nv <= max_verts and nf <= max_faces:
            break
        max_verts = max(2 * max_verts, nv)
        max_faces = max(2 * max_faces, nf)
    return res.verts[:nv].cpu().numpy(), res.faces[:nf].cpu().numpy()
