"""Wire-format marching tetrahedra on the device (kernel K7).

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
"""

from __future__ import annotations

import ctypes

import torch

from sculptmate_tpu_torch.geometry.marching_cubes import _SCAN_TILE, BS, _u32_le_bytes, pack_bits_u8
from sculptmate_tpu_torch.geometry.mt_tables import EDGE_DIRS
from sculptmate_tpu_torch.runtime import kernels

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
