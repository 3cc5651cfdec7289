"""Wire-format marching cubes on the device (plain torch).

Counterpart of ``sculptmate_tpu/geometry/marching_cubes.py:mc_wire_device``.
Faces are pure table logic on the occupancy field, so the device ships only
what the host cannot rebuild, as one uint8 buffer (order version 2):

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
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

BS = 8  # block side
N_WIRE_COUNTS = 2  # num_verts, n_vblocks


def _cut_masks(inside: torch.Tensor) -> torch.Tensor:
    """(3, RX, RY, RZ) per-axis cut-edge masks: edge (a, i, j, k) joins
    lattice point (i, j, k) to its +a neighbour."""
    m = torch.zeros((3,) + inside.shape, dtype=torch.bool, device=inside.device)
    m[0, :-1] = inside[:-1] != inside[1:]
    m[1, :, :-1] = inside[:, :-1] != inside[:, 1:]
    m[2, :, :, :-1] = inside[:, :, :-1] != inside[:, :, 1:]
    return m


def _to_blocks(m: torch.Tensor) -> torch.Tensor:
    """(3, RX, RY, RZ) -> (3 * NB, 512) rows in block-major order."""
    _, RX, RY, RZ = m.shape
    nbx, nby, nbz = RX // BS, RY // BS, RZ // BS
    m = m.reshape(3, nbx, BS, nby, BS, nbz, BS).permute(0, 1, 3, 5, 2, 4, 6)
    return m.reshape(3 * nbx * nby * nbz, BS**3)


def pack_bits_u8(flags: torch.Tensor) -> torch.Tensor:
    """(M,) bool, M % 8 == 0 -> (M/8,) uint8, bit b = element 8 i + b."""
    # bit weights made on the device: uploading a host list would wait for it
    w = (1 << torch.arange(8, dtype=torch.int32, device=flags.device)).to(torch.uint8)
    return (flags.reshape(-1, 8).to(torch.uint8) * w).sum(dim=1, dtype=torch.uint8)


def _u32_le_bytes(counts: torch.Tensor) -> torch.Tensor:
    shifts = torch.arange(0, 32, 8, device=counts.device)
    return ((counts.long()[:, None] >> shifts) & 0xFF).to(torch.uint8).reshape(-1)


def mc_wire_device(level: torch.Tensor, max_verts: int, color_fn: Optional[Callable] = None):
    """level (RX, RY, RZ) f32, ``level > 0`` inside, each dim a multiple of 8
    -> the (W,) uint8 wire, or ``(wire, colors (3 * max_verts,) uint8)``
    with ``color_fn``.

    ``color_fn(vx, vy, vz) -> (r, g, b)``: color query at the (max_verts,)
    vertex positions in lattice index coords (unused slots sit at the
    origin); returns rows in [0, 1], quantized here to uint8.
    """
    RX, RY, RZ = level.shape
    if RX % BS or RY % BS or RZ % BS:
        raise ValueError(f"lattice {tuple(level.shape)} must be a multiple of {BS} per axis")
    dev = level.device
    n3 = RX * RY * RZ
    nby, nbz = RY // BS, RZ // BS
    NB = (RX // BS) * nby * nbz

    inside = level > 0
    rows = _to_blocks(_cut_masks(inside))  # (3 NB, 512)
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
    flat = level.reshape(-1)
    l0 = flat[lin]
    l1 = flat[(lin + step).clamp(max=n3 - 1)]
    denom = l0 - l1
    t = torch.where(valid, (l0 / torch.where(denom == 0, 1.0, denom)).clamp(0.0, 1.0), 0.0)
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
    rgb = [torch.round(c * 255.0).clamp(0, 255).to(torch.uint8) for c in color_fn(vx, vy, vz)]
    return wire, torch.cat(rgb)

