"""Batched asset farm over a device mesh, and the sharded extractions.

Counterpart of ``sculptmate_tpu/parallel/farm.py``, on the port's
single-controller mesh (``parallel/mesh.py``: one process driving a
``DeviceMesh`` of ``torch.device``; NCCL puts one rank on one card, so a
process group could not split anything on a one-card machine, where one
device named several times can):

- ``AssetFarm``: the batch (and each serving chunk) is split over the
  ``dp`` axis with ``torch.tensor_split``; each dp row runs its own TSR
  replica, made once in the constructor and shared where mesh devices
  repeat, and with ``tp_axis`` that row's backbone runs tensor-parallel
  over the row's devices (``ops/sharding.py``). Results come back in batch
  order. Without a mesh it is a one-device farm on ``device``.
  ``generate_batch_rgba`` is the serving loop: each chunk's matting, fused
  preprocess and encode are enqueued per dp shard, then every asset's
  extraction (``TSR.extract_mesh_async`` on the replica of its shard, on
  the TSR's path for ``mode``), and up to three chunks are in flight before
  the oldest is waited on and finished on the host
  (``TSR.extract_mesh_wait_all``). Nothing before that wait waits for the
  device. ``mode="packed"`` returns one batched ``MCResult`` of device
  tensors in lattice coords (``TSR.packed_mesh`` per asset).
- ``sharded_density_grid``, ``sharded_extract`` and
  ``sharded_extract_wire``: the high-resolution extraction over x-slabs of
  the lattice on the ``sp`` axis. Each shard evaluates its ``slab + 1``
  rows (its own and its neighbour's first, recomputed, the last shard's
  clamped to the lattice's last row) with K2 on those rows of the whole
  lattice's first-layer partials, pads x to a multiple of 8,
  and runs K10 (or K3) with an x limit that keeps the halo's cells out;
  every shard is dispatched before any is waited on, and the host welds
  the seams by edge identity: a halo row's cut edges are the next shard's
  first row's (``_seam_weld``).

Each stage of the farm's front runs inside a ``torch.profiler`` span
(``farm.matting``, ``farm.preprocess``; the encode is the TSR's own
``tsr.scene_codes``), beside the TSR's other ``tsr.*`` spans.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from sculptmate_tpu_torch.frontend.matting import U2NET_SIZE
from sculptmate_tpu_torch.frontend.preprocess import preprocess_batch_device
from sculptmate_tpu_torch.geometry import mc_wire
from sculptmate_tpu_torch.geometry.marching_cubes import BS, N_WIRE_COUNTS, MCResult, marching_cubes, mc_wire_device
from sculptmate_tpu_torch.ops.density_grid import DensityGridSpec, Weights, density_mlp, first_layer_partials
from sculptmate_tpu_torch.ops.resize import resize_bilinear_antialias
from sculptmate_tpu_torch.parallel.mesh import DeviceMesh, make_mesh, replicate, shard_batch
from sculptmate_tpu_torch.runtime.device import canonical, device_scope, resolve_device
from sculptmate_tpu_torch.systems.tsr import packed_path, upload


class AssetFarm:
    """Batched Lean generation over the ``dp`` axis of ``mesh``, with the
    backbone tensor-parallel over ``tp_axis`` when given (the heads must
    split evenly over it, or the first encode raises ``ValueError``).

    ``tsr`` is a ``systems.tsr.TSR``. Without a mesh the farm runs on
    ``device``, which defaults to the card and must be the TSR's (pass
    ``device="cpu"`` for a TSR on the CPU); ``tp_axis`` then raises."""

    def __init__(self, tsr, mesh: Optional[DeviceMesh] = None, dp_axis: str = "dp", tp_axis: Optional[str] = None,
                 device=None):
        if mesh is None:
            if tp_axis is not None:
                raise ValueError("tp_axis needs a mesh with that axis: AssetFarm(tsr, mesh, tp_axis=...)")
            device = resolve_device(device)
            if device != tsr.device:
                raise ValueError(f"the farm's device {device} is not the TSR's {tsr.device}")
            mesh = make_mesh((1,), (dp_axis,), devices=[device])
        elif device is not None:
            raise ValueError("a farm over a mesh takes its devices from the mesh, not from device=")
        groups = mesh.groups(dp_axis, tp_axis)
        self.tsr, self.mesh, self.dp_axis = tsr, mesh, dp_axis
        self.device = groups[0][0]
        self._replicas = replicate([g[0] for g in groups], tsr)
        self._tp = [g if tp_axis is not None else None for g in groups]

    def _tsr_on(self, device):
        return self._replicas[canonical(device)]

    def _split(self, x: torch.Tensor) -> List[Tuple[int, torch.Tensor]]:
        """(shard, part) for each dp shard with at least one row of ``x``."""
        return [(s, p) for s, p in enumerate(shard_batch(self.mesh, x, self.dp_axis)) if len(p)]

    def _encode(self, images) -> List[Tuple[int, torch.Tensor]]:
        x = upload(images, self.device)
        return [(s, self._tsr_on(p.device).scene_codes(p, self._tp[s])) for s, p in self._split(x)]

    def generate_batch(
        self,
        images,
        resolution: int = 256,
        threshold: float = 25.0,
        max_verts: int = 0,
        max_faces: int = 0,
        mode: Optional[str] = None,
        has_vertex_color: bool = False,
    ):
        """Cond images (B, S, S, 3), split over dp -> a list of (verts,
        faces, colors | None) numpy triples in world coords, like
        ``TSR.extract_mesh`` (``mode`` None or "wire": the TSR's paths, see
        ``systems.tsr.packed_path``); with ``mode="packed"`` one ``MCResult``
        of (B, mv) and (B, mf) tensors (see ``extract_batch_packed``)."""
        packed_path(mode, self.device, max_faces)  # raises before any work
        parts = self._encode(images)
        if mode == "packed":
            return self._packed(parts, resolution, threshold, max_verts, max_faces)
        return self.extract_batch_wire_wait(self._extract_async(parts, resolution, threshold, max_verts, max_faces,
                                                                has_vertex_color, mode))

    def extract_batch_packed(
        self, codes, resolution: int = 256, threshold: float = 25.0, max_verts: int = 0, max_faces: int = 0
    ) -> MCResult:
        """Packed extraction of a batch of codes (B, 3, C, H, W), split over
        dp: each asset's density grid and K10 on its shard's device -> one
        ``MCResult`` on the farm's first device whose fields have a leading
        batch dimension: (B, mv) f32 lattice positions, (B, mf) int32
        faces, (B,) int32 counters. Capacities default to the K10 path's
        (``TSR.packed_mesh``); rows past them are dropped and the counters
        stay exact, so the caller sees an overflow."""
        return self._packed(self._split(codes), resolution, threshold, max_verts, max_faces)

    def _packed(self, parts, resolution, threshold, max_verts, max_faces) -> MCResult:
        results = []
        for _, codes in parts:
            tsr = self._tsr_on(codes.device)
            with device_scope(codes.device):
                results += [tsr.packed_mesh(code, resolution, float(threshold), max_verts, max_faces) for code in codes]
        stack = lambda field: torch.stack([f.to(self.device, non_blocking=True) for f in field])  # noqa: E731
        return MCResult(*(None if field[0] is None else stack(field) for field in zip(*results)))  # edges: None

    def extract_batch_wire(
        self, codes, resolution: int = 256, threshold: float = 25.0, max_verts: int = 0,
        has_vertex_color: bool = False,
    ):
        """Extraction of a batch of codes (B, 3, C, H, W), split over dp, on
        the TSR's default path -> a list of (verts (nv, 3) f32 world, faces
        (nf, 3) i64, colors (nv, 3) f32 | None)."""
        return self.extract_batch_wire_wait(
            self.extract_batch_wire_async(codes, resolution, threshold, max_verts, has_vertex_color)
        )

    def extract_batch_wire_async(
        self, codes, resolution: int = 256, threshold: float = 25.0, max_verts: int = 0,
        has_vertex_color: bool = False,
    ):
        """Enqueue every asset's extraction and host copy, each on its dp
        shard (``TSR.extract_mesh_async`` on its default path); the handles,
        in batch order, for ``extract_batch_wire_wait``."""
        return self._extract_async(self._split(codes), resolution, threshold, max_verts, 0, has_vertex_color, None)

    def _extract_async(self, parts, resolution, threshold, max_verts, max_faces, has_vertex_color, mode):
        handles = []
        for _, codes in parts:
            tsr = self._tsr_on(codes.device)
            with device_scope(codes.device):
                handles += [tsr.extract_mesh_async(code, has_vertex_color, resolution, threshold, max_verts,
                                                   max_faces, mode) for code in codes]
        return handles

    def extract_batch_wire_wait(self, handles):
        """Wait for and finish each handle in order on the host
        (``TSR.extract_mesh_wait_all``)."""
        return self.tsr.extract_mesh_wait_all(handles)

    def _prep_cond(self, rgba: torch.Tensor, matting, ratio: float) -> torch.Tensor:
        """Matting and the fused preprocess of (B, H, W, 4) RGBA on its
        device -> (B, S, S, 3) cond images; nothing here waits for it. The
        matting runs on its own device and its mask comes back."""
        H, W = rgba.shape[1:3]
        if matting is not None:
            # antialiased bilinear with half-pixel centers: the counterpart
            # of jax.image.resize(..., "linear") both ways
            with record_function("farm.matting"):
                small = resize_bilinear_antialias(rgba[..., :3], U2NET_SIZE, U2NET_SIZE)
                mask = matting.predict_mask_batch(small).to(rgba.device, non_blocking=True)
                alpha = resize_bilinear_antialias(mask[..., None], H, W)
                rgba = torch.cat([rgba[..., :3], alpha], dim=-1)
        with record_function("farm.preprocess"):
            size = self.tsr.config.cond_image_size
            return preprocess_batch_device(rgba, ratio=ratio, out_size=size)

    def _front(self, rgba: torch.Tensor, matting, ratio: float, tp=None) -> torch.Tensor:
        """Matting, preprocess and encode of one chunk on its device (the
        replica there, its backbone over the tp group ``tp``) -> scene codes."""
        with device_scope(rgba.device):
            cond = self._prep_cond(rgba, matting, ratio)
            return self._tsr_on(rgba.device).scene_codes(cond, tp)

    def generate_batch_rgba(
        self,
        rgba,
        matting=None,
        ratio: float = 0.75,
        resolution: int = 256,
        threshold: float = 25.0,
        max_verts: int = 0,
        max_faces: int = 0,
        mode: Optional[str] = None,
        has_vertex_color: bool = False,
        chunk: Optional[int] = None,
    ):
        """The serving loop: raw (B, H, W, 4) RGBA in [0, 1] -> (optional)
        u2net matting -> fused preprocess -> encode -> extraction on the
        TSR's path for ``mode`` (None: K10 on the card, the wire on the CPU;
        "wire": K3 and the host's face rebuild anywhere), in ``chunk``-sized
        slices (default: the dp size, one asset per dp shard), each split
        over dp, with up to three chunks in flight, so chunk i's host copy
        and finish overlap the device work of the chunks after it. Returns a
        list of (verts, faces, colors | None) triples in batch order; with
        ``mode="packed"`` the whole batch's cond images go through
        ``generate_batch(mode="packed")`` (one ``MCResult``)."""
        packed_path(mode, self.device, max_faces)  # raises before any work
        rgba = upload(rgba, self.device)  # once, for the whole batch
        if mode == "packed":
            cond = torch.cat([self._prep_cond(p, matting, ratio).to(self.device) for _, p in self._split(rgba)])
            return self.generate_batch(cond, resolution, threshold, max_verts, max_faces, mode="packed")
        B = rgba.shape[0]
        dp = self.mesh.shape[self.dp_axis]
        chunk = chunk or dp
        if chunk % dp or B % chunk:
            raise ValueError(f"batch {B} must split into dp-divisible chunks (chunk={chunk}, dp={dp})")
        out, inflight = [], []
        for s in range(0, B, chunk):
            parts = [(i, self._front(p, matting, ratio, self._tp[i])) for i, p in self._split(rgba[s : s + chunk])]
            inflight.append(self._extract_async(parts, resolution, threshold, max_verts, max_faces, has_vertex_color,
                                                mode))
            if len(inflight) > 2:
                out.extend(self.extract_batch_wire_wait(inflight.pop(0)))
        for h in inflight:
            out.extend(self.extract_batch_wire_wait(h))
        return out


# -- the x-slab sharded extraction (the sp axis) --


def _slab_geometry(mesh: DeviceMesh, spec: DensityGridSpec, sp_axis: str):
    """(sp devices, slab rows per shard, rows with the halo padded to a
    multiple of 8)."""
    devices = [g[0] for g in mesh.groups(sp_axis)]
    R = spec.resolution
    if R % len(devices):
        raise ValueError(f"resolution {R} does not split over sp = {len(devices)}")
    slab = R // len(devices)
    return devices, slab, slab + 1 + (-(slab + 1)) % BS


def _slab_density(triplane, weights: Weights, spec: DensityGridSpec, s: int, slab: int, device,
                  partials: dict) -> torch.Tensor:
    """Shard s's activated density rows s slab .. s slab + slab (the last
    one its neighbour's first), each clamped to the lattice's last row ->
    (slab + 1, R, R) f32 on ``device``: K2 on those rows of the whole
    lattice's first-layer partials (``partials``: kept per device for the
    call), so that a row has the same bits in every slab that holds it and
    in the whole lattice (the partials' products on the card are not
    row-position-independent across shapes; K2 is)."""
    R = spec.resolution
    if device not in partials:
        w = [(W.to(device, non_blocking=True), b.to(device, non_blocking=True)) for W, b in weights]
        partials[device] = (w, first_layer_partials(triplane.to(device, non_blocking=True), w, spec))
    w, (A, B, C) = partials[device]
    rows = torch.clamp(s * slab + torch.arange(slab + 1, device=device), max=R - 1)
    return density_mlp(A[rows].contiguous(), B[:, rows].contiguous(), C, w, spec)


def _slab_level(triplane, weights, spec, threshold, s, slab, RXp, device, partials) -> torch.Tensor:
    """Shard s's level, its x rows padded with -1 (outside) to ``RXp``."""
    level = _slab_density(triplane, weights, spec, s, slab, device, partials) - threshold
    return F.pad(level, (0, 0, 0, 0, 0, RXp - (slab + 1)), value=-1.0)


def sharded_density_grid(
    mesh: DeviceMesh, triplane: torch.Tensor, weights: Weights, spec: DensityGridSpec, sp_axis: str = "sp"
) -> List[torch.Tensor]:
    """Grid-axis-sharded density evaluation for high resolutions: the
    (R, R, R) lattice as one (R / sp, R, R) x-slab per ``sp_axis`` device
    (K2 on each), on that device; ``mesh.gather`` joins them. The triplane
    and the decoder's weights are copied to each device (they are small)."""
    devices, slab, _ = _slab_geometry(mesh, spec, sp_axis)
    out, partials = [], {}
    for s, dev in enumerate(devices):
        with device_scope(dev):
            out.append(_slab_density(triplane, weights, spec, s, slab, dev, partials)[:slab])
    return out


def _seam_weld(shards, slab: int, R: int, RXp: int) -> Tuple[np.ndarray, np.ndarray]:
    """Join the x-slabs' meshes by edge identity. ``shards``: per shard, in
    x order, (verts (n, 3) f32 lattice coords with the slab's x origin
    added, faces (m, 3) int64 into them, edges (n,) int64 ascending: each
    vertex's cut edge in the shard's padded (RXp, R, R) lattice, as K10
    numbers them). Shard s keeps the vertices of its own rows (x < slab);
    the y and z cut edges of its halo row x = slab are shard s + 1's edges
    of row 0, the same cuts at the same positions (the row has the same
    bits in both), and each face corner on one takes that vertex. The last
    shard's halo row (the lattice's last row again) is used by no face, as
    its x limit keeps its cells out. Vertices inside a shard are never
    merged, so coincident vertices of different edges (a cut at a lattice
    point where the level is exactly 0) stay apart, as in the whole
    lattice's mesh. Returns the vertices in the whole lattice's K10 order
    (axis-major, then flat x-major) and the faces in shard order."""
    plane, n3, n_sp = R * R, RXp * R * R, len(shards)
    # per shard and axis: where its vertices start, where the halo row's start
    axis_at = [np.searchsorted(e, np.arange(4) * n3) for _, _, e in shards]
    halo_at = [np.searchsorted(e, np.arange(3) * n3 + slab * plane) for _, _, e in shards]
    if any(h[0] != a[1] for a, h in zip(axis_at, halo_at)):
        raise RuntimeError("an x-cut edge of a halo row (the x limit was not the slab's)")
    kept = np.array([[h[a] - at[a] for a in range(3)] for at, h in zip(axis_at, halo_at)])  # (sp, 3)
    base = (np.cumsum(kept.T.ravel()) - kept.T.ravel()).reshape(3, n_sp)  # axis-major, then shard
    verts = np.empty((int(kept.sum()), 3), np.float32)
    remaps = []
    for s, (v, _, _) in enumerate(shards):
        remap = np.full(len(v), -1, np.int64)
        for a in range(3):
            lo, hi, b = axis_at[s][a], halo_at[s][a], base[a, s]
            verts[b : b + hi - lo] = v[lo:hi]
            remap[lo:hi] = np.arange(b, b + hi - lo)
        remaps.append(remap)
    for s in range(n_sp - 1):
        e, e1 = shards[s][2], shards[s + 1][2]
        for a in (1, 2):
            halo = slice(halo_at[s][a], axis_at[s][a + 1])
            row0 = slice(axis_at[s + 1][a], np.searchsorted(e1, a * n3 + plane))
            if not np.array_equal(e[halo] - slab * plane, e1[row0]):
                raise RuntimeError(f"the seam between shards {s} and {s + 1} has different cut edges on its two sides")
            remaps[s][halo] = remaps[s + 1][row0]
    faces = np.concatenate([remap[f] for remap, (_, f, _) in zip(remaps, shards)])
    if (faces < 0).any():
        raise RuntimeError("a face uses a vertex of the last shard's halo row")
    return verts, faces


def sharded_extract(
    mesh: DeviceMesh,
    triplane: torch.Tensor,
    weights: Weights,
    spec: DensityGridSpec,
    threshold: float,
    sp_axis: str = "sp",
    max_verts_per_shard: int = 0,
    max_faces_per_shard: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """End-to-end grid-axis-sharded extraction for high resolutions: per
    x-slab on its ``sp_axis`` device the density (K2) and the packed
    marching cubes (K10) with the slab's x limit (its own rows; the last
    shard's last row is the lattice's boundary), every shard dispatched
    before any is read, then one copy per shard and the host weld of the
    seams by edge identity (``_seam_weld``). Returns (verts (N, 3) f32
    lattice coords, faces (M, 3) int64): the single-device
    ``marching_cubes`` mesh, its vertices in its order (positions within an
    f32 ulp: a shard adds its x origin to its own coordinates) and its
    faces (in its order too where the slab is a multiple of 8). A shard's
    overflow raises ``RuntimeError``."""
    devices, slab, RXp = _slab_geometry(mesh, spec, sp_axis)
    R, n_sp = spec.resolution, len(devices)
    mv = max_verts_per_shard if max_verts_per_shard > 0 else 16 * R * R // n_sp + 65536
    mf = max_faces_per_shard if max_faces_per_shard > 0 else 2 * mv
    packed, partials = [], {}
    for s, dev in enumerate(devices):
        with device_scope(dev):
            level = _slab_level(triplane, weights, spec, threshold, s, slab, RXp, dev, partials)
            res = marching_cubes(level, mv, mf, valid_x_limit=slab - 1 if s == n_sp - 1 else slab, return_edges=True)
            counts = torch.stack([res.num_verts, res.num_faces, res.num_active_blocks, res.num_active_cells])
            packed.append((res.vx + float(s * slab), res.vy, res.vz, res.faces, res.edges, counts.to(torch.int64)))
    shards = []
    for s, (vx, vy, vz, faces, edges, counts) in enumerate(packed):
        nv, nf, nblk, ncell = (int(c) for c in counts.cpu())
        if nv > mv or nf > mf:
            raise RuntimeError(
                f"sharded_extract capacity overflow on shard {s}: "
                f"nv={nv}/{mv} nf={nf}/{mf} blocks={nblk} cells={ncell}"
            )
        shards.append((torch.stack([vx[:nv], vy[:nv], vz[:nv]], dim=1).cpu().numpy(),
                       faces[:nf].cpu().numpy().astype(np.int64), edges[:nv].cpu().numpy()))
    return _seam_weld(shards, slab, R, RXp)


def sharded_extract_wire(
    mesh: DeviceMesh,
    triplane: torch.Tensor,
    weights: Weights,
    spec: DensityGridSpec,
    threshold: float,
    sp_axis: str = "sp",
    max_verts_per_shard: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """``sharded_extract`` over the wire format: each shard's K3 wire
    (occupancy bits and u16 t) with the slab's x limit, every shard
    dispatched before any is read; the host rebuilds each shard's faces and
    its vertices' edges with the same limit, puts the vertices in edge
    order and welds the seams by edge identity (``_seam_weld``). The
    result is ``sharded_extract``'s mesh in its vertex order, positions
    within a u16 t step, faces in the wire decoder's order."""
    devices, slab, RXp = _slab_geometry(mesh, spec, sp_axis)
    R, n_sp = spec.resolution, len(devices)
    mv = max_verts_per_shard if max_verts_per_shard > 0 else 16 * R * R // n_sp + 65536
    wires, partials = [], {}
    for s, dev in enumerate(devices):
        with device_scope(dev):
            level = _slab_level(triplane, weights, spec, threshold, s, slab, RXp, dev, partials)
            wires.append(mc_wire_device(level, mv, valid_x_limit=slab - 1 if s == n_sp - 1 else slab))
    shards = []
    for s, wire in enumerate(wires):
        wire = wire.cpu().numpy()
        nv, nblk = (int(c) for c in mc_wire.wire_counts(wire, N_WIRE_COUNTS))
        if nv > mv:
            raise RuntimeError(f"sharded_extract_wire capacity overflow on shard {s}: nv={nv}/{mv} blocks={nblk}")
        limit = slab - 1 if s == n_sp - 1 else slab
        verts, faces, _, _, edges = mc_wire.decode_wire(wire, (RXp, R, R), mv, has_colors=False,
                                                        valid_x_limit=limit, return_edges=True)
        verts[:, 0] += s * slab
        order = np.argsort(edges)  # block-major -> K10's edge order
        rank = np.empty_like(order)
        rank[order] = np.arange(len(order))
        shards.append((verts[order], rank[faces], edges[order]))
    return _seam_weld(shards, slab, R, RXp)
