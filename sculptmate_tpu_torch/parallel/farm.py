"""Batched asset farm on one card: raw RGBA in, meshes out.

Counterpart of ``sculptmate_tpu/parallel/farm.py:AssetFarm`` for a single
device: the JAX farm's ``dp`` mesh axis has size 1 here, so a chunk is one
asset by default. ``generate_batch_rgba`` is the serving loop: each
chunk's matting, fused preprocess and encode are enqueued, then its
extraction (``TSR.extract_mesh_async``, per asset, so the retry and
capacity policy is the TSR's own), and up to three chunks are in flight
before the oldest is waited on and decoded on the host. Nothing before that
wait waits for the device.

Each stage of the front runs inside a ``torch.profiler`` span
(``farm.matting``, ``farm.preprocess``, ``farm.encode``), beside the TSR's
``tsr.*`` spans.

``mode="packed"`` returns one batched ``MCResult`` of device tensors in
lattice coords, without colors, as the JAX farm does: each asset's density
grid (K2) and face-emitting marching cubes (K10), one after another on the
card where the JAX farm vmaps them.

Tensor parallelism (``tp_axis``) and the sharded extractions are
multi-device work, ROADMAP item 9, and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.profiler import record_function

from sculptmate_tpu_torch.frontend.matting import U2NET_SIZE
from sculptmate_tpu_torch.frontend.preprocess import preprocess_batch_device
from sculptmate_tpu_torch.geometry.marching_cubes import MCResult
from sculptmate_tpu_torch.ops.resize import resize_bilinear_antialias
from sculptmate_tpu_torch.runtime.device import resolve_device
from sculptmate_tpu_torch.systems.tsr import upload

_LATER = "is multi-device work, not ported yet (ROADMAP item 9)"
_MODES = ("wire", "packed")
_NO_MAX_FACES = (
    "max_faces is not applicable in wire mode (faces are rebuilt on the host from the wire counters)"
)


class AssetFarm:
    """Batched Lean generation on one card.

    ``tsr`` is a ``systems.tsr.TSR``; ``device`` defaults to the card and
    must be the TSR's (pass ``device="cpu"`` for a TSR on the CPU)."""

    def __init__(self, tsr, device=None, tp_axis: Optional[str] = None):
        if tp_axis is not None:
            raise NotImplementedError(f"tensor parallelism (tp_axis) {_LATER}")
        self.device = resolve_device(device)
        if self.device != tsr.device:
            raise ValueError(f"the farm's device {self.device} is not the TSR's {tsr.device}")
        self.tsr = tsr

    def generate_batch(
        self,
        images,
        resolution: int = 256,
        threshold: float = 25.0,
        max_verts: int = 0,
        max_faces: int = 0,
        mode: str = "wire",
        has_vertex_color: bool = False,
    ):
        """Cond images (B, S, S, 3) -> in wire mode a list of (verts, faces,
        colors | None) numpy triples in world coords, like
        ``TSR.extract_mesh``; in packed mode one ``MCResult`` of (B, mv) and
        (B, mf) tensors (see ``extract_batch_packed``)."""
        if mode not in _MODES:
            raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")
        if mode == "wire" and max_faces > 0:
            raise ValueError(_NO_MAX_FACES)
        codes = self.tsr.scene_codes(images)
        if mode == "packed":
            return self.extract_batch_packed(codes, resolution, threshold, max_verts, max_faces)
        return self.extract_batch_wire(codes, resolution, threshold, max_verts, has_vertex_color)

    def extract_batch_packed(
        self, codes, resolution: int = 256, threshold: float = 25.0, max_verts: int = 0, max_faces: int = 0
    ) -> MCResult:
        """Packed extraction of a batch of codes (B, 3, C, H, W): each
        asset's density grid and K10 on the card -> one ``MCResult`` whose
        fields have a leading batch dimension: (B, mv) f32 lattice positions,
        (B, mf) int32 faces, (B,) int32 counters. Capacities default to
        8 R^2 and 16 R^2; rows past them are dropped and the counters stay
        exact, so the caller sees an overflow."""
        mv = max_verts if max_verts > 0 else 8 * resolution * resolution
        mf = max_faces if max_faces > 0 else 16 * resolution * resolution
        results = [self.tsr._packed_mesh(code, resolution, float(threshold), mv, mf) for code in codes]
        return MCResult(*(torch.stack(field) for field in zip(*results)))

    def extract_batch_wire(
        self, codes, resolution: int = 256, threshold: float = 25.0, max_verts: int = 0,
        has_vertex_color: bool = False,
    ):
        """Wire extraction of a batch of codes (B, 3, C, H, W) -> a list of
        (verts (nv, 3) f32 world, faces (nf, 3) i64, colors (nv, 3) f32 |
        None)."""
        return self.extract_batch_wire_wait(
            self.extract_batch_wire_async(codes, resolution, threshold, max_verts, has_vertex_color)
        )

    def extract_batch_wire_async(
        self, codes, resolution: int = 256, threshold: float = 25.0, max_verts: int = 0,
        has_vertex_color: bool = False,
    ):
        """Enqueue every asset's extraction and host copy; the handles for
        ``extract_batch_wire_wait``."""
        return [
            self.tsr.extract_mesh_async(code, has_vertex_color, resolution, threshold, max_verts) for code in codes
        ]

    def extract_batch_wire_wait(self, handles):
        """Wait for and decode each handle in order. An overflow is
        re-extracted with a grown capacity, never truncated; the largest
        capacity and count of the batch go to the capacity cache."""
        out, nv_seen, mv = [], 0, 0
        for h in handles:
            mesh, (nv, mv_h) = self.tsr.extract_mesh_wait(h, store=False)
            nv_seen, mv = max(nv_seen, nv), max(mv, mv_h)
            out.append(mesh)
        if handles:
            self.tsr._wire_caps_store(handles[0].resolution, mv, nv_seen)
        return out

    def _prep_cond(self, rgba: torch.Tensor, matting, ratio: float) -> torch.Tensor:
        """Matting and the fused preprocess of (B, H, W, 4) RGBA on the
        device -> (B, S, S, 3) cond images; nothing here waits for it."""
        H, W = rgba.shape[1:3]
        if matting is not None:
            # antialiased bilinear with half-pixel centers: the counterpart
            # of jax.image.resize(..., "linear") both ways
            with record_function("farm.matting"):
                small = resize_bilinear_antialias(rgba[..., :3], U2NET_SIZE, U2NET_SIZE)
                mask = matting.predict_mask_batch(small)
                alpha = resize_bilinear_antialias(mask[..., None], H, W)
                rgba = torch.cat([rgba[..., :3], alpha], dim=-1)
        with record_function("farm.preprocess"):
            size = self.tsr.config.cond_image_size
            return preprocess_batch_device(rgba, ratio=ratio, out_size=size)

    def _front(self, rgba: torch.Tensor, matting, ratio: float) -> torch.Tensor:
        """Matting, preprocess and encode of one chunk -> scene codes."""
        cond = self._prep_cond(rgba, matting, ratio)
        with record_function("farm.encode"):
            return self.tsr.scene_codes(cond)

    def generate_batch_rgba(
        self,
        rgba,
        matting=None,
        ratio: float = 0.75,
        resolution: int = 256,
        threshold: float = 25.0,
        max_verts: int = 0,
        max_faces: int = 0,
        mode: str = "wire",
        has_vertex_color: bool = False,
        chunk: Optional[int] = None,
    ):
        """The serving loop: raw (B, H, W, 4) RGBA in [0, 1] -> (optional)
        u2net matting -> fused preprocess -> encode -> wire extraction, in
        ``chunk``-sized slices (default 1) with up to three chunks in
        flight, so chunk i's host copy and decode overlap the device work of
        the chunks after it. Returns a list of (verts, faces, colors | None)
        triples in batch order; in packed mode the whole batch's cond images
        go through ``generate_batch(mode="packed")`` (one ``MCResult``)."""
        if mode not in _MODES:
            raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")
        if mode == "packed":
            cond = self._prep_cond(upload(rgba, self.device), matting, ratio)
            return self.generate_batch(cond, resolution, threshold, max_verts, max_faces, mode="packed")
        if max_faces > 0:
            raise ValueError(_NO_MAX_FACES)
        B = rgba.shape[0]
        chunk = chunk or 1
        if B % chunk:
            raise ValueError(f"batch {B} must split into chunks of {chunk}")
        if matting is not None and matting.device != self.device:
            raise ValueError(f"matting runs on {matting.device}, the farm on {self.device}")
        rgba = upload(rgba, self.device)  # once, for the whole batch
        out, inflight = [], []
        for s in range(0, B, chunk):
            codes = self._front(rgba[s : s + chunk], matting, ratio)
            inflight.append(self.extract_batch_wire_async(codes, resolution, threshold, max_verts, has_vertex_color))
            if len(inflight) > 2:
                out.extend(self.extract_batch_wire_wait(inflight.pop(0)))
        for h in inflight:
            out.extend(self.extract_batch_wire_wait(h))
        return out


def sharded_density_grid(*args, **kwargs):
    """Grid-axis-sharded density evaluation: not ported (multi-device)."""
    raise NotImplementedError(f"sharded_density_grid {_LATER}")


def sharded_extract(*args, **kwargs):
    """Grid-axis-sharded packed extraction: not ported (multi-device)."""
    raise NotImplementedError(f"sharded_extract {_LATER}")


def sharded_extract_wire(*args, **kwargs):
    """Grid-axis-sharded wire extraction: not ported (multi-device)."""
    raise NotImplementedError(f"sharded_extract_wire {_LATER}")
