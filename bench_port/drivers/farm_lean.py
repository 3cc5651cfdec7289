"""A pipeline converting an image catalogue on the Lean model: a closed loop
over batches, one batch at a time.

Each batch is ``batch`` new seeded RGBA photos (``harness/photos.py``),
float in [0, 1] on the host, handed to ``AssetFarm(tsr)
.generate_batch_rgba`` with the u2net session, vertex colors, the
traffic's resolution and the configuration's iso-level, at dp 1 and the
default chunk (the farm keeps its own three chunks in flight). The window's
rate counts the assets whose mesh came back non-empty; an empty one counts
as failed.

``check`` holds a seeded sample of the window's assets, the largest mesh
among them, against the plain reference (``harness/mesh_check.py``): the
farm's device frontend (matting, fused crop, pad and Lanczos), the codes,
the lattice, the faces and the colors, worked out from the same photo and
weights.
"""

from __future__ import annotations

import time

import torch
from torch.profiler import record_function

from harness import mesh_check
from harness.photos import request_photos
from harness.sample import Keeper
from reference.frontend import matte_device, preprocess_device


def _rgba(ctx, indices) -> torch.Tensor:
    return request_photos(ctx.traffic["photo"], ctx.seed, indices, ctx.device).float() / 255.0


def cond_images(ctx, ref, indices) -> torch.Tensor:
    """The reference's condition images of photos ``indices``: the farm's
    device frontend, with the reference's own u2net."""
    with torch.no_grad():
        return preprocess_device(matte_device(_rgba(ctx, indices), ref.masks), ctx.traffic["ratio"],
                                 ctx.config["cond_image_size"])


def prepare(ctx) -> None:
    mesh_check.prepare(ctx, cond_images)


def check(ctx) -> dict:
    return mesh_check.check(ctx, cond_images)


def control(ctx, indices) -> dict:
    return mesh_check.control(ctx, indices, cond_images, with_cond=False)


def setup(ctx) -> None:
    from sculptmate_tpu_torch.parallel.farm import AssetFarm

    t, cfg = ctx.traffic, ctx.config
    prepare(ctx)
    ctx.program = ctx.system.build_program(cfg, ctx.weights, ctx.device)
    ctx.program["farm"] = AssetFarm(ctx.program["tsr"], device=ctx.device)
    for i in range(t["warmup_batches"]):
        _batch(ctx, -1 - i)
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)


def _indices(ctx, b: int):
    """Photo indices of batch ``b``; the warm-up's batches -1, -2, ... take
    indices below -1 (-1 is the calibration photo)."""
    n = ctx.traffic["loop"]["batch"]
    return [b * n + k for k in range(n)] if b >= 0 else [-2 - (-1 - b) * n - k for k in range(n)]


def _batch(ctx, b: int):
    t = ctx.traffic
    with record_function("bench.photo"):
        rgba = _rgba(ctx, _indices(ctx, b)).cpu().numpy()
    t0 = time.perf_counter()
    with record_function("bench.generate_batch_rgba"):
        meshes = ctx.program["farm"].generate_batch_rgba(
            rgba, matting=ctx.program["matting"], ratio=t["ratio"], resolution=t["resolution"],
            threshold=ctx.threshold, has_vertex_color=True)
    return meshes, time.perf_counter() - t0


def window(ctx, seconds: float) -> dict:
    """Batches one after another until ``seconds`` have passed; the last
    one started runs to its end, and the window with it."""
    keeper = Keeper(ctx.traffic["sample_assets"], ctx.seed)
    stats = {"attempted": 0, "failed": 0, "completed": 0, "batch_s": [], "verts": []}
    with record_function("bench.window"):
        start = time.perf_counter()
        b = 0
        while time.perf_counter() - start < seconds:
            meshes, sec = _batch(ctx, b)
            stats["batch_s"].append(sec)
            for i, (verts, faces, colors) in zip(_indices(ctx, b), meshes):
                stats["attempted"] += 1
                if len(verts) and len(faces):
                    stats["completed"] += 1
                    stats["verts"].append(len(verts))
                    keeper.offer(i, len(verts), {"verts": verts, "faces": faces, "colors": colors})
                else:
                    stats["failed"] += 1
            b += 1
        stats["window_s"] = time.perf_counter() - start
    ctx.keeper = keeper
    return stats
