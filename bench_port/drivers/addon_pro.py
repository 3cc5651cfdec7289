"""The add-on's Pro button, one user at a time (a closed loop, one client).

Each request is a new seeded photo (``harness/photos.py``), handed as a
PIL image to ``preprocess_image`` with ``use_alpha`` (u2net matting, crop,
pad: an RGBA image at the padded size) and then, as an array in [0, 1], to
``SF3D.run_image`` with the traffic's bake resolution, remesh and vertex
budget, textured, at the configuration's iso-level: ``addon/panel.py``'s
path through ``Fast3DGenerator.generate_mesh``, without the Blender import
and the GLB write. The latency runs from the image handed over to the
host arrays returned: the mesh, its UVs, the maps and their PNGs. A
request whose matte comes out empty (``preprocess_image`` returns None) or
whose mesh is empty counts as failed.

``check`` holds a seeded sample of the window's requests, the largest mesh
among them, against the plain reference (``harness/pro_check.py``): the
condition image, the mesh against the reference's raw marching-tets
surface, the atlas, the baked maps texel by texel and the materials,
worked out from the same photo and weights.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch
from torch.profiler import record_function

from harness import pro_check
from harness.photos import pool_entry, request_photo
from harness.sample import Keeper
from reference.frontend import preprocess_host


def _pil(ctx, index: int):
    from PIL import Image

    return Image.fromarray(request_photo(ctx.traffic["photo"], ctx.seed, index, ctx.device).cpu().numpy())


def cond_images(ctx, ref, indices):
    """The reference's RGBA condition images of photos ``indices``: the
    add-on's host frontend, with the reference's own u2net."""
    out = []
    for i in indices:
        cond = preprocess_host(_pil(ctx, i), ctx.traffic["ratio"], True, ref.masks)
        out.append(torch.from_numpy(np.asarray(cond, dtype=np.float32) / 255.0)[None].to(ctx.device))
    return out


def prepare(ctx) -> None:
    pro_check.prepare(ctx, cond_images)


def check(ctx) -> dict:
    return pro_check.check(ctx, cond_images)


def control(ctx, indices) -> dict:
    return pro_check.control(ctx, indices, cond_images)


def setup(ctx) -> None:
    t, cfg = ctx.traffic, ctx.config
    prepare(ctx)
    ctx.program = ctx.system.build_program(cfg, ctx.weights, ctx.device)
    for i in range(t["warmup_requests"]):
        _request(ctx, -2 - i)
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)


def _request(ctx, index: int) -> dict:
    """One request, timed from the photo handed over."""
    from sculptmate_tpu_torch.frontend.preprocess import preprocess_image

    t = ctx.traffic
    with record_function("bench.photo"):
        image = _pil(ctx, index)
    t0 = time.perf_counter()
    with record_function("bench.frontend"):
        cond = preprocess_image(image, ratio=t["ratio"], use_alpha=True, session=ctx.program["matting"])
    t1 = time.perf_counter()
    if cond is None:
        return {"ok": False, "latency_s": t1 - t0}
    with record_function("bench.run_image"):
        out = ctx.program["sf3d"].run_image(
            np.asarray(cond, dtype=np.float32)[None] / 255.0, bake_resolution=t["bake_resolution"],
            remesh=t["remesh"], vertex_simplification_factor=t["vertex_simplification_factor"],
            enable_texture=True, threshold=ctx.threshold)
    t2 = time.perf_counter()
    if out is None or len(out["faces"]) == 0:
        return {"ok": False, "latency_s": t2 - t0}
    return {"ok": True, "latency_s": t2 - t0, "frontend_s": t1 - t0, "cond": np.asarray(cond), **out}


def window(ctx, seconds: float) -> dict:
    """Requests one after another until ``seconds`` have passed; the last
    one started runs to its end, and the window with it."""
    keeper = Keeper(ctx.traffic["sample_requests"], ctx.seed)
    stats = {"attempted": 0, "failed": 0, "latencies_s": [], "frontend_ms": [], "verts": [], "faces": [],
             "requests": []}
    with record_function("bench.window"):
        start = time.perf_counter()
        i = 0
        while time.perf_counter() - start < seconds:
            r = _request(ctx, i)
            stats["attempted"] += 1
            stats["requests"].append([pool_entry(ctx.traffic["photo"], ctx.seed, i), len(r.get("faces", ())),
                                      round(r["latency_s"], 4)])
            if r["ok"]:
                stats["latencies_s"].append(r["latency_s"])
                stats["frontend_ms"].append(1e3 * r["frontend_s"])
                stats["verts"].append(len(r["verts"]))
                stats["faces"].append(len(r["faces"]))
                keeper.offer(i, len(r["faces"]), {
                    "cond": r["cond"], "verts": r["verts"], "faces": r["faces"], "uvs": r["uvs"],
                    "albedo": r["textures"]["albedo"], "bump": r["textures"]["bump"],
                    "roughness": r["roughness"], "metallic": r["metallic"]})
            else:
                stats["failed"] += 1
            i += 1
        stats["window_s"] = time.perf_counter() - start
    stats["completed"] = len(stats["latencies_s"])
    ctx.log("requests (pool entry, faces, seconds) " + json.dumps(stats["requests"]))
    ctx.keeper = keeper
    return stats
