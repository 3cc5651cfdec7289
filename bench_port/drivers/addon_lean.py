"""The add-on's Lean button, one user at a time (a closed loop, one client).

Each request is a new seeded photo (``harness/photos.py``), handed as a
PIL image to ``preprocess_image`` (u2net matting, crop, pad, Lanczos to
1024^2) and then, as an array in [0, 1], to ``TSR.image_to_mesh`` with
vertex colors, at the traffic's resolution and the configuration's
iso-level: ``addon/panel.py``'s path through
``TripoGenerator.generate_mesh``, without the Blender import. The latency
runs from the image handed over to the host mesh arrays returned. A
request whose matte comes out empty (``preprocess_image`` returns None) or
whose mesh is empty counts as failed.

``check`` holds a seeded sample of the window's requests, the largest mesh
among them, against the plain reference (``harness/mesh_check.py``): the
condition image, and the mesh's vertices, faces and colors against the
reference's lattice and decoder worked out from the same photo and
weights.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from harness import mesh_check
from harness.photos import request_photo
from harness.sample import Keeper
from reference.frontend import preprocess_host


def _pil(ctx, index: int):
    from PIL import Image

    return Image.fromarray(request_photo(ctx.traffic["photo"], ctx.seed, index, ctx.device).cpu().numpy())


def _as_input(cond) -> np.ndarray:
    return np.asarray(cond, dtype=np.float32) / 255.0


def cond_images(ctx, ref, indices) -> torch.Tensor:
    """The reference's condition images of photos ``indices``: the add-on's
    host frontend, with the reference's own u2net."""
    conds = [_as_input(preprocess_host(_pil(ctx, i), ctx.traffic["ratio"], False, ref.masks)) for i in indices]
    return torch.from_numpy(np.stack(conds)).to(ctx.device)


def prepare(ctx) -> None:
    mesh_check.prepare(ctx, cond_images)


def check(ctx) -> dict:
    return mesh_check.check(ctx, cond_images)


def control(ctx, indices) -> dict:
    return mesh_check.control(ctx, indices, cond_images, with_cond=True)


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
        cond = preprocess_image(image, ratio=t["ratio"], use_alpha=False, session=ctx.program["matting"])
    t1 = time.perf_counter()
    if cond is None:
        return {"ok": False, "latency_s": t1 - t0, "frontend_s": t1 - t0}
    with record_function("bench.image_to_mesh"):
        verts, faces, colors = ctx.program["tsr"].image_to_mesh(
            _as_input(cond)[None], has_vertex_color=True, resolution=t["resolution"], threshold=ctx.threshold)
    t2 = time.perf_counter()
    return {"ok": len(verts) > 0 and len(faces) > 0, "latency_s": t2 - t0, "frontend_s": t1 - t0,
            "cond": np.asarray(cond), "verts": verts, "faces": faces, "colors": colors}


def window(ctx, seconds: float) -> dict:
    """Requests one after another until ``seconds`` have passed; the last
    one started runs to its end, and the window with it."""
    keeper = Keeper(ctx.traffic["sample_requests"], ctx.seed)
    stats = {"attempted": 0, "failed": 0, "latencies_s": [], "frontend_ms": [], "verts": []}
    with record_function("bench.window"):
        start = time.perf_counter()
        i = 0
        while time.perf_counter() - start < seconds:
            r = _request(ctx, i)
            stats["attempted"] += 1
            if r["ok"]:
                stats["latencies_s"].append(r["latency_s"])
                stats["frontend_ms"].append(1e3 * r["frontend_s"])
                stats["verts"].append(len(r["verts"]))
                keeper.offer(i, len(r["verts"]), {k: r[k] for k in ("cond", "verts", "faces", "colors")})
            else:
                stats["failed"] += 1
            i += 1
        stats["window_s"] = time.perf_counter() - start
    stats["completed"] = len(stats["latencies_s"])
    ctx.keeper = keeper
    return stats
