"""What every driver of a mesh-making cell shares: the weights and the
iso-level both sides get, and the judging of the window's meshes (or the
control's) against the plain reference.

A driver hands in one function of its own, ``cond_images(ctx, ref,
indices)``: the reference's condition images of the photos ``indices``,
(B, H, W, 3) float in [0, 1] on the device, worked out by ``ref`` (whose
matting precision the control lowers) from the photos alone. Where the
program returns its condition image too, an item it produced carries it
as ``cond`` (uint8) and is compared with the reference's.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from reference.judge import (cut_edge_count, image_numbers, lattice_surface, lattice_vertices, mesh_numbers,
                             mesh_surface, surface_scale, worst)
from reference.precision import control_precisions


def prepare(ctx, cond_images) -> None:
    """The weights, and the iso-level from the reference's lattice of the
    calibration photo. The reference's seconds are kept apart
    (``ctx.reference_s``): they are not the program's set-up."""
    cfg = ctx.config
    ctx.weights = ctx.system.make_weights(cfg, ctx.device)
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    t0 = time.perf_counter()
    ref = ctx.system.Reference(cfg, ctx.weights)
    calibration = cfg["assumed"]["threshold_rule"]["calibration_image"]
    ctx.threshold = ctx.system.threshold(cfg, ctx.weights, cond_images(ctx, ref, [calibration]))
    ctx.reference_s += time.perf_counter() - t0
    ctx.log(f"threshold {ctx.threshold!r} (the reference's {ctx.reference_s:.3f} s, not set-up)")


def judge(ctx, ref, index: int, produced: dict, cond_images) -> dict:
    """One request's numbers: ``produced`` (``verts`` world, ``faces`` or a
    ``surface``, ``colors``, maybe ``cond``) against the reference ``ref``
    on the same photo."""
    R, r = ctx.traffic["resolution"], ctx.config["renderer"]["radius"]
    image = cond_images(ctx, ref, [index])
    out = {}
    if "cond" in produced:
        out.update(image_numbers(np.asarray(produced["cond"]) / 255.0, image[0].cpu().numpy()))
    code = ref.codes(image)[0]
    level = ref.lattice(code, R) - ctx.threshold
    verts = torch.as_tensor(np.ascontiguousarray(produced["verts"]), dtype=torch.float32, device=ctx.device)
    colors = torch.as_tensor(np.ascontiguousarray(produced["colors"]), dtype=torch.float32, device=ctx.device)
    pos = (verts + r) * ((R - 1) / (2 * r))
    surface = produced.get("surface")
    if surface is None:
        surface = mesh_surface(pos, torch.as_tensor(np.ascontiguousarray(produced["faces"])), level.shape)
    out.update(mesh_numbers(level, surface_scale(level), cut_edge_count(level), pos, colors, ref.colors(code, verts),
                            surface))
    return out


def check(ctx, cond_images) -> dict:
    """The widest reading of each number over the window's sample."""
    ref = ctx.system.Reference(ctx.config, ctx.weights)
    items = ctx.keeper.items()
    out = worst(judge(ctx, ref, i, item, cond_images) for i, item in items)
    out["_sampled"] = len(items)
    return out


def control(ctx, indices, cond_images, with_cond: bool) -> dict:
    """The control in the program's place on the photos ``indices``: the
    reference one precision step below the configuration's, its mesh the
    vertices of its own lattice with its own colors, and its faces the
    surface of that lattice (``lattice_surface``: the vector areas any
    triangles of its loops have)."""
    cfg = ctx.config
    ref = ctx.system.Reference(cfg, ctx.weights)
    low = ctx.system.Reference(cfg, ctx.weights, *control_precisions())
    R, r = ctx.traffic["resolution"], cfg["renderer"]["radius"]
    rows = []
    for i in indices:
        image = cond_images(ctx, low, [i])
        code = low.codes(image)[0]
        level = low.lattice(code, R) - ctx.threshold
        world = lattice_vertices(level) * (2 * r / (R - 1)) - r
        produced = {"verts": world.cpu().numpy(), "colors": low.colors(code, world).cpu().numpy(),
                    "surface": lattice_surface(level)}
        if with_cond:
            produced["cond"] = (image[0] * 255.0).round().to(torch.uint8).cpu().numpy()
        rows.append(judge(ctx, ref, i, produced, cond_images))
    return worst(rows)
