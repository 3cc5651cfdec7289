"""What a driver of a Stable Fast 3D cell needs beside its loop: the
weights and the iso-level both sides get, and the judging of the window's
textured meshes (or the control's) against the plain reference
(``reference/sf3d.py``, numbers in ``reference/pro_judge.py``).

A driver hands in one function of its own, ``cond_images(ctx, ref,
indices)``: the reference's RGBA condition images of the photos
``indices``, a list of (1, H, W, 4) float tensors in [0, 1] on the device
(their sizes follow each photo's matte), worked out by ``ref`` (whose
matting precision the control lowers) from the photos alone.

An item the program produced carries ``cond`` (the RGBA condition image,
uint8), ``verts``, ``faces``, ``uvs``, the ``albedo`` and ``bump`` maps
and the ``roughness`` and ``metallic`` scalars, as ``SF3D.run_image``
returns them. The control's carries ``points`` (its raw vertices) in place
of a mesh, its ``vertex_count`` under the program's rule (``vertex_budget``:
the snap-weld, then the decimation's budget), and its own
``texels`` (``pro_judge.atlas_texels``' keys): it has no faces or atlas,
so it reads no ``winding_share`` or ``uv_range``.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch
import torch.nn.functional as F

from reference import sf3d as ref_sf3d
from reference.judge import worst
from reference.precision import control_precisions
from reference.pro_judge import (atlas_texels, bump_values, level_gradient, surface_numbers, texel_numbers,
                                 uv_range, winding_share)

# the program's vertex budget of "high" (SF3D's vertex_simplification_factor)
BUDGET_HIGH = 0.75


def vertex_budget(cfg: dict, level: torch.Tensor, raw: int) -> int:
    """The vertices the program's rule leaves of a raw surface of ``raw``
    vertices: the snap-weld's, decimated to at most the "high" budget of
    the raw count."""
    return min(ref_sf3d.welded_vertex_count(level, cfg["weld_eps"]), round(BUDGET_HIGH * raw))


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
    ctx.threshold = ctx.system.threshold(cfg, ctx.weights, cond_images(ctx, ref, [calibration])[0])
    ctx.reference_s += time.perf_counter() - t0
    ctx.log(f"threshold {ctx.threshold!r} (the reference's {ctx.reference_s:.3f} s, not set-up)")


def _model_view(c: dict, rgba: torch.Tensor) -> torch.Tensor:
    """An RGBA condition image as the model sees it, at the condition size."""
    s = c["cond_image_size"]
    return F.interpolate(rgba.float().permute(0, 3, 1, 2), size=(s, s), mode="bilinear", align_corners=False,
                         antialias=True).permute(0, 2, 3, 1)


def _generator(ctx, index: int) -> torch.Generator:
    return torch.Generator().manual_seed((ctx.seed * 0x9E3779B1 + index * 0x85EBCA6B) % (1 << 63))


def _as_tensor(a, ctx, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=ctx.device)


def judge(ctx, ref, index: int, produced: dict, cond_images) -> dict:
    """One request's numbers: ``produced`` against the reference ``ref`` on
    the same photo."""
    cfg, chk = ctx.config, ctx.traffic["check"]
    r = cfg["radius"]
    image = cond_images(ctx, ref, [index])[0]
    out = {}
    if "cond" in produced:
        mine = _as_tensor(produced["cond"], ctx)[None] / 255.0
        d = (_model_view(cfg, mine) - _model_view(cfg, image)).abs()
        out.update(cond_gap=float(d.max()), cond_mean_gap=float(d.mean()))
    code, rough, metal = ref.encode(image)
    density, offsets = ref.lattice(code)
    level = density - ctx.threshold
    ref_verts = ref_sf3d.raw_surface(level, offsets, r)
    budget = vertex_budget(cfg, level, ref_verts.shape[0])
    grid = (r, cfg["isosurface_resolution"], chk["surface_quantile"], chk["coverage_quantile"])
    if "points" in produced:  # the control: its raw vertices
        out.update(surface_numbers(ref_verts, budget, _as_tensor(produced["points"], ctx), produced["vertex_count"],
                                   *grid))
        texels = produced["texels"]
    else:
        verts = _as_tensor(produced["verts"], ctx)
        faces = _as_tensor(produced["faces"], ctx, torch.int64)
        corners = verts[faces]
        distinct = torch.unique(corners.reshape(-1, 3), dim=0)
        out.update(surface_numbers(ref_verts, budget, torch.cat([distinct, corners.mean(1)]), distinct.shape[0],
                                   *grid))
        out["winding_share"] = winding_share(level, r, corners)
        uvs = _as_tensor(produced["uvs"], ctx)
        out["uv_range"] = uv_range(uvs[faces])
        texels = atlas_texels(verts, faces, uvs, _as_tensor(produced["albedo"], ctx),
                              _as_tensor(produced["bump"], ctx), chk["texels"], _generator(ctx, index))
    if texels is None:
        out.update(albedo_gap=float("inf"), albedo_mean_gap=float("inf"), bump_mean_gap=float("inf"))
    else:
        out.update(texel_numbers(texels, *ref.surface(code, texels["points"])))
    out["material_gap"] = max(abs(produced["roughness"] - rough), abs(produced["metallic"] - metal))
    out["ref_vertices"] = ref_verts.shape[0]
    ctx.log(f"photo {index}: " + json.dumps(out))
    return out


def check(ctx, cond_images) -> dict:
    """The widest reading of each number over the window's sample."""
    ref = ctx.system.Reference(ctx.config, ctx.weights)
    items = ctx.keeper.items()
    out = worst(judge(ctx, ref, i, item, cond_images) for i, item in items)
    out["_sampled"] = len(items)
    return out


def _control_item(ctx, low, index: int, cond_images) -> dict:
    """The control's answer for photo ``index``: its condition image, its
    raw vertices with their count under the program's budget, and at a
    seeded sample of them its albedo and its perturbed normal, the latter
    as a bump value in a frame about its own surface normal."""
    cfg, chk = ctx.config, ctx.traffic["check"]
    r = cfg["radius"]
    image = cond_images(ctx, low, [index])[0]
    code, rough, metal = low.encode(image)
    density, offsets = low.lattice(code)
    level = density - ctx.threshold
    verts = ref_sf3d.raw_surface(level, offsets, r)
    pick = torch.randperm(verts.shape[0], generator=_generator(ctx, index))[: chk["texels"]].to(verts.device)
    points = verts[pick]
    albedo, perturbed = low.surface(code, points)
    n = -level_gradient(level, points, r)
    n = n / n.norm(dim=1, keepdim=True).clamp_min(1e-12)
    helper = torch.where((n[:, :1].abs() < 0.9), torch.tensor([1.0, 0.0, 0.0], device=n.device),
                         torch.tensor([0.0, 1.0, 0.0], device=n.device))
    t = torch.linalg.cross(helper, n)
    t = t / t.norm(dim=1, keepdim=True).clamp_min(1e-12)
    b = torch.linalg.cross(t, n)
    texels = {"points": points, "albedo": albedo, "bump": bump_values(perturbed, t, b, n), "tangent": t,
              "bitangent": b, "normal": n}
    return {"cond": (image[0] * 255.0).round().to(torch.uint8).cpu().numpy(), "points": verts.cpu().numpy(),
            "vertex_count": vertex_budget(cfg, level, verts.shape[0]), "texels": texels, "roughness": rough,
            "metallic": metal}


def control(ctx, indices, cond_images) -> dict:
    """The control in the program's place on the photos ``indices``: the
    reference one precision step below the configuration's."""
    ref = ctx.system.Reference(ctx.config, ctx.weights)
    low = ctx.system.Reference(ctx.config, ctx.weights, *control_precisions())
    return worst(judge(ctx, ref, i, _control_item(ctx, low, i, cond_images), cond_images) for i in indices)
