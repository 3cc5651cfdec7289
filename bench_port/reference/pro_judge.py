"""Numbers that hold a decimated, unwrapped and baked mesh against the plain
reference of Stable Fast 3D (``reference/sf3d.py``).

The reference's own raw marching-tets surface (one vertex per cut tet edge
of its (res + 1)^3 lattice, deformed by its own vertex offsets) stands for
the surface. Distances are in the reference's lattice cells, Chebyshev, to
half a cell (``grid_distance``: a distance transform on a grid of half
cells, so that a mesh of millions of faces is held in a second):

- ``surface_gap``: a high quantile, over the mesh's vertices and face
  centroids, of the distance to the nearest reference vertex (a stray sheet
  or a shifted mesh shows);
- ``coverage_gap``: a lower quantile, over the reference's vertices, of
  the distance to the nearest corner or centroid of the mesh's faces (a
  dropped part shows; the lower quantile passes over the specks that the
  program's weld lets vanish and the thin sheets where the field lies so
  near the iso-level that bfloat16 moves them, a tenth of the reference's
  vertices on some photos with random weights);
- ``vertex_count_gap``: the mesh's distinct vertices against the vertex
  budget the program's rule gives the reference's raw count;
- ``winding_share``: the area share of the faces whose normal points up the
  reference level's gradient (into the inside, where level > 0);
- ``uv_range``: the largest distance of a UV outside [0, 1], or the share
  of faces with no UV area, whichever is larger.

The baked maps are held texel by texel: a seeded sample of the texels the
mesh's own UV atlas covers (texel x, y has its centre at u = x / (res - 1),
v = y / (res - 1); the lowest covering face wins, the published baker's
rule; texels within ``EDGE_MARGIN`` of a deciding edge are left out) is
located in its face, the face's world corners interpolated there,
and at that point the reference's albedo is set against the albedo texel
(``albedo_gap``, ``albedo_mean_gap``) and the reference's perturbed normal,
put into the face's tangent frame as the published bake composes the bump
map, against the bump texel (``bump_mean_gap``). ``material_gap``: the
roughness and metallic scalars against the reference's.

Imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

# (face, texel) candidates tested at once by the texel locator
_CANDIDATES = 1 << 22
# how far a texel must lie inside its face, and outside every lower face, in
# barycentrics, to be sampled (``locate_texels``)
EDGE_MARGIN = 0.01
# the published baker's test of a face that covers no texel: the Gram
# determinant of its UV edges (four times its squared UV area) under this
MIN_GRAM = 1e-12
# grid steps per lattice cell of the distance grids, and the farthest a
# distance is followed, in grid steps
GRID_SUB = 2
GRID_STEPS = 64


def grid_distance(sources: torch.Tensor, queries: torch.Tensor, radius: float, res: int) -> torch.Tensor:
    """For each of the (n, 3) world points ``queries``, the Chebyshev
    distance in lattice cells (1 / ``GRID_SUB`` steps, capped a step past
    ``GRID_STEPS``) from its cell to the nearest cell holding one of the
    (m, 3) world points ``sources``, on a grid of ``GRID_SUB`` cells per
    lattice cell over the bounding box [-radius, radius]^3 (points outside
    it count in its border cells)."""
    n = GRID_SUB * res + 1
    step = 2 * radius / (GRID_SUB * res)

    def cells(p):
        i = torch.floor((p.float() + radius) / step).long().clamp(0, n - 1)
        return (i[:, 0] * n + i[:, 1]) * n + i[:, 2]

    dev = queries.device
    dist = torch.full((n ** 3,), GRID_STEPS + 1, dtype=torch.uint8, device=dev)
    reached = torch.zeros(n ** 3, device=dev)
    reached[cells(sources)] = 1.0
    dist[reached > 0] = 0
    reached = reached.view(1, 1, n, n, n)
    for k in range(1, GRID_STEPS + 1):
        reached = torch.nn.functional.max_pool3d(reached, 3, 1, 1)
        dist[(reached.flatten() > 0) & (dist > GRID_STEPS)] = k
    return dist[cells(queries)].float() / GRID_SUB


def _quantile(x: torch.Tensor, q: float) -> float:
    if x.numel() == 0:
        return float("inf")
    return float(torch.quantile(x.double()[: 1 << 24], q))


def surface_numbers(ref_verts: torch.Tensor, budget: int, points: torch.Tensor, vertex_count: int,
                    radius: float, res: int, q_surface: float, q_coverage: float) -> Dict[str, float]:
    """``ref_verts`` the reference's raw vertices (world), ``budget`` its
    vertex budget; ``points`` the distinct corners and the centroids of the
    mesh's faces, ``vertex_count`` its distinct vertices; distances in the
    reference's lattice cells (``grid_distance``)."""
    out = {"vertex_count_gap": abs(vertex_count - budget) / max(budget, 1)}
    if points.shape[0] == 0 or ref_verts.shape[0] == 0:
        return {**out, "surface_gap": float("inf"), "coverage_gap": float("inf")}
    near = grid_distance(ref_verts, points, radius, res)
    cover = grid_distance(points, ref_verts, radius, res)
    return {**out, "surface_gap": _quantile(near, q_surface), "surface_max_gap": float(near.max()),
            "coverage_gap": _quantile(cover, q_coverage), "coverage_max_gap": float(cover.max())}


def _trilinear(field: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(K, X, Y, Z) at (n, 3) lattice coordinates (clamped inside) -> (n, K)."""
    hi = torch.tensor(field.shape[1:], device=p.device, dtype=torch.float32) - 1
    p = torch.minimum(p.clamp(min=0.0), hi)
    i0 = torch.minimum(p.floor(), hi - 1).long()
    f = p - i0.float()
    out = torch.zeros((p.shape[0], field.shape[0]), device=p.device)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = ((f[:, 0] if dx else 1 - f[:, 0]) * (f[:, 1] if dy else 1 - f[:, 1])
                     * (f[:, 2] if dz else 1 - f[:, 2]))
                out += w[:, None] * field[:, i0[:, 0] + dx, i0[:, 1] + dy, i0[:, 2] + dz].t()
    return out


def level_gradient(level: torch.Tensor, world: torch.Tensor, radius: float) -> torch.Tensor:
    """The gradient of the lattice field ``level`` (central differences,
    one-sided at the border) at (n, 3) world points -> (n, 3)."""
    res = level.shape[-1] - 1
    grad = torch.stack(torch.gradient(level.float()))
    return _trilinear(grad, (world.float() + radius) * (res / (2 * radius)))


def winding_share(level: torch.Tensor, radius: float, corners: torch.Tensor) -> float:
    """The area share of the faces (``corners`` (F, 3, 3) world) whose
    normal points up the gradient of ``level`` (inside where > 0), where
    outward normals point down it."""
    if corners.shape[0] == 0:
        return float("inf")
    normal = torch.linalg.cross(corners[:, 1] - corners[:, 0], corners[:, 2] - corners[:, 0])
    grad = level_gradient(level, corners.mean(1), radius)
    area = normal.norm(dim=1).double()
    wrong = ((normal * grad).sum(1) > 0).double()
    return float((wrong * area).sum() / area.sum().clamp_min(1e-300))


def uv_range(uv: torch.Tensor) -> float:
    """``uv`` (F, 3, 2): the largest distance of a UV outside [0, 1], or
    the share of faces with no UV area, whichever is larger."""
    if uv.shape[0] == 0:
        return float("inf")
    outside = float(torch.maximum(-uv, uv - 1.0).clamp_min(0.0).max())
    e1, e2 = uv[:, 1] - uv[:, 0], uv[:, 2] - uv[:, 0]
    return max(outside, float(((e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]) == 0).double().mean()))


def locate_texels(uv: torch.Tensor, res: int, margin: float = EDGE_MARGIN):
    """The texels the atlas ``uv`` (F, 3, 2) covers beyond doubt, located in
    their face: (texel indices y * res + x (K,), face ids (K,), barycentrics
    (K, 3)). A texel's face is the lowest that covers it (a face whose UV
    Gram determinant is under ``MIN_GRAM`` covers none, the published
    baker's rule, which faces of a millionth of the atlas meet; a texel
    that a face within a factor 2 of that floor may win is left out); a
    texel is kept
    where that face is the lowest one both with every triangle grown by
    ``margin`` of its barycentrics and with every triangle shrunk by it, so
    that a texel on an edge, which the program's rasterizer (on its own
    rounding of the UVs) may give to another face or to none, is left out."""
    dev = uv.device
    step = 1.0 / (res - 1)
    lo = (torch.ceil(uv.amin(1) / step) - 1).clamp(0, res - 1).long()  # (F, 2): x, y, one texel wider
    hi = (torch.floor(uv.amax(1) / step) + 1).clamp(0, res - 1).long()
    span = (hi - lo + 1).clamp_min(0)
    e1, e2 = uv[:, 1] - uv[:, 0], uv[:, 2] - uv[:, 0]
    den = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]
    gram = (e1 * e1).sum(1) * (e2 * e2).sum(1) - (e1 * e2).sum(1) ** 2
    # faces near the baker's floor, which its own rounding may put either side
    doubtful = (gram.abs() >= MIN_GRAM / 2) & (gram.abs() < 2 * MIN_GRAM)
    count = torch.where((den == 0) | ((gram.abs() < MIN_GRAM) & ~doubtful), 0, span[:, 0] * span[:, 1])
    none = len(uv)
    best = {k: torch.full((res * res,), none, dtype=torch.long, device=dev)
            for k in ("grown", "exact", "shrunk", "doubtful")}
    found = []
    ends = torch.cumsum(count, 0)
    f0 = 0
    while f0 < len(uv):
        start = int(ends[f0 - 1]) if f0 else 0
        f1 = max(int(torch.searchsorted(ends, torch.tensor(start + _CANDIDATES, device=dev), right=True)), f0 + 1)
        n = count[f0:f1]
        fid = torch.repeat_interleave(torch.arange(f0, f1, device=dev), n)
        if fid.numel():
            first = torch.cumsum(n, 0) - n
            off = torch.arange(fid.numel(), device=dev) - torch.repeat_interleave(first, n)
            x = lo[fid, 0] + off % span[fid, 0]
            y = lo[fid, 1] + off // span[fid, 0]
            p = torch.stack([x.float(), y.float()], 1) * step - uv[fid, 0]
            s = (p[:, 0] * e2[fid, 1] - p[:, 1] * e2[fid, 0]) / den[fid]
            t = (e1[fid, 0] * p[:, 1] - e1[fid, 1] * p[:, 0]) / den[fid]
            least = torch.minimum(torch.minimum(s, t), 1 - s - t)
            texel = y * res + x
            sure = ~doubtful[fid]
            for key, floor, among in (("grown", -margin, sure), ("exact", 0.0, sure), ("shrunk", margin, sure),
                                      ("doubtful", -margin, ~sure)):
                hit = (least >= floor) & among
                best[key].scatter_reduce_(0, texel[hit], fid[hit], reduce="amin")
            hit = (least >= 0) & sure
            found.append((texel[hit], fid[hit], s[hit], t[hit]))
        f0 = f1
    if not found:
        empty = torch.zeros(0, dtype=torch.long, device=dev)
        return empty, empty, torch.zeros((0, 3), device=dev)
    texel, fid, s, t = (torch.cat(x) for x in zip(*found))
    keep = ((fid == best["exact"][texel]) & (fid == best["grown"][texel]) & (fid == best["shrunk"][texel])
            & (best["doubtful"][texel] > fid))
    texel, fid, s, t = texel[keep], fid[keep], s[keep], t[keep]
    order = torch.argsort(texel)
    return texel[order], fid[order], torch.stack([1 - s - t, s, t], 1)[order]


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=1, keepdim=True).clamp_min(1e-12)


def tangent_frames(corners: torch.Tensor, uv: torch.Tensor):
    """Per face (``corners`` (F, 3, 3) world, ``uv`` (F, 3, 2)) the bump
    map's frame as the published bake composes it -> (tangent, bitangent,
    normal), each (F, 3)."""
    p0, p1, p2 = corners.unbind(1)
    fn = torch.linalg.cross(p1 - p0, p2 - p0)
    up = torch.tensor([0.0, 0.0, 1.0], device=corners.device)
    fn = torch.where(((fn * fn).sum(1) <= 1e-20)[:, None], up, fn)
    duv1, duv2 = uv[:, 1] - uv[:, 0], uv[:, 2] - uv[:, 0]
    denom = duv1[:, 0] * duv2[:, 1] - duv1[:, 1] * duv2[:, 0]
    tng = ((p1 - p0) * duv2[:, 1:2] - (p2 - p0) * duv1[:, 1:2]) / denom.clamp_min(1e-6)[:, None]
    n = _unit(fn)
    t = _unit(tng)
    t = _unit(t - (t * n).sum(1, keepdim=True) * n)
    return t, _unit(torch.linalg.cross(t, n)), n


def bump_values(normal: torch.Tensor, t: torch.Tensor, b: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """A unit normal in a tangent frame, encoded as the bump map holds it."""
    normal = _unit(normal)
    v = torch.stack([(normal * t).sum(1), (normal * b).sum(1), (normal * n).sum(1).clamp(0.3, 1.0)], 1)
    return (v * 0.5 + 0.5).clamp(0.0, 1.0)


def atlas_texels(verts: torch.Tensor, faces: torch.Tensor, uvs: torch.Tensor, albedo: torch.Tensor,
                 bump: torch.Tensor, count: int, generator: torch.Generator) -> Optional[dict]:
    """A seeded sample of ``count`` texels that a mesh's own atlas covers:
    ``verts`` (V, 3) world, ``faces`` (F, 3), ``uvs`` (V, 2), the maps
    (res, res, 3) in [0, 1] -> {points (K, 3) world, albedo, bump (K, 3)
    texel values, tangent, bitangent, normal (K, 3) of the texel's face}."""
    res = albedo.shape[0]
    corners, uv = verts[faces], uvs[faces]
    texel, fid, bary = locate_texels(uv, res)
    if texel.numel() == 0:
        return None
    pick = torch.randperm(texel.numel(), generator=generator)[:count].to(texel.device)
    texel, fid, bary = texel[pick], fid[pick], bary[pick]
    t, b, n = tangent_frames(corners[fid], uv[fid])
    y, x = texel // res, texel % res
    return {"points": (bary[:, :, None] * corners[fid]).sum(1), "albedo": albedo[y, x], "bump": bump[y, x],
            "tangent": t, "bitangent": b, "normal": n}


def texel_numbers(texels: dict, ref_albedo: torch.Tensor, ref_normal: torch.Tensor) -> Dict[str, float]:
    """The sampled texels against the reference's albedo and perturbed
    normal at their points."""
    gap = (texels["albedo"].float() - ref_albedo.float()).abs()
    ref_bump = bump_values(ref_normal, texels["tangent"], texels["bitangent"], texels["normal"])
    return {"albedo_gap": float(gap.max()), "albedo_mean_gap": float(gap.mean()),
            "bump_mean_gap": float((texels["bump"].float() - ref_bump).abs().mean())}
