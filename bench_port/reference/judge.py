"""Numbers that hold a marching-cubes mesh with vertex colors, and a
condition image, against the plain reference.

The reference's own density lattice L (float32) at the request's
resolution, minus the iso-level T, is the surface's definition. A mesh
vertex lies on a cut lattice edge, so the reference's trilinear
interpolation of L - T at the vertex's lattice coordinates is the gap by
which the vertex misses the reference's surface there; it is divided by
the median |L_b - L_a| over the reference's cut edges, which makes it about
a distance in lattice cells. The vertex count is set against the number of
the reference's cut edges (one vertex each), and each vertex's color
against the reference decoder's color at the vertex's position.

The faces are held to the reference's surface cell by cell. In each
lattice cell the marching-cubes surface is a set of closed loops through
the cell's cut edges, joined on every face of the cell as that face's own
corner signs say: each crossing from inside to outside, walking the face's
boundary counter-clockwise as seen from outside the cell, goes to the next
crossing from outside to inside. A patch's vector area (the sum of its
triangles' (p1 - p0) x (p2 - p0) / 2) depends on its boundary loops alone,
whatever triangles fill them, so the reference needs no triangle table:
``lattice_surface`` sums (p x q) / 2 over the directed segments. The
mesh's triangles are summed by the cell that holds their centroid
(``mesh_surface``), and ``face_gap`` is the sum over cells of the two
vector areas' difference, over the reference's own sum. Triangles dropped,
wound the wrong way or joined across the lattice each move it by their
share of the surface.

``lattice_vertices`` gives the vertices of a lattice (one per cut edge,
t = L_a / (L_a - L_b) clamped to [0, 1]): the control's mesh, whose faces
``lattice_surface`` of its own lattice stands for.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _cut_edges(level: torch.Tensor):
    """(axis, a, b) per axis: the values at both ends of every edge of the
    lattice ``level`` that changes sign (inside: level > 0)."""
    inside = level > 0
    out = []
    for axis in range(3):
        n = level.shape[axis]
        a = level.narrow(axis, 0, n - 1)
        b = level.narrow(axis, 1, n - 1)
        cut = inside.narrow(axis, 0, n - 1) != inside.narrow(axis, 1, n - 1)
        out.append((axis, a, b, cut))
    return out


def surface_scale(level: torch.Tensor) -> float:
    """Median |L_b - L_a| over the cut edges of ``level``."""
    steps = torch.cat([(b - a)[cut].abs() for _, a, b, cut in _cut_edges(level)])
    return float(steps.median()) if steps.numel() else float("nan")


def cut_edge_count(level: torch.Tensor) -> int:
    return int(sum(int(cut.sum()) for *_, cut in _cut_edges(level)))


def lattice_vertices(level: torch.Tensor) -> torch.Tensor:
    """(N, 3) lattice coordinates of one vertex per cut edge of ``level``."""
    out = []
    for axis, a, b, cut in _cut_edges(level):
        idx = cut.nonzero()
        va, vb = a[cut], b[cut]
        denom = va - vb
        t = (va / torch.where(denom == 0, 1.0, denom)).clamp(0.0, 1.0)
        p = idx.float()
        p[:, axis] += t
        out.append(p)
    return torch.cat(out) if out else torch.zeros((0, 3), device=level.device)


# the in-plane axes (u, v) of the lattice faces normal to each axis, with
# u x v along that axis; corners c0..c3 at (u, v) offsets counter-clockwise
# as seen from the axis's + side, edge k from corner k to corner k + 1
_PLANE = {0: (1, 2), 1: (2, 0), 2: (0, 1)}
_CORNERS = ((0, 0), (1, 0), (1, 1), (0, 1))
# each edge's corners (low, high) along its lattice axis: t runs from low
_EDGE_ENDS = ((0, 1), (1, 2), (3, 2), (0, 3))
# a centroid this near (in cells) to a face between two cells lies on it
_ON_FACE = 1e-4


def _cell_keys(cells: torch.Tensor, shape) -> torch.Tensor:
    """(N, 3) int64 cell indices -> flat keys over the (X-1, Y-1, Z-1) cells."""
    return (cells[:, 0] * (shape[1] - 1) + cells[:, 1]) * (shape[2] - 1) + cells[:, 2]


def _sum_by_key(keys: torch.Tensor, values: torch.Tensor):
    """(unique keys, the sum of ``values`` (N, 3) per key)."""
    uk, inv = torch.unique(keys, return_inverse=True)
    return uk, torch.zeros((uk.numel(), 3), dtype=values.dtype, device=values.device).index_add_(0, inv, values)


def lattice_surface(level: torch.Tensor):
    """(keys, (K, 3) float64): the outward vector area (pointing away from
    level > 0) of the iso-surface level = 0 in each lattice cell it cuts."""
    shape = level.shape
    keys, areas = [], []
    for n, (u, v) in _PLANE.items():
        lv = level.permute(n, u, v)
        ins = lv > 0
        vals = [lv[:, du : lv.shape[1] - 1 + du, dv : lv.shape[2] - 1 + dv] for du, dv in _CORNERS]
        bits = [ins[:, du : lv.shape[1] - 1 + du, dv : lv.shape[2] - 1 + dv] for du, dv in _CORNERS]
        pattern = bits[0].int() + 2 * bits[1].int() + 4 * bits[2].int() + 8 * bits[3].int()
        idx = ((pattern != 0) & (pattern != 15)).nonzero()  # (M, 3): (n, u, v) of each cut face
        if idx.numel() == 0:
            continue
        sel = tuple(idx.t())
        val = torch.stack([x[sel] for x in vals], 1).double()  # (M, 4)
        inside = torch.stack([x[sel] for x in bits], 1)
        base = torch.zeros((idx.shape[0], 3), dtype=torch.float64, device=level.device)
        base[:, n], base[:, u], base[:, v] = idx[:, 0].double(), idx[:, 1].double(), idx[:, 2].double()
        corner = torch.zeros((4, 3), dtype=torch.float64, device=level.device)
        for k, (du, dv) in enumerate(_CORNERS):
            corner[k, u], corner[k, v] = du, dv
        points = []
        for lo, hi in _EDGE_ENDS:
            a, b = val[:, lo], val[:, hi]
            d = a - b
            t = (a / torch.where(d == 0, torch.ones_like(d), d)).clamp(0.0, 1.0)[:, None]
            points.append(base + corner[lo] + t * (corner[hi] - corner[lo]))
        points = torch.stack(points, 1)  # (M, 4, 3)
        exits = [inside[:, k] & ~inside[:, (k + 1) % 4] for k in range(4)]
        entries = [~inside[:, k] & inside[:, (k + 1) % 4] for k in range(4)]
        s = torch.zeros((idx.shape[0], 3), dtype=torch.float64, device=level.device)
        for k in range(4):
            nxt = torch.where(entries[(k + 1) % 4], (k + 1) % 4, torch.where(entries[(k + 2) % 4], (k + 2) % 4,
                                                                             (k + 3) % 4))
            q = points.gather(1, nxt[:, None, None].expand(-1, 1, 3))[:, 0]
            s += torch.where(exits[k][:, None], 0.5 * torch.linalg.cross(points[:, k], q), 0.0)
        # the face is the +n face of the cell below it along n and the -n
        # face of the cell above; these loops wind into the inside region,
        # so the outward area takes -s below and +s above
        cell = torch.zeros_like(idx)
        cell[:, n], cell[:, u], cell[:, v] = idx[:, 0], idx[:, 1], idx[:, 2]
        below, above = idx[:, 0] >= 1, idx[:, 0] <= shape[n] - 2
        lower = cell.clone()
        lower[:, n] -= 1
        keys += [_cell_keys(lower[below], shape), _cell_keys(cell[above], shape)]
        areas += [-s[below], s[above]]
    if not keys:
        return torch.zeros(0, dtype=torch.int64, device=level.device), torch.zeros(
            (0, 3), dtype=torch.float64, device=level.device)
    return _sum_by_key(torch.cat(keys), torch.cat(areas))


def mesh_surface(pos: torch.Tensor, faces: torch.Tensor, shape):
    """The vector areas of a mesh's triangles by lattice cell, ``pos`` (N, 3)
    lattice coordinates, ``faces`` (F, 3) vertex indices: (keys, (K, 3)
    float64 sums) of the triangles in the cell that holds their centroid,
    and (lower keys, upper keys, (M, 3) areas) of the triangles whose
    centroid lies on a face between two cells (those of an ambiguous face,
    which ``face_gap`` gives to the cell they fit). None where a face names
    a vertex the mesh does not have."""
    faces = faces.to(device=pos.device, dtype=torch.int64)
    if faces.numel() and (int(faces.min()) < 0 or int(faces.max()) >= pos.shape[0]):
        return None
    p = pos.double()
    p0, p1, p2 = p[faces[:, 0]], p[faces[:, 1]], p[faces[:, 2]]
    area = 0.5 * torch.linalg.cross(p1 - p0, p2 - p0)
    hi = torch.tensor(shape, device=pos.device) - 2
    centroid = (p0 + p1 + p2) / 3
    cells = torch.minimum(centroid.floor().long().clamp(min=0), hi)
    near = centroid.round()
    on_face = ((centroid - near).abs() < _ON_FACE) & (near >= 1) & (near <= hi)
    split = on_face.any(dim=1)
    axis = on_face.int().argmax(dim=1)[split]
    upper = cells[split].clone()
    upper.scatter_(1, axis[:, None], near[split].long().gather(1, axis[:, None]))
    lower = upper.clone()
    lower.scatter_(1, axis[:, None], upper.gather(1, axis[:, None]) - 1)
    return (*_sum_by_key(_cell_keys(cells[~split], shape), area[~split]),
            _cell_keys(lower, shape), _cell_keys(upper, shape), area[split])


def face_gap(reference, surface) -> float:
    """Sum over cells of |A - A_ref| over the sum of |A_ref|: ``reference``
    the (keys, areas) of ``lattice_surface``, ``surface`` those of another
    ``lattice_surface`` or a ``mesh_surface``, whose triangles on a face
    between two cells each go to the one of the two where they leave the
    smaller gap."""
    if surface is None:
        return float("inf")
    (rk, ra), (k, a) = reference, surface[:2]
    lower, upper, split = surface[2:] if len(surface) > 2 else (k[:0], k[:0], a[:0])
    keys, inv = torch.unique(torch.cat([rk, k, lower, upper]), return_inverse=True)
    diff = torch.zeros((keys.numel(), 3), dtype=torch.float64, device=ra.device)
    diff.index_add_(0, inv[: rk.numel() + k.numel()], torch.cat([ra, -a]))
    lo, up = inv[rk.numel() + k.numel():].chunk(2)
    d_lo, d_up = diff[lo], diff[up]
    cost_lo = (d_lo - split).norm(dim=1) - d_lo.norm(dim=1)
    cost_up = (d_up - split).norm(dim=1) - d_up.norm(dim=1)
    diff.index_add_(0, torch.where(cost_lo <= cost_up, lo, up), -split)
    return float(diff.norm(dim=1).sum() / ra.norm(dim=1).sum().clamp_min(1e-300))


def trilinear(level: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``level`` (X, Y, Z) at (N, 3) lattice coordinates (clamped inside)."""
    hi = torch.tensor(level.shape, device=p.device, dtype=torch.float32) - 1
    p = torch.minimum(p.clamp(min=0.0), hi)
    i0 = torch.minimum(p.floor(), hi - 1).long()
    f = p - i0.float()
    out = torch.zeros(p.shape[0], device=p.device)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = ((f[:, 0] if dx else 1 - f[:, 0]) * (f[:, 1] if dy else 1 - f[:, 1])
                     * (f[:, 2] if dz else 1 - f[:, 2]))
                out += w * level[i0[:, 0] + dx, i0[:, 1] + dy, i0[:, 2] + dz]
    return out


def mesh_numbers(level: torch.Tensor, scale: float, n_ref: int, lattice_pos: torch.Tensor,
                 colors: torch.Tensor, ref_colors: torch.Tensor, surface) -> Dict[str, float]:
    """One mesh against the reference: ``level`` = L - T of the reference,
    ``lattice_pos`` (N, 3) the mesh's vertices in lattice coordinates,
    ``colors`` its vertex colors, ``ref_colors`` the reference's at the
    same vertices, ``surface`` its faces' ``mesh_surface``."""
    n = lattice_pos.shape[0]
    out = {"vertex_count_gap": abs(n - n_ref) / max(n_ref, 1), "face_gap": face_gap(lattice_surface(level), surface)}
    if n == 0:
        return {**out, "surface_gap": float("inf"), "color_gap": float("inf"), "color_mean_gap": float("inf")}
    gap = trilinear(level, lattice_pos).abs() / scale
    cgap = (colors.float() - ref_colors.float()).abs()
    return {**out, "surface_gap": float(gap.max()), "surface_p99_gap": float(torch.quantile(gap[:1 << 24], 0.99)),
            "color_gap": float(cgap.max()), "color_mean_gap": float(cgap.mean())}


def image_numbers(image: np.ndarray, ref: np.ndarray) -> Dict[str, float]:
    """A condition image against the reference's, both (H, W, 3) in [0, 1]."""
    d = np.abs(np.asarray(image, np.float64) - np.asarray(ref, np.float64))
    return {"cond_gap": float(d.max()), "cond_mean_gap": float(d.mean())}


def worst(rows) -> Dict[str, float]:
    """The widest reading of each number over the sampled requests."""
    out: Dict[str, float] = {}
    for r in rows:
        for k, v in r.items():
            out[k] = max(out.get(k, -np.inf), v)
    return out
