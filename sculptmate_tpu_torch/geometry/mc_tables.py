"""Marching-cubes case tables, generated rather than transcribed.

The classic Lorensen/Bourke triTable is derived here from first principles at
import time (microseconds, cached): for each of the 256 corner-sign cases we
walk each cube face's boundary in a consistent outward-CCW order, pair each
inside->outside crossing ("exit") with the next outside->inside crossing
("entry"), chain the resulting directed face segments into closed loops of cut
edges, and fan-triangulate each loop.

Because the exit->next-entry pairing depends only on the face's own corner
signs and is invariant under reversing the walk direction, the two cubes
sharing a face always derive the same edge pairing — the mesh is watertight by
construction, including on the ambiguous (two-diagonal) faces, where this rule
consistently keeps the inside corners connected.

Replaces the reference's dependency on ``skimage.measure.marching_cubes``
(``tsr/models/isosurface.py:41-54``) with tables the device kernel can index.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import numpy as np

# Corner c has offset bits (x, y, z) = (c & 1, (c >> 1) & 1, (c >> 2) & 1).
CORNER_OFFSETS = np.array(
    [[(c >> 0) & 1, (c >> 1) & 1, (c >> 2) & 1] for c in range(8)], dtype=np.int32
)

# Edge e = (axis, ox, oy, oz): runs from corner at offset o along +axis.
EDGES: List[Tuple[int, int, int, int]] = (
    [(0, 0, y, z) for z in (0, 1) for y in (0, 1)]
    + [(1, x, 0, z) for z in (0, 1) for x in (0, 1)]
    + [(2, x, y, 0) for y in (0, 1) for x in (0, 1)]
)
EDGE_AXIS = np.array([e[0] for e in EDGES], dtype=np.int32)
EDGE_OFFSET = np.array([e[1:] for e in EDGES], dtype=np.int32)


def _corner_index(off) -> int:
    return int(off[0]) | (int(off[1]) << 1) | (int(off[2]) << 2)


# corner-pair -> edge id
_EDGE_BY_CORNERS: Dict[Tuple[int, int], int] = {}
for eid, (axis, ox, oy, oz) in enumerate(EDGES):
    a = _corner_index((ox, oy, oz))
    off_b = [ox, oy, oz]
    off_b[axis] += 1
    b = _corner_index(off_b)
    _EDGE_BY_CORNERS[(a, b)] = eid
    _EDGE_BY_CORNERS[(b, a)] = eid

# Faces: 4 corner offsets in CCW order viewed from outside the cube.
_FACES = [
    [(1, 0, 0), (1, 1, 0), (1, 1, 1), (1, 0, 1)],  # +x
    [(0, 0, 0), (0, 0, 1), (0, 1, 1), (0, 1, 0)],  # -x
    [(0, 1, 0), (0, 1, 1), (1, 1, 1), (1, 1, 0)],  # +y
    [(0, 0, 0), (1, 0, 0), (1, 0, 1), (0, 0, 1)],  # -y
    [(0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)],  # +z
    [(0, 0, 0), (0, 1, 0), (1, 1, 0), (1, 0, 0)],  # -z
]
_FACE_CORNERS = [[_corner_index(o) for o in f] for f in _FACES]


def _case_loops(case: int) -> List[List[int]]:
    """Closed loops of cut-edge ids for one corner-sign case."""
    inside = [(case >> c) & 1 for c in range(8)]
    succ: Dict[int, int] = {}  # exit edge -> entry edge (directed segment)
    for corners in _FACE_CORNERS:
        crossings = []  # (position m, kind, edge) in CCW walk order
        for m in range(4):
            a, b = corners[m], corners[(m + 1) % 4]
            if inside[a] and not inside[b]:
                crossings.append(("exit", _EDGE_BY_CORNERS[(a, b)]))
            elif not inside[a] and inside[b]:
                crossings.append(("entry", _EDGE_BY_CORNERS[(a, b)]))
        n = len(crossings)
        for idx, (kind, eid) in enumerate(crossings):
            if kind != "exit":
                continue
            # connect to the next entry in cyclic CCW order
            for step in range(1, n + 1):
                kind2, eid2 = crossings[(idx + step) % n]
                if kind2 == "entry":
                    succ[eid] = eid2
                    break
    loops: List[List[int]] = []
    remaining = dict(succ)
    while remaining:
        start = next(iter(remaining))
        loop = [start]
        cur = remaining.pop(start)
        while cur != start:
            loop.append(cur)
            cur = remaining.pop(cur)
        loops.append(loop)
    return loops


def _edge_midpoint(eid: int) -> np.ndarray:
    axis, ox, oy, oz = EDGES[eid]
    p = np.array([ox, oy, oz], dtype=np.float64)
    p[axis] += 0.5
    return p


@functools.lru_cache(maxsize=1)
def build_tables() -> Tuple[np.ndarray, np.ndarray, int]:
    """Returns (tri_table (256, maxtri, 3) int32 with -1 padding,
    tri_count (256,) int32, maxtri)."""
    all_tris: List[List[Tuple[int, int, int]]] = []
    for case in range(256):
        tris: List[Tuple[int, int, int]] = []
        for loop in _case_loops(case):
            for i in range(1, len(loop) - 1):
                tris.append((loop[0], loop[i], loop[i + 1]))
        all_tris.append(tris)

    maxtri = max(len(t) for t in all_tris)
    tri_table = np.full((256, maxtri, 3), -1, dtype=np.int32)
    tri_count = np.zeros((256,), dtype=np.int32)
    for case, tris in enumerate(all_tris):
        tri_count[case] = len(tris)
        for t, tri in enumerate(tris):
            tri_table[case, t] = tri

    _orient_tables(tri_table, tri_count)
    return tri_table, tri_count, maxtri


def _orient_tables(tri_table: np.ndarray, tri_count: np.ndarray) -> None:
    """Flip winding (in place) so normals point away from the inside region."""
    # Case 1: only corner 0 (at the origin) inside. The outward surface
    # normal (pointing away from the inside region) is ~ +(1,1,1).
    case = 1
    tri = tri_table[case, 0]
    p = [_edge_midpoint(e) for e in tri]
    n = np.cross(p[1] - p[0], p[2] - p[0])
    if np.dot(n, np.array([1.0, 1.0, 1.0])) < 0:
        # normals currently point into the inside region -> flip all
        for c in range(256):
            for t in range(tri_count[c]):
                tri_table[c, t, 1], tri_table[c, t, 2] = (
                    tri_table[c, t, 2],
                    tri_table[c, t, 1],
                )
