"""A K10 mesh against a wire mesh of the same lattice, vertex by vertex:
both have one vertex per cut edge, in different orders (K10's axis-major
flat order, the wire decoder's block-major one), so each is matched by its
cut edge. Imports no JAX, so card tests can use it."""

import numpy as np
import torch

from sculptmate_tpu_torch.geometry import marching_cubes as mc
from sculptmate_tpu_torch.geometry import mc_wire


def wire_to_packed(level: torch.Tensor) -> np.ndarray:
    """For each vertex of the wire mesh of ``level`` (the wire decoder's
    order), the index of the vertex on the same cut edge in K10's mesh of
    it; both extracted here with room for every lattice edge."""
    n = level.numel()
    packed = mc.marching_cubes(level, 3 * n, 6 * n, return_edges=True)
    nv = int(packed.num_verts)
    edges = packed.edges[:nv].cpu().numpy()
    wire = mc.mc_wire_device(level, 3 * n).cpu().numpy()
    *_, wire_edges = mc_wire.decode_wire(wire, tuple(level.shape), 3 * n, has_colors=False, return_edges=True)
    match = np.searchsorted(edges, wire_edges)
    assert len(wire_edges) == nv and np.array_equal(edges[match], wire_edges)
    return match


def assert_same_mesh(packed, wire, match: np.ndarray, scale: float) -> None:
    """The (verts, faces, colors) of the K10 path against the wire path's,
    vertex ``i`` of the wire being vertex ``match[i]`` of K10's: the same
    triangles, positions within one u16 step of the wire's t (``scale``:
    world units per lattice step) and colors within half a u8 step."""
    (vp, fp, cp), (vw, fw, cw) = packed, wire
    assert len(vp) > 0 and vp.shape == vw.shape and fp.shape == fw.shape
    assert vp.dtype == cp.dtype == np.float32 and fp.dtype == np.int64
    assert sorted(map(tuple, fp.tolist())) == sorted(map(tuple, match[fw].tolist()))
    np.testing.assert_allclose(vp[match], vw, rtol=0, atol=scale / 65535)
    np.testing.assert_allclose(cp[match], cw, rtol=0, atol=0.5 / 255 + 1e-6)
