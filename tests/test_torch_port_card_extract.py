"""The Lean extraction's default path on the card: face-emitting marching
cubes (kernel K10) and the mesh's pinned copies, against the wire path
(K3 and the host's face rebuild) on the same codes. Imports no JAX, so the
card's machine runs it without the suite's conftest:
``python -m pytest --noconftest tests/test_torch_port_card_extract.py``."""

import pytest
import torch

from mesh_match import assert_same_mesh, wire_to_packed
from sculptmate_tpu_torch.geometry import marching_cubes as mc
from sculptmate_tpu_torch.ops.density_grid import query_density_grid
from sculptmate_tpu_torch.systems.tsr import TSR, TSRConfig


@pytest.mark.cuda
def test_default_extraction_on_the_card_is_k10():
    """One asset's default ``extract_mesh`` on the card launches K10 once
    and K3 never, and gives the mesh of ``mode="wire"`` under the edge
    matching, in arrays that own their memory."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # head widths of 64, the only one kernel K1 takes
    cfg = TSRConfig(cond_image_size=64, plane_size=8, num_channels=64, num_attention_heads=1, attention_head_dim=64,
                    num_layers=2, cross_attention_dim=128, vit_hidden_size=128, vit_num_layers=2, vit_num_heads=2,
                    vit_intermediate_size=256)
    tt = TSR(cfg, device="cuda")
    codes = tt.scene_codes(torch.rand(1, 64, 64, 3, device="cuda", generator=torch.Generator("cuda").manual_seed(3)))
    R = 32
    density = query_density_grid(codes[0], tt.decoder_weights(), tt.grid_spec(R, tt.extract_dtype))
    kw = dict(has_vertex_color=True, resolution=R, threshold=float(density.median()))
    tt.extract_mesh(codes, **kw)  # warm-up: builds the kernels, learns the capacities
    k10, k3 = mc.marching_cubes.launches, mc.mc_wire_device.launches
    packed = tt.extract_mesh(codes, **kw)[0]
    assert (mc.marching_cubes.launches - k10, mc.mc_wire_device.launches - k3) == (1, 0)
    wire = tt.extract_mesh(codes, mode="wire", **kw)[0]
    assert_same_mesh(packed, wire, wire_to_packed(density - kw["threshold"]), 2 * tt.config.radius / (R - 1))
    assert all(a.flags.owndata for a in packed)
