"""Triplane NeRF density on the marching-cubes lattice, and at scattered
points.

Counterpart of ``sculptmate_tpu/ops/density_grid.py``. The lattice query
rests on two observations:

1. The lattice is separable, so the bilinear plane samples are small dense
   interpolation products (``ops/grid_sample.py``), with no gathers.
2. The first MLP layer factorizes over the three planes:
   h1[i,j,k] = (Fxy W1a)[i,j] + (Fxz W1b)[k,i] + (Fyz W1c)[k,j] + b1,
   three R^2 x 40 x 64 products instead of an R^3 x 120 x 64 one.

The rest of the MLP over all R^3 points is kernel K2
(``csrc/density_grid.cu``) on a CUDA tensor, and the z-slab loop of
``density_mlp_plain`` on a CPU tensor. The scattered query
(``query_triplane_points``, mesh-vertex colors) is plain torch.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, List, Sequence, Tuple

import torch

from sculptmate_tpu_torch.ops.activations import get_activation
from sculptmate_tpu_torch.ops.grid_sample import (
    sample_triplane,
    sample_triplane_regular_grid,
)
from sculptmate_tpu_torch.runtime import kernels

Weights = List[Tuple[torch.Tensor, torch.Tensor]]  # [(kernel (in, out), bias)]


def mlp_weights_from_params(layers: torch.nn.Module) -> Weights:
    """[(kernel (in, out), bias), ...] in layer order from an ``MLPStack``
    (the JAX package's kernel layout, so both sides share one convention)."""
    return [(m.weight.t(), m.bias) for m in layers if isinstance(m, torch.nn.Linear)]


@dataclasses.dataclass(frozen=True)
class DensityGridSpec:
    resolution: int = 256
    radius: float = 0.87
    density_activation: str = "exp"
    density_bias: float = -1.0
    activation: str = "silu"
    align_corners: bool = False
    slab: int = 8  # z-slices per step of the plain version
    compute_dtype: torch.dtype = torch.float32


def lattice_coords(resolution: int, device=None) -> torch.Tensor:
    """Normalized [-1, 1] coords of the MC lattice: g_i = 2 i / (R - 1) - 1."""
    return 2.0 * torch.arange(resolution, dtype=torch.float32, device=device) / (resolution - 1) - 1.0


def _run_hidden(h: torch.Tensor, weights: Sequence, act, cd) -> torch.Tensor:
    """Hidden layers 1..n-1 and the output layer on (..., 64) activations."""
    for W, b in weights[1:-1]:
        h = act(h @ W.to(cd) + b.to(cd))
    W, b = weights[-1]
    return h @ W.to(cd) + b.to(cd)


def density_mlp_plain(
    A: torch.Tensor, B: torch.Tensor, C: torch.Tensor, weights: Weights, spec: DensityGridSpec
) -> torch.Tensor:
    """Plain version of kernel K2. A (R_i, R_j, 64) with b1 added, B (R_k,
    R_i, 64), C (R_k, R_j, 64), all in the compute dtype -> (R, R, R) f32
    activated density in [x, y, z] order."""
    R = A.shape[0]
    act = get_activation(spec.activation)
    slabs = []
    for z0 in range(0, R, spec.slab):
        b_s, c_s = B[z0 : z0 + spec.slab], C[z0 : z0 + spec.slab]
        h = act(A[None] + b_s[:, :, None, :] + c_s[:, None, :, :])  # (slab, Ri, Rj, 64)
        slabs.append(_run_hidden(h, weights, act, A.dtype)[..., 0].float())
    dens = torch.cat(slabs).permute(1, 2, 0)  # [z, x, y] -> [x, y, z]
    return get_activation(spec.density_activation)(dens + spec.density_bias).contiguous()


def _density_lib():
    fn = kernels.load("density_grid").density_mlp_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_float] + [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


_HIDDEN = 64  # the only hidden width kernel K2 is built for


def density_mlp(
    A: torch.Tensor, B: torch.Tensor, C: torch.Tensor, weights: Weights, spec: DensityGridSpec
) -> torch.Tensor:
    """Kernel K2 on CUDA tensors, its plain version on CPU tensors."""
    if not A.is_cuda:
        return density_mlp_plain(A, B, C, weights, spec)
    R = A.shape[0]
    hidden = weights[1:-1]
    if A.dtype != torch.bfloat16:
        raise TypeError(f"density kernel computes in bf16, got {A.dtype} (use a bf16 extract dtype on the card)")
    if spec.activation.lower() != "silu" or spec.density_activation.lower() != "exp":
        raise ValueError("density kernel implements silu hidden layers and exp density only")
    if A.shape != (R, R, _HIDDEN) or B.shape != A.shape or C.shape != A.shape:
        raise ValueError(f"bad partial-sum shapes {tuple(A.shape)} {tuple(B.shape)} {tuple(C.shape)}")
    if not hidden or any(W.shape != (_HIDDEN, _HIDDEN) for W, _ in hidden):
        raise ValueError("density kernel needs >= 1 hidden 64x64 layer")
    dev = A.device
    # (L, out, in) bf16: the row-major B operand of the kernel's products
    W = kernels.aligned(torch.stack([w.detach().t() for w, _ in hidden]).to(dev, torch.bfloat16))
    bias = torch.stack([b.detach() for _, b in hidden]).to(dev, torch.bfloat16).float().contiguous()
    # output channel 0 and its bias in one device buffer: reading the bias
    # on the host would wait for the device
    w_out, b_out = (t.detach() for t in weights[-1])
    wout = torch.cat([w_out[:, 0], b_out[:1]]).to(dev, torch.bfloat16).float().contiguous()
    A, B, C = (kernels.aligned(t) for t in (A, B, C))
    out = torch.empty((R, R, R), dtype=torch.float32, device=dev)
    ntiles = -(-R * R * R // 16)
    grid = min(-(-ntiles // 8), 2 * torch.cuda.get_device_properties(dev).multi_processor_count)
    err = _density_lib()(
        A.data_ptr(), B.data_ptr(), C.data_ptr(), W.data_ptr(), bias.data_ptr(),
        wout.data_ptr(), float(spec.density_bias), out.data_ptr(),
        R, len(hidden), grid, torch.cuda.current_stream(dev).cuda_stream,
    )
    kernels.check(err, "density_mlp_fwd")
    density_mlp.launches += 1
    return out


density_mlp.launches = 0


def first_layer_partials(
    triplane: torch.Tensor, weights: Weights, spec: DensityGridSpec
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The factorized first layer: A (R_i, R_j, 64) + b1, B (R_k, R_i, 64),
    C (R_k, R_j, 64) in the compute dtype."""
    cd = spec.compute_dtype
    coords = lattice_coords(spec.resolution, triplane.device)
    Fxy, Fxz, Fyz = sample_triplane_regular_grid(
        triplane, coords, coords, coords, spec.align_corners
    )
    W1, b1 = weights[0]
    C = triplane.shape[1]
    A = torch.einsum("cji,cn->ijn", Fxy.to(cd), W1[:C].to(cd)) + b1.to(cd)
    Bm = torch.einsum("cki,cn->kin", Fxz.to(cd), W1[C : 2 * C].to(cd))
    Cm = torch.einsum("ckj,cn->kjn", Fyz.to(cd), W1[2 * C :].to(cd))
    return A, Bm, Cm


def query_density_grid(triplane: torch.Tensor, weights: Weights, spec: DensityGridSpec) -> torch.Tensor:
    """Activated density on the full R^3 lattice. triplane: (3, C, H, W).
    Returns (R, R, R) float32 indexed [x, y, z]."""
    A, Bm, Cm = first_layer_partials(triplane, weights, spec)
    return density_mlp(A, Bm, Cm, weights, spec)


def query_triplane_points(
    triplane: torch.Tensor,
    weights: Weights,
    px: torch.Tensor,
    py: torch.Tensor,
    pz: torch.Tensor,
    spec: DensityGridSpec,
) -> Dict[str, torch.Tensor]:
    """Scattered query at flat (N,) world coords in (-radius, radius):
    density/density_act (N,) and color (3, N), channels first."""
    cd = spec.compute_dtype
    act = get_activation(spec.activation)
    r = spec.radius
    h = sample_triplane(triplane, px / r, py / r, pz / r, spec.align_corners).to(cd)
    for W, b in weights[:-1]:
        h = act(W.to(cd).t() @ h + b.to(cd)[:, None])
    W, b = weights[-1]
    out = (W.to(cd).t() @ h + b.to(cd)[:, None]).float()  # (4, N)
    density = out[0]
    return {
        "density": density,
        "density_act": get_activation(spec.density_activation)(density + spec.density_bias),
        "color": torch.sigmoid(out[1:4]),
    }
