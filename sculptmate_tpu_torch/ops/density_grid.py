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
(``query_triplane_points``: mesh-vertex colors and the renderer's samples)
is kernel K4 (``csrc/triplane_points.cu``) on a CUDA tensor and
``triplane_points_plain`` on a CPU tensor.

SF3D's lattice query (``query_grid_multihead``) uses the same scheme for two
heads at once, their first layers side by side; the rest of both heads is
kernel K5 (``csrc/grid_multihead.cu``) on a CUDA tensor and
``grid_multihead_plain`` on a CPU tensor. The texture bake's scattered
two-head query (``query_points_multihead``) is kernel K6
(``csrc/points_multihead.cu``) on a CUDA tensor and
``points_multihead_plain`` on a CPU tensor.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

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
    """Plain version of kernel K2. A (RX, R, 64) with b1 added, B (R, RX,
    64), C (R, R, 64), all in the compute dtype -> (RX, R, R) f32 activated
    density in [x, y, z] order (RX = R for the whole lattice, fewer rows for
    an x-slab)."""
    R = A.shape[1]
    act = get_activation(spec.activation)
    slabs = []
    for z0 in range(0, R, spec.slab):
        b_s, c_s = B[z0 : z0 + spec.slab], C[z0 : z0 + spec.slab]
        h = act(A[None] + b_s[:, :, None, :] + c_s[:, None, :, :])  # (slab, RX, R, 64)
        slabs.append(_run_hidden(h, weights, act, A.dtype)[..., 0].float())
    dens = torch.cat(slabs).permute(1, 2, 0)  # [z, x, y] -> [x, y, z]
    return get_activation(spec.density_activation)(dens + spec.density_bias).contiguous()


def _density_lib():
    fn = kernels.load("density_grid").density_mlp_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_float, ctypes.c_void_p] + [ctypes.c_int] * 4 + [
            ctypes.c_void_p
        ]
        fn.restype = ctypes.c_int
    return fn


_HIDDEN = 64  # the only hidden width kernel K2 is built for
_LAYERS = 8  # its hidden 64x64 layers: TripoSR's decoder (n_hidden_layers 9)


def swizzle_128b(rows: torch.Tensor) -> torch.Tensor:
    """Rows of 64 two-byte values, (..., N, 64), in the 128-byte swizzle that
    TMA writes and ``wgmma`` reads: the 16-byte chunk q of row r moves to
    chunk q ^ (r % 8). The swizzle is its own inverse."""
    n = rows.shape[-2]
    r = torch.arange(n, device=rows.device)[:, None]
    perm = torch.arange(8, device=rows.device)[None, :] ^ (r % 8)  # (N, 8)
    chunks = rows.reshape(*rows.shape[:-1], 8, 8)
    return chunks[..., r, perm, :].reshape(rows.shape)


def pack_density_weights(weights: Weights, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The decoder's hidden layers and output channel 0 in kernel K2's layout.

    Returns bf16 rows (L*64 + 8, 64), 128-byte swizzled: for each hidden layer
    its (out, in) matrix halved, then w_out[:, 0] and 7 zero rows; and f32
    (L*64 + 1,): each hidden bias halved, then b_out[0]. The halving is exact
    in bf16 and lets each product give h = x / 2 for silu(x) = h (1 + tanh h).
    """
    hidden = weights[1:-1]
    w_out, b_out = (t.detach() for t in weights[-1])
    out_rows = torch.zeros(8, _HIDDEN, dtype=torch.float32, device=w_out.device)
    out_rows[0] = w_out[:, 0].float()
    # bf16 first, then halved: the same bf16 weights as the plain version
    rows = torch.cat(
        [0.5 * w.detach().t().to(torch.bfloat16).float() for w, _ in hidden] + [out_rows.to(torch.bfloat16).float()]
    )
    w = swizzle_128b(rows.to(device, torch.bfloat16)).contiguous()
    b = torch.cat([0.5 * b.detach().to(torch.bfloat16).float() for _, b in hidden] + [b_out[:1].to(torch.bfloat16).float()])
    return w, b.to(device).contiguous()


def density_mlp(
    A: torch.Tensor, B: torch.Tensor, C: torch.Tensor, weights: Weights, spec: DensityGridSpec
) -> torch.Tensor:
    """Kernel K2 on CUDA tensors, its plain version on CPU tensors; the
    shapes of ``density_mlp_plain``."""
    if not A.is_cuda:
        return density_mlp_plain(A, B, C, weights, spec)
    RX, R = A.shape[:2]
    hidden = weights[1:-1]
    if A.dtype != torch.bfloat16:
        raise TypeError(f"density kernel computes in bf16, got {A.dtype} (use a bf16 extract dtype on the card)")
    if spec.activation.lower() != "silu" or spec.density_activation.lower() != "exp":
        raise ValueError("density kernel implements silu hidden layers and exp density only")
    if A.shape != (RX, R, _HIDDEN) or B.shape != (R, RX, _HIDDEN) or C.shape != (R, R, _HIDDEN):
        raise ValueError(f"bad partial-sum shapes {tuple(A.shape)} {tuple(B.shape)} {tuple(C.shape)}")
    if len(hidden) != _LAYERS or any(W.shape != (_HIDDEN, _HIDDEN) for W, _ in hidden):
        raise ValueError(f"density kernel takes {_LAYERS} hidden 64x64 layers")
    dev = A.device
    # weights and biases stay on the device: reading one on the host would
    # wait for the device
    W, bias = pack_density_weights(weights, dev)
    A, B, C = (kernels.aligned(t) for t in (A, B, C))
    out = torch.empty((RX, R, R), dtype=torch.float32, device=dev)
    num_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    err = _density_lib()(
        A.data_ptr(), B.data_ptr(), C.data_ptr(), W.data_ptr(), bias.data_ptr(),
        float(spec.density_bias), out.data_ptr(), R, RX, len(hidden), num_sms,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    kernels.check(err, "density_mlp_fwd")
    density_mlp.launches += 1
    return out


density_mlp.launches = 0


def first_layer_partials(
    triplane: torch.Tensor, weights: Weights, spec: DensityGridSpec, x_coords: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The factorized first layer: A (RX, R, 64) + b1, B (R, RX, 64), C (R,
    R, 64) in the compute dtype. ``x_coords``: normalized [-1, 1] x rows in
    place of the whole lattice's (RX = len(x_coords))."""
    cd = spec.compute_dtype
    coords = lattice_coords(spec.resolution, triplane.device)
    cx = coords if x_coords is None else x_coords.to(triplane.device, torch.float32)
    Fxy, Fxz, Fyz = sample_triplane_regular_grid(
        triplane, cx, coords, coords, spec.align_corners
    )
    W1, b1 = weights[0]
    C = triplane.shape[1]
    A = torch.einsum("cji,cn->ijn", Fxy.to(cd), W1[:C].to(cd)) + b1.to(cd)
    Bm = torch.einsum("cki,cn->kin", Fxz.to(cd), W1[C : 2 * C].to(cd))
    Cm = torch.einsum("ckj,cn->kjn", Fyz.to(cd), W1[2 * C :].to(cd))
    return A, Bm, Cm


def query_density_grid(
    triplane: torch.Tensor, weights: Weights, spec: DensityGridSpec, x_coords: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Activated density on the full R^3 lattice. triplane: (3, C, H, W).
    Returns (R, R, R) float32 indexed [x, y, z]. ``x_coords``: optional
    normalized [-1, 1] coords replacing the lattice's along x, for an
    (len(x_coords), R, R) x-slab (the JAX package's building block of its
    sharded extraction; the port's, ``parallel/farm.py``, takes rows of the
    whole lattice's partials instead, whose bits on the card do not depend
    on the slab's shape)."""
    A, Bm, Cm = first_layer_partials(triplane, weights, spec, x_coords)
    return density_mlp(A, Bm, Cm, weights, spec)


def triplane_points_plain(
    triplane: torch.Tensor,
    weights: Weights,
    px: torch.Tensor,
    py: torch.Tensor,
    pz: torch.Tensor,
    spec: DensityGridSpec,
) -> torch.Tensor:
    """Plain version of kernel K4. triplane (3, C, H, W), flat (N,) world
    coords in (-radius, radius) -> (5, N) f32: density, density_act, then
    color (3 rows). The planes are sampled in their own dtype and only the
    features are cast to the compute dtype, as the JAX package does."""
    cd = spec.compute_dtype
    act = get_activation(spec.activation)
    r = spec.radius
    h = sample_triplane(triplane, px / r, py / r, pz / r, spec.align_corners).to(cd)
    for W, b in weights[:-1]:
        h = act(W.to(cd).t() @ h + b.to(cd)[:, None])
    W, b = weights[-1]
    out = (W.to(cd).t() @ h + b.to(cd)[:, None]).float()  # (4, N)
    density = out[0]
    density_act = get_activation(spec.density_activation)(density + spec.density_bias)
    return torch.cat([density[None], density_act[None], torch.sigmoid(out[1:4])])


def _triplane_lib():
    fn = kernels.load("triplane_points").triplane_points_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
            ctypes.c_float
        ] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


_K4_FEATURES = 128  # K4's first-layer depth: the 120 features and 8 zero columns


def pack_triplane_weights(weights: Weights, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The decoder in kernel K4's layout.

    Returns bf16 rows (2*64 + L*64 + 8, 64), 128-byte swizzled: the first
    layer's (out, in) matrix, its 120 inputs zero-padded to 128, as two
    64-deep halves of 64 rows; each hidden layer's (out, in) matrix; all of
    these halved; then the output layer's 4 channels (not halved) and 4 zero
    rows. And f32 (64 + L*64 + 8,): the first and each hidden layer's bias
    halved, then the output bias zero-padded to 8. The halving is exact in
    bf16 and lets each product give h = x / 2 for silu(x) = h (1 + tanh h);
    the values are the plain version's bf16 weights and biases."""
    bf = lambda t: t.detach().to(torch.bfloat16).float()  # noqa: E731
    (w1, b1), hidden, (w_out, b_out) = weights[0], weights[1:-1], weights[-1]
    first = torch.zeros(_HIDDEN, _K4_FEATURES, dtype=torch.float32, device=w1.device)
    first[:, : w1.shape[0]] = 0.5 * bf(w1).t()
    out_rows = torch.zeros(8, _HIDDEN, dtype=torch.float32, device=w_out.device)
    out_rows[: w_out.shape[1]] = bf(w_out).t()
    rows = torch.cat([first[:, :_HIDDEN], first[:, _HIDDEN:]] + [0.5 * bf(w).t() for w, _ in hidden] + [out_rows])
    W = swizzle_128b(rows.to(device, torch.bfloat16)).contiguous()
    bias_out = torch.zeros(8, dtype=torch.float32, device=b_out.device)
    bias_out[: b_out.shape[0]] = bf(b_out)
    bias = torch.cat([0.5 * bf(b1)] + [0.5 * bf(b) for _, b in hidden] + [bias_out])
    return W, bias.to(device).contiguous()


def pack_triplane_planes(triplane: torch.Tensor) -> torch.Tensor:
    """The planes channels last, (3, H, W, C), so that a bilinear tap is one
    contiguous row: bf16 codes stay bf16 (an 80-byte tap), any other dtype
    becomes f32 (160 bytes). Either holds the codes' own values exactly, so
    the taps are summed from them as the plain version sums them."""
    dtype = torch.bfloat16 if triplane.dtype == torch.bfloat16 else torch.float32
    return triplane.to(dtype).permute(0, 2, 3, 1).contiguous()


def pack_triplane_inputs(triplane: torch.Tensor, weights: Weights):
    """Kernel K4's inputs besides the points, laid out once per scene code:
    the planes as ``pack_triplane_planes`` lays them out and the decoder as
    ``pack_triplane_weights`` packs it -> (planes, weights, biases)."""
    return (pack_triplane_planes(triplane), *pack_triplane_weights(weights, triplane.device))


def triplane_points(
    triplane: torch.Tensor,
    weights: Weights,
    px: torch.Tensor,
    py: torch.Tensor,
    pz: torch.Tensor,
    spec: DensityGridSpec,
    packed=None,
) -> torch.Tensor:
    """Kernel K4 on CUDA tensors, its plain version on CPU tensors (same
    arguments and result as ``triplane_points_plain``). ``packed``: the
    result of ``pack_triplane_inputs`` for these planes and weights, when
    the caller has it already."""
    if not triplane.is_cuda:
        return triplane_points_plain(triplane, weights, px, py, pz, spec)
    if spec.compute_dtype != torch.bfloat16:
        raise TypeError(
            f"triplane point kernel computes in bf16, got {spec.compute_dtype} (use a bf16 extract dtype)"
        )
    if spec.activation.lower() != "silu" or spec.density_activation.lower() != "exp":
        raise ValueError("triplane point kernel implements silu hidden layers and exp density only")
    P, C, H, W = triplane.shape
    if (
        P != 3 or C != 40 or len(weights) != _LAYERS + 2
        or weights[0][0].shape != (3 * C, _HIDDEN) or weights[-1][0].shape != (_HIDDEN, 4)
        or any(w.shape != (_HIDDEN, _HIDDEN) for w, _ in weights[1:-1])
    ):
        raise ValueError(f"triplane point kernel takes 120 -> 64, {_LAYERS} hidden 64x64 layers and 64 -> 4 "
                         "over (3, 40, H, W) planes")
    N = px.shape[0]
    coords = [kernels.aligned(t.float()) for t in (px, py, pz)]
    if any(t.shape != (N,) or not t.is_cuda for t in coords):
        raise ValueError("triplane point kernel takes three flat (N,) coordinate arrays on the card")
    dev = triplane.device
    planes, Wp, bias = packed if packed is not None else pack_triplane_inputs(triplane, weights)
    if planes.dtype not in (torch.bfloat16, torch.float32) or planes.shape != (P, H, W, C):
        raise ValueError(f"triplane point kernel takes bf16 or f32 (3, H, W, 40) planes, got {planes.dtype} "
                         f"{tuple(planes.shape)}")
    out = torch.empty((5, N), dtype=torch.float32, device=dev)
    num_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    err = _triplane_lib()(
        planes.data_ptr(), int(planes.dtype == torch.bfloat16), *(t.data_ptr() for t in coords), Wp.data_ptr(),
        bias.data_ptr(), out.data_ptr(),
        N, H, W, float(spec.radius), float(spec.density_bias), int(spec.align_corners), num_sms,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    kernels.check(err, "triplane_points_fwd")
    triplane_points.launches += 1
    return out


triplane_points.launches = 0


def query_triplane_points(
    triplane: torch.Tensor,
    weights: Weights,
    px: torch.Tensor,
    py: torch.Tensor,
    pz: torch.Tensor,
    spec: DensityGridSpec,
    packed=None,
) -> Dict[str, torch.Tensor]:
    """Scattered query at flat (N,) world coords in (-radius, radius):
    density/density_act (N,) and color (3, N), channels first; kernel K4 on
    the card."""
    out = triplane_points(triplane, weights, px, py, pz, spec, packed)
    return {"density": out[0], "density_act": out[1], "color": out[2:5]}


# -- SF3D: the multi-head query over the marching-tets lattice (kernel K5) --


def lattice_coords_tets(resolution: int, device=None) -> torch.Tensor:
    """Normalized [-1, 1] coords of the (res+1)-point marching-tets lattice:
    points at i / res in [0, 1], scaled to the bbox and divided by the
    radius -> 2 i / res - 1."""
    return 2.0 * torch.arange(resolution + 1, dtype=torch.float32, device=device) / resolution - 1.0


def multihead_partials(
    triplane: torch.Tensor, heads: Sequence[Weights], coords: torch.Tensor, spec: DensityGridSpec
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The factorized first layer of all heads at once, their first layers
    side by side (the planes are resampled once): A (R_i, R_j, sum h) + b1,
    B (R_k, R_i, sum h), C (R_k, R_j, sum h) in the compute dtype."""
    W1 = torch.cat([w[0][0] for w in heads], dim=1)
    b1 = torch.cat([w[0][1] for w in heads])
    cd = spec.compute_dtype
    Fxy, Fxz, Fyz = sample_triplane_regular_grid(triplane, coords, coords, coords, spec.align_corners)
    C = triplane.shape[1]
    A = torch.einsum("cji,cn->ijn", Fxy.to(cd), W1[:C].to(cd)) + b1.to(cd)
    Bm = torch.einsum("cki,cn->kin", Fxz.to(cd), W1[C : 2 * C].to(cd))
    Cm = torch.einsum("ckj,cn->kjn", Fyz.to(cd), W1[2 * C :].to(cd))
    return A, Bm, Cm


def grid_multihead_plain(
    A: torch.Tensor, B: torch.Tensor, C: torch.Tensor, heads: Sequence[Weights], spec: DensityGridSpec
) -> torch.Tensor:
    """Plain version of kernel K5, the heads one after another. A, B, C as
    ``multihead_partials`` gives them -> (K_total, R, R, R) f32 raw head
    outputs (no output bias of the head, no activation) in [x, y, z] order,
    channels in head order."""
    R = A.shape[0]
    act = get_activation(spec.activation)
    outs, col = [], 0
    for weights in heads:
        h1 = weights[0][0].shape[1]
        a, b, c = (t[..., col : col + h1] for t in (A, B, C))
        col += h1
        slabs = []
        for z0 in range(0, R, spec.slab):
            h = act(a[None] + b[z0 : z0 + spec.slab, :, None, :] + c[z0 : z0 + spec.slab, None, :, :])
            slabs.append(_run_hidden(h, weights, act, A.dtype).float())  # (slab, Ri, Rj, K)
        outs.append(torch.cat(slabs).permute(3, 1, 2, 0))  # (K, x, y, z)
    return torch.cat(outs).contiguous()


def _multihead_lib():
    fn = kernels.load("grid_multihead").grid_multihead_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


_K5_HEADS = 2  # kernel K5 takes two heads, each 64 -> 64 (SiLU) -> K


def pack_multihead_weights(heads: Sequence[Weights], device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two heads' hidden and output layers in kernel K5's layout.

    Returns bf16 rows (2*64 + 2*8, 64), 128-byte swizzled: each head's
    hidden (out, in) matrix halved, then an 8-row output tile per head whose
    rows are the head's output channels at their place in the concatenated
    output (head 0's from row 0, head 1's after them, the rest zero); and
    f32 (2*64 + 8,): each hidden bias halved, then the output biases in
    channel order, zero-padded to 8. The halving is exact in bf16 and lets
    each product give h = x / 2 for silu(x) = h (1 + tanh h)."""
    k0 = heads[0][-1][0].shape[1]
    tiles = torch.zeros(2, 8, _HIDDEN, dtype=torch.float32, device=heads[0][-1][0].device)
    bias_out = torch.zeros(8, dtype=torch.float32, device=tiles.device)
    for h, (w, b) in enumerate(w_[-1] for w_ in heads):
        off = 0 if h == 0 else k0
        tiles[h, off : off + w.shape[1]] = w.detach().t().to(torch.bfloat16).float()
        bias_out[off : off + w.shape[1]] = b.detach().to(torch.bfloat16).float()
    rows = torch.cat([0.5 * w[1][0].detach().t().to(torch.bfloat16).float() for w in heads] + [tiles.reshape(16, _HIDDEN)])
    W = swizzle_128b(rows.to(device, torch.bfloat16)).contiguous()
    bias = torch.cat([0.5 * w[1][1].detach().to(torch.bfloat16).float() for w in heads] + [bias_out])
    return W, bias.to(device).contiguous()


def grid_multihead(
    A: torch.Tensor, B: torch.Tensor, C: torch.Tensor, heads: Sequence[Weights], spec: DensityGridSpec,
    packed=None,
) -> torch.Tensor:
    """Kernel K5 on CUDA tensors, its plain version on CPU tensors.
    ``packed``: ``pack_multihead_weights(heads, A.device)``, when the caller
    keeps it (``SF3D`` packs its heads once per model)."""
    if not A.is_cuda:
        return grid_multihead_plain(A, B, C, heads, spec)
    R = A.shape[0]
    if A.dtype != torch.bfloat16:
        raise TypeError(f"multi-head grid kernel computes in bf16, got {A.dtype} (use a bf16 extract dtype on the card)")
    if spec.activation.lower() != "silu":
        raise ValueError("multi-head grid kernel implements silu hidden layers only")
    width = _K5_HEADS * _HIDDEN
    if A.shape != (R, R, width) or B.shape != A.shape or C.shape != A.shape:
        raise ValueError(f"bad partial-sum shapes {tuple(A.shape)} {tuple(B.shape)} {tuple(C.shape)}")
    k_total = sum(w[-1][0].shape[1] for w in heads)
    if (
        len(heads) != _K5_HEADS
        or any(len(w) != 3 or w[0][0].shape[1] != _HIDDEN or w[1][0].shape != (_HIDDEN, _HIDDEN) for w in heads)
        or k_total > 8
    ):
        raise ValueError("multi-head grid kernel takes two heads of one hidden 64x64 layer, at most 8 outputs in all")
    dev = A.device
    W, bias = packed if packed is not None else pack_multihead_weights(heads, dev)
    if (
        W.shape != (_K5_HEADS * (_HIDDEN + 8), _HIDDEN) or W.dtype != torch.bfloat16 or not W.is_cuda
        or bias.shape != (_K5_HEADS * _HIDDEN + 8,) or bias.dtype != torch.float32 or not bias.is_cuda
    ):
        raise ValueError(f"multi-head grid kernel takes weights as pack_multihead_weights gives them on the card, "
                         f"got {W.dtype} {tuple(W.shape)} on {W.device} and {bias.dtype} {tuple(bias.shape)}")
    A, B, C = (kernels.aligned(t) for t in (A, B, C))
    out = torch.empty((k_total, R, R, R), dtype=torch.float32, device=dev)
    num_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    err = _multihead_lib()(
        A.data_ptr(), B.data_ptr(), C.data_ptr(), W.data_ptr(), bias.data_ptr(), out.data_ptr(),
        R, k_total, num_sms, torch.cuda.current_stream(dev).cuda_stream,
    )
    kernels.check(err, "grid_multihead_fwd")
    grid_multihead.launches += 1
    return out


grid_multihead.launches = 0


def query_grid_multihead(
    triplane: torch.Tensor, head_weights: Dict[str, Weights], coords: torch.Tensor, spec: DensityGridSpec,
    packed=None,
) -> Dict[str, torch.Tensor]:
    """Multi-head lattice query (SF3D's ``MaterialMLP`` over the tet
    lattice, ``sf3d/system.py:141-168``): the separable resample and the
    factorized first layer shared by the heads, then kernel K5 (or its plain
    version on the CPU). triplane (3, C, H, W), coords (R,) normalized ->
    {head: (K, R, R, R) f32 raw outputs in [x, y, z] order}; callers apply
    the heads' output biases and activations. ``packed``: K5's weights as
    ``pack_multihead_weights`` gives them, when the caller keeps them."""
    heads = list(head_weights.values())
    A, B, C = multihead_partials(triplane, heads, coords, spec)
    out = grid_multihead(A, B, C, heads, spec, packed)
    split, col = {}, 0
    for name, w in head_weights.items():
        k = w[-1][0].shape[1]
        split[name] = out[col : col + k]
        col += k
    return split


# -- SF3D: the bake's scattered two-head query (kernel K6) --


def _inv_radius(spec: DensityGridSpec) -> float:
    """The f32 reciprocal of the radius (f32 1 / f32 r)."""
    return float(torch.tensor(1.0) / torch.tensor(spec.radius))


def points_multihead_plain(
    triplane: torch.Tensor, heads: Sequence[Weights], px: torch.Tensor, py: torch.Tensor, pz: torch.Tensor,
    spec: DensityGridSpec,
) -> torch.Tensor:
    """Plain version of kernel K6. triplane (3, C, H, W), flat (N,) world
    coords -> (K_total, N) f32 raw outputs of the heads, one after another
    (no output activation), channels in head order. The planes are cast to
    the compute dtype before the bilinear sample, as the JAX package does;
    the coordinates are scaled by the f32 reciprocal of the radius, as XLA
    computes their division by it."""
    cd = spec.compute_dtype
    act = get_activation(spec.activation)
    inv_r = _inv_radius(spec)
    feats = sample_triplane(triplane.to(cd), px * inv_r, py * inv_r, pz * inv_r, spec.align_corners).to(cd)
    outs = []
    for weights in heads:
        h = feats
        for W, b in weights[:-1]:
            h = act(W.to(cd).t() @ h + b.to(cd)[:, None])
        W, b = weights[-1]
        outs.append((W.to(cd).t() @ h + b.to(cd)[:, None]).float())
    return torch.cat(outs)


def _points_lib():
    fn = kernels.load("points_multihead").points_multihead_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_float] + [ctypes.c_int] * 2 + [
            ctypes.c_void_p
        ]
        fn.restype = ctypes.c_int
    return fn


def _planes_lib():
    fn = kernels.load("points_multihead").points_planes_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


_K6_LAYERS = 2  # hidden 64x64 layers per head kernel K6 is built for (MaterialMLP's features/perturb_normal)


def pack_points_weights(heads: Sequence[Weights], device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two heads in kernel K6's layout.

    Returns bf16 rows (2*2*64 + 2*L*64 + 2*8, 64), 128-byte swizzled: each
    head's first-layer (out, in) matrix, its 120 inputs zero-padded to 128,
    as two 64-deep halves of 64 rows (head 0's, then head 1's); each head's
    hidden (out, in) matrices in layer order (head 0's, then head 1's); all
    of these halved; then an 8-row output tile per head (not halved) whose
    rows are the head's output channels at their place in the concatenated
    output (head 0's from row 0, head 1's after them, the rest zero). And
    f32 (3*2*64 + 8,): the halved biases of the first layer (head 0's, head
    1's), then of each hidden layer likewise, then the output biases in
    channel order, zero-padded to 8. The halving is exact in bf16 and lets
    each product give h = x / 2 for silu(x) = h (1 + tanh h); the values are
    the plain version's bf16 weights and biases."""
    bf = lambda t: t.detach().to(torch.bfloat16).float()  # noqa: E731
    dev = heads[0][0][0].device
    k0 = heads[0][-1][0].shape[1]
    rows = []
    for w1, _ in (h[0] for h in heads):
        first = torch.zeros(_HIDDEN, _K4_FEATURES, dtype=torch.float32, device=dev)
        first[:, : w1.shape[0]] = 0.5 * bf(w1).t()
        rows += [first[:, :_HIDDEN], first[:, _HIDDEN:]]
    rows += [0.5 * bf(h[1 + layer][0]).t() for h in heads for layer in range(_K6_LAYERS)]
    tiles = torch.zeros(2, 8, _HIDDEN, dtype=torch.float32, device=dev)
    bias_out = torch.zeros(8, dtype=torch.float32, device=dev)
    for i, (w, b) in enumerate(h[-1] for h in heads):
        off = 0 if i == 0 else k0
        tiles[i, off : off + w.shape[1]] = bf(w).t()
        bias_out[off : off + w.shape[1]] = bf(b)
    W = swizzle_128b(torch.cat(rows + [tiles.reshape(16, _HIDDEN)]).to(device, torch.bfloat16)).contiguous()
    bias = torch.cat([0.5 * bf(h[layer][1]) for layer in range(_K6_LAYERS + 1) for h in heads] + [bias_out])
    return W, bias.to(device).contiguous()


def points_planes_plain(triplane: torch.Tensor) -> torch.Tensor:
    """Plain version of K6's planes relayout: (3, C, H, W) -> bf16 (3, H, W,
    C), so that a bilinear tap is one contiguous 80-byte row."""
    return triplane.to(torch.bfloat16).permute(0, 2, 3, 1).contiguous()


def points_planes(triplane: torch.Tensor) -> torch.Tensor:
    """K6's planes relayout, once per scene code: the kernel
    ``points_planes_fwd`` (one pass, f32 or bf16 codes) on a CUDA tensor,
    ``points_planes_plain`` on a CPU tensor; the same result."""
    if not triplane.is_cuda:
        return points_planes_plain(triplane)
    P, C, H, W = triplane.shape
    if C != 40 or triplane.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the planes relayout takes (P, 40, H, W) f32 or bf16 planes, got {triplane.dtype} "
                         f"{tuple(triplane.shape)}")
    src = triplane.contiguous()
    out = torch.empty((P, H, W, C), dtype=torch.bfloat16, device=triplane.device)
    err = _planes_lib()(
        src.data_ptr(), int(src.dtype == torch.bfloat16), out.data_ptr(), P, C, H, W,
        torch.cuda.current_stream(triplane.device).cuda_stream,
    )
    kernels.check(err, "points_planes_fwd")
    points_planes.launches += 1
    return out


points_planes.launches = 0


def pack_points_inputs(triplane: torch.Tensor, heads: Sequence[Weights]):
    """Kernel K6's inputs besides the points: the planes as
    ``points_planes`` lays them out (once per scene code) and the heads as
    ``pack_points_weights`` packs them (once per model, ``SF3D`` keeps
    them) -> (planes, weights, biases)."""
    return (points_planes(triplane), *pack_points_weights(heads, triplane.device))


def points_multihead(
    triplane: torch.Tensor, heads: Sequence[Weights], px: torch.Tensor, py: torch.Tensor, pz: torch.Tensor,
    spec: DensityGridSpec, packed=None,
) -> torch.Tensor:
    """Kernel K6 on CUDA tensors, its plain version on CPU tensors (same
    arguments and result as ``points_multihead_plain``). ``packed``: the
    result of ``pack_points_inputs`` for these planes and heads, when the
    caller has it already."""
    if not triplane.is_cuda:
        return points_multihead_plain(triplane, heads, px, py, pz, spec)
    if spec.compute_dtype != torch.bfloat16:
        raise TypeError(f"point query kernel computes in bf16, got {spec.compute_dtype} (use a bf16 extract dtype)")
    if spec.activation.lower() != "silu":
        raise ValueError("point query kernel implements silu hidden layers only")
    P, C, H, W = triplane.shape
    k_total = sum(w[-1][0].shape[1] for w in heads)
    if (
        P != 3 or C != 40 or len(heads) != 2
        or any(len(w) != _K6_LAYERS + 2 or w[0][0].shape != (3 * C, _HIDDEN) for w in heads)
        or any(w[1 + i][0].shape != (_HIDDEN, _HIDDEN) for w in heads for i in range(_K6_LAYERS))
        or k_total > 8
    ):
        raise ValueError("point query kernel takes two heads of 120 -> 64 and two hidden 64x64 layers, "
                         "at most 8 outputs in all, over (3, 40, H, W) planes")
    N = px.shape[0]
    coords = [kernels.aligned(t.float()) for t in (px, py, pz)]
    if any(t.shape != (N,) or not t.is_cuda for t in coords):
        raise ValueError("point query kernel takes three flat (N,) coordinate arrays on the card")
    dev = triplane.device
    planes, Wp, bias = packed if packed is not None else pack_points_inputs(triplane, heads)
    rows = 2 * 2 * _HIDDEN + 2 * _K6_LAYERS * _HIDDEN + 2 * 8
    if (
        planes.shape != (P, H, W, C) or planes.dtype != torch.bfloat16 or not planes.is_contiguous()
        or Wp.shape != (rows, _HIDDEN) or Wp.dtype != torch.bfloat16 or bias.shape != (6 * _HIDDEN + 8,)
        or bias.dtype != torch.float32 or not all(t.is_cuda for t in (planes, Wp, bias))
    ):
        raise ValueError("point query kernel takes its planes and weights as pack_points_inputs gives them on the "
                         f"card, got {planes.dtype} {tuple(planes.shape)}, {Wp.dtype} {tuple(Wp.shape)}, "
                         f"{bias.dtype} {tuple(bias.shape)}")
    out = torch.empty((k_total, N), dtype=torch.float32, device=dev)
    inv_r = _inv_radius(spec)
    num_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    err = _points_lib()(
        planes.data_ptr(), *(t.data_ptr() for t in coords), Wp.data_ptr(), bias.data_ptr(), out.data_ptr(),
        N, H, W, k_total, inv_r, int(spec.align_corners), num_sms, torch.cuda.current_stream(dev).cuda_stream,
    )
    kernels.check(err, "points_multihead_fwd")
    points_multihead.launches += 1
    return out


points_multihead.launches = 0


def query_points_multihead(
    triplane: torch.Tensor, head_weights: Dict[str, Weights], px: torch.Tensor, py: torch.Tensor, pz: torch.Tensor,
    spec: DensityGridSpec, packed=None,
) -> Dict[str, torch.Tensor]:
    """Scattered multi-head query (the texture bake, ``sf3d/system.py:375-377``):
    flat (N,) world coords -> {head: (K, N) f32 raw outputs}, channels
    first; kernel K6 on the card. ``packed``: K6's planes and weights as
    ``pack_points_inputs`` gives them, when the caller keeps them."""
    out = points_multihead(triplane, list(head_weights.values()), px, py, pz, spec, packed)
    split, col = {}, 0
    for name, w in head_weights.items():
        k = w[-1][0].shape[1]
        split[name] = out[col : col + k]
        col += k
    return split
