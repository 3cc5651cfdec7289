"""SF3D system: the Stable Fast 3D ("Pro") image -> textured mesh model in
PyTorch.

Counterpart of ``sculptmate_tpu/systems/sf3d.py`` (``sf3d/system.py:96-528``
in the reference): camera-modulated DINOv2-large tokenizer -> learned 96^2
triplane tokens -> two-stream interleave backbone -> pixel-shuffle upsample
to (3, 40, 384, 384) codes -> the density and vertex-offset heads of
``MaterialMLP`` over the 161^3 marching-tets lattice (kernel K5) ->
wire-format marching tets on the device (kernel K7) -> one uint8 transfer -> faces
rebuilt and snapped vertices welded on the host by the native wire decoder
-> quadric decimation to the vertex budget -> the cube-projection UV unwrap
-> the texture bake.

The unwrap runs on the device (kernel K9, with the rasterizer K8) when the
model is on the card and on the host otherwise. The bake rasterizes the
atlas (K8), interpolates world positions, queries the features and
perturb-normal heads there (K6), composes the tangent-space bump map,
dilates the islands and quantizes to uint8; the three PNGs are encoded on
the host without PIL. On the card the unwrap and the bake run fused
(``unwrap_bake``): one upload of u16-quantized rotated positions and int32
faces, one set of asynchronous copies back (the textures as uint8, the
per-corner UVs as f32), no host sync in the dispatch.

The encoder computes in ``dtype`` (bf16 on the card) under autocast, its
matrix weights stored in ``dtype`` once (``cast_matrix_weights``) and the
other parameters in f32; the lattice and texel queries compute in
``extract_dtype``, which follows it, from the f32 decoder. The wire has a
fixed vertex capacity, dispatched, grown after an overflow and kept by
``capacities`` (``runtime/capacity_cache.Capacities``). The rasterizer has
no capacity at all.

Each stage runs inside a ``torch.profiler`` span named ``sf3d.<stage>``:
``encode`` (holding ``materials``, the CLIP estimator), ``extract``
(holding ``grid``, ``marching_tets``, ``wire_to_host`` and
``wire_decode``; each re-extraction after a capacity overflow runs inside
``capacity_retry``, so their number is the retry count), ``decimate``,
then ``unwrap_bake`` (fused; its host parts in ``bake_prep``,
``bake_wait`` and ``png_encode``) or ``unwrap`` and ``bake`` (holding
``png_encode``).

Beside the wire, ``_extract_packed`` and ``_extract_packed_mesh`` give the
packed mesh of the JAX package's ``_extract_jit`` and
``_extract_packed_jit`` (kernel K11 on the card); no public mode reaches
them, as in the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
from torch.profiler import record_function

from sculptmate_tpu_torch.config import load_yaml_config
from sculptmate_tpu_torch.geometry import mt_wire, texture_bake
from sculptmate_tpu_torch.geometry.decimate import decimate, vertex_normals
from sculptmate_tpu_torch.geometry.marching_tets import (
    N_WIRE_COUNTS, MTResult, lattice_size, marching_tets, mt_wire_device,
)
from sculptmate_tpu_torch.geometry.mesh import Mesh
from sculptmate_tpu_torch.geometry.uv_unwrap import _main_axis_rotation
from sculptmate_tpu_torch.geometry.uv_unwrap_device import unwrap_core
from sculptmate_tpu_torch.io.png import encode_png
from sculptmate_tpu_torch.models.camera import LinearCameraEmbedder, default_cond_c2w, intrinsic_from_fov_deg
from sculptmate_tpu_torch.models.clip import CLIPAttention
from sculptmate_tpu_torch.models.dinov2 import DINOV2SingleImageTokenizer
from sculptmate_tpu_torch.models.estimators import ClipBasedHeadEstimator, MultiHeadEstimator
from sculptmate_tpu_torch.models.heads import MaterialMLP
from sculptmate_tpu_torch.models.tokenizers import TriplaneLearnablePositionalEmbedding
from sculptmate_tpu_torch.models.two_stream import TwoStreamInterleaveTransformer
from sculptmate_tpu_torch.models.upsamplers import PixelShuffleUpsampleNetwork
from sculptmate_tpu_torch.ops.density_grid import (
    DensityGridSpec,
    lattice_coords_tets,
    mlp_weights_from_params,
    pack_multihead_weights,
    pack_points_weights,
    points_planes,
    query_grid_multihead,
    query_points_multihead,
)
from sculptmate_tpu_torch.ops.resize import resize_bilinear_antialias
from sculptmate_tpu_torch.runtime.capacity_cache import Capacities
from sculptmate_tpu_torch.runtime.checkpoint import is_optional_sf3d_key
from sculptmate_tpu_torch.runtime.device import resolve_device
from sculptmate_tpu_torch.systems.tsr import _HostCopy, _to_host_async, cast_matrix_weights, upload

DEFAULT_HEADS = (
    {"name": "density", "out_channels": 1, "out_bias": -1.0, "n_hidden_layers": 2,
     "output_activation": "trunc_exp"},
    {"name": "features", "out_channels": 3, "n_hidden_layers": 3,
     "output_activation": "sigmoid"},
    {"name": "perturb_normal", "out_channels": 3, "n_hidden_layers": 3,
     "output_activation": "normalize_channel_last"},
    {"name": "vertex_offset", "out_channels": 3, "n_hidden_layers": 2},
)
# the submodules that run under autocast; the decoder stays f32 (its kernels
# pack their own bf16 copies)
_ENCODERS = ("camera_embedder", "image_tokenizer", "tokenizer", "backbone", "post_processor", "image_estimator",
             "global_estimator")
# the heads the lattice query runs, in output-channel order (kernel K5 takes
# exactly this pair)
_LATTICE_HEADS = ("density", "vertex_offset")
# the heads the texel query runs, in output-channel order (kernel K6)
_TEXEL_HEADS = ("features", "perturb_normal")
# vertex budget per simplification setting (sf3d/system.py:346-351; "medium"
# is accepted beside the reference's "med")
_BUDGET = {"high": 0.75, "med": 0.4, "medium": 0.4, "low": 0.1}


@dataclasses.dataclass(frozen=True)
class SF3DConfig:
    cond_image_size: int = 512
    isosurface_resolution: int = 160
    isosurface_threshold: float = 10.0
    radius: float = 0.87
    # snap-weld: an MT interpolation t within weld_eps of {0, 1} snaps onto
    # the shared deformed lattice point, and the wire decoder welds those
    # vertices and drops the degenerate slivers; 0 keeps raw marching tets
    weld_eps: float = 0.2
    background_color: Tuple[float, float, float] = (0.5, 0.5, 0.5)
    default_fovy_deg: float = 40.0
    default_distance: float = 1.6

    camera_in_channels: int = 25
    camera_out_channels: int = 768
    plane_size: int = 96
    num_channels: int = 1024
    num_attention_heads: int = 16
    attention_head_dim: int = 64
    num_latents: int = 1792
    num_blocks: int = 4
    num_basic_blocks: int = 3
    upsample_out_channels: int = 40
    upsample_scale_factor: int = 4
    upsample_conv_layers: int = 4
    decoder_heads: Tuple[Dict[str, Any], ...] = DEFAULT_HEADS
    decoder_n_neurons: int = 64
    decoder_activation: str = "silu"

    # encoder sizes (facebook/dinov2-large and CLIP ViT-B/32)
    dinov2_hidden_size: int = 1024
    dinov2_num_layers: int = 24
    dinov2_num_heads: int = 16
    dinov2_intermediate_size: int = 4096
    clip_width: int = 768
    clip_layers: int = 12
    clip_heads: int = 12

    @classmethod
    def from_yaml(cls, path: str) -> "SF3DConfig":
        """Load the reference's config.yaml layout (``stabilityai/
        stable-fast-3d``), ``${...}`` interpolations resolved; the encoder
        sizes are not read from it (the defaults are DINOv2-L and CLIP
        ViT-B/32), as in the JAX package."""
        y = load_yaml_config(path)
        heads = tuple(dict(h) for h in y["decoder"]["heads"])
        return cls(
            cond_image_size=y.get("cond_image_size", 512),
            isosurface_resolution=y.get("isosurface_resolution", 160),
            isosurface_threshold=y.get("isosurface_threshold", 10.0),
            radius=y.get("radius", 0.87),
            weld_eps=y.get("weld_eps", 0.2),
            camera_in_channels=y["camera_embedder"]["in_channels"],
            camera_out_channels=y["camera_embedder"]["out_channels"],
            plane_size=y["tokenizer"]["plane_size"],
            num_channels=y["tokenizer"]["num_channels"],
            num_attention_heads=y["backbone"]["num_attention_heads"],
            attention_head_dim=y["backbone"]["attention_head_dim"],
            num_latents=y["backbone"]["num_latents"],
            num_blocks=y["backbone"]["num_blocks"],
            num_basic_blocks=y["backbone"]["num_basic_blocks"],
            upsample_out_channels=y["post_processor"]["out_channels"],
            upsample_scale_factor=y["post_processor"]["scale_factor"],
            upsample_conv_layers=y["post_processor"]["conv_layers"],
            decoder_heads=heads,
            decoder_n_neurons=y["decoder"]["n_neurons"],
            decoder_activation=y["decoder"].get("activation", "silu"),
        )


class SF3DModule(nn.Module):
    """Every learned parameter of the SF3D stack, under the reference
    checkpoint's state-dict names."""

    def __init__(self, config: SF3DConfig):
        super().__init__()
        c = self.config = config
        self.camera_embedder = LinearCameraEmbedder(c.camera_in_channels, c.camera_out_channels)
        self.image_tokenizer = DINOV2SingleImageTokenizer(
            hidden_size=c.dinov2_hidden_size,
            num_layers=c.dinov2_num_layers,
            num_heads=c.dinov2_num_heads,
            intermediate_size=c.dinov2_intermediate_size,
            condition_dim=c.camera_out_channels,
        )
        self.tokenizer = TriplaneLearnablePositionalEmbedding(c.plane_size, c.num_channels)
        self.backbone = TwoStreamInterleaveTransformer(
            num_attention_heads=c.num_attention_heads,
            attention_head_dim=c.attention_head_dim,
            raw_triplane_channels=c.num_channels,
            triplane_channels=c.num_channels,
            raw_image_channels=c.dinov2_hidden_size,
            num_latents=c.num_latents,
            num_blocks=c.num_blocks,
            num_basic_blocks=c.num_basic_blocks,
        )
        self.post_processor = PixelShuffleUpsampleNetwork(
            c.num_channels, c.upsample_out_channels, c.upsample_scale_factor, c.upsample_conv_layers
        )
        self.decoder = MaterialMLP(
            c.decoder_heads, 3 * c.upsample_out_channels, c.decoder_n_neurons, c.decoder_activation
        )
        self.image_estimator = ClipBasedHeadEstimator(
            clip_width=c.clip_width, clip_layers=c.clip_layers, clip_heads=c.clip_heads
        )
        self.global_estimator = MultiHeadEstimator(triplane_features=c.num_channels)

    def forward(self, rgb_cond, c2w_cond, intrinsic_normed_cond, tp=None):
        """rgb_cond (B, S, S, 3) -> (scene_codes (B, 3, 40, 384, 384),
        direct_codes (B, 3, 1024, 96, 96)); ``tp``: the two-stream
        backbone's tp group, or None (the encoders stay whole, as in the
        JAX package)."""
        camera_embeds = self.camera_embedder(c2w_cond, intrinsic_normed_cond)
        image_tokens = self.image_tokenizer(rgb_cond, camera_embeds).transpose(1, 2)  # (B, Nt, C)
        tokens = self.tokenizer(rgb_cond.shape[0]).transpose(1, 2)  # (B, C, 3HW)
        tokens = self.backbone(tokens, image_tokens, tp)
        direct_codes = self.tokenizer.detokenize(tokens.transpose(1, 2))
        return self.post_processor(direct_codes), direct_codes

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded random weights with the JAX package's initializer scales:
        fan-in normal kernels and zero biases, unit norms, unit LayerScale,
        zero AdaLN modulations, N(0, 1)/sqrt(C) triplane tokens, N(0, 0.02)
        position tables, latents, class embedding and CLIP projection."""
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                m.weight.normal_(0.0, m.weight[0].numel() ** -0.5, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, CLIPAttention):
                m.in_proj_weight.normal_(0.0, m.in_proj_weight.shape[1] ** -0.5, generator=generator)
                m.in_proj_bias.zero_()
        dino = self.image_tokenizer.model
        dino.embeddings.cls_token.zero_()
        dino.embeddings.position_embeddings.normal_(0.0, 0.02, generator=generator)
        for layer in dino.encoder.layer:
            for mod in (layer.norm1_modulation, layer.norm2_modulation):
                mod.linear2.weight.zero_()
            layer.layer_scale1.lambda1.fill_(1.0)
            layer.layer_scale2.lambda1.fill_(1.0)
        tok = self.tokenizer.embeddings
        tok.normal_(0.0, 1.0, generator=generator).div_(tok.shape[1] ** 0.5)
        self.backbone.latent_init.normal_(0.0, 0.02, generator=generator)
        clip = self.image_estimator.model.visual
        for p in (clip.class_embedding, clip.positional_embedding, clip.proj):
            p.normal_(0.0, 0.02, generator=generator)


class SF3D:
    """Host-side wrapper: the module, its device and dtype, and the
    extraction policy (``sf3d/system.py``'s ``run_image``).

    ``device`` defaults to the card; without one it raises rather than run
    on the CPU (pass ``device="cpu"`` for that). ``state_dict`` holds the
    reference checkpoint's keys (``runtime/checkpoint.py:
    load_sf3d_state_dict``); without one the weights are random from
    ``seed``.
    """

    def __init__(
        self,
        config: Optional[SF3DConfig] = None,
        state_dict=None,
        seed: int = 0,
        dtype: torch.dtype = torch.bfloat16,
        extract_dtype: Optional[torch.dtype] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.config = c = config or SF3DConfig()
        self.dtype = dtype
        # lattice-query compute dtype: follows the model dtype. Kernel K5
        # computes in bf16, so an f32 model on the card passes bf16 here
        self.extract_dtype = extract_dtype if extract_dtype is not None else dtype
        with torch.device(self.device):
            self.module = SF3DModule(c)
        # seeded weights first: a checkpoint may leave out the optional keys
        # (see runtime/checkpoint.py), which then keep the JAX package's
        # initial values (zero AdaLN modulations)
        self.module.reset_parameters(torch.Generator(device=self.device).manual_seed(seed))
        if state_dict is not None:
            missing, unexpected = self.module.load_state_dict(state_dict, strict=False)
            required = [k for k in missing if not is_optional_sf3d_key(k)]
            if required or unexpected:
                raise KeyError(f"SF3D state dict: missing {required}, unexpected {unexpected}")
        self.module.eval().requires_grad_(False)
        cast_matrix_weights(self.module, _ENCODERS, dtype)
        # the fixed condition camera and the background, uploaded once
        _, Kn = intrinsic_from_fov_deg(c.default_fovy_deg, c.cond_image_size, c.cond_image_size)
        self._c2w = upload(default_cond_c2w(c.default_distance), self.device)
        self._Kn = upload(Kn, self.device)
        self._bg = upload(np.asarray(c.background_color), self.device)
        self.capacities = Capacities("torch_sf3d_mt", lambda res: (24 * lattice_size(res) ** 2,),
                                     at_least_default=False)
        self._k5_weights = None  # (key, K5's packed heads), see _k5_weights_packed
        self._k6_weights = None  # (key, K6's packed heads), see _k6_weights_packed

    def replica(self, device) -> "SF3D":
        """This model on another device: the same config, dtypes and
        weights, copied once, and the same capacity policy."""
        out = SF3D(self.config, state_dict=self.module.state_dict(), dtype=self.dtype,
                   extract_dtype=self.extract_dtype, device=device)
        out.capacities = self.capacities
        return out

    def _autocast(self):
        return torch.autocast(self.device.type, dtype=self.dtype, enabled=self.dtype != torch.float32)

    # -- stage 1: image -> scene codes --------------------------------
    def prepare_image(self, image: torch.Tensor):
        """(B, H, W, 4) rgba in [0, 1] -> (mask, rgb lerped onto the
        background) at the cond size (``sf3d/system.py:285-306``)."""
        s = self.config.cond_image_size
        if image.shape[1] != s or image.shape[2] != s:
            image = resize_bilinear_antialias(image, s, s)
        rgb = image[..., :3]
        mask = image[..., 3:4] if image.shape[-1] == 4 else torch.ones_like(image[..., :1])
        bg = self._bg.to(rgb.dtype)
        return mask, (bg * (1.0 - mask) + rgb * mask).clamp(0.0, 1.0)

    @torch.inference_mode()
    def get_scene_codes(self, rgb_cond: torch.Tensor, tp=None):
        """(B, S, S, 3) -> (scene_codes (B, 3, 40, 384, 384), direct_codes).
        ``tp``: a tp group (a tuple of devices, the first this model's) for
        the two-stream backbone, or None."""
        B = rgb_cond.shape[0]
        with self._autocast():
            return self.module(rgb_cond, self._c2w.expand(B, 4, 4), self._Kn.expand(B, 3, 3), tp)

    @torch.inference_mode()
    def estimate_materials(self, masked_rgb: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Global roughness and metallic (``decoder_``-prefixed keys)."""
        with self._autocast():
            return self.module.image_estimator(masked_rgb)

    @torch.inference_mode()
    def estimate_illumination(self, direct_codes: torch.Tensor) -> Dict[str, torch.Tensor]:
        with self._autocast():
            return self.module.global_estimator(direct_codes)

    # -- stage 2: scene code -> mesh ----------------------------------
    def grid_spec(self, compute_dtype: torch.dtype = torch.float32) -> DensityGridSpec:
        N = lattice_size(self.config.isosurface_resolution)
        return DensityGridSpec(
            resolution=N,
            radius=self.config.radius,
            activation=self.config.decoder_activation,
            align_corners=True,  # SF3D's convention (sf3d/system.py:193)
            slab=max(s for s in range(1, 9) if N % s == 0),
            compute_dtype=compute_dtype,
        )

    def lattice_head_weights(self):
        """The density and vertex-offset heads' weights, in that order."""
        return {n: mlp_weights_from_params(self.module.decoder.heads[n]) for n in _LATTICE_HEADS}

    def _packed_once(self, slot: str, names, device, pack):
        """``pack(heads, device)`` of the named heads, packed once and kept
        in ``self.<slot>`` while their parameters (their storage and version
        counters) stay the same, as ``TSR._k4_inputs`` keeps K4's decoder.
        Parameters made under inference mode keep no version counter: they
        are packed anew."""
        params = [p for n in names for p in self.module.decoder.heads[n].parameters()]
        key = None
        if not any(p.is_inference() for p in params):
            key = (torch.device(device), tuple((p.data_ptr(), p._version) for p in params))
        kept = getattr(self, slot)
        if key is None or kept is None or kept[0] != key:
            heads = [mlp_weights_from_params(self.module.decoder.heads[n]) for n in names]
            kept = (key, pack(heads, device))
            setattr(self, slot, kept)
        return kept[1]

    def _k5_weights_packed(self, device):
        """Kernel K5's packed heads on ``device``, packed once per model
        (``_packed_once``; the plain version on the CPU does not read
        them)."""
        return self._packed_once("_k5_weights", _LATTICE_HEADS, device, pack_multihead_weights)

    def _k6_weights_packed(self, device):
        """Kernel K6's packed heads (features, perturb normal) on
        ``device``, packed once per model (``_packed_once``)."""
        return self._packed_once("_k6_weights", _TEXEL_HEADS, device, pack_points_weights)

    @torch.inference_mode()
    def query_lattice(self, scene_code: torch.Tensor):
        """The density and vertex-offset heads' raw outputs on the
        (res+1)^3 lattice (kernel K5 on the card, its weights packed once
        per model) -> {head: (K, N, N, N) f32}."""
        res = self.config.isosurface_resolution
        coords = lattice_coords_tets(res, scene_code.device)
        return query_grid_multihead(scene_code, self.lattice_head_weights(), coords, self.grid_spec(self.extract_dtype),
                                    self._k5_weights_packed(scene_code.device))

    @torch.inference_mode()
    def _extract_wire(self, scene_code, threshold: float, max_verts: int, snap_eps: float) -> torch.Tensor:
        """The lattice query, the density head's output bias and activation
        (-1, trunc_exp: ``config.yaml:49-53``), the threshold, then the MT
        wire (``_extract_wire_jit`` in the JAX package)."""
        with record_function("sf3d.grid"):
            grids = self.query_lattice(scene_code)
        with record_function("sf3d.marching_tets"):
            sdf = torch.exp(grids["density"][0] - 1.0) - threshold
            dx, dy, dz = grids["vertex_offset"]
            return mt_wire_device(sdf, dx, dy, dz, self.config.isosurface_resolution, max_verts, snap_eps)

    @torch.inference_mode()
    def _extract_packed(self, scene_code, threshold: float, max_verts: int, max_faces: int) -> MTResult:
        """The lattice query, the density head's bias and activation, the
        threshold, then the packed marching tets (kernel K11 on the card):
        ``_extract_jit`` in the JAX package. Positions in [0, 1] lattice
        units; nothing here waits for the device."""
        with record_function("sf3d.grid"):
            grids = self.query_lattice(scene_code)
        with record_function("sf3d.marching_tets"):
            sdf = torch.exp(grids["density"][0] - 1.0) - threshold
            dx, dy, dz = grids["vertex_offset"]
            return marching_tets(sdf, dx, dy, dz, self.config.isosurface_resolution, max_verts, max_faces)

    def _extract_packed_mesh(self, scene_code, threshold: float, max_verts: int, max_faces: int):
        """``_extract_packed`` with the world positions (v 2r - r), the int32
        faces and the five counters brought to the host in one copy
        (``_extract_packed_jit`` in the JAX package) -> (verts (n, 3) f32,
        faces (m, 3) int32, counters (5,) int64), n and m the counts cut to
        the capacities: a caller compares the counters with them."""
        mt = self._extract_packed(scene_code, threshold, max_verts, max_faces)
        r = self.config.radius
        pos = mt.verts * (2 * r) - r
        with record_function("sf3d.packed_to_host"):
            host = torch.cat([pos.reshape(-1).view(torch.int32), mt.faces.reshape(-1), torch.stack(mt[6:])]).cpu()
        host = host.numpy()
        counts = host[-5:].astype(np.int64)
        nv, nf = min(int(counts[0]), max_verts), min(int(counts[1]), max_faces)
        verts = host[: 3 * max_verts].view(np.float32).reshape(max_verts, 3)[:nv]
        faces = host[3 * max_verts : 3 * (max_verts + max_faces)].reshape(max_faces, 3)[:nf]
        return verts, faces, counts

    def extract_wire_async(self, scene_code: torch.Tensor, threshold: float, max_verts: int = 0) -> tuple:
        """Enqueue one asset's lattice query and MT wire, then the wire's copy
        to pinned host memory; nothing here waits for the device. The vertex
        capacity is ``max_verts`` where given (> 0), else ``capacities``'s
        -> (the host copy, (capacity,)), a ``pending`` for ``extract_mesh``."""
        caps = self.capacities.dispatch(self.config.isosurface_resolution, (max_verts,))
        return _to_host_async(self._extract_wire(scene_code, threshold, *caps, float(self.config.weld_eps))), caps

    def extract_mesh(self, scene_code: torch.Tensor, threshold: float, pending: Optional[tuple] = None):
        """Wire extraction of one asset -> (verts world f32, faces i32, raw
        vertex count) or None for an empty surface. ``pending``: a wire
        already in flight (``extract_wire_async``). An overflow is
        re-extracted with a grown capacity, never decoded truncated."""
        c = self.config
        res = c.isosurface_resolution
        host, caps = pending if pending is not None else self.extract_wire_async(scene_code, threshold)
        while True:
            with record_function("sf3d.wire_to_host"):
                wire = host.wire()
            counts = (int(mt_wire.wire_counts(wire, N_WIRE_COUNTS)[0]),)
            grown = self.capacities.grow(counts, caps)
            if grown is None:
                break
            with record_function("sf3d.capacity_retry"):
                host, caps = self.extract_wire_async(scene_code, threshold, *grown)
        self.capacities.keep(res, counts, caps)
        (nv,), (mv,) = counts, caps
        if nv == 0:
            return None
        with record_function("sf3d.wire_decode"):
            # weld the snapped vertices, drop the degenerate slivers
            lverts, faces, _ = mt_wire.decode_wire(wire, res, mv, weld=c.weld_eps > 0)
        return lverts * (2 * c.radius) - c.radius, faces, nv  # [0, 1] lattice -> world bbox

    @staticmethod
    def decimate_mesh(verts, faces, nv: int, vertex_simplification_factor: str, normals: bool):
        """Quadric decimation to the vertex budget, which counts the raw
        pre-weld vertices ``nv`` as the JAX package does -> (verts, faces,
        vertex normals | None). With ``normals`` False (the fused bake derives
        its own per-face normals) no normals are computed."""
        vertex_count = round(_BUDGET.get(vertex_simplification_factor, 0.75) * nv)
        if vertex_count < len(verts):
            ratio = vertex_count / len(verts)
            if normals:
                return decimate(verts, faces, target_ratio=ratio, return_normals=True)
            return (*decimate(verts, faces, target_ratio=ratio), None)
        return verts, faces, vertex_normals(verts, faces) if normals else None

    def run_image(
        self,
        image,
        bake_resolution: int = 512,
        remesh: str = "triangle",
        vertex_simplification_factor: str = "high",
        estimate_illumination: bool = False,
        enable_texture: bool = True,
        threshold: Optional[float] = None,
        timings: Optional[Dict[str, float]] = None,
        fused: Optional[bool] = None,
    ) -> Optional[Dict[str, Any]]:
        """image: (1, H, W, 3|4) float in [0, 1] (array or tensor). Returns
        the mesh as a dict of host arrays (verts, faces, uvs, normals) with
        the textures (``textures``, ``texture_pngs``, ``roughness``,
        ``metallic``; None without ``enable_texture``), or None when the
        surface is empty.

        ``fused``: the one-dispatch unwrap and bake (default: on when the
        model is on the card). ``timings``: when given, each stage (encode,
        extract, decimate, then unwrap_bake, or unwrap and bake) is bracketed
        by device syncs and its seconds stored there."""

        def stage(name: str):
            return _stage(name, timings, self.device)

        c = self.config
        use_fused = enable_texture and (fused if fused is not None else self.device.type == "cuda")
        with stage("encode"):
            mask, rgb = self.prepare_image(upload(image, self.device))
            scene_codes, direct_codes = self.get_scene_codes(rgb)
            with record_function("sf3d.materials"):
                materials = self.estimate_materials(rgb * mask)
            if estimate_illumination:
                self.estimate_illumination(direct_codes)

        thr = float(c.isosurface_threshold if threshold is None else threshold)
        with stage("extract"):
            extracted = self.extract_mesh(scene_codes[0], thr)
        if extracted is None:
            return None
        verts, faces, nv = extracted
        v_nrm = None
        if remesh == "triangle":
            with stage("decimate"):
                verts, faces, v_nrm = self.decimate_mesh(verts, faces, nv, vertex_simplification_factor, not use_fused)
        mesh = Mesh(verts, faces)
        if v_nrm is not None:
            mesh._v_nrm = v_nrm
        if use_fused:
            with stage("unwrap_bake"):
                uv_flat, textures = self.unwrap_bake(
                    mesh.v_pos, mesh.t_pos_idx, scene_codes[0], materials, bake_resolution
                )
                mesh.apply_flat_uv(uv_flat)
            return {**mesh_arrays(mesh), **textures}
        with stage("unwrap"):
            # the device unwrap (K9) on the card, the host one on the CPU
            mesh.unwrap_uv(backend="auto", device=self.device)
        out = {**mesh_arrays(mesh), "textures": None, "texture_pngs": None, "roughness": None, "metallic": None}
        if enable_texture:
            with stage("bake"):
                out.update(self.bake_textures(mesh, scene_codes[0], materials, bake_resolution))
        return out

    # -- stage 3: the texture bake ------------------------------------
    def texel_head_weights(self):
        """The features and perturb-normal heads' weights, in that order."""
        return {n: mlp_weights_from_params(self.module.decoder.heads[n]) for n in _TEXEL_HEADS}

    def _surface_query(self, scene_code, px, py, pz):
        """Albedo (sigmoid of the features head) and the unit perturbed
        normal at flat (N,) world positions (kernel K6 on the card: the
        code's planes laid out once in one pass, the heads packed once per
        model)."""
        packed = None
        if scene_code.is_cuda:
            packed = (points_planes(scene_code), *self._k6_weights_packed(scene_code.device))
        out = query_points_multihead(scene_code, self.texel_head_weights(), px, py, pz,
                                     self.grid_spec(self.extract_dtype), packed)
        albedo = torch.sigmoid(out["features"])
        pn = out["perturb_normal"]
        return albedo, pn / torch.linalg.vector_norm(pn, dim=0, keepdim=True).clamp_min(1e-12)

    @torch.inference_mode()
    def _bake_core(self, scene_code, uc, vc, pos_cf, fa, fb, fc, res: int):
        """Rasterize per-corner UVs (K8), interpolate world positions, query
        the materials (K6), compose the tangent-space bump, dilate the
        islands. ``uc``/``vc``: the corners' flat (F,) UV rows; ``pos_cf``:
        (3, Nv) world positions; ``fa/fb/fc``: the corners' vertex ids.
        Returns (albedo (3, res, res), bump (3, res, res), mask (res, res))."""
        with record_function("sf3d.raster"):
            rast = texture_bake.rasterize_device(uc[0], vc[0], uc[1], vc[1], uc[2], vc[2], res)
        mask = texture_bake.get_mask(rast)
        tid = rast[3].to(torch.int64).clamp_min(0).flatten()  # the winner face
        fa, fb, fc = (f.long() for f in (fa, fb, fc))
        pos = texture_bake.interpolate_device(pos_cf, rast, fa, fb, fc)
        p0, p1, p2 = (pos_cf[:, f[tid]] for f in (fa, fb, fc))
        uv_rows = torch.stack([uc[0], vc[0], uc[1], vc[1], uc[2], vc[2]])[:, tid]
        uv0, uv1, uv2 = uv_rows[0:2], uv_rows[2:4], uv_rows[4:6]
        px, py, pz = pos.reshape(3, -1)
        with record_function("sf3d.texel_query"):
            albedo, perturb = self._surface_query(scene_code, px, py, pz)

        def unit(x):
            return x / torch.linalg.vector_norm(x, dim=0, keepdim=True).clamp_min(1e-12)

        up = _column(pos_cf.device, 0.0, 0.0, 1.0)
        fn = torch.linalg.cross(p1 - p0, p2 - p0, dim=0)
        fn = torch.where((fn * fn).sum(0) <= 1e-20, up, fn)
        duv1, duv2 = uv1 - uv0, uv2 - uv0
        denom_t = duv1[0] * duv2[1] - duv1[1] * duv2[0]
        tng = ((p1 - p0) * duv2[1][None] - (p2 - p0) * duv1[1][None]) / denom_t.clamp_min(1e-6)[None]
        gb_nrm = unit(fn)
        gb_tng = unit(tng)
        gb_tng = unit(gb_tng - (gb_tng * gb_nrm).sum(0, keepdim=True) * gb_nrm)
        gb_btng = unit(torch.linalg.cross(gb_tng, gb_nrm, dim=0))
        normal = unit(perturb)
        bump = torch.stack([
            (normal * gb_tng).sum(0), (normal * gb_btng).sum(0), (normal * gb_nrm).sum(0).clamp(0.3, 1.0),
        ])
        bump = (bump * 0.5 + 0.5).clamp(0.0, 1.0)
        m = mask.flatten()[None]
        albedo_img = torch.where(m, albedo, 0.0).reshape(3, res, res)
        flat = _column(pos_cf.device, 0.5, 0.5, 1.0)  # empty texels: a flat +z normal
        bump_img = torch.where(m, bump, flat).reshape(3, res, res)
        with record_function("sf3d.dilate"):
            iters = max(res // 150, 1)
            albedo_img = texture_bake.dilate_fill(albedo_img, mask, iters)
            bump_img = texture_bake.dilate_fill(bump_img, mask, iters)
        return albedo_img, bump_img, mask

    def _dither_noise(self, shape) -> torch.Tensor:
        """The bump map's dither: uniform in +-0.5 / 255 from a counter-based
        generator seeded on the device, the same every call."""
        g = torch.Generator(device=self.device).manual_seed(0)
        return (torch.rand(shape, generator=g, device=self.device) - 0.5) / 255.0

    @torch.inference_mode()
    def unwrap_bake_async(
        self, v_pos: np.ndarray, faces: np.ndarray, scene_code: torch.Tensor, materials, bake_resolution: int,
        island_padding: float = 0.02,
    ) -> _HostCopy:
        """Host prep and dispatch of the fused unwrap and bake of one
        (non-duplicated) mesh: the PCA rotation on the host, one upload of
        the rotated positions (u16 over their bbox) and the int32 faces,
        then the device unwrap (K9), the bake and the uint8 quantisation,
        and the copies of the textures, the per-corner UVs and the
        materials into pinned host memory. Nothing here waits for the
        device; ``unwrap_bake_wait`` does."""
        dev = self.device
        with record_function("sf3d.bake_prep"):
            v_pos = np.asarray(v_pos, np.float32)
            faces = np.asarray(faces)
            rot = _main_axis_rotation(v_pos)
            rp = v_pos @ rot.T
            bb_min = rp.min(axis=0) if len(rp) else np.zeros(3, np.float32)
            bb_max = rp.max(axis=0) if len(rp) else np.ones(3, np.float32)
            rng = np.maximum(bb_max - bb_min, 1e-12)
            q = np.round((rp - bb_min) / rng * 65535.0).astype(np.uint16).T  # (3, Nv)
            scale = (bb_max - bb_min).astype(np.float32) * np.float32(_INV_U16)
            meta = np.concatenate([scale, bb_min, rot.reshape(-1)]).astype(np.float32)
            q_d = _upload_exact(np.ascontiguousarray(q).view(np.int16), dev)
            f_d = _upload_exact(np.ascontiguousarray(faces.T, np.int32), dev)
            meta_d = _upload_exact(meta, dev)
        rp_d = _dequantize(q_d, meta_d[0:3], meta_d[3:6])
        uv6, _, _ = unwrap_core(rp_d[0], rp_d[1], rp_d[2], f_d[0], f_d[1], f_d[2], island_padding)
        world = meta_d[6:15].reshape(3, 3).t() @ rp_d  # rotated = v @ rot.T, so world = rot.T @ rotated
        uc, vc = (uv6[0], uv6[2], uv6[4]), (uv6[1], uv6[3], uv6[5])
        albedo, bump, mask = self._bake_core(scene_code, uc, vc, world, f_d[0], f_d[1], f_d[2], bake_resolution)
        albedo_u8, bump_u8 = quantize_textures(albedo, bump, mask, self._dither_noise(bump.shape))
        rm = torch.stack([materials["decoder_roughness"].reshape(-1)[0], materials["decoder_metallic"].reshape(-1)[0]])
        return _to_host_async((albedo_u8, bump_u8, uv6.t().contiguous(), rm.float()))

    def unwrap_bake_wait(self, host: _HostCopy):
        """Wait for the copies of ``unwrap_bake_async`` -> (per-corner UVs
        (F, 3, 2) f32, the texture dict as ``bake_textures`` gives it)."""
        with record_function("sf3d.bake_wait"):
            if host.events:
                host.events[-1].synchronize()
        albedo_u8, bump_u8, uv, rm = (t.numpy() for t in host.parts)
        return uv.reshape(-1, 3, 2), _texture_dict(
            albedo_u8.transpose(1, 2, 0), bump_u8.transpose(1, 2, 0), float(rm[0]), float(rm[1])
        )

    def unwrap_bake(self, v_pos, faces, scene_code, materials, bake_resolution: int, island_padding: float = 0.02):
        """The fused unwrap and bake of one mesh, waited for."""
        return self.unwrap_bake_wait(
            self.unwrap_bake_async(v_pos, faces, scene_code, materials, bake_resolution, island_padding)
        )

    @torch.inference_mode()
    def bake_textures(self, mesh: Mesh, scene_code: torch.Tensor, materials, bake_resolution: int) -> Dict[str, Any]:
        """The staged bake of an unwrapped mesh (``sf3d/system.py:359-512``),
        as the JAX package's ``bake_textures``: positions (u16 over the
        bbox) and UVs (u16) go up, the float textures come down, and the
        host quantizes them with numpy's seeded dither."""
        dev = self.device
        nv = len(mesh.v_pos)
        bb_min = mesh.v_pos.min(axis=0) if nv else np.zeros(3, np.float32)
        bb_max = mesh.v_pos.max(axis=0) if nv else np.ones(3, np.float32)
        rng = np.maximum(bb_max - bb_min, 1e-12)
        q_pos = np.round((mesh.v_pos - bb_min) / rng * 65535.0).astype(np.uint16).T
        q_uv = np.round(np.clip(mesh.v_tex, 0.0, 1.0) * 65535.0).astype(np.uint16).T
        q = _upload_exact(np.ascontiguousarray(np.concatenate([q_pos, q_uv])).view(np.int16), dev)
        q = (q.to(torch.int32) & 0xFFFF).float()
        bb = _upload_exact(np.concatenate([bb_min, bb_max]).astype(np.float32), dev)
        pos = q[0:3] * ((bb[3:6] - bb[0:3]) * _INV_U16)[:, None] + bb[0:3, None]
        u, v = q[3] * _INV_U16, q[4] * _INV_U16
        f = _upload_exact(np.ascontiguousarray(mesh.t_pos_idx.T, np.int32), dev).long()
        albedo, bump, _ = self._bake_core(scene_code, [u[f[c]] for c in range(3)], [v[f[c]] for c in range(3)],
                                          pos, f[0], f[1], f[2], bake_resolution)
        albedo_np = albedo.permute(1, 2, 0).cpu().numpy()
        bump_np = bump.permute(1, 2, 0).cpu().numpy()
        roughness = float(materials["decoder_roughness"].reshape(-1)[0])
        metallic = float(materials["decoder_metallic"].reshape(-1)[0])
        flat = np.all(bump_np == np.array([0.5, 0.5, 1.0], np.float32), axis=-1, keepdims=True).astype(np.float32)
        albedo_u8 = texture_bake.float32_to_uint8(albedo_np)
        bump_u8 = texture_bake.float32_to_uint8(bump_np, dither=True, dither_mask=flat)
        out = _texture_dict(albedo_u8, bump_u8, roughness, metallic)
        out["textures"] = {"albedo": albedo_np, "bump": bump_np}
        return out


_INV_U16 = float(np.float32(1.0) / np.float32(65535.0))  # XLA's u16 dequantisation: a product with 1/65535


def _column(device, *values: float) -> torch.Tensor:
    """A (len(values), 1) f32 constant made on ``device`` by fills (a
    tensor built from a host list would wait for the device)."""
    col = torch.empty(len(values), 1, device=device)
    for i, v in enumerate(values):
        col[i] = v
    return col


def _dequantize(q: torch.Tensor, scale: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
    """(3, N) u16 values (held as int16) -> q * scale + offset in f32, the
    product and the sum rounded once, as the JAX program's fused
    multiply-add rounds them (the exact f32 product fits an f64)."""
    qf = (q.to(torch.int32) & 0xFFFF).double()
    return (qf * scale.double()[:, None] + offset.double()[:, None]).float()


def _upload_exact(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array to ``device`` in its own dtype, through pinned memory
    with a non-blocking copy on the card."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def quantize_textures(albedo: torch.Tensor, bump: torch.Tensor, mask: torch.Tensor, noise: torch.Tensor):
    """The fused bake's uint8 quantisation (``float32_to_uint8`` semantics):
    albedo plain, bump dithered by ``noise`` on covered texels only."""
    albedo_u8 = (albedo.clamp(0.0, 1.0) * 255.0 + 0.5).clamp(0.0, 255.0).to(torch.uint8)
    bump_d = (bump + noise * mask[None].to(noise.dtype)).clamp(0.0, 1.0)
    return albedo_u8, (bump_d * 255.0 + 0.5).clamp(0.0, 255.0).to(torch.uint8)


def _texture_dict(albedo_u8: np.ndarray, bump_u8: np.ndarray, roughness: float, metallic: float) -> Dict[str, Any]:
    """The texture keys of a mesh dict from the (res, res, 3) uint8 maps;
    the glTF metallic-roughness map holds roughness in G, metallic in B.
    The float copies and the three PNGs are made inside ``sf3d.png_encode``."""
    with record_function("sf3d.png_encode"):
        mr = np.zeros_like(albedo_u8)
        mr[..., 1] = int(np.clip(roughness, 0, 1) * 255)
        mr[..., 2] = int(np.clip(metallic, 0, 1) * 255)
        return {
            "textures": {"albedo": albedo_u8.astype(np.float32) / 255.0, "bump": bump_u8.astype(np.float32) / 255.0},
            "texture_pngs": {
                "baseColor": encode_png(np.ascontiguousarray(albedo_u8)),
                "normal": encode_png(np.ascontiguousarray(bump_u8)),
                "metallicRoughness": encode_png(mr),
            },
            "roughness": roughness,
            "metallic": metallic,
        }


def mesh_arrays(mesh: Mesh) -> Dict[str, np.ndarray]:
    """A mesh's host arrays under ``run_image``'s keys."""
    return {"verts": mesh.v_pos, "faces": mesh.t_pos_idx, "uvs": mesh.v_tex, "normals": mesh.v_nrm}



@contextlib.contextmanager
def _stage(name: str, timings: Optional[Dict[str, float]], device: torch.device):
    """A ``sf3d.<name>`` profiler span; with ``timings``, also the stage's
    seconds between device syncs."""
    with record_function(f"sf3d.{name}"):
        if timings is None:
            yield
            return
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            timings[name] = timings.get(name, 0.0) + time.perf_counter() - t0
