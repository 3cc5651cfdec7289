"""SF3D system: the Stable Fast 3D ("Pro") image -> mesh model in PyTorch.

Counterpart of ``sculptmate_tpu/systems/sf3d.py`` (``sf3d/system.py:96-528``
in the reference), untextured: camera-modulated DINOv2-large tokenizer ->
learned 96^2 triplane tokens -> two-stream interleave backbone ->
pixel-shuffle upsample to (3, 40, 384, 384) codes -> the density and
vertex-offset heads of ``MaterialMLP`` over the 161^3 marching-tets lattice
(kernel K5) -> wire-format marching tets on the device -> one uint8
transfer -> faces rebuilt and snapped vertices welded on the host by the
native wire decoder -> quadric decimation to the vertex budget -> host
cube-projection UV unwrap.

Parameters are f32 and the encoder computes in ``dtype`` (bf16 on the card)
under autocast; the lattice query computes in ``extract_dtype``, which
follows it. The wire has a fixed vertex capacity whose counters are exact:
an overflow is detected and re-extracted with a grown capacity, never
decoded truncated; the capacity that worked is remembered on the instance
and on disk (``runtime/capacity_cache.py``, key ``torch_sf3d_mt_r<res>``).

Each stage runs inside a ``torch.profiler`` span named ``sf3d.<stage>``:
``encode``, ``extract`` (holding ``grid``, ``marching_tets``,
``wire_to_host`` and ``wire_decode``), ``decimate`` and ``unwrap``. The
texture bake (kernels K6, K8, K9 and the fused unwrap-and-bake) is not
ported yet: ``enable_texture=True`` raises.
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

from sculptmate_tpu_torch.geometry import mt_wire
from sculptmate_tpu_torch.geometry.decimate import decimate, vertex_normals
from sculptmate_tpu_torch.geometry.marching_tets import N_WIRE_COUNTS, lattice_size, mt_wire_device
from sculptmate_tpu_torch.geometry.mesh import Mesh
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
    query_grid_multihead,
)
from sculptmate_tpu_torch.ops.resize import resize_bilinear_antialias
from sculptmate_tpu_torch.runtime import capacity_cache
from sculptmate_tpu_torch.runtime.device import resolve_device
from sculptmate_tpu_torch.systems.tsr import upload

DEFAULT_HEADS = (
    {"name": "density", "out_channels": 1, "out_bias": -1.0, "n_hidden_layers": 2,
     "output_activation": "trunc_exp"},
    {"name": "features", "out_channels": 3, "n_hidden_layers": 3,
     "output_activation": "sigmoid"},
    {"name": "perturb_normal", "out_channels": 3, "n_hidden_layers": 3,
     "output_activation": "normalize_channel_last"},
    {"name": "vertex_offset", "out_channels": 3, "n_hidden_layers": 2},
)
# the heads the lattice query runs, in output-channel order (kernel K5 takes
# exactly this pair)
_LATTICE_HEADS = ("density", "vertex_offset")
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

    def forward(self, rgb_cond, c2w_cond, intrinsic_normed_cond):
        """rgb_cond (B, S, S, 3) -> (scene_codes (B, 3, 40, 384, 384),
        direct_codes (B, 3, 1024, 96, 96))."""
        camera_embeds = self.camera_embedder(c2w_cond, intrinsic_normed_cond)
        image_tokens = self.image_tokenizer(rgb_cond, camera_embeds).transpose(1, 2)  # (B, Nt, C)
        tokens = self.tokenizer(rgb_cond.shape[0]).transpose(1, 2)  # (B, C, 3HW)
        tokens = self.backbone(tokens, image_tokens)
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
    reference checkpoint's keys; without one the weights are random from
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
        if state_dict is None:
            self.module.reset_parameters(torch.Generator(device=self.device).manual_seed(seed))
        else:
            self.module.load_state_dict(state_dict)
        self.module.eval().requires_grad_(False)
        # the fixed condition camera and the background, uploaded once
        _, Kn = intrinsic_from_fov_deg(c.default_fovy_deg, c.cond_image_size, c.cond_image_size)
        self._c2w = upload(default_cond_c2w(c.default_distance), self.device)
        self._Kn = upload(Kn, self.device)
        self._bg = upload(np.asarray(c.background_color), self.device)
        self._mt_cap: Optional[int] = None

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
    def get_scene_codes(self, rgb_cond: torch.Tensor):
        """(B, S, S, 3) -> (scene_codes (B, 3, 40, 384, 384), direct_codes)."""
        B = rgb_cond.shape[0]
        with self._autocast():
            return self.module(rgb_cond, self._c2w.expand(B, 4, 4), self._Kn.expand(B, 3, 3))

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

    @torch.inference_mode()
    def query_lattice(self, scene_code: torch.Tensor):
        """The density and vertex-offset heads' raw outputs on the
        (res+1)^3 lattice (kernel K5 on the card) -> {head: (K, N, N, N)
        f32}."""
        res = self.config.isosurface_resolution
        coords = lattice_coords_tets(res, scene_code.device)
        return query_grid_multihead(scene_code, self.lattice_head_weights(), coords, self.grid_spec(self.extract_dtype))

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

    def _capacity(self, res: int) -> int:
        if self._mt_cap is None:
            persisted = capacity_cache.load(f"torch_sf3d_mt_r{res}")
            N = lattice_size(res)
            self._mt_cap = persisted[0] if persisted else 24 * N * N
        return self._mt_cap

    def run_image(
        self,
        image,
        remesh: str = "triangle",
        vertex_simplification_factor: str = "high",
        estimate_illumination: bool = False,
        enable_texture: bool = True,
        threshold: Optional[float] = None,
        timings: Optional[Dict[str, float]] = None,
    ) -> Optional[Dict[str, Any]]:
        """image: (1, H, W, 3|4) float in [0, 1] (array or tensor). Returns
        the mesh as a dict of host arrays (verts, faces, uvs, normals; the
        texture keys None), or None when the surface is empty.

        ``timings``: when given, each stage (encode, extract, decimate,
        unwrap) is bracketed by device syncs and its seconds stored there."""
        if enable_texture:
            raise NotImplementedError("SF3D texture bake (K6, K8, K9, unwrap_bake) is ROADMAP item 12")

        def stage(name: str):
            return _stage(name, timings, self.device)

        c = self.config
        with stage("encode"):
            mask, rgb = self.prepare_image(upload(image, self.device))
            scene_codes, direct_codes = self.get_scene_codes(rgb)
            # the JAX package always runs the material estimate here; only
            # the texture bake consumes it
            self.estimate_materials(rgb * mask)
            if estimate_illumination:
                self.estimate_illumination(direct_codes)

        thr = float(c.isosurface_threshold if threshold is None else threshold)
        res = c.isosurface_resolution
        mv = self._capacity(res)
        with stage("extract"):
            while True:
                wire = self._extract_wire(scene_codes[0], thr, mv, float(c.weld_eps))
                with record_function("sf3d.wire_to_host"):
                    wire = wire.cpu().numpy()
                nv = int(mt_wire.wire_counts(wire, N_WIRE_COUNTS)[0])
                if nv <= mv:  # overflow is detected, never decoded truncated
                    break
                mv = max(mv, 65536 * -(-int(1.2 * nv) // 65536))
            # tighten toward the observed count, so one giant mesh does not
            # inflate every later extraction; this wire keeps its capacity
            self._mt_cap = capacity_cache.tighten(mv, nv)
            capacity_cache.store(f"torch_sf3d_mt_r{res}", (self._mt_cap,))
            if nv == 0:
                return None
            with record_function("sf3d.wire_decode"):
                # weld the snapped vertices, drop the degenerate slivers
                lverts, faces, _ = mt_wire.decode_wire(wire, res, mv, weld=c.weld_eps > 0)
            verts = lverts * (2 * c.radius) - c.radius  # [0, 1] lattice -> world bbox

        # the budget counts the raw pre-weld vertices (nv), as the JAX package
        vertex_count = round(_BUDGET.get(vertex_simplification_factor, 0.75) * nv)
        v_nrm = None
        if remesh == "triangle":
            with stage("decimate"):
                if vertex_count < len(verts):
                    verts, faces, v_nrm = decimate(
                        verts, faces, target_ratio=vertex_count / len(verts), return_normals=True
                    )
                else:  # the weld already reached the budget: normals only
                    v_nrm = vertex_normals(verts, faces)
        mesh = Mesh(verts, faces)
        if v_nrm is not None:
            mesh._v_nrm = v_nrm
        with stage("unwrap"):
            # host unwrap: the JAX package's "auto" takes its device unwrap
            # on an accelerator, whose port (K9) is ROADMAP item 12
            mesh.unwrap_uv(backend="host")
        return {
            "verts": mesh.v_pos,
            "faces": mesh.t_pos_idx,
            "uvs": mesh.v_tex,
            "normals": mesh.v_nrm,
            "textures": None,
            "texture_pngs": None,
            "roughness": None,
            "metallic": None,
        }


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
