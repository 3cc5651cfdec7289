"""TSR system: the TripoSR ("Lean") image -> mesh model in PyTorch.

Counterpart of ``sculptmate_tpu/systems/tsr.py``: DINO ViT-B/16 tokenizer ->
learned triplane tokens -> 16-block cross-attention backbone ->
ConvTranspose upsample -> NeRF MLP decoder, in two stages:

- ``scene_codes``: images (B, H, W, 3) in [0, 1] -> triplane codes
  (B, 3, 40, 64, 64), parameters in f32 and compute in ``dtype`` (bf16 on
  the card) under autocast;
- ``extract_mesh``: codes -> density lattice (kernel K2) -> wire-format
  marching cubes with per-vertex colors on the device -> one uint8 transfer
  -> faces rebuilt on the host by the native wire decoder.

The wire buffer has a fixed vertex capacity. Its counters are exact, so an
overflow is detected and the extraction retried with a grown capacity,
never decoded truncated; capacities that worked are remembered per
resolution on the instance.

Each stage runs inside a ``torch.profiler`` span named ``tsr.<stage>``, so
a profile of one asset splits its host and device time by stage.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
from torch.profiler import record_function

from sculptmate_tpu_torch.geometry import mc_wire
from sculptmate_tpu_torch.geometry.marching_cubes import N_WIRE_COUNTS, mc_wire_device
from sculptmate_tpu_torch.models.heads import NeRFMLP
from sculptmate_tpu_torch.models.tokenizers import Triplane1DTokenizer
from sculptmate_tpu_torch.models.transformer import Transformer1D
from sculptmate_tpu_torch.models.upsamplers import TriplaneUpsampleNetwork
from sculptmate_tpu_torch.models.vit import DINOSingleImageTokenizer
from sculptmate_tpu_torch.ops.density_grid import (
    DensityGridSpec,
    mlp_weights_from_params,
    query_density_grid,
    query_triplane_points,
)
from sculptmate_tpu_torch.ops.resize import resize_bilinear_antialias
from sculptmate_tpu_torch.runtime.device import resolve_device

_COLOR_CHUNK = 1 << 18  # points per color-query step: bounds the feature tensor


@dataclasses.dataclass(frozen=True)
class TSRConfig:
    cond_image_size: int = 512
    plane_size: int = 32
    num_channels: int = 1024
    num_attention_heads: int = 16
    attention_head_dim: int = 64
    num_layers: int = 16
    cross_attention_dim: int = 768
    upsample_out_channels: int = 40
    decoder_in_channels: int = 120
    decoder_n_neurons: int = 64
    decoder_n_hidden_layers: int = 9
    decoder_activation: str = "silu"
    radius: float = 0.87
    density_activation: str = "exp"
    density_bias: float = -1.0
    # image tokenizer (ViT-B/16 per TripoSR/checkpoints/config.json)
    vit_hidden_size: int = 768
    vit_num_layers: int = 12
    vit_num_heads: int = 12
    vit_intermediate_size: int = 3072
    vit_patch_size: int = 16
    vit_base_image_size: int = 224

    @classmethod
    def from_yaml(cls, path: str) -> "TSRConfig":
        """Load the reference's config.yaml layout (``TripoSR/checkpoints/config.yaml``)."""
        import yaml

        with open(path) as f:
            y = yaml.safe_load(f)
        return cls(
            cond_image_size=y.get("cond_image_size", 512),
            plane_size=y["tokenizer"]["plane_size"],
            num_channels=y["tokenizer"]["num_channels"],
            num_attention_heads=y["backbone"]["num_attention_heads"],
            attention_head_dim=y["backbone"]["attention_head_dim"],
            num_layers=y["backbone"]["num_layers"],
            cross_attention_dim=y["backbone"]["cross_attention_dim"],
            upsample_out_channels=y["post_processor"]["out_channels"],
            decoder_in_channels=y["decoder"]["in_channels"],
            decoder_n_neurons=y["decoder"]["n_neurons"],
            decoder_n_hidden_layers=y["decoder"]["n_hidden_layers"],
            decoder_activation=y["decoder"].get("activation", "silu"),
            radius=y["renderer"]["radius"],
            density_activation=y["renderer"].get("density_activation", "exp"),
            density_bias=y["renderer"].get("density_bias", -1.0),
        )


class TSRModule(nn.Module):
    """Every learned parameter of the TSR stack, under the reference
    checkpoint's state-dict names."""

    def __init__(self, config: TSRConfig):
        super().__init__()
        c = config
        self.config = c
        self.image_tokenizer = DINOSingleImageTokenizer(
            hidden_size=c.vit_hidden_size,
            num_layers=c.vit_num_layers,
            num_heads=c.vit_num_heads,
            intermediate_size=c.vit_intermediate_size,
            patch_size=c.vit_patch_size,
            base_image_size=c.vit_base_image_size,
        )
        self.tokenizer = Triplane1DTokenizer(c.plane_size, c.num_channels)
        self.backbone = Transformer1D(
            in_channels=c.num_channels,
            num_attention_heads=c.num_attention_heads,
            attention_head_dim=c.attention_head_dim,
            num_layers=c.num_layers,
            cross_attention_dim=c.cross_attention_dim,
        )
        self.post_processor = TriplaneUpsampleNetwork(c.num_channels, c.upsample_out_channels)
        self.decoder = NeRFMLP(
            c.decoder_in_channels, c.decoder_n_neurons, c.decoder_n_hidden_layers, c.decoder_activation
        )

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images (B, H, W, 3) in [0, 1] at cond_image_size -> (B, 3, C, H, W)."""
        image_tokens = self.image_tokenizer(images).transpose(1, 2)  # (B, Nt, 768)
        tokens = self.tokenizer(images.shape[0])
        tokens = self.backbone(tokens, encoder_hidden_states=image_tokens)
        return self.post_processor(self.tokenizer.detokenize(tokens))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded random weights with the JAX package's initializer scales:
        fan-in normal kernels and zero biases, unit norms, N(0, 1)/sqrt(C)
        triplane tokens and N(0, 0.02) position table."""
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
                w = m.weight
                fan_in = w.shape[0] * w[0, 0].numel() if isinstance(m, nn.ConvTranspose2d) else w[0].numel()
                w.normal_(0.0, fan_in**-0.5, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
                m.weight.fill_(1.0)
                m.bias.zero_()
        emb = self.image_tokenizer.model.embeddings
        emb.cls_token.zero_()
        emb.position_embeddings.normal_(0.0, 0.02, generator=generator)
        tok = self.tokenizer.embeddings
        tok.normal_(0.0, 1.0, generator=generator).div_(tok.shape[1] ** 0.5)


def _tighten(current: int, observed: int) -> int:
    """Capacity to keep after a successful run that observed ``observed``
    vertices: shrink toward 1.35 x observed (65536-rounded) only when the
    overshoot exceeds 2x that target, so one giant asset cannot inflate
    every later buffer and normal variation does not flap."""
    target = max(65536, 65536 * -(-int(1.35 * observed) // 65536))
    return target if current > 2 * target else current


@dataclasses.dataclass(frozen=True)
class _WireHandle:
    """An enqueued wire extraction plus what a retry or the decode needs."""

    scene_code: torch.Tensor
    fut: object  # wire tensor, or (wire, colors) with vertex colors
    mv: int
    resolution: int
    threshold: float
    want_colors: bool


class TSR:
    """Host-side wrapper: the module, its device and dtype, and the
    extraction policy. Mirrors ``tsr/system.py``'s forward/extract_mesh split.

    ``device`` defaults to the card; without one it raises rather than run
    on the CPU (pass ``device="cpu"`` for that). ``state_dict`` holds the
    reference checkpoint's keys; without one the weights are random from
    ``seed``.
    """

    def __init__(
        self,
        config: Optional[TSRConfig] = None,
        state_dict=None,
        seed: int = 0,
        dtype: torch.dtype = torch.bfloat16,
        extract_dtype: Optional[torch.dtype] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.config = config or TSRConfig()
        self.dtype = dtype
        # density-grid compute dtype: follows the model dtype. The density
        # kernel computes in bf16, so an f32 model on the card passes bf16 here
        self.extract_dtype = extract_dtype if extract_dtype is not None else dtype
        with torch.device(self.device):
            self.module = TSRModule(self.config)
        if state_dict is None:
            self.module.reset_parameters(torch.Generator(device=self.device).manual_seed(seed))
        else:
            self.module.load_state_dict(state_dict)
        self.module.eval().requires_grad_(False)
        self._wire_cap_cache = {}

    # -- stage 1: image -> scene codes --------------------------------
    @torch.inference_mode()
    def scene_codes(self, images) -> torch.Tensor:
        """images: (B, H, W, 3) float in [0, 1]; resized if needed."""
        x = torch.as_tensor(images, dtype=torch.float32, device=self.device)
        s = self.config.cond_image_size
        if x.shape[1] != s or x.shape[2] != s:
            x = resize_bilinear_antialias(x, s, s)
        with record_function("tsr.scene_codes"), torch.autocast(
            self.device.type, dtype=self.dtype, enabled=self.dtype != torch.float32
        ):
            return self.module(x)

    # -- stage 2: scene code -> mesh ----------------------------------
    def grid_spec(self, resolution: int, compute_dtype: torch.dtype = torch.float32) -> DensityGridSpec:
        c = self.config
        return DensityGridSpec(
            resolution=resolution,
            radius=c.radius,
            density_activation=c.density_activation,
            density_bias=c.density_bias,
            activation=c.decoder_activation,
            align_corners=False,
            slab=max(s for s in range(1, 9) if resolution % s == 0),
            compute_dtype=compute_dtype,
        )

    def decoder_weights(self):
        return mlp_weights_from_params(self.module.decoder.layers)

    def _color_query(self, scene_code, weights, spec, wx, wy, wz) -> torch.Tensor:
        """Colors at world positions, in chunks -> (3, N)."""
        return torch.cat(
            [
                query_triplane_points(
                    scene_code, weights, wx[s : s + _COLOR_CHUNK], wy[s : s + _COLOR_CHUNK],
                    wz[s : s + _COLOR_CHUNK], spec,
                )["color"]
                for s in range(0, wx.shape[0], _COLOR_CHUNK)
            ],
            dim=1,
        )

    @torch.inference_mode()
    def _extract_wire(self, scene_code, resolution, threshold, max_verts, want_colors):
        weights = self.decoder_weights()
        spec = self.grid_spec(resolution, compute_dtype=self.extract_dtype)
        with record_function("tsr.density_grid"):
            density = query_density_grid(scene_code, weights, spec)
        color_fn = None
        if want_colors:
            r = self.config.radius
            scale = 2 * r / (resolution - 1.0)

            def color_fn(vx, vy, vz):
                with record_function("tsr.color_query"):
                    return tuple(self._color_query(scene_code, weights, spec, vx * scale - r, vy * scale - r, vz * scale - r))

        with record_function("tsr.marching_cubes"):
            return mc_wire_device(density - threshold, max_verts, color_fn)

    def _wire_caps(self, resolution: int, max_verts: int, explicit: bool = False) -> int:
        """Vertex capacity to dispatch with: a capacity that worked before at
        this resolution, unless the caller sized it explicitly."""
        cached = self._wire_cap_cache.get(resolution)
        if cached is None or explicit:
            return max_verts
        return max(max_verts, cached)

    def _wire_caps_store(self, resolution: int, mv: int, nv_seen: int) -> None:
        self._wire_cap_cache[resolution] = _tighten(mv, nv_seen)

    @staticmethod
    def _wire_grown(nv: int, mv: int) -> Optional[int]:
        """None when the capacity held; otherwise the grown capacity to retry
        with. Overflow is read from the exact wire counter, never truncated."""
        if nv > mv:
            return max(mv, 65536 * -(-int(1.2 * nv) // 65536))
        return None

    def _wire_decode(self, fut, wire: np.ndarray, nv: int, mv_used: int, resolution: int):
        """Wire (+ split color bytes) -> (verts world f32, faces i64, colors f32 | None)."""
        shape = (resolution, resolution, resolution)
        verts, faces, _, _ = mc_wire.decode_wire(wire, shape, mv_used, has_colors=False)
        colors = None
        if isinstance(fut, tuple) and nv > 0:
            cb = fut[1].cpu().numpy()
            colors = cb.reshape(3, mv_used)[:, :nv].T.astype(np.float32) / 255.0
        scale = 2 * self.config.radius / (resolution - 1.0)
        return verts * scale - self.config.radius, faces.astype(np.int64), colors

    def extract_mesh_async(
        self,
        scene_code: torch.Tensor,
        has_vertex_color: bool = False,
        resolution: int = 256,
        threshold: float = 25.0,
        max_verts: int = 0,
    ) -> _WireHandle:
        """Enqueue one asset's extraction on the device and return a handle
        for ``extract_mesh_wait``; nothing here waits for the device."""
        explicit = max_verts > 0
        if max_verts <= 0:
            max_verts = 8 * resolution * resolution
        mv = self._wire_caps(resolution, max_verts, explicit)
        fut = self._extract_wire(scene_code, resolution, float(threshold), mv, bool(has_vertex_color))
        return _WireHandle(scene_code, fut, mv, resolution, float(threshold), bool(has_vertex_color))

    def extract_mesh_wait(self, handle: _WireHandle, store: bool = True):
        """Block on a handle -> ((verts, faces, colors | None), (nv, mv)).
        Overflow is re-extracted synchronously with a grown capacity.
        ``store=False`` skips the capacity-cache update."""
        fut, mv = handle.fut, handle.mv
        while True:
            with record_function("tsr.wire_to_host"):  # waits for the device
                wire = (fut[0] if isinstance(fut, tuple) else fut).cpu().numpy()
            nv = int(mc_wire.wire_counts(wire, N_WIRE_COUNTS)[0])
            grown = self._wire_grown(nv, mv)
            if grown is None:
                break
            mv = grown
            fut = self._extract_wire(handle.scene_code, handle.resolution, handle.threshold, mv, handle.want_colors)
        if store:
            self._wire_caps_store(handle.resolution, mv, nv)
        with record_function("tsr.wire_decode"):
            mesh = self._wire_decode(fut, wire, nv, mv, handle.resolution)
        return mesh, (nv, mv)

    def extract_mesh(
        self,
        scene_codes,
        has_vertex_color: bool = False,
        resolution: int = 256,
        threshold: float = 25.0,
        max_verts: int = 0,
    ):
        """A list of (verts, faces, colors | None) numpy triples, verts in
        (-radius, radius) world coords like the reference
        (``tsr/system.py:185-189``). Every asset is enqueued before the
        first is decoded, so the host decode overlaps device work."""
        handles = [
            self.extract_mesh_async(code, has_vertex_color, resolution, threshold, max_verts)
            for code in scene_codes
        ]
        out = []
        nv_seen = mv = 0
        for h in handles:
            mesh, (nv, mv_h) = self.extract_mesh_wait(h, store=False)
            nv_seen, mv = max(nv_seen, nv), max(mv, mv_h)
            out.append(mesh)
        if handles:
            self._wire_caps_store(resolution, mv, nv_seen)
        return out

    def image_to_mesh(
        self,
        images,
        has_vertex_color: bool = False,
        resolution: int = 256,
        threshold: float = 25.0,
        max_verts: int = 0,
    ):
        """One (1, S, S, 3) cond image -> one (verts, faces, colors | None)
        triple, with ``extract_mesh``'s capacity-retry semantics."""
        codes = self.scene_codes(images)
        return self.extract_mesh(codes[:1], has_vertex_color, resolution, threshold, max_verts)[0]
