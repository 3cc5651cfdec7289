"""TSR system: the TripoSR ("Lean") image -> mesh model in PyTorch.

Counterpart of ``sculptmate_tpu/systems/tsr.py``: DINO ViT-B/16 tokenizer ->
learned triplane tokens -> 16-block cross-attention backbone ->
ConvTranspose upsample -> NeRF MLP decoder, in two stages:

- ``scene_codes``: images (B, H, W, 3) in [0, 1] -> triplane codes
  (B, 3, 40, 64, 64), computed in ``dtype`` (bf16 on the card) under
  autocast; the encoder's matrix weights are stored in ``dtype`` once
  (``cast_matrix_weights``), the rest of the parameters in f32. With a tp
  group (``tp``, a tuple of devices) the backbone runs tensor-parallel
  (``ops/sharding.py``); the ViT encoder stays whole, as in the JAX package;
- ``extract_mesh``: codes -> density lattice (kernel K2) -> marching cubes
  with per-vertex colors (K4) -> host arrays, along one of two paths. On the
  card by default, face-emitting marching cubes (K10): the faces, exact f32
  world positions and f32 colors are built on the device and copied back
  whole, at their capacities, into pinned memory. On the CPU by default
  (and anywhere with ``mode="wire"``), the wire format (K3): occupancy bits,
  u16 t and u8 colors come to the host, which rebuilds the faces with the
  native wire decoder. The path follows the device: on the card a pinned
  copy of the whole mesh takes milliseconds where the host's face rebuild
  takes tens of them; on the CPU the wire is the JAX package's default
  path, which the tests hold the port to;
- ``render_views``: codes -> spherical novel views, the decoder (K4) at
  every ray sample, alpha-composited onto white.

Each path's buffers have fixed capacities (the vertices; on the K10 path
the faces too), dispatched, grown after an overflow and kept by the path's
``runtime/capacity_cache.Capacities``.

``extract_mesh_async`` only enqueues: the extraction's kernels, then a
non-blocking copy of each part of its output into pinned host memory, each
followed by a CUDA event. ``extract_mesh_wait`` waits on the counters'
event alone (on the wire path the wire's, whose tail holds them), then
builds the host arrays part by part, waiting on each part's event just
before it, so the last copies overlap the first parts' host work and asset
i's host work overlaps the device work of the assets enqueued after it.
The arrays it returns own their memory: the pinned blocks go back to
PyTorch's caching host allocator. Numpy inputs go up once through pinned
memory, so nothing on the dispatch path waits for the device.

Each stage runs inside a ``torch.profiler`` span named ``tsr.<stage>``, so
a profile of one asset splits its host and device time by stage; on both
paths ``tsr.wire_decode`` brackets a handle's host finish and
``tsr.wire_faces`` the faces' part of it (the native rebuild, or the copy
out of the pinned block and the int64 conversion); each re-extraction
after a capacity overflow runs inside ``tsr.capacity_retry``, so their
number is the retry count.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
from torch.profiler import record_function

from sculptmate_tpu_torch.config import load_yaml_config
from sculptmate_tpu_torch.geometry import mc_wire
from sculptmate_tpu_torch.geometry.marching_cubes import N_WIRE_COUNTS, MCResult, marching_cubes, mc_wire_device
from sculptmate_tpu_torch.models.heads import NeRFMLP
from sculptmate_tpu_torch.models.tokenizers import Triplane1DTokenizer
from sculptmate_tpu_torch.models.transformer import Transformer1D
from sculptmate_tpu_torch.models.upsamplers import TriplaneUpsampleNetwork
from sculptmate_tpu_torch.models.vit import DINOSingleImageTokenizer
from sculptmate_tpu_torch.ops.density_grid import (
    DensityGridSpec,
    mlp_weights_from_params,
    pack_triplane_planes,
    pack_triplane_weights,
    query_density_grid,
    query_triplane_points,
)
from sculptmate_tpu_torch.ops.rays import get_spherical_cameras, rays_intersect_bbox
from sculptmate_tpu_torch.ops.resize import resize_bilinear_antialias
from sculptmate_tpu_torch.runtime.capacity_cache import Capacities
from sculptmate_tpu_torch.runtime.device import device_scope, resolve_device

_COLOR_CHUNK = 1 << 18  # points per color-query step: bounds the feature tensor
# the submodules that run under autocast; the decoder stays f32 (its kernels
# pack their own bf16 copies)
_ENCODERS = ("image_tokenizer", "tokenizer", "backbone", "post_processor")


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
        """Load the reference's config.yaml layout
        (``TripoSR/checkpoints/config.yaml``), ``${...}`` interpolations
        resolved."""
        y = load_yaml_config(path)
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

    def forward(self, images: torch.Tensor, tp=None) -> torch.Tensor:
        """images (B, H, W, 3) in [0, 1] at cond_image_size -> (B, 3, C, H, W);
        ``tp``: the backbone's tp group, or None."""
        image_tokens = self.image_tokenizer(images).transpose(1, 2)  # (B, Nt, 768)
        tokens = self.tokenizer(images.shape[0])
        tokens = self.backbone(tokens, encoder_hidden_states=image_tokens, tp=tp)
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


def cast_matrix_weights(module: nn.Module, names, dtype: torch.dtype) -> None:
    """Store the weights and biases of the Linear and convolution layers
    (and CLIP's packed in-projection) under the submodules ``names`` of
    ``module`` in ``dtype``, once. Autocast casts exactly these to its
    compute type on every call (with round-to-nearest-even, as ``to``
    does), so the results do not change and the per-call casts go. Norms,
    embeddings, LayerScale and every other parameter stay f32, as autocast
    runs them. ``state_dict()`` still reads f32 (the rounded values)."""
    if dtype == torch.float32:
        return
    for name in names:
        for m in module.get_submodule(name).modules():
            if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
                params = (m.weight, m.bias)
            elif hasattr(m, "in_proj_weight"):
                params = (m.in_proj_weight, m.in_proj_bias)
            else:
                continue
            for p in params:
                if p is not None:
                    p.data = p.data.to(dtype)
    module.register_state_dict_post_hook(_f32_state_dict)


def _f32_state_dict(module, state_dict, prefix, local_metadata):
    for k, v in state_dict.items():
        if v.is_floating_point() and v.dtype != torch.float32:
            state_dict[k] = v.float()


def upload(x, device: torch.device) -> torch.Tensor:
    """``x`` (array or tensor) as f32 on ``device``. A host array goes up
    through pinned memory with a non-blocking copy, which does not wait for
    the device; a tensor already there is used as it is."""
    if isinstance(x, torch.Tensor) and x.device.type == device.type:
        return x.to(device, torch.float32)
    t = torch.as_tensor(x, dtype=torch.float32)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


@dataclasses.dataclass(frozen=True)
class _HostCopy:
    """An extraction's output on its way to the host: host tensors, and on
    the card the event recorded after each one's copy."""

    parts: tuple  # host tensors, in the order their copies were queued
    events: Optional[tuple]  # a CUDA event per part; None on the CPU

    def part(self, i: int) -> torch.Tensor:
        """Part ``i``, once its copy has landed."""
        if self.events:
            self.events[i].synchronize()
        return self.parts[i]

    def wire(self) -> np.ndarray:
        return self.part(0).numpy()


def _to_host_async(fut) -> _HostCopy:
    """Queue the device-to-host copy of each part of an extraction's
    output into pinned memory (PyTorch's caching host allocator reuses the
    blocks), an event after each; on the CPU the parts already are there. A
    part given as a list of equal-shape tensors lands as the rows of one
    host tensor."""
    parts = fut if isinstance(fut, tuple) else (fut,)
    first = parts[0][0] if isinstance(parts[0], list) else parts[0]
    if not first.is_cuda:
        return _HostCopy(tuple(torch.stack(p) if isinstance(p, list) else p for p in parts), None)
    hosts, events = [], []
    for p in parts:
        if isinstance(p, list):
            h = torch.empty((len(p), *p[0].shape), dtype=p[0].dtype, pin_memory=True)
            for row, src in zip(h, p):
                row.copy_(src, non_blocking=True)
        else:
            h = torch.empty(p.shape, dtype=p.dtype, pin_memory=True)
            h.copy_(p, non_blocking=True)
        e = torch.cuda.Event()
        e.record()
        hosts.append(h)
        events.append(e)
    return _HostCopy(tuple(hosts), tuple(events))


def _rows_out(rows: torch.Tensor, n: int, dtype) -> np.ndarray:
    """The first ``n`` columns of host rows (k, capacity) as an (n, k)
    array of ``dtype`` that owns its memory (so a kept mesh holds no pinned
    block); one multi-threaded copy does the transpose and the conversion."""
    out = np.empty((n, rows.shape[0]), dtype)
    torch.from_numpy(out).copy_(rows[:, :n].t())
    return out


def packed_path(mode: Optional[str], device: torch.device, max_faces: int = 0) -> bool:
    """Whether an extraction on ``device`` builds its faces there (kernel
    K10, ``mode="packed"``) or rebuilds them on the host from the wire
    (K3, ``mode="wire"``). ``mode=None`` follows the device: K10 on the
    card, the wire on the CPU. An unknown mode raises, and so does
    ``max_faces`` on the wire path, which has no device face buffer."""
    if mode not in (None, "wire", "packed"):
        raise ValueError(f'mode must be None, "wire" or "packed", got {mode!r}')
    packed = mode == "packed" or (mode is None and device.type == "cuda")
    if max_faces > 0 and not packed:
        raise ValueError(
            "max_faces is not applicable in wire mode (faces are rebuilt on the host without a device face buffer); "
            'use mode="packed" to bound the device face capacity'
        )
    return packed


@dataclasses.dataclass(frozen=True)
class _MeshHandle:
    """An enqueued extraction plus what a retry or the host finish needs:
    the ``TSR`` that dispatched it, and ``caps``: (max_verts,) on the wire
    path, (max_verts, max_faces) on the K10 path."""

    tsr: "TSR"
    scene_code: torch.Tensor
    host: _HostCopy
    caps: tuple
    resolution: int
    threshold: float
    want_colors: bool
    packed: bool

    @property
    def capacities(self) -> Capacities:
        return self.tsr.packed_capacities if self.packed else self.tsr.wire_capacities


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
        cast_matrix_weights(self.module, _ENCODERS, dtype)
        self.wire_capacities = Capacities("torch_tsr_wire", lambda r: (8 * r * r,), at_least_default=True)
        self.packed_capacities = Capacities("torch_tsr_packed", lambda r: (8 * r * r, 16 * r * r),
                                            at_least_default=True)
        self._k4_weights = None  # (key, K4's packed decoder), see _k4_inputs

    def replica(self, device) -> "TSR":
        """This model on another device: the same config, dtypes and
        weights, copied once, and the same capacity policies."""
        out = TSR(self.config, state_dict=self.module.state_dict(), dtype=self.dtype,
                  extract_dtype=self.extract_dtype, device=device)
        out.wire_capacities, out.packed_capacities = self.wire_capacities, self.packed_capacities
        return out

    # -- stage 1: image -> scene codes --------------------------------
    @torch.inference_mode()
    def scene_codes(self, images, tp=None) -> torch.Tensor:
        """images: (B, H, W, 3) float in [0, 1]; resized if needed. ``tp``:
        a tp group (a tuple of devices, the first this model's) for the
        backbone, or None."""
        x = upload(images, self.device)
        s = self.config.cond_image_size
        if x.shape[1] != s or x.shape[2] != s:
            x = resize_bilinear_antialias(x, s, s)
        with record_function("tsr.scene_codes"), torch.autocast(
            self.device.type, dtype=self.dtype, enabled=self.dtype != torch.float32
        ):
            return self.module(x, tp)

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

    def _k4_inputs(self, scene_code):
        """Kernel K4's packed inputs for one code: its planes, laid out per
        code, and the decoder, packed once and kept while its parameters
        (their storage and version counters) stay the same. Parameters made
        under inference mode keep no version counter: they are packed anew."""
        params = list(self.module.decoder.parameters())
        key = None
        if not any(p.is_inference() for p in params):
            key = (scene_code.device, tuple((p.data_ptr(), p._version) for p in params))
        if key is None or self._k4_weights is None or self._k4_weights[0] != key:
            self._k4_weights = (key, pack_triplane_weights(self.decoder_weights(), scene_code.device))
        return (pack_triplane_planes(scene_code), *self._k4_weights[1])

    @staticmethod
    def _query_points(scene_code, weights, spec, wx, wy, wz, packed=None):
        """``query_triplane_points`` at flat world positions: one K4 launch
        on the card; on the CPU in chunks, which only bound the plain
        version's feature tensors."""
        if scene_code.is_cuda:
            return query_triplane_points(scene_code, weights, wx, wy, wz, spec, packed)
        parts = [
            query_triplane_points(scene_code, weights, wx[s : s + _COLOR_CHUNK], wy[s : s + _COLOR_CHUNK],
                                  wz[s : s + _COLOR_CHUNK], spec)
            for s in range(0, wx.shape[0], _COLOR_CHUNK)
        ]
        return {key: torch.cat([p[key] for p in parts], dim=-1) for key in parts[0]}

    def _color_query(self, scene_code, weights, spec, wx, wy, wz) -> torch.Tensor:
        """Colors at world positions -> (3, N)."""
        packed = self._k4_inputs(scene_code) if scene_code.is_cuda else None
        return self._query_points(scene_code, weights, spec, wx, wy, wz, packed)["color"]

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

    # -- the handles: dispatch, then wait and finish on the host --------
    def extract_mesh_async(
        self,
        scene_code: torch.Tensor,
        has_vertex_color: bool = False,
        resolution: int = 256,
        threshold: float = 25.0,
        max_verts: int = 0,
        max_faces: int = 0,
        mode: Optional[str] = None,
    ) -> _MeshHandle:
        """Enqueue one asset's extraction on the device, on the path that
        ``mode`` and the device choose (``packed_path``), then the copy of
        its output to pinned host memory, and return a handle for
        ``extract_mesh_wait``; nothing here waits for the device.
        ``max_faces`` bounds the K10 path's face capacity; the wire path has
        no device face buffer and refuses it. Capacities not given come
        from the path's policy (``wire_capacities``, ``packed_capacities``)."""
        packed = packed_path(mode, scene_code.device, max_faces)
        policy = self.packed_capacities if packed else self.wire_capacities
        caps = policy.dispatch(resolution, (max_verts, max_faces)[: 1 + packed])
        threshold, want_colors = float(threshold), bool(has_vertex_color)
        host = self._dispatch(scene_code, resolution, threshold, caps, want_colors, packed)
        return _MeshHandle(self, scene_code, host, caps, resolution, threshold, want_colors, packed)

    def _dispatch(self, scene_code, resolution, threshold, caps, want_colors, packed) -> _HostCopy:
        extract = self._extract_packed if packed else self._extract_wire
        return _to_host_async(extract(scene_code, resolution, threshold, *caps, want_colors))

    @staticmethod
    def _counts(host: _HostCopy, packed: bool) -> tuple:
        """The exact counters: (num_verts, num_faces) on the K10 path, the
        wire's (num_verts,) from its tail."""
        if packed:
            return tuple(host.part(0).tolist())
        return (int(mc_wire.wire_counts(host.wire(), N_WIRE_COUNTS)[0]),)

    def _wait(self, handle: _MeshHandle):
        """Block on a handle -> (mesh, counts, caps). Waits for the counters
        only; an overflow is re-extracted with grown capacities, its copies
        queued the same way; then the host finish."""
        host, caps = handle.host, handle.caps
        while True:
            with record_function("tsr.counts_to_host" if handle.packed else "tsr.wire_to_host"):
                counts = self._counts(host, handle.packed)
            grown = handle.capacities.grow(counts, caps)
            if grown is None:
                break
            caps = grown
            with record_function("tsr.capacity_retry"):
                host = self._dispatch(handle.scene_code, handle.resolution, handle.threshold, caps,
                                      handle.want_colors, handle.packed)
        with record_function("tsr.wire_decode"):
            if handle.packed:
                mesh = self._packed_finish(host, counts)
            else:
                mesh = self._wire_decode(host, counts, caps, handle.resolution)
        return mesh, counts, caps

    def _wire_decode(self, host: _HostCopy, counts: tuple, caps: tuple, resolution: int):
        """Wire (+ split color bytes) -> (verts world f32, faces i64, colors f32 | None)."""
        (nv,), (mv,) = counts, caps
        shape = (resolution, resolution, resolution)
        with record_function("tsr.wire_faces"):
            verts, faces, *_ = mc_wire.decode_wire(host.wire(), shape, mv, has_colors=False)
        colors = None
        if len(host.parts) > 1 and nv > 0:
            with record_function("tsr.colors_to_host"):
                cb = host.part(1).numpy()  # its copy ran while the geometry decoded
            colors = cb.reshape(3, mv)[:, :nv].T.astype(np.float32) / 255.0
        scale = 2 * self.config.radius / (resolution - 1.0)
        return verts * scale - self.config.radius, faces.astype(np.int64), colors

    @staticmethod
    def _packed_finish(host: _HostCopy, counts: tuple):
        """The K10 path's host parts (counts, faces, world positions, colors)
        -> (verts (nv, 3) f32, faces (nf, 3) i64, colors (nv, 3) f32 | None),
        the live rows copied out of the pinned blocks, each part waited on
        just before its copy, so the later parts' copies overlap the faces'."""
        nv, nf = counts
        with record_function("tsr.wire_faces"):
            faces = _rows_out(host.part(1), nf, np.int64)
        verts = _rows_out(host.part(2), nv, np.float32)
        colors = None
        if len(host.parts) > 3 and nv > 0:
            with record_function("tsr.colors_to_host"):
                rgb = host.part(3)
            colors = _rows_out(rgb, nv, np.float32)
        return verts, faces, colors

    def extract_mesh_wait(self, handle: _MeshHandle, store: bool = True):
        """Block on a handle -> ((verts, faces, colors | None), (nv, mv)):
        verts (nv, 3) f32 world, faces (nf, 3) int64, colors (nv, 3) f32,
        arrays that own their memory. Waits for the counters only; an
        overflow is re-extracted with grown capacities. ``store=False`` skips
        the capacity policy's ``keep``."""
        mesh, counts, caps = self._wait(handle)
        if store:
            handle.capacities.keep(handle.resolution, counts, caps)
        return mesh, (counts[0], caps[0])

    @staticmethod
    def extract_mesh_wait_all(handles) -> list:
        """Wait for and finish each handle in order, each on its own model
        and in its device's scope -> the meshes of ``extract_mesh_wait``. An
        overflow is re-extracted with grown capacities; then each path's
        policy keeps the batch's largest counts and capacities, once."""
        out, runs = [], {}
        for h in handles:
            with device_scope(h.scene_code.device):
                mesh, counts, caps = h.tsr._wait(h)
            runs.setdefault((h.capacities, h.resolution), []).append((counts, caps))
            out.append(mesh)
        for (policy, resolution), batch in runs.items():
            policy.keep_batch(resolution, batch)
        return out

    def extract_mesh(
        self,
        scene_codes,
        has_vertex_color: bool = False,
        resolution: int = 256,
        threshold: float = 25.0,
        max_verts: int = 0,
        max_faces: int = 0,
        mode: Optional[str] = None,
    ):
        """A list of (verts, faces, colors | None) numpy triples, verts in
        (-radius, radius) world coords like the reference
        (``tsr/system.py:185-189``).

        Every asset is enqueued (``extract_mesh_async``) before the first is
        waited on (``extract_mesh_wait_all``), so the host work overlaps
        device work.
        ``mode=None`` follows the device (``packed_path``): on the card the
        faces come from the device (kernel K10) with exact f32 positions and
        colors; on the CPU, and with ``mode="wire"`` anywhere, occupancy
        bits, u16 t and u8 colors come to the host, which rebuilds the
        faces. ``mode="packed"`` takes K10 anywhere. The wire path has no
        device face buffer, so ``max_faces`` raises there."""
        packed_path(mode, self.device, max_faces)  # raises before any work
        return self.extract_mesh_wait_all([
            self.extract_mesh_async(code, has_vertex_color, resolution, threshold, max_verts, max_faces, mode)
            for code in scene_codes
        ])

    # -- the K10 path's device work ---------------------------------------
    @torch.inference_mode()
    def packed_mesh(self, scene_code, resolution: int, threshold: float, mv: int = 0, mf: int = 0) -> MCResult:
        """The density lattice (K2), the iso-level taken off in place, and
        the face-emitting marching cubes (K10) of one code -> its
        ``MCResult`` in lattice coords. Capacities not given (> 0) are the
        K10 path's defaults; rows past them are dropped and the counters
        stay exact, so the caller sees an overflow."""
        mv, mf = (c if c > 0 else d for c, d in zip((mv, mf), self.packed_capacities.default(resolution)))
        spec = self.grid_spec(resolution, compute_dtype=self.extract_dtype)
        with record_function("tsr.density_grid"):
            level = query_density_grid(scene_code, self.decoder_weights(), spec)
        with record_function("tsr.marching_cubes"):
            return marching_cubes(level.sub_(threshold), mv, mf)

    @torch.inference_mode()
    def _extract_packed(self, scene_code, resolution: int, threshold: float, mv: int, mf: int, want_colors: bool):
        """One asset on the K10 path: ``packed_mesh``, its positions turned
        into world coordinates in K10's own buffer, and (with
        ``want_colors``) K4 at every vertex slot -> the parts to copy to the
        host: counts (2,) int32 (num_verts, num_faces), the faces' three
        (mf,) int32 rows, the positions' three (mv,) f32 rows, colors (3, mv)
        f32."""
        res = self.packed_mesh(scene_code, resolution, threshold, mv, mf)
        r = self.config.radius
        scale = 2 * r / (resolution - 1.0)
        verts = [res.vx, res.vy, res.vz]
        for v in verts:
            v.mul_(scale).sub_(r)
        parts = (torch.stack([res.num_verts, res.num_faces]), [res.fa, res.fb, res.fc], verts)
        if want_colors:
            with record_function("tsr.color_query"):
                spec = self.grid_spec(resolution, compute_dtype=self.extract_dtype)
                parts += (self._color_query(scene_code, self.decoder_weights(), spec, *verts),)
        return parts

    # -- novel-view rendering (the reference's spherical render path,
    # -- nerf_renderer.py:93-172 with get_spherical_cameras) ---------------
    def _render_points(self, rays_o: torch.Tensor, rays_d: torch.Tensor, num_samples: int):
        """Sample positions of (..., 3) rays: the bbox slab test, then the
        midpoints of ``num_samples`` equal steps between t_near and t_far ->
        (px, py, pz) flat (N * S,), t_vals (S + 1,), valid (N,)."""
        o, d = rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)
        t_near, t_far, valid = rays_intersect_bbox(o, d, self.config.radius)
        t_vals = torch.linspace(0.0, 1.0, num_samples + 1, device=o.device)
        t_mid = (t_vals[:-1] + t_vals[1:]) / 2.0
        z = t_near[:, None] * (1 - t_mid)[None] + t_far[:, None] * t_mid[None]
        pts = [(o[:, a : a + 1] + z * d[:, a : a + 1]).reshape(-1) for a in range(3)]
        return pts, t_vals, valid

    @torch.inference_mode()
    def _render_rays(self, scene_code, rays_o, rays_d, num_samples: int, packed=None):
        """Volume-render (H, W, 3) rays of one scene code -> (rgb (H, W, 3)
        on white, opacity (H, W)). The decoder runs at every sample (K4 on
        the card, in ``extract_dtype``); alpha = 1 - exp(-delta sigma) with
        delta the spacing of ``t_vals`` (1 / S), the JAX package's spec."""
        shape = rays_o.shape[:-1]
        weights = self.decoder_weights()
        spec = self.grid_spec(2, compute_dtype=self.extract_dtype)  # resolution unused for point queries
        (px, py, pz), t_vals, valid = self._render_points(rays_o, rays_d, num_samples)
        with record_function("tsr.render_query"):
            out = self._query_points(scene_code, weights, spec, px, py, pz, packed)
        with record_function("tsr.render_composite"):
            sigma = out["density_act"].reshape(-1, num_samples)
            color = out["color"].reshape(3, -1, num_samples)
            delta = (t_vals[1:] - t_vals[:-1])[None]
            alpha = 1.0 - torch.exp(-delta * sigma)
            accum = torch.cat(
                [torch.ones_like(alpha[:, :1]), torch.cumprod(1.0 - alpha[:, :-1] + 1e-10, dim=-1)], dim=-1
            )
            w = alpha * accum
            rgb = torch.einsum("ns,cns->nc", w, color)
            opacity = w.sum(-1)
            zero = torch.zeros((), device=rgb.device)
            rgb = torch.where(valid[:, None], rgb, zero)
            opacity = torch.where(valid, opacity, zero)
            rgb = rgb + (1.0 - opacity[:, None])  # white background
        return rgb.reshape(*shape, 3), opacity.reshape(shape)

    def render_views(
        self,
        scene_codes,
        n_views: int = 8,
        elevation_deg: float = 0.0,
        camera_distance: float = 1.9,
        fovy_deg: float = 40.0,
        height: int = 256,
        width: int = 256,
        num_samples: int = 128,
    ):
        """Spherical novel views of each scene code -> a list of (n_views,
        H, W, 3) f32 numpy arrays, one per code."""
        out = []
        with record_function("tsr.render"):
            rays_o, rays_d = get_spherical_cameras(
                n_views, elevation_deg, camera_distance, fovy_deg, height, width, device=self.device
            )
            for code in scene_codes:
                packed = self._k4_inputs(code) if code.is_cuda else None  # laid out once per code
                views = [self._render_rays(code, rays_o[v], rays_d[v], num_samples, packed)[0] for v in range(n_views)]
                out.append(torch.stack(views).cpu().numpy())
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
