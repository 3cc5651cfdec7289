"""Plain reference of Stable Fast 3D ("Pro"): RGBA image -> triplane codes,
materials, the tet lattice's density and vertex offsets, and the albedo and
perturbed normal at surface points, over a state dict under the published
checkpoint's names (``stabilityai/stable-fast-3d``, ``config.yaml``; arXiv
2408.00653).

Written from the published architecture, in plain torch operations, each
product through a ``Precision`` (float32 with TF32 off for the reference,
rounded operands for the control). No kernels, no cache, no batching:

- the camera embedder: one Linear over the flattened condition c2w (16)
  and normalised intrinsics (9), the fixed condition camera of the
  published ``utils.py`` (looking down -x from ``default_distance``,
  ``default_fovy_deg``);
- DINOv2 with camera AdaLN: ImageNet normalisation, the 14-pixel patch
  convolution, the class token, the position table resized bicubic by the
  factor (grid + 0.1) / base (the published ``interpolate_pos_encoding``),
  pre-LN layers whose norm outputs are modulated x (1 + scale) + shift by
  a Linear of SiLU(camera embedding), LayerScale, exact-erf GELU, a final
  LayerNorm;
- the learned triplane tokens, channels last, plane-major;
- the two-stream interleave backbone: GroupNorm and a projection of the
  triplane tokens, the projected image tokens followed by the projected
  learned latents as the latent stream, per block a fuse-in (the latents
  attend to the triplane), basic blocks (latent self-attention,
  cross-attention to the raw image tokens, a GEGLU feed-forward) and a
  fuse-out (the triplane attends to the latents), a projection out and the
  residual; attention is softmax(q k^T / sqrt(d)) v over the whole
  sequence, computed in blocks of queries where memory asks;
- the pixel-shuffle upsample: per plane 3x3 convolutions with ReLU between,
  the last one to C_out s^2 channels, then a pixel shuffle by s;
- the CLIP ViT-B/32 material estimator: the masked image resized bilinear
  (no antialias) to 224^2, OpenAI normalisation, the visual tower's class
  token through ``ln_post`` and the projection, per material a shared ReLU
  stack and two parameter stacks, softplus(p + 1), and the Beta mode;
- the ``MaterialMLP`` heads over triplane features sampled bilinear with
  aligned corners (planes xy, xz, yz): on the (res + 1)^3 lattice the
  density exp(d - 1) and the raw vertex offsets, at world points the albedo
  (sigmoid of the features head) and the unit perturbed normal.

Departures from the published description, each the port's and the JAX
package's too: the marching tetrahedra run on the Freudenthal (Kuhn) split
of the lattice cubes (six tets a cube, seven edge directions) in place of
the published precomputed ``160_tets.npz`` grid, which is not available;
the port's snap-weld (``weld_eps``: a vertex within that share of an edge
end is welded onto the lattice point) is the JAX package's, not the
published model's, and this reference does not weld: its raw marching-tets
vertices are one per cut edge, at t = clamp(s_a / (s_a - s_b), 0, 1)
between the two deformed ends (each lattice point moved by tanh(offset) /
res in [0, 1] lattice units, the published ``normalize_grid_deformation``).

``param_specs`` lists every parameter with its shape and its seeded
initialisation (fan-in normal matrices, zero biases, unit norms and
LayerScales, N(0, 0.02) position tables, latents, class embedding and CLIP
projection, zero DINOv2 class token, N(0, 1) / sqrt(C) triplane tokens;
the AdaLN modulations at ``modulation_init_gain`` x the fan-in scale, and
the decoder heads' matrices and biases as the configuration's ``decoder``
group sets them). Imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch
import torch.nn.functional as F

from reference.precision import EXACT, Precision
from reference.tsr import IMAGENET_MEAN, IMAGENET_STD, Spec

OPENAI_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_STD = (0.26862954, 0.26130258, 0.27577711)
# the seven tet-edge directions of the Freudenthal split along the main
# diagonal: every tet edge of every cube is one of them from a lattice point
EDGE_DIRS = ((1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 1, 0), (1, 0, 1), (0, 1, 1), (1, 1, 1))
# query rows per attention block, and lattice x-rows per MLP block
_QUERY_BLOCK = 4096
_LATTICE_ROWS = 8


def param_specs(c: dict) -> List[Spec]:
    """Every parameter of the model configured by ``c`` (the configuration
    file), under the published checkpoint's names."""
    out: List[Spec] = []

    def linear(name, d_in, d_out, bias=True, gain=1.0):
        out.append((f"{name}.weight", (d_out, d_in), ("normal", gain * d_in ** -0.5)))
        if bias:
            out.append((f"{name}.bias", (d_out,), ("zeros",)))

    def norm(name, d):
        out.append((f"{name}.weight", (d,), ("ones",)))
        out.append((f"{name}.bias", (d,), ("zeros",)))

    def conv(name, c_in, c_out, k, bias=True):
        out.append((f"{name}.weight", (c_out, c_in, k, k), ("normal", (c_in * k * k) ** -0.5)))
        if bias:
            out.append((f"{name}.bias", (c_out,), ("zeros",)))

    cam = c["camera_embedder"]
    linear("camera_embedder.linear", cam["in_channels"], cam["out_channels"])

    v = c["image_tokenizer"]
    hv, p = v["hidden_size"], v["patch_size"]
    base = v["base_image_size"] // p
    e = "image_tokenizer.model.embeddings"
    out.append((f"{e}.cls_token", (1, 1, hv), ("zeros",)))
    out.append((f"{e}.position_embeddings", (1, 1 + base * base, hv), ("normal", 0.02)))
    conv(f"{e}.patch_embeddings.projection", 3, hv, p)
    for i in range(v["num_hidden_layers"]):
        L = f"image_tokenizer.model.encoder.layer.{i}"
        norm(f"{L}.norm1", hv)
        linear(f"{L}.norm1_modulation.linear2", cam["out_channels"], 2 * hv, gain=v["modulation_init_gain"])
        for n in ("query", "key", "value"):
            linear(f"{L}.attention.attention.{n}", hv, hv)
        linear(f"{L}.attention.output.dense", hv, hv)
        out.append((f"{L}.layer_scale1.lambda1", (hv,), ("ones",)))
        norm(f"{L}.norm2", hv)
        linear(f"{L}.norm2_modulation.linear2", cam["out_channels"], 2 * hv, gain=v["modulation_init_gain"])
        linear(f"{L}.mlp.fc1", hv, v["intermediate_size"])
        linear(f"{L}.mlp.fc2", v["intermediate_size"], hv)
        out.append((f"{L}.layer_scale2.lambda1", (hv,), ("ones",)))
    norm("image_tokenizer.model.layernorm", hv)

    t, b = c["tokenizer"], c["backbone"]
    C, S = t["num_channels"], t["plane_size"]
    out.append(("tokenizer.embeddings", (3, C, S, S), ("normal", C ** -0.5)))
    inner = b["num_attention_heads"] * b["attention_head_dim"]
    out.append(("backbone.latent_init", (1, b["num_latents"], inner), ("normal", 0.02)))
    norm("backbone.norm_triplane", C)
    linear("backbone.proj_triplane", C, C)
    norm("backbone.norm_image", hv)
    linear("backbone.proj_image", hv, inner)
    norm("backbone.norm_latent", inner)
    linear("backbone.proj_latent", inner, inner)

    def attention(name, dim, kv_dim):
        for w, d_in in (("wq", dim), ("wk", kv_dim), ("wv", kv_dim)):
            linear(f"{name}.{w}", d_in, dim, bias=False)
        linear(f"{name}.proj", dim, dim)

    def feed_forward(name, dim):
        linear(f"{name}.net.0.proj", dim, 8 * dim)
        linear(f"{name}.net.2", 4 * dim, dim)

    def fuse(name, dim_z, dim_x):
        norm(f"{name}.norm_z1", dim_z)
        attention(f"{name}.attn", dim_z, dim_x)
        norm(f"{name}.norm_z2", dim_z)
        feed_forward(f"{name}.ff", dim_z)

    for i in range(b["num_blocks"]):
        B = f"backbone.main_blocks.{i}"
        fuse(f"{B}.fuse_block_in", inner, C)
        for j in range(b["num_basic_blocks"]):
            T = f"{B}.transformer_block.{j}"
            norm(f"{T}.norm1", inner)
            attention(f"{T}.attn1", inner, inner)
            norm(f"{T}.norm2", inner)
            attention(f"{T}.attn2", inner, hv)
            norm(f"{T}.norm3", inner)
            feed_forward(f"{T}.ff", inner)
        fuse(f"{B}.fuse_block_out", C, inner)
    linear("backbone.proj_out", C, C)

    po = c["post_processor"]
    for i in range(po["conv_layers"]):
        last = i == po["conv_layers"] - 1
        conv(f"post_processor.upsample.{2 * i}", C, po["out_channels"] * po["scale_factor"] ** 2 if last else C, 3)

    d = c["decoder"]
    for h in d["heads"]:
        dims = [3 * po["out_channels"]] + [d["n_neurons"]] * h["n_hidden_layers"] + [h["out_channels"]]
        for i in range(len(dims) - 1):
            gain, bias_std = d["init_gain"], d["init_bias_std"]
            if i == len(dims) - 2:  # the output layer, scaled per head where the configuration says
                gain *= d["output_gain"].get(h["name"], 1.0)
                bias_std *= d["output_gain"].get(h["name"], 1.0)
            name = f"decoder.heads.{h['name']}.{2 * i}"
            out.append((f"{name}.weight", (dims[i + 1], dims[i]), ("normal", gain * dims[i] ** -0.5)))
            out.append((f"{name}.bias", (dims[i + 1],), ("normal", bias_std) if bias_std else ("zeros",)))

    ie = c["image_estimator"]
    w, hf = ie["clip_width"], ie["hidden_features"]
    grid = ie["image_size"] // ie["patch_size"]
    vis = "image_estimator.model.visual"
    conv(f"{vis}.conv1", 3, w, ie["patch_size"], bias=False)
    out.append((f"{vis}.class_embedding", (w,), ("normal", 0.02)))
    out.append((f"{vis}.positional_embedding", (1 + grid * grid, w), ("normal", 0.02)))
    norm(f"{vis}.ln_pre", w)
    for i in range(ie["clip_layers"]):
        R = f"{vis}.transformer.resblocks.{i}"
        norm(f"{R}.ln_1", w)
        out.append((f"{R}.attn.in_proj_weight", (3 * w, w), ("normal", w ** -0.5)))
        out.append((f"{R}.attn.in_proj_bias", (3 * w,), ("zeros",)))
        linear(f"{R}.attn.out_proj", w, w)
        norm(f"{R}.ln_2", w)
        linear(f"{R}.mlp.c_fc", w, 4 * w)
        linear(f"{R}.mlp.c_proj", 4 * w, w)
    norm(f"{vis}.ln_post", w)
    out.append((f"{vis}.proj", (w, hf), ("normal", 0.02)))
    for name in ie["heads"]:
        H = f"image_estimator.heads.{name}"
        for i in range(ie["n_hidden_layers"]):
            linear(f"{H}.0.{2 * i}", hf, hf)
        for k in (1, 2):
            linear(f"{H}.{k}.0", hf, hf)
            linear(f"{H}.{k}.2", hf, 1)

    ge = c["global_estimator"]
    conv("global_estimator.layers.0", 3 * C, ge["pool_features"], 3)
    conv("global_estimator.layers.2", ge["pool_features"], ge["pool_features"], 3)
    for i in range(ge["n_hidden_layers"]):
        linear(f"global_estimator.heads.sg_amplitudes.{2 * i}", ge["pool_features"] if i == 0 else ge["hidden_features"],
               ge["hidden_features"])
    linear(f"global_estimator.heads.sg_amplitudes.{2 * ge['n_hidden_layers']}", ge["hidden_features"],
           ge["out_channels"])
    return out


def _layer_norm(x, sd, name, eps):
    return F.layer_norm(x.float(), x.shape[-1:], sd[f"{name}.weight"].float(), sd[f"{name}.bias"].float(), eps)


def _lin(q: Precision, x, sd, name):
    return q.linear(x, sd[f"{name}.weight"], sd.get(f"{name}.bias"))


def _heads(x, n):
    B, N, C = x.shape
    return x.reshape(B, N, n, C // n).transpose(1, 2)


def _merge(x):
    B, H, N, D = x.shape
    return x.transpose(1, 2).reshape(B, N, H * D)


def _attention(q: Precision, qh, kh, vh):
    """(B, H, Nq, D), (B, H, Nk, D) -> (B, H, Nq, D): the softmax in float32
    over every key, ``_QUERY_BLOCK`` queries at a time."""
    kt = kh.transpose(-1, -2)
    scale = 1.0 / math.sqrt(qh.shape[-1])
    parts = []
    for s in range(0, qh.shape[2], _QUERY_BLOCK):
        scores = q.matmul(qh[:, :, s : s + _QUERY_BLOCK], kt) * scale
        parts.append(q.matmul(torch.softmax(scores, dim=-1), vh))
    return torch.cat(parts, dim=2)


def _cross_attention(q: Precision, sd, name, x_q, x_kv, heads):
    qh = _heads(_lin(q, x_q, sd, f"{name}.wq"), heads)
    kh = _heads(_lin(q, x_kv, sd, f"{name}.wk"), heads)
    vh = _heads(_lin(q, x_kv, sd, f"{name}.wv"), heads)
    return _lin(q, _merge(_attention(q, qh, kh, vh)), sd, f"{name}.proj")


def _geglu_ff(q: Precision, sd, name, x):
    val, gate = _lin(q, x, sd, f"{name}.net.0.proj").chunk(2, dim=-1)
    return _lin(q, val * F.gelu(gate), sd, f"{name}.net.2")


def condition_camera(c: dict, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fixed condition camera: (c2w (4, 4), normalised intrinsics (3, 3))."""
    d = c["default_distance"]
    c2w = torch.tensor([[0.0, 0.0, 1.0, d], [1.0, 0.0, 0.0, 0.0], [0.0, 1.0, 0.0, 0.0], [0.0, 0.0, 0.0, 1.0]],
                       device=device)
    s = c["cond_image_size"]
    focal = 0.5 * s / math.tan(0.5 * math.radians(c["default_fovy_deg"]))
    kn = torch.tensor([[focal / s, 0.0, 0.5], [0.0, focal / s, 0.5], [0.0, 0.0, 1.0]], device=device)
    return c2w, kn


def camera_embedding(sd, c: dict, batch: int, device, q: Precision = EXACT) -> torch.Tensor:
    c2w, kn = condition_camera(c, device)
    x = torch.cat([c2w.reshape(-1), kn.reshape(-1)])[None].expand(batch, -1)
    return _lin(q, x, sd, "camera_embedder.linear")


def image_tokens(sd, c: dict, rgb: torch.Tensor, camera: torch.Tensor, q: Precision = EXACT) -> torch.Tensor:
    """(B, S, S, 3) in [0, 1] and the camera embedding (B, E) -> the
    camera-modulated DINOv2 tokens (B, 1 + g^2, hidden)."""
    v = c["image_tokenizer"]
    mean = torch.tensor(IMAGENET_MEAN, device=rgb.device)
    std = torch.tensor(IMAGENET_STD, device=rgb.device)
    x = ((rgb.float() - mean) / std).permute(0, 3, 1, 2)
    e = "image_tokenizer.model.embeddings"
    x = q.conv2d(x, sd[f"{e}.patch_embeddings.projection.weight"], sd[f"{e}.patch_embeddings.projection.bias"],
                 stride=v["patch_size"])
    B, C, g, _ = x.shape
    x = x.flatten(2).transpose(1, 2)
    pos = sd[f"{e}.position_embeddings"].float()
    base = int(round((pos.shape[1] - 1) ** 0.5))
    patch = pos[:, 1:].reshape(1, base, base, C).permute(0, 3, 1, 2)
    if base != g:
        factor = (g + 0.1) / base
        patch = F.interpolate(patch, scale_factor=(factor, factor), mode="bicubic", align_corners=False)
    pos = torch.cat([pos[:, :1], patch.flatten(2).transpose(1, 2)], dim=1)
    x = torch.cat([sd[f"{e}.cls_token"].float().expand(B, 1, C), x], dim=1) + pos
    heads, eps = v["num_attention_heads"], v["layer_norm_eps"]
    cond = F.silu(camera.float())
    for i in range(v["num_hidden_layers"]):
        L = f"image_tokenizer.model.encoder.layer.{i}"
        for k, block in ((1, "attention"), (2, "mlp")):
            scale, shift = _lin(q, cond, sd, f"{L}.norm{k}_modulation.linear2").chunk(2, dim=-1)
            h = _layer_norm(x, sd, f"{L}.norm{k}", eps) * (1.0 + scale[:, None]) + shift[:, None]
            if block == "attention":
                qh, kh, vh = (_heads(_lin(q, h, sd, f"{L}.attention.attention.{n}"), heads)
                              for n in ("query", "key", "value"))
                h = _lin(q, _merge(_attention(q, qh, kh, vh)), sd, f"{L}.attention.output.dense")
            else:
                h = _lin(q, F.gelu(_lin(q, h, sd, f"{L}.mlp.fc1")), sd, f"{L}.mlp.fc2")
            x = x + h * sd[f"{L}.layer_scale{k}.lambda1"].float()
    return _layer_norm(x, sd, "image_tokenizer.model.layernorm", eps)


def backbone(sd, c: dict, tokens: torch.Tensor, image: torch.Tensor, q: Precision = EXACT) -> torch.Tensor:
    """The two-stream interleave transformer: triplane tokens (B, N, C) and
    image tokens (B, Ni, hidden) -> triplane tokens (B, N, C)."""
    b = c["backbone"]
    heads = b["num_attention_heads"]
    triplane = F.group_norm(tokens.transpose(1, 2), b["norm_num_groups"], sd["backbone.norm_triplane.weight"].float(),
                            sd["backbone.norm_triplane.bias"].float(), 1e-6).transpose(1, 2)
    triplane = _lin(q, triplane, sd, "backbone.proj_triplane")
    img = _lin(q, _layer_norm(image, sd, "backbone.norm_image", 1e-5), sd, "backbone.proj_image")
    lat = sd["backbone.latent_init"].float().expand(tokens.shape[0], -1, -1)
    lat = _lin(q, _layer_norm(lat, sd, "backbone.norm_latent", 1e-5), sd, "backbone.proj_latent")
    latent = torch.cat([img, lat], dim=1)

    def fuse(name, z, x):
        z = z + _cross_attention(q, sd, f"{name}.attn", _layer_norm(z, sd, f"{name}.norm_z1", 1e-5), x, heads)
        return z + _geglu_ff(q, sd, f"{name}.ff", _layer_norm(z, sd, f"{name}.norm_z2", 1e-5))

    for i in range(b["num_blocks"]):
        B = f"backbone.main_blocks.{i}"
        latent = fuse(f"{B}.fuse_block_in", latent, triplane)
        for j in range(b["num_basic_blocks"]):
            T = f"{B}.transformer_block.{j}"
            h = _layer_norm(latent, sd, f"{T}.norm1", 1e-5)
            latent = latent + _cross_attention(q, sd, f"{T}.attn1", h, h, heads)
            latent = latent + _cross_attention(q, sd, f"{T}.attn2", _layer_norm(latent, sd, f"{T}.norm2", 1e-5),
                                               image.float(), heads)
            latent = latent + _geglu_ff(q, sd, f"{T}.ff", _layer_norm(latent, sd, f"{T}.norm3", 1e-5))
        triplane = fuse(f"{B}.fuse_block_out", triplane, latent)
    return _lin(q, triplane, sd, "backbone.proj_out") + tokens


def prepare_image(c: dict, rgba: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W, 4) RGBA in [0, 1] -> (mask, RGB over the background) at the
    condition size (antialiased bilinear, half-pixel centres)."""
    s = c["cond_image_size"]
    x = rgba.float()
    if x.shape[1] != s or x.shape[2] != s:
        x = F.interpolate(x.permute(0, 3, 1, 2), size=(s, s), mode="bilinear", align_corners=False,
                          antialias=True).permute(0, 2, 3, 1)
    mask = x[..., 3:4]
    bg = torch.tensor(c["background_color"], dtype=torch.float32, device=x.device)
    return mask, (bg * (1.0 - mask) + x[..., :3] * mask).clamp(0.0, 1.0)


def scene_codes(sd, c: dict, rgb: torch.Tensor, q: Precision = EXACT) -> torch.Tensor:
    """(B, S, S, 3) at the condition size -> (B, 3, C_out, s P, s P) codes."""
    B = rgb.shape[0]
    image = image_tokens(sd, c, rgb, camera_embedding(sd, c, B, rgb.device, q), q)
    t, po = c["tokenizer"], c["post_processor"]
    C, P = t["num_channels"], t["plane_size"]
    tokens = sd["tokenizer.embeddings"].float().reshape(3, C, P * P).permute(0, 2, 1).reshape(1, 3 * P * P, C)
    out = backbone(sd, c, tokens.expand(B, -1, -1), image, q)
    planes = out.transpose(1, 2).reshape(B, C, 3, P, P).transpose(1, 2).reshape(B * 3, C, P, P)
    for i in range(po["conv_layers"]):
        planes = q.conv2d(planes, sd[f"post_processor.upsample.{2 * i}.weight"],
                          sd[f"post_processor.upsample.{2 * i}.bias"], padding=1)
        planes = F.relu(planes) if i < po["conv_layers"] - 1 else F.pixel_shuffle(planes, po["scale_factor"])
    return planes.reshape(B, 3, *planes.shape[1:])


def materials(sd, c: dict, masked_rgb: torch.Tensor, q: Precision = EXACT) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S, S, 3) masked RGB -> (roughness (B,), metallic (B,)): the CLIP
    estimator's Beta modes."""
    ie = c["image_estimator"]
    x = F.interpolate(masked_rgb.float().permute(0, 3, 1, 2), size=(ie["image_size"],) * 2, mode="bilinear",
                      align_corners=False, antialias=False)
    mean = torch.tensor(OPENAI_MEAN, device=x.device)[:, None, None]
    std = torch.tensor(OPENAI_STD, device=x.device)[:, None, None]
    vis = "image_estimator.model.visual"
    x = q.conv2d((x - mean) / std, sd[f"{vis}.conv1.weight"], stride=ie["patch_size"])
    B, W = x.shape[:2]
    x = torch.cat([sd[f"{vis}.class_embedding"].float().expand(B, 1, W), x.flatten(2).transpose(1, 2)], dim=1)
    x = _layer_norm(x + sd[f"{vis}.positional_embedding"].float()[None], sd, f"{vis}.ln_pre", 1e-6)
    heads = ie["clip_heads"]
    for i in range(ie["clip_layers"]):
        R = f"{vis}.transformer.resblocks.{i}"
        h = _layer_norm(x, sd, f"{R}.ln_1", 1e-6)
        qkv = q.linear(h, sd[f"{R}.attn.in_proj_weight"], sd[f"{R}.attn.in_proj_bias"])
        qh, kh, vh = (_heads(t, heads) for t in qkv.chunk(3, dim=-1))
        x = x + _lin(q, _merge(_attention(q, qh, kh, vh)), sd, f"{R}.attn.out_proj")
        h = _layer_norm(x, sd, f"{R}.ln_2", 1e-6)
        x = x + _lin(q, F.gelu(_lin(q, h, sd, f"{R}.mlp.c_fc")), sd, f"{R}.mlp.c_proj")
    feats = q.matmul(_layer_norm(x[:, 0], sd, f"{vis}.ln_post", 1e-6), sd[f"{vis}.proj"])
    out = []
    for name in ie["heads"]:
        H = f"image_estimator.heads.{name}"
        s = feats
        for i in range(ie["n_hidden_layers"]):
            s = F.relu(_lin(q, s, sd, f"{H}.0.{2 * i}"))
        a, b = (F.softplus(_lin(q, F.relu(_lin(q, s, sd, f"{H}.{k}.0")), sd, f"{H}.{k}.2")[:, 0] + ie["output_bias"])
                for k in (1, 2))
        out.append(((a - 1.0) / torch.clamp(a + b - 2.0, min=1e-6)).clamp(0.0, 1.0))
    return out[0], out[1]


def _plane_sample(plane: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Bilinear sample with zero padding and aligned corners of a (C, H, W)
    plane at flat (N,) normalised points, u along W and v along H -> (N, C)."""
    grid = torch.stack([u, v], dim=-1).float()[None, None]
    out = F.grid_sample(plane.float()[None], grid, mode="bilinear", padding_mode="zeros", align_corners=True)
    return out[0, :, 0].t()


def triplane_features(code: torch.Tensor, px, py, pz) -> torch.Tensor:
    """(3, C, H, W) planes (xy, xz, yz) at flat normalised points -> (N, 3C)."""
    return torch.cat([_plane_sample(code[0], px, py), _plane_sample(code[1], px, pz),
                      _plane_sample(code[2], py, pz)], dim=1)


def _head(sd, c: dict, name: str, feats: torch.Tensor, q: Precision) -> torch.Tensor:
    """One decoder head's output with its bias, before its activation."""
    spec = next(h for h in c["decoder"]["heads"] if h["name"] == name)
    h = feats
    n = spec["n_hidden_layers"]
    for i in range(n):
        h = F.silu(_lin(q, h, sd, f"decoder.heads.{name}.{2 * i}"))
    return _lin(q, h, sd, f"decoder.heads.{name}.{2 * n}") + spec.get("out_bias", 0.0)


def lattice(sd, c: dict, code: torch.Tensor, q: Precision = EXACT) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (res + 1)^3 tet lattice, points at i / res of the bounding box
    (normalised 2 i / res - 1), indexed [x, y, z] -> (density exp(d - 1)
    (N, N, N), raw vertex offsets (3, N, N, N)), ``_LATTICE_ROWS`` x-rows
    at a time."""
    res = c["isosurface_resolution"]
    N = res + 1
    g = 2.0 * torch.arange(N, dtype=torch.float32, device=code.device) / res - 1.0
    density = torch.empty((N, N, N), device=code.device)
    offsets = torch.empty((3, N, N, N), device=code.device)
    for x0 in range(0, N, _LATTICE_ROWS):
        xs = g[x0 : x0 + _LATTICE_ROWS]
        px, py, pz = (t.reshape(-1) for t in torch.meshgrid(xs, g, g, indexing="ij"))
        feats = triplane_features(code, px, py, pz)
        density[x0 : x0 + len(xs)] = torch.exp(_head(sd, c, "density", feats, q)[:, 0]).reshape(len(xs), N, N)
        offsets[:, x0 : x0 + len(xs)] = _head(sd, c, "vertex_offset", feats, q).t().reshape(3, len(xs), N, N)
    return density, offsets


def surface_heads(sd, c: dict, code: torch.Tensor, world: torch.Tensor, q: Precision = EXACT,
                  chunk: int = 1 << 18) -> Tuple[torch.Tensor, torch.Tensor]:
    """At (n, 3) world points -> (albedo (n, 3): sigmoid of the features
    head, perturbed normal (n, 3): the unit perturb-normal head)."""
    r = c["radius"]
    albedo, normal = [], []
    for s in range(0, world.shape[0], chunk):
        p = world[s : s + chunk].float() / r
        feats = triplane_features(code, p[:, 0], p[:, 1], p[:, 2])
        albedo.append(torch.sigmoid(_head(sd, c, "features", feats, q)))
        normal.append(F.normalize(_head(sd, c, "perturb_normal", feats, q), dim=-1, eps=1e-12))
    if not albedo:
        empty = torch.zeros((0, 3), device=world.device)
        return empty, empty
    return torch.cat(albedo), torch.cat(normal)


def _edge_ends(field: torch.Tensor, d):
    """The values at both ends of every lattice edge along direction d."""
    N = field.shape[-1]
    dx, dy, dz = d
    return field[..., : N - dx, : N - dy, : N - dz], field[..., dx:, dy:, dz:]


def cut_tet_edges(density: torch.Tensor, level: float) -> int:
    """How many tet edges the iso-surface density = ``level`` cuts: the raw
    marching-tets vertex count (one vertex a cut edge)."""
    inside = density > level
    return int(sum(int((a != b).sum()) for a, b in (_edge_ends(inside, d) for d in EDGE_DIRS)))


def threshold_for_vertices(density: torch.Tensor, target: int) -> float:
    """A level at which at least ``target`` tet edges are cut, and fewer at
    any higher lattice value: a bisection over the sorted values from the
    top, where fewer points are inside as the level rises."""
    v = density.flatten().float().sort().values
    lo, hi = v.numel() // 2, v.numel() - 2
    if cut_tet_edges(density, float(v[lo])) >= target:
        while hi - lo > 1:
            mid = (lo + hi) // 2
            if cut_tet_edges(density, float(v[mid])) >= target:
                lo = mid
            else:
                hi = mid
    # half way to the next value: the same points are inside, and none lies
    # on the level, where the program's rounding could put it either side
    return float((v[lo] + v[lo + 1]) / 2)


def welded_vertex_count(level: torch.Tensor, weld_eps: float) -> int:
    """How many vertices the raw surface of ``level`` keeps under the
    snap-weld: each cut edge's vertex with t under ``weld_eps`` goes to the
    edge's first lattice point, over 1 - ``weld_eps`` to its second, and
    the vertices at one lattice point become one."""
    N = level.shape[-1]
    inside = level > 0
    snapped = torch.zeros_like(inside)
    free = 0
    for d in EDGE_DIRS:
        (ia, ib), (la, lb) = _edge_ends(inside, d), _edge_ends(level, d)
        cut = ia != ib
        denom = la - lb
        t = (la / torch.where(denom == 0, torch.ones_like(denom), denom)).clamp(0.0, 1.0)
        at_a, at_b = cut & (t < weld_eps), cut & (t > 1.0 - weld_eps)
        free += int((cut & ~at_a & ~at_b).sum())
        dx, dy, dz = d
        snapped[: N - dx, : N - dy, : N - dz] |= at_a
        snapped[dx:, dy:, dz:] |= at_b
    return free + int(snapped.sum())


def raw_surface(level: torch.Tensor, offsets: torch.Tensor, radius: float) -> torch.Tensor:
    """The raw marching-tets vertices of ``level`` = density - T (inside
    where > 0) on the lattice deformed by ``offsets`` -> (n, 3) world
    positions."""
    N = level.shape[-1]
    res = N - 1
    base = torch.stack(torch.meshgrid(*(torch.arange(N, dtype=torch.float32, device=level.device),) * 3,
                                      indexing="ij"))
    points = (base + torch.tanh(offsets.float())) / res  # (3, N, N, N) in [0, 1] lattice units
    inside = level > 0
    verts = []
    for d in EDGE_DIRS:
        (ia, ib), (la, lb), (pa, pb) = _edge_ends(inside, d), _edge_ends(level, d), _edge_ends(points, d)
        cut = ia != ib
        a, b = la[cut], lb[cut]
        denom = a - b
        t = (a / torch.where(denom == 0, torch.ones_like(denom), denom)).clamp(0.0, 1.0)
        p0, p1 = pa[:, cut].t(), pb[:, cut].t()
        verts.append(p0 + t[:, None] * (p1 - p0))
    return torch.cat(verts) * (2 * radius) - radius
