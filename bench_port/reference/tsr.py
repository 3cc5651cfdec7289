"""Plain reference of TripoSR ("Lean"): image -> triplane codes -> density
lattice and colors, over a state dict under the published checkpoint's names.

Written from the published architecture (``stabilityai/TripoSR``: DINO
ViT-B/16 tokenizer, ``Triplane1DTokenizer``, ``Transformer1D`` with
GroupNorm in, pre-LN self- and cross-attention and a GEGLU feed-forward,
``TriplaneUpsampleNetwork``, the NeRF MLP decoder), in plain torch
operations, each product through a ``Precision`` (float32 with TF32 off for
the reference, rounded operands for the control). No kernels, no cache, no
batching; attention is softmax(q k^T / sqrt(d)) v on the whole sequence.
Imports nothing of the program.

``param_specs`` lists every parameter with its shape and its seeded
initialisation (fan-in normal matrices, zero biases, unit norms, N(0, 0.02)
position table, zero class token, N(0, 1) / sqrt(C) triplane tokens; the
decoder's matrices scaled by its ``init_gain`` and its biases normal with
``init_bias_std``, where the configuration sets them).
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch
import torch.nn.functional as F

from reference.precision import EXACT, Precision

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# (name, shape, init), init as harness/weights.py:init_tensors takes it
Spec = Tuple[str, Tuple[int, ...], tuple]


def param_specs(c: dict) -> List[Spec]:
    """Every parameter of the model configured by ``c`` (the configuration
    file's ``model`` group)."""
    out: List[Spec] = []

    def linear(name, d_in, d_out, bias=True):
        out.append((f"{name}.weight", (d_out, d_in), ("normal", d_in ** -0.5)))
        if bias:
            out.append((f"{name}.bias", (d_out,), ("zeros",)))

    def norm(name, d):
        out.append((f"{name}.weight", (d,), ("ones",)))
        out.append((f"{name}.bias", (d,), ("zeros",)))

    v = c["image_tokenizer"]
    hv, p = v["hidden_size"], v["patch_size"]
    base = v["base_image_size"] // p
    e = "image_tokenizer.model.embeddings"
    out.append((f"{e}.cls_token", (1, 1, hv), ("zeros",)))
    out.append((f"{e}.position_embeddings", (1, 1 + base * base, hv), ("normal", 0.02)))
    out.append((f"{e}.patch_embeddings.projection.weight", (hv, 3, p, p), ("normal", (3 * p * p) ** -0.5)))
    out.append((f"{e}.patch_embeddings.projection.bias", (hv,), ("zeros",)))
    for i in range(v["num_hidden_layers"]):
        L = f"image_tokenizer.model.encoder.layer.{i}"
        norm(f"{L}.layernorm_before", hv)
        for n in ("query", "key", "value"):
            linear(f"{L}.attention.attention.{n}", hv, hv)
        linear(f"{L}.attention.output.dense", hv, hv)
        norm(f"{L}.layernorm_after", hv)
        linear(f"{L}.intermediate.dense", hv, v["intermediate_size"])
        linear(f"{L}.output.dense", v["intermediate_size"], hv)
    norm("image_tokenizer.model.layernorm", hv)

    t, b = c["tokenizer"], c["backbone"]
    C, S = t["num_channels"], t["plane_size"]
    out.append(("tokenizer.embeddings", (3, C, S, S), ("normal", C ** -0.5)))
    inner = b["num_attention_heads"] * b["attention_head_dim"]
    norm("backbone.norm", C)
    linear("backbone.proj_in", C, inner)
    for i in range(b["num_layers"]):
        B = f"backbone.transformer_blocks.{i}"
        for a, ctx in (("attn1", inner), ("attn2", b["cross_attention_dim"])):
            norm(f"{B}.norm{1 if a == 'attn1' else 2}", inner)
            linear(f"{B}.{a}.to_q", inner, inner, bias=False)
            linear(f"{B}.{a}.to_k", ctx, inner, bias=False)
            linear(f"{B}.{a}.to_v", ctx, inner, bias=False)
            linear(f"{B}.{a}.to_out.0", inner, inner)
        norm(f"{B}.norm3", inner)
        linear(f"{B}.ff.net.0.proj", inner, 8 * inner)
        linear(f"{B}.ff.net.2", 4 * inner, inner)
    linear("backbone.proj_out", inner, C)
    po = c["post_processor"]
    out.append(("post_processor.upsample.weight", (C, po["out_channels"], 2, 2), ("normal", (C * 4) ** -0.5)))
    out.append(("post_processor.upsample.bias", (po["out_channels"],), ("zeros",)))
    d = c["decoder"]
    gain, bias_std = d.get("init_gain", 1.0), d.get("init_bias_std", 0.0)
    dims = [d["in_channels"]] + [d["n_neurons"]] * d["n_hidden_layers"] + [4]
    for i in range(len(dims) - 1):
        name = f"decoder.layers.{2 * i}"
        out.append((f"{name}.weight", (dims[i + 1], dims[i]), ("normal", gain * dims[i] ** -0.5)))
        out.append((f"{name}.bias", (dims[i + 1],), ("normal", bias_std) if bias_std else ("zeros",)))
    return out


def _layer_norm(x, sd, name, eps):
    return F.layer_norm(x.float(), x.shape[-1:], sd[f"{name}.weight"].float(), sd[f"{name}.bias"].float(), eps)


def _lin(q: Precision, x, sd, name):
    return q.linear(x, sd[f"{name}.weight"], sd.get(f"{name}.bias"))


def _attention(q: Precision, qh, kh, vh):
    """(B, H, Nq, D), (B, H, Nk, D) -> (B, H, Nq, D), the whole softmax in
    float32, each head's scores at once."""
    s = q.matmul(qh, kh.transpose(-1, -2)) / math.sqrt(qh.shape[-1])
    return q.matmul(torch.softmax(s, dim=-1), vh)


def _heads(x, n):
    B, N, C = x.shape
    return x.reshape(B, N, n, C // n).transpose(1, 2)


def _merge(x):
    B, H, N, D = x.shape
    return x.transpose(1, 2).reshape(B, N, H * D)


def image_tokens(sd, c: dict, images: torch.Tensor, q: Precision = EXACT) -> torch.Tensor:
    """(B, S, S, 3) in [0, 1] at the condition size -> (B, 1 + g^2, hidden)."""
    v = c["image_tokenizer"]
    mean = torch.tensor(IMAGENET_MEAN, device=images.device)
    std = torch.tensor(IMAGENET_STD, device=images.device)
    x = ((images.float() - mean) / std).permute(0, 3, 1, 2)
    e = "image_tokenizer.model.embeddings"
    p = v["patch_size"]
    x = q.conv2d(x, sd[f"{e}.patch_embeddings.projection.weight"], sd[f"{e}.patch_embeddings.projection.bias"],
                 stride=p)
    B, C, g, _ = x.shape
    x = x.flatten(2).transpose(1, 2)
    pos = sd[f"{e}.position_embeddings"].float()
    base = int(round((pos.shape[1] - 1) ** 0.5))
    patch = pos[:, 1:].reshape(1, base, base, C).permute(0, 3, 1, 2)
    if base != g:
        patch = F.interpolate(patch, size=(g, g), mode="bicubic", align_corners=False)
    pos = torch.cat([pos[:, :1], patch.flatten(2).transpose(1, 2)], dim=1)
    x = torch.cat([sd[f"{e}.cls_token"].float().expand(B, 1, C), x], dim=1) + pos
    heads = v["num_attention_heads"]
    eps = v["layer_norm_eps"]
    for i in range(v["num_hidden_layers"]):
        L = f"image_tokenizer.model.encoder.layer.{i}"
        h = _layer_norm(x, sd, f"{L}.layernorm_before", eps)
        qh, kh, vh = (_heads(_lin(q, h, sd, f"{L}.attention.attention.{n}"), heads) for n in ("query", "key", "value"))
        x = x + _lin(q, _merge(_attention(q, qh, kh, vh)), sd, f"{L}.attention.output.dense")
        h = _layer_norm(x, sd, f"{L}.layernorm_after", eps)
        h = F.gelu(_lin(q, h, sd, f"{L}.intermediate.dense"))
        x = x + _lin(q, h, sd, f"{L}.output.dense")
    return _layer_norm(x, sd, "image_tokenizer.model.layernorm", eps)


def scene_codes(sd, c: dict, images: torch.Tensor, q: Precision = EXACT) -> torch.Tensor:
    """(B, H, W, 3) in [0, 1] -> (B, 3, C_out, 2S, 2S) triplane codes; the
    images are first resized to the condition size (antialiased bilinear,
    half-pixel centres)."""
    s = c["cond_image_size"]
    x = images.float()
    if x.shape[1] != s or x.shape[2] != s:
        x = F.interpolate(x.permute(0, 3, 1, 2), size=(s, s), mode="bilinear", align_corners=False,
                          antialias=True).permute(0, 2, 3, 1)
    cond = image_tokens(sd, c, x, q)
    t, b = c["tokenizer"], c["backbone"]
    C, S = t["num_channels"], t["plane_size"]
    B = x.shape[0]
    tokens = sd["tokenizer.embeddings"].float().reshape(3, C, S * S).transpose(0, 1).reshape(1, C, 3 * S * S)
    tokens = tokens.expand(B, C, 3 * S * S)
    residual = tokens
    h = F.group_norm(tokens, 32, sd["backbone.norm.weight"].float(), sd["backbone.norm.bias"].float(), 1e-6)
    h = _lin(q, h.transpose(1, 2), sd, "backbone.proj_in")
    heads = b["num_attention_heads"]
    for i in range(b["num_layers"]):
        P = f"backbone.transformer_blocks.{i}"
        for a, norm, ctx in (("attn1", "norm1", None), ("attn2", "norm2", cond)):
            n = _layer_norm(h, sd, f"{P}.{norm}", 1e-5)
            src = n if ctx is None else ctx
            qh = _heads(_lin(q, n, sd, f"{P}.{a}.to_q"), heads)
            kh = _heads(_lin(q, src, sd, f"{P}.{a}.to_k"), heads)
            vh = _heads(_lin(q, src, sd, f"{P}.{a}.to_v"), heads)
            h = h + _lin(q, _merge(_attention(q, qh, kh, vh)), sd, f"{P}.{a}.to_out.0")
        n = _layer_norm(h, sd, f"{P}.norm3", 1e-5)
        val, gate = _lin(q, n, sd, f"{P}.ff.net.0.proj").chunk(2, dim=-1)
        h = h + _lin(q, val * F.gelu(gate), sd, f"{P}.ff.net.2")
    h = _lin(q, h, sd, "backbone.proj_out").transpose(1, 2) + residual
    planes = h.reshape(B, C, 3, S, S).transpose(1, 2).reshape(B * 3, C, S, S)
    up = q.conv_transpose2d(planes, sd["post_processor.upsample.weight"], sd["post_processor.upsample.bias"],
                            stride=2)
    return up.reshape(B, 3, *up.shape[1:])


def _decoder(sd, c: dict, feats: torch.Tensor, q: Precision) -> torch.Tensor:
    """(N, 120) features -> (N, 4) raw outputs (density, 3 color logits)."""
    n = c["decoder"]["n_hidden_layers"]
    h = feats
    for i in range(n):
        h = F.silu(_lin(q, h, sd, f"decoder.layers.{2 * i}"))
    return _lin(q, h, sd, f"decoder.layers.{2 * n}")


def _plane_sample(plane: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Bilinear sample with zero padding, half-pixel convention
    (``F.grid_sample(align_corners=False)``) of a (C, H, W) plane at flat
    (N,) normalised points, u along W and v along H -> (N, C)."""
    grid = torch.stack([u, v], dim=-1).float()[None, None]  # (1, 1, N, 2)
    out = F.grid_sample(plane.float()[None], grid, mode="bilinear", padding_mode="zeros", align_corners=False)
    return out[0, :, 0].t()


def triplane_features(code: torch.Tensor, px, py, pz) -> torch.Tensor:
    """(3, C, H, W) planes (xy, xz, yz) at flat normalised points -> (N, 3C)."""
    return torch.cat([_plane_sample(code[0], px, py), _plane_sample(code[1], px, pz),
                      _plane_sample(code[2], py, pz)], dim=1)


def density_lattice(sd, c: dict, code: torch.Tensor, resolution: int, q: Precision = EXACT,
                    rows: int = 4) -> torch.Tensor:
    """Activated density exp(d + bias) at every point of the R^3 lattice
    g_i = 2 i / (R - 1) - 1 (normalised by the radius), indexed [x, y, z],
    computed ``rows`` x-rows at a time -> (R, R, R) float32."""
    R = resolution
    g = 2.0 * torch.arange(R, dtype=torch.float32, device=code.device) / (R - 1) - 1.0
    bias = c["renderer"]["density_bias"]
    out = torch.empty((R, R, R), dtype=torch.float32, device=code.device)
    for x0 in range(0, R, rows):
        xs = g[x0 : x0 + rows]
        px, py, pz = torch.meshgrid(xs, g, g, indexing="ij")
        d = _decoder(sd, c, triplane_features(code, px.reshape(-1), py.reshape(-1), pz.reshape(-1)), q)[:, 0]
        out[x0 : x0 + rows] = torch.exp(d + bias).reshape(len(xs), R, R)
    return out


def colors_at(sd, c: dict, code: torch.Tensor, world: torch.Tensor, q: Precision = EXACT,
              chunk: int = 1 << 20) -> torch.Tensor:
    """Colors (sigmoid of the decoder's features) at (N, 3) world points
    -> (N, 3)."""
    r = c["renderer"]["radius"]
    parts = []
    for s in range(0, world.shape[0], chunk):
        p = world[s : s + chunk].float() / r
        parts.append(torch.sigmoid(_decoder(sd, c, triplane_features(code, p[:, 0], p[:, 1], p[:, 2]), q)[:, 1:4]))
    if not parts:
        return torch.zeros((0, 3), device=world.device)
    return torch.cat(parts)


def cut_edges(lattice: torch.Tensor, level: float) -> int:
    """How many lattice edges the iso-surface at ``level`` cuts."""
    inside = lattice > level
    return int((inside[1:] != inside[:-1]).sum() + (inside[:, 1:] != inside[:, :-1]).sum()
               + (inside[:, :, 1:] != inside[:, :, :-1]).sum())


def threshold_for_cut_edges(lattice: torch.Tensor, target: int) -> float:
    """The highest level, among the lattice's own values, at which at least
    ``target`` edges are cut: a bisection over the sorted values from the
    top, where fewer points are inside as the level rises."""
    v = lattice.flatten().float().sort().values
    n = v.numel()
    lo, hi = n // 2, n - 2  # the count at index i: level v[i]
    if cut_edges(lattice, float(v[lo])) < target:
        return float(v[lo])
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if cut_edges(lattice, float(v[mid])) >= target:
            lo = mid
        else:
            hi = mid
    return float(v[lo])
