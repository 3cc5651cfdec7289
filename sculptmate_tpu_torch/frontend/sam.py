"""Segment Anything (SAM, Kirillov et al.): the prompt-driven matting session.

Counterpart of ``sculptmate_tpu/frontend/sam.py``, after the reference's
ONNX encoder and decoder pair (``rembg/sessions/sam.py:133-330``): a ViT
image encoder with windowed attention and decomposed relative position
bias, a point and box prompt encoder with random Fourier features, and the
two-way-transformer mask decoder with hypernetwork heads. The modules carry
the names of the official ``segment_anything`` torch modules, so an official
``sam_vit_b.pth`` loads with ``load_state_dict``
(``runtime/checkpoint.py:try_load_sam_state_dict``; the mask-prompt
``prompt_encoder.mask_downscaling`` is not built, since the session passes
points and boxes only). Convolutions run in NCHW.

The port follows the published recipe (the ``segment_anything`` encoder,
the decoder as rembg's ONNX export runs it) where the JAX package departs
from it; ``tests/test_torch_port_sam.py`` records each difference:

- a windowed block pads ``norm1``'s output with zeros (the JAX package pads
  the block's input, so the padded tokens become ``norm1``'s bias);
- the dense prompt adds ``no_mask_embed`` to every image position (the JAX
  package adds nothing);
- points are encoded at pixel centres, +0.5 (the JAX package does not shift
  them);
- the first two-way block's self-attention replaces the tokens (the JAX
  package adds it to them);
- ViT-L and ViT-H take global attention at their own blocks (5, 11, 17, 23
  and 7, 15, 23, 31; the JAX package uses ViT-B's 2, 5, 8, 11 for all);
- the two-way transformer's LayerNorms take eps 1e-5 (the JAX package's
  1e-6; a difference of ~1e-6 relative on unit-variance tokens).

Attention products stay plain matmuls and softmax here, in f32, as the JAX
package computes them outside any Pallas kernel.
"""

from __future__ import annotations

import json
import math
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from sculptmate_tpu_torch.ops.warp import resample_matrix
from sculptmate_tpu_torch.runtime.device import resolve_device

IMG_SIZE = 1024
PROMPT_DIM = 256
# (embed dim, depth, heads, global attention blocks) of the published encoders
SAM_SIZES = {
    "vit_b": (768, 12, 12, (2, 5, 8, 11)),
    "vit_l": (1024, 24, 16, (5, 11, 17, 23)),
    "vit_h": (1280, 32, 16, (7, 15, 23, 31)),
}
# the two-way transformer's LayerNorms (torch's default; the encoder's and
# the 2-D ones take 1e-6)
DECODER_LN_EPS = 1e-5
_SAM_MEAN = (123.675, 116.28, 103.53)
_SAM_STD = (58.395, 57.12, 57.375)


# ---------------------------------------------------------------------------
# image encoder (ViT-det)

def _window_partition(x: torch.Tensor, ws: int) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """(B, H, W, C) -> (B * windows, ws, ws, C), zero-padded to a multiple of
    ``ws``; returns the padded size too."""
    B, H, W, C = x.shape
    ph, pw = (-H) % ws, (-W) % ws
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    Hp, Wp = H + ph, W + pw
    x = x.reshape(B, Hp // ws, ws, Wp // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws, ws, C), (Hp, Wp)


def _window_unpartition(w: torch.Tensor, ws: int, pad_hw: Tuple[int, int], hw: Tuple[int, int]) -> torch.Tensor:
    Hp, Wp = pad_hw
    B = w.shape[0] // (Hp // ws * Wp // ws)
    x = w.reshape(B, Hp // ws, Wp // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, -1)
    return x[:, : hw[0], : hw[1]]


def _get_rel_pos(size: int, rel_pos: torch.Tensor) -> torch.Tensor:
    """The (2 size - 1, C) table (linearly resized when it has another
    length) gathered to (size, size, C) by query minus key offset."""
    needed = 2 * size - 1
    if rel_pos.shape[0] != needed:
        rel_pos = F.interpolate(rel_pos.T[None], size=needed, mode="linear")[0].T
    coords = torch.arange(size, device=rel_pos.device)
    return rel_pos[coords[:, None] - coords[None, :] + size - 1]


def _rel_pos_bias(q: torch.Tensor, rel_h: torch.Tensor, rel_w: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Decomposed relative position bias (ViT-det): (B*, H W, H W)."""
    Bn, _, C = q.shape
    q2 = q.reshape(Bn, H, W, C)
    rh = torch.einsum("bhwc,hkc->bhwk", q2, rel_h)
    rw = torch.einsum("bhwc,wkc->bhwk", q2, rel_w)
    return (rh[..., :, None] + rw[..., None, :]).reshape(Bn, H * W, H * W)


class Attention(nn.Module):
    """Multi-head self-attention with decomposed relative position bias over
    an (H, W) grid of ``input_size`` tokens a side."""

    def __init__(self, dim: int, num_heads: int, input_size: int):
        super().__init__()
        self.num_heads = num_heads
        head_dim = dim // num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size - 1, head_dim))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size - 1, head_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        hd = C // self.num_heads
        qkv = self.qkv(x).reshape(B, H * W, 3, self.num_heads, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.reshape(3, B * self.num_heads, H * W, hd).unbind(0)
        attn = (q * hd**-0.5) @ k.transpose(-2, -1)
        attn = attn + _rel_pos_bias(q, _get_rel_pos(H, self.rel_pos_h), _get_rel_pos(W, self.rel_pos_w), H, W)
        out = (attn.softmax(dim=-1) @ v).reshape(B, self.num_heads, H, W, hd)
        return self.proj(out.permute(0, 2, 3, 1, 4).reshape(B, H, W, C))


class MLPBlock(nn.Module):
    def __init__(self, dim: int, hidden: int, act=nn.GELU):
        super().__init__()
        self.lin1 = nn.Linear(dim, hidden)
        self.lin2 = nn.Linear(hidden, dim)
        self.act = act()

    def forward(self, x):
        return self.lin2(self.act(self.lin1(x)))


class Block(nn.Module):
    """Pre-LN transformer block, windowed (``window_size`` > 0) or global."""

    def __init__(self, dim: int, num_heads: int, window_size: int, grid: int):
        super().__init__()
        self.window_size = window_size
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads, window_size or grid)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = MLPBlock(dim, 4 * dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.norm1(x)
        if self.window_size:
            hw = h.shape[1:3]
            h, pad_hw = _window_partition(h, self.window_size)
            h = _window_unpartition(self.attn(h), self.window_size, pad_hw, hw)
        else:
            h = self.attn(h)
        x = x + h
        return x + self.mlp(self.norm2(x))


class LayerNorm2d(nn.Module):
    """LayerNorm over the channels of an NCHW tensor."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.eps = eps

    def forward(self, x):
        u = x.mean(1, keepdim=True)
        s = (x - u).pow(2).mean(1, keepdim=True)
        x = (x - u) / torch.sqrt(s + self.eps)
        return self.weight[:, None, None] * x + self.bias[:, None, None]


class PatchEmbed(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, 16, stride=16)

    def forward(self, x):
        return self.proj(x).permute(0, 2, 3, 1)  # (B, H, W, C)


class ImageEncoderViT(nn.Module):
    """ViT-det encoder: (B, 3, S, S) normalised -> (B, 256, S/16, S/16)."""

    def __init__(self, embed_dim: int = 768, depth: int = 12, num_heads: int = 12, window_size: int = 14,
                 global_attn_indexes: Sequence[int] = (2, 5, 8, 11), img_size: int = IMG_SIZE):
        super().__init__()
        grid = img_size // 16
        self.patch_embed = PatchEmbed(embed_dim)
        self.pos_embed = nn.Parameter(torch.zeros(1, grid, grid, embed_dim))
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, 0 if i in global_attn_indexes else window_size, grid) for i in range(depth)
        )
        self.neck = nn.Sequential(
            nn.Conv2d(embed_dim, PROMPT_DIM, 1, bias=False), LayerNorm2d(PROMPT_DIM),
            nn.Conv2d(PROMPT_DIM, PROMPT_DIM, 3, padding=1, bias=False), LayerNorm2d(PROMPT_DIM),
        )

    def forward(self, x):
        x = self.patch_embed(x) + self.pos_embed
        for blk in self.blocks:
            x = blk(x)
        return self.neck(x.permute(0, 3, 1, 2))


# ---------------------------------------------------------------------------
# prompt encoder

class PositionEmbeddingRandom(nn.Module):
    def __init__(self):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix", torch.empty(2, PROMPT_DIM // 2))

    def encode(self, coords01: torch.Tensor) -> torch.Tensor:
        """(..., 2) in [0, 1] -> (..., 256)."""
        c = 2 * math.pi * ((2 * coords01 - 1) @ self.positional_encoding_gaussian_matrix)
        return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)

    def dense(self, grid: int) -> torch.Tensor:
        """(256, grid, grid) at the cell centres."""
        g = (torch.arange(grid, dtype=torch.float32, device=self.positional_encoding_gaussian_matrix.device)
             + 0.5) / grid
        yy, xx = torch.meshgrid(g, g, indexing="ij")
        return self.encode(torch.stack([xx, yy], -1)).permute(2, 0, 1)


class PromptEncoder(nn.Module):
    """Points and box corners -> sparse tokens; the no-mask dense prompt."""

    def __init__(self):
        super().__init__()
        self.pe_layer = PositionEmbeddingRandom()
        # 0: negative point, 1: positive point, 2 and 3: box corners
        self.point_embeddings = nn.ModuleList(nn.Embedding(1, PROMPT_DIM) for _ in range(4))
        self.not_a_point_embed = nn.Embedding(1, PROMPT_DIM)
        self.no_mask_embed = nn.Embedding(1, PROMPT_DIM)

    def forward(self, point_coords: torch.Tensor, point_labels: torch.Tensor) -> torch.Tensor:
        """point_coords (B, N, 2) in pixels of the 1024 frame, labels (B, N):
        1 positive, 0 negative, 2/3 box corners, -1 padding -> (B, N, 256),
        each point at its pixel's centre."""
        emb = self.pe_layer.encode((point_coords + 0.5) / IMG_SIZE)
        lbl = point_labels[..., None]
        emb = torch.where(lbl == -1, self.not_a_point_embed.weight[0], emb)
        for code in range(4):
            emb = emb + (lbl == code) * self.point_embeddings[code].weight[0]
        return emb


# ---------------------------------------------------------------------------
# mask decoder (two-way transformer)

class TwoWayAttention(nn.Module):
    """Attention with an inner width of dim / downsample."""

    def __init__(self, dim: int = PROMPT_DIM, num_heads: int = 8, downsample: int = 1):
        super().__init__()
        inner = dim // downsample
        self.num_heads = num_heads
        self.q_proj = nn.Linear(dim, inner)
        self.k_proj = nn.Linear(dim, inner)
        self.v_proj = nn.Linear(dim, inner)
        self.out_proj = nn.Linear(inner, dim)

    def forward(self, q, k, v):
        B, Nq, _ = q.shape
        heads = lambda x: x.reshape(B, x.shape[1], self.num_heads, -1).transpose(1, 2)  # noqa: E731
        q, k, v = heads(self.q_proj(q)), heads(self.k_proj(k)), heads(self.v_proj(v))
        attn = (q @ k.transpose(-2, -1)) / math.sqrt(q.shape[-1])
        out = (attn.softmax(dim=-1) @ v).transpose(1, 2).reshape(B, Nq, -1)
        return self.out_proj(out)


class TwoWayAttentionBlock(nn.Module):
    def __init__(self, skip_first_layer_pe: bool = False):
        super().__init__()
        self.skip_first_layer_pe = skip_first_layer_pe
        self.self_attn = TwoWayAttention()
        self.norm1 = nn.LayerNorm(PROMPT_DIM, eps=DECODER_LN_EPS)
        self.cross_attn_token_to_image = TwoWayAttention(downsample=2)
        self.norm2 = nn.LayerNorm(PROMPT_DIM, eps=DECODER_LN_EPS)
        self.mlp = MLPBlock(PROMPT_DIM, 2048, act=nn.ReLU)
        self.norm3 = nn.LayerNorm(PROMPT_DIM, eps=DECODER_LN_EPS)
        self.norm4 = nn.LayerNorm(PROMPT_DIM, eps=DECODER_LN_EPS)
        self.cross_attn_image_to_token = TwoWayAttention(downsample=2)

    def forward(self, queries, keys, q_pe, k_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            qq = queries + q_pe
            queries = queries + self.self_attn(qq, qq, queries)
        queries = self.norm1(queries)
        queries = self.norm2(queries + self.cross_attn_token_to_image(queries + q_pe, keys + k_pe, keys))
        queries = self.norm3(queries + self.mlp(queries))
        keys = self.norm4(keys + self.cross_attn_image_to_token(keys + k_pe, queries + q_pe, queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, depth: int = 2):
        super().__init__()
        self.layers = nn.ModuleList(TwoWayAttentionBlock(skip_first_layer_pe=i == 0) for i in range(depth))
        self.final_attn_token_to_image = TwoWayAttention(downsample=2)
        self.norm_final_attn = nn.LayerNorm(PROMPT_DIM, eps=DECODER_LN_EPS)

    def forward(self, image_embedding, image_pe, tokens):
        """image_embedding (B, C, G, G), image_pe (C, G, G), tokens (B, N, C)
        -> (tokens, image keys (B, G G, C))."""
        keys = image_embedding.flatten(2).transpose(1, 2)
        k_pe = image_pe.flatten(1).T[None]
        queries = tokens
        for layer in self.layers:
            queries, keys = layer(queries, keys, tokens, k_pe)
        a = self.final_attn_token_to_image(queries + tokens, keys + k_pe, keys)
        return self.norm_final_attn(queries + a), keys


class MLP(nn.Module):
    """Linear layers with ReLU between."""

    def __init__(self, dims: Sequence[int]):
        super().__init__()
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class MaskDecoder(nn.Module):
    def __init__(self, num_mask_tokens: int = 4):
        super().__init__()
        C = PROMPT_DIM
        self.num_mask_tokens = num_mask_tokens
        self.transformer = TwoWayTransformer()
        self.iou_token = nn.Embedding(1, C)
        self.mask_tokens = nn.Embedding(num_mask_tokens, C)
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(C, C // 4, 2, stride=2), LayerNorm2d(C // 4), nn.GELU(),
            nn.ConvTranspose2d(C // 4, C // 8, 2, stride=2), nn.GELU(),
        )
        self.output_hypernetworks_mlps = nn.ModuleList(MLP((C, C, C, C // 8)) for _ in range(num_mask_tokens))
        self.iou_prediction_head = MLP((C, C, C, num_mask_tokens))

    def forward(self, image_embedding, image_pe, sparse_prompt):
        """image_embedding (B, C, G, G) with the dense prompt added, image_pe
        (C, G, G), sparse_prompt (B, Np, C) -> (mask logits (B, M, 4G, 4G),
        iou predictions (B, M))."""
        B, C, G, _ = image_embedding.shape
        out_tokens = torch.cat([self.iou_token.weight, self.mask_tokens.weight])
        tokens = torch.cat([out_tokens[None].expand(B, -1, -1), sparse_prompt], dim=1)
        hs, keys = self.transformer(image_embedding, image_pe, tokens)
        up = self.output_upscaling(keys.transpose(1, 2).reshape(B, C, G, G))  # (B, C/8, 4G, 4G)
        hyper = torch.stack([mlp(hs[:, 1 + m]) for m, mlp in enumerate(self.output_hypernetworks_mlps)], dim=1)
        masks = (hyper @ up.flatten(2)).reshape(B, -1, *up.shape[-2:])
        return masks, self.iou_prediction_head(hs[:, 0])


class Sam(nn.Module):
    def __init__(self, encoder_embed_dim: int = 768, encoder_depth: int = 12, encoder_heads: int = 12,
                 global_attn_indexes: Sequence[int] = (2, 5, 8, 11), img_size: int = IMG_SIZE):
        super().__init__()
        self.image_encoder = ImageEncoderViT(encoder_embed_dim, encoder_depth, encoder_heads,
                                             global_attn_indexes=global_attn_indexes, img_size=img_size)
        self.prompt_encoder = PromptEncoder()
        self.mask_decoder = MaskDecoder()

    def encode(self, image: torch.Tensor) -> torch.Tensor:
        """(B, 3, S, S) normalised -> (B, 256, S/16, S/16)."""
        return self.image_encoder(image)

    def decode(self, image_embedding, point_coords, point_labels):
        """Masks and IoU predictions for point prompts (pixels of the 1024
        frame; labels as ``PromptEncoder``); the dense prompt is the no-mask
        embedding, added to every position."""
        sparse = self.prompt_encoder(point_coords, point_labels)
        dense = image_embedding + self.prompt_encoder.no_mask_embed.weight.reshape(1, -1, 1, 1)
        pe = self.prompt_encoder.pe_layer.dense(image_embedding.shape[-1])
        return self.mask_decoder(dense, pe, sparse)

    def forward(self, image, point_coords, point_labels):
        return self.decode(self.encode(image), point_coords, point_labels)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded random weights at the JAX package's scales: lecun normal
        kernels (truncated at two standard deviations, fan-in of the input
        channels and taps), zero biases, norms 1 and 0, unit normal
        embeddings and Fourier matrix, zero position tables."""
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
                w = m.weight
                fan_in = w.shape[0] * w[0, 0].numel() if isinstance(m, nn.ConvTranspose2d) else w[0].numel()
                std = fan_in**-0.5 / 0.87962566103423978  # the std of a unit normal truncated to [-2, 2]
                nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (nn.LayerNorm, LayerNorm2d)):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                m.weight.normal_(generator=generator)
        self.prompt_encoder.pe_layer.positional_encoding_gaussian_matrix.normal_(generator=generator)
        for name, p in self.image_encoder.named_parameters():
            if "rel_pos" in name or name == "pos_embed":
                p.zero_()


# ---------------------------------------------------------------------------
# session


def _resize_u8(x: torch.Tensor, out_hw: Tuple[int, int], method: str) -> torch.Tensor:
    """PIL's resize of an 8-bit (H, W, C) image on x's device: the
    horizontal pass rounded to 8 bits, then the vertical one; ``"linear"``
    is its BILINEAR and ``"lanczos3"`` its LANCZOS (the taps of
    ``ops/warp.py:resample_matrix``, the support dilated when reducing).
    Returns f32 values in 0..255."""
    H, W = x.shape[:2]
    cols = resample_matrix(W, out_hw[1], 0.0, float(W), method).to(x.device)
    rows = resample_matrix(H, out_hw[0], 0.0, float(H), method).to(x.device)
    x = torch.einsum("pw,hwc->hpc", cols, x.float()).round().clamp(0, 255)
    return torch.einsum("oh,hpc->opc", rows, x).round().clamp(0, 255)


def get_input_points(prompt) -> Tuple[np.ndarray, np.ndarray]:
    """Parse rembg's JSON prompt schema (``sessions/sam.py``): points, and
    rectangles as two corner points labelled 2 and 3."""
    if isinstance(prompt, str):
        prompt = json.loads(prompt)
    points: List[Sequence[float]] = []
    labels: List[int] = []
    for mark in prompt:
        if mark["type"] == "point":
            points.append(mark["data"])
            labels.append(int(mark.get("label", 1)))
        elif mark["type"] == "rectangle":
            x1, y1, x2, y2 = mark["data"]
            points.append([x1, y1])
            points.append([x2, y2])
            labels.extend([2, 3])
    if not points:
        raise ValueError("sam_prompt must contain at least one point or rectangle")
    return np.asarray(points, np.float32), np.asarray(labels, np.int32)


class SamSession:
    """Prompt-driven segmentation session (rembg's ``sam``).

    ``variant`` is one of ``SAM_SIZES``. ``state_dict`` holds the official
    names; without one, ``sam_<variant>.pth`` is read from the checkpoint
    directory where it is there, else the weights are random from ``seed``.
    ``device`` defaults to the card. The network runs in f32."""

    def __init__(self, state_dict=None, seed: int = 0, variant: str = "vit_b", device=None):
        self.device = resolve_device(device)
        dim, depth, heads, global_idx = SAM_SIZES[variant]
        with torch.device(self.device):
            self.module = Sam(dim, depth, heads, global_idx)
        if state_dict is None:
            from sculptmate_tpu_torch.runtime.checkpoint import try_load_sam_state_dict

            state_dict = try_load_sam_state_dict(variant)
        if state_dict is None:
            self.module.reset_parameters(torch.Generator(device=self.device).manual_seed(seed))
        else:
            self.module.load_state_dict(state_dict)
        self.module.eval().requires_grad_(False)
        self._mean = torch.tensor(_SAM_MEAN, device=self.device)
        self._std = torch.tensor(_SAM_STD, device=self.device)

    @torch.inference_mode()
    def encode_batch(self, canvas: torch.Tensor) -> torch.Tensor:
        """Device path: (B, 1024, 1024, 3) RGB in [0, 255] (the image at the
        top left, zeros past it) -> (B, 256, 64, 64) image embeddings."""
        x = (canvas.to(self.device, torch.float32) - self._mean) / self._std
        return self.module.encode(x.permute(0, 3, 1, 2))

    @torch.inference_mode()
    def decode_batch(self, embedding: torch.Tensor, points: torch.Tensor, labels: torch.Tensor):
        """Device path: embeddings, points (B, N, 2) in pixels of the 1024
        frame and labels (B, N) -> (mask logits (B, 4, 256, 256), IoU
        predictions (B, 4))."""
        return self.module.decode(embedding, points.to(self.device, torch.float32), labels.to(self.device))

    def predict_mask_batch(self, canvas: torch.Tensor, points: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """Device path: the mask of the best IoU prediction, (B, 256, 256)
        in {0, 1}."""
        masks, iou = self.decode_batch(self.encode_batch(canvas), points, labels)
        best = iou.argmax(dim=1)
        return (masks[torch.arange(masks.shape[0], device=masks.device), best] > 0).float()

    def predict(self, img, *args, **kwargs):
        """PIL image and ``sam_prompt`` (JSON or a list) -> one 'L' mask at
        the image's size: ``predict_rgb`` on its RGB values."""
        from PIL import Image

        mask = self.predict_rgb(np.array(img.convert("RGB")), kwargs.get("sam_prompt", "[]"))
        return [Image.fromarray(mask.cpu().numpy(), mode="L")]

    def predict_rgb(self, rgb, sam_prompt) -> torch.Tensor:
        """(H, W, 3) RGB values in [0, 255] (an array or a tensor) and
        ``sam_prompt`` -> the (H, W) uint8 mask, every step on the session's
        device: the image bilinear into the top left of the 1024^2 frame,
        the best-IoU mask bilinear up to the frame and Lanczos down to the
        image (PIL's filters and 8-bit rounding, ``_resize_u8``)."""
        rgb = torch.as_tensor(rgb, device=self.device)
        h0, w0 = rgb.shape[:2]
        points, labels = get_input_points(sam_prompt)
        scale = IMG_SIZE / max(w0, h0)
        nw, nh = int(round(w0 * scale)), int(round(h0 * scale))
        pts = np.concatenate([points * scale, [[0.0, 0.0]]], axis=0)[None].astype(np.float32)
        lbl = np.concatenate([labels, [-1]])[None].astype(np.int64)
        canvas = torch.zeros((1, IMG_SIZE, IMG_SIZE, 3), device=self.device)
        canvas[0, :nh, :nw] = _resize_u8(rgb, (nh, nw), "linear")
        m = 255 * self.predict_mask_batch(canvas, torch.from_numpy(pts), torch.from_numpy(lbl))[0, :, :, None]
        mask_full = _resize_u8(m, (IMG_SIZE, IMG_SIZE), "linear")
        return _resize_u8(mask_full[:nh, :nw], (h0, w0), "lanczos3")[..., 0].to(torch.uint8)

    def predict_mask(self, image):
        """A centre box prompt when used as a generic matting session."""
        w, h = image.size
        prompt = [{"type": "rectangle", "data": [0.05 * w, 0.05 * h, 0.95 * w, 0.95 * h]}]
        return self.predict(image, sam_prompt=json.dumps(prompt))[0]
