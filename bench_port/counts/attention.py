"""Attention: softmax(q k^T / sqrt(D)) v over (B, H) heads of Nq queries
and Nk keys of width D (``chip_smoke.py:check_attention``).

- operations: 4 B H Nq Nk D (the two products, two operations a
  multiply-add);
- bytes: esize B H D (2 Nq + 2 Nk): q and the output once, k and v once.
"""

from counts import PEAK_BF16_FLOPS, PEAK_F32_FLOPS, bound_s


def flops(B: int, Nq: int, Nk: int, H: int, D: int) -> float:
    return 4.0 * B * H * Nq * Nk * D


def nbytes(B: int, Nq: int, Nk: int, H: int, D: int, esize: int = 2) -> float:
    return float(esize * B * H * D * (2 * Nq + 2 * Nk))


def call_bound_s(B: int, Nq: int, Nk: int, H: int, D: int, esize: int = 2) -> float:
    return bound_s(flops(B, Nq, Nk, H, D), nbytes(B, Nq, Nk, H, D, esize),
                   PEAK_BF16_FLOPS if esize == 2 else PEAK_F32_FLOPS)


def tsr_calls(config: dict, batch: int = 1):
    """The attention calls of one TripoSR encode: the ViT's self-attention
    per layer over 1 + (S/p)^2 tokens, and per backbone block the
    self-attention over the 3 S_t^2 triplane tokens and the
    cross-attention into the image tokens -> [(B, Nq, Nk, H, D)]."""
    v, b = config["image_tokenizer"], config["backbone"]
    n_img = 1 + (config["cond_image_size"] // v["patch_size"]) ** 2
    n_tri = 3 * config["tokenizer"]["plane_size"] ** 2
    vit = (batch, n_img, n_img, v["num_attention_heads"], v["hidden_size"] // v["num_attention_heads"])
    h, d = b["num_attention_heads"], b["attention_head_dim"]
    return ([vit] * v["num_hidden_layers"] + [(batch, n_tri, n_tri, h, d)] * b["num_layers"]
            + [(batch, n_tri, n_img, h, d)] * b["num_layers"])


def tsr_bound_s(config: dict) -> float:
    """The bound of one TripoSR encode's attention calls, in bfloat16."""
    return sum(call_bound_s(*c) for c in tsr_calls(config))


def is_attention_kernel(name: str) -> bool:
    """Device operations that compute attention: the port's kernel K1
    (``flash_fwd_bf16`` / ``flash_fwd_f32``) and PyTorch's SDPA kernels
    (flash, memory-efficient, cuDNN), so that the same work reads the same
    whatever implements it."""
    n = name.lower()
    return "flash_fwd" in n or "fmha" in n or "attention" in n or "sdpa" in n
