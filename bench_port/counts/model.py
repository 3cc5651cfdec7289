"""Model operations of one TripoSR request, counted from shapes (two
operations a multiply-add), for the ``mfu`` metrics:

- the encode: the ViT (patch embedding, per layer the q, k, v and output
  projections, the MLP and the attention products), the triplane backbone
  (projections in and out, per block the self- and cross-attention
  projections and products and the GEGLU feed-forward) and the
  transposed-convolution upsample;
- the lattice: the decoder MLP at every one of the R^3 points (the first
  layer on its 120 features, the hidden layers, the 4 outputs);
- the colors: the same MLP at every mesh vertex.

The u2net matting is left out (about 0.1 TFLOP at 320^2, under 3 % of a
request): the count is of the 3D model's work, a lower bound.
"""

from counts.attention import flops as attention_flops
from counts.attention import tsr_calls


def encode_flops(config: dict) -> float:
    v, t, b = config["image_tokenizer"], config["tokenizer"], config["backbone"]
    p, hv, iv = v["patch_size"], v["hidden_size"], v["intermediate_size"]
    n_img = 1 + (config["cond_image_size"] // p) ** 2
    vit = 2.0 * (n_img - 1) * 3 * p * p * hv + v["num_hidden_layers"] * 2.0 * n_img * (4 * hv * hv + 2 * hv * iv)
    C, S = t["num_channels"], t["plane_size"]
    n_tri = 3 * S * S
    inner = b["num_attention_heads"] * b["attention_head_dim"]
    ctx = b["cross_attention_dim"]
    block = 2.0 * n_tri * (4 * inner * inner + 2 * inner * inner + inner * 8 * inner + 4 * inner * inner)
    block += 2.0 * n_img * 2 * ctx * inner  # the cross-attention's k and v
    backbone = 2.0 * n_tri * 2 * C * inner + b["num_layers"] * block
    upsample = 2.0 * 3 * S * S * C * config["post_processor"]["out_channels"] * 4
    attn = sum(attention_flops(*c) for c in tsr_calls(config))
    return vit + backbone + upsample + attn


def decoder_flops_per_point(config: dict) -> float:
    d = config["decoder"]
    w = d["n_neurons"]
    return 2.0 * (d["in_channels"] * w + (d["n_hidden_layers"] - 1) * w * w + w * 4)


def request_flops(config: dict, resolution: int, n_vertices: int) -> float:
    per_point = decoder_flops_per_point(config)
    return encode_flops(config) + per_point * (resolution ** 3 + n_vertices)
