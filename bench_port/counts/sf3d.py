"""Operation and byte counts of one Stable Fast 3D ("Pro") request, from
the configuration's shapes (two operations a multiply-add), for the
``attention_roofline``, ``grid_roofline`` and ``mfu`` metrics of the Pro
cells:

- ``calls``: the attention calls of one request: the DINOv2 layers over
  1 + (S/p)^2 image tokens, the CLIP layers over 1 + (224/32)^2 tokens,
  and per backbone block the fuse-in (the 3 089 latents over the 27 648
  triplane tokens), the basic blocks' latent self-attention and
  cross-attention into the image tokens, and the fuse-out (the triplane
  over the latents): 68 calls at the published widths;
- ``grid_bound_s``: kernel K5's yardstick (``chip_smoke.py``'s count): at
  each of the (res + 1)^3 lattice points the density and vertex-offset
  heads' hidden 64 x 64 layer and output layer, the three partial planes,
  the weights and the float32 outputs moved once;
- ``request_flops``: the encode (camera embedder and modulations, DINOv2,
  the backbone's projections, attention products and GEGLU feed-forwards,
  the pixel-shuffle convolutions), the CLIP estimator and its heads, the
  two lattice heads at every lattice point (their first layer on the 120
  features included) and the two texel heads at every texel of the bake.

The u2net matting, the illumination estimator (not run by the add-on) and
the host's geometry are left out: a lower bound of the model's work.
"""

from counts import bound_s
from counts.attention import call_bound_s
from counts.attention import flops as attention_flops

_HIDDEN = 64  # the decoder heads' width, which K5 is built for


def _tokens(config: dict):
    v, ie = config["image_tokenizer"], config["image_estimator"]
    n_img = 1 + (config["cond_image_size"] // v["patch_size"]) ** 2
    n_clip = 1 + (ie["image_size"] // ie["patch_size"]) ** 2
    n_tri = 3 * config["tokenizer"]["plane_size"] ** 2
    n_lat = n_img + config["backbone"]["num_latents"]
    return n_img, n_clip, n_tri, n_lat


def calls(config: dict, batch: int = 1):
    """The attention calls of one request -> [(B, Nq, Nk, H, D)]."""
    v, b, ie = config["image_tokenizer"], config["backbone"], config["image_estimator"]
    n_img, n_clip, n_tri, n_lat = _tokens(config)
    h, d = b["num_attention_heads"], b["attention_head_dim"]
    dino = (batch, n_img, n_img, v["num_attention_heads"], v["hidden_size"] // v["num_attention_heads"])
    clip = (batch, n_clip, n_clip, ie["clip_heads"], ie["clip_width"] // ie["clip_heads"])
    block = ([(batch, n_lat, n_tri, h, d)] + [(batch, n_lat, n_lat, h, d), (batch, n_lat, n_img, h, d)]
             * b["num_basic_blocks"] + [(batch, n_tri, n_lat, h, d)])
    return [dino] * v["num_hidden_layers"] + [clip] * ie["clip_layers"] + block * b["num_blocks"]


def attention_bound_s(config: dict) -> float:
    """The bound of one request's attention calls, in bfloat16."""
    return sum(call_bound_s(*c) for c in calls(config))


def _lattice_heads(config: dict):
    return [h for h in config["decoder"]["heads"] if h["name"] in ("density", "vertex_offset")]


def _texel_heads(config: dict):
    return [h for h in config["decoder"]["heads"] if h["name"] in ("features", "perturb_normal")]


def grid_bound_s(config: dict) -> float:
    """Kernel K5's bound at the (res + 1)^3 lattice."""
    R = config["isosurface_resolution"] + 1
    heads = _lattice_heads(config)
    K = sum(h["out_channels"] for h in heads)
    flops = R ** 3 * sum(2 * _HIDDEN * _HIDDEN + 2 * _HIDDEN * h["out_channels"] for h in heads)
    nbytes = 3 * R * R * len(heads) * _HIDDEN * 2 + len(heads) * (_HIDDEN * _HIDDEN + 8 * _HIDDEN) * 2 + K * R ** 3 * 4
    return bound_s(flops, nbytes)


def _head_flops(config: dict, head: dict) -> float:
    w, d_in = config["decoder"]["n_neurons"], 3 * config["post_processor"]["out_channels"]
    return 2.0 * (d_in * w + (head["n_hidden_layers"] - 1) * w * w + w * head["out_channels"])


def encode_flops(config: dict) -> float:
    cam, v, t, b, po = (config[k] for k in ("camera_embedder", "image_tokenizer", "tokenizer", "backbone",
                                            "post_processor"))
    n_img, n_clip, n_tri, n_lat = _tokens(config)
    hv, iv, p = v["hidden_size"], v["intermediate_size"], v["patch_size"]
    C, P = t["num_channels"], t["plane_size"]
    inner = b["num_attention_heads"] * b["attention_head_dim"]
    camera = 2.0 * cam["in_channels"] * cam["out_channels"]
    dino = (2.0 * (n_img - 1) * 3 * p * p * hv
            + v["num_hidden_layers"] * (2.0 * n_img * (4 * hv * hv + 2 * hv * iv) + 2 * 2.0 * cam["out_channels"]
                                        * 2 * hv))

    def ff(n, dim):
        return 2.0 * n * (dim * 8 * dim + 4 * dim * dim)

    block = (2.0 * n_lat * 2 * inner * inner + 2.0 * n_tri * 2 * C * inner + ff(n_lat, inner)  # fuse-in
             + b["num_basic_blocks"] * (2.0 * n_lat * 4 * inner * inner + 2.0 * n_lat * 2 * inner * inner
                                        + 2.0 * n_img * 2 * hv * inner + ff(n_lat, inner))
             + 2.0 * n_tri * 2 * C * C + 2.0 * n_lat * 2 * inner * C + ff(n_tri, C))  # fuse-out
    backbone = (2.0 * n_tri * C * C + 2.0 * n_img * hv * inner + 2.0 * b["num_latents"] * inner * inner
                + b["num_blocks"] * block + 2.0 * n_tri * C * C)
    s = po["scale_factor"]
    upsample = 3 * P * P * 2.0 * 9 * C * ((po["conv_layers"] - 1) * C + po["out_channels"] * s * s)
    attn = sum(attention_flops(*c) for c in calls(config) if c[1] != n_clip)
    return camera + dino + backbone + upsample + attn


def clip_flops(config: dict) -> float:
    ie = config["image_estimator"]
    w, hf, pc = ie["clip_width"], ie["hidden_features"], ie["patch_size"]
    _, n_clip, _, _ = _tokens(config)
    tower = 2.0 * (n_clip - 1) * 3 * pc * pc * w + ie["clip_layers"] * 2.0 * n_clip * 12 * w * w + 2.0 * w * hf
    heads = len(ie["heads"]) * 2.0 * hf * hf * (ie["n_hidden_layers"] + 2)
    attn = sum(attention_flops(*c) for c in calls(config) if c[1] == n_clip)
    return tower + heads + attn


def request_flops(config: dict, bake_resolution: int) -> float:
    R = config["isosurface_resolution"] + 1
    lattice = R ** 3 * sum(_head_flops(config, h) for h in _lattice_heads(config))
    texels = bake_resolution ** 2 * sum(_head_flops(config, h) for h in _texel_heads(config))
    return encode_flops(config) + clip_flops(config) + lattice + texels


