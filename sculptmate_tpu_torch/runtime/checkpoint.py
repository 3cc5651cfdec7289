"""Weight bridge from the JAX package's flax params to the port's state dict.

``tsr_params_from_jax`` is the inverse of the JAX package's
``runtime/checkpoint.py:convert_tsr_state_dict``: it takes the flax param
tree of ``systems/tsr.py:TSRModule`` as nested dicts of numpy arrays and
returns the port's ``TSRModule`` state dict, whose keys are the reference
torch checkpoint's. Layout rules (flax -> torch):

  Dense          kernel (I, O)          -> weight (O, I)
  Conv           kernel (kh, kw, I, O)  -> weight (O, I, kh, kw)
  ConvTranspose  kernel (kh, kw, I, O)  -> weight (I, O, kh, kw), spatially
                 un-flipped (flax's transpose_kernel=False convention mirrors
                 the taps of torch's)
  Norms          scale/bias             -> weight/bias

Only transposes and flips, so the round trip is exact.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, order="C"))  # a writable copy


def _linear(sd, prefix: str, p: Mapping) -> None:
    sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _norm(sd, prefix: str, p: Mapping) -> None:
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _numbered(tree: Mapping, stem: str):
    """Sorted indices of the ``<stem>_<i>`` children of a flax subtree."""
    return sorted(int(m.group(1)) for k in tree if (m := re.fullmatch(rf"{stem}_(\d+)", k)))


def tsr_params_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ``TSRModule`` params -> the port's ``TSRModule`` state dict."""
    sd: Dict[str, torch.Tensor] = {}

    vit = params["image_tokenizer"]["vit"]
    emb = "image_tokenizer.model.embeddings"
    sd[f"{emb}.cls_token"] = _t(vit["cls_token"])
    sd[f"{emb}.position_embeddings"] = _t(vit["pos_embed"])
    pe = vit["patch_embed"]
    sd[f"{emb}.patch_embeddings.projection.weight"] = _t(np.asarray(pe["kernel"]).transpose(3, 2, 0, 1))
    sd[f"{emb}.patch_embeddings.projection.bias"] = _t(pe["bias"])
    for i in _numbered(vit, "layer"):
        fl = vit[f"layer_{i}"]
        tl = f"image_tokenizer.model.encoder.layer.{i}"
        _norm(sd, f"{tl}.layernorm_before", fl["layernorm_before"])
        _norm(sd, f"{tl}.layernorm_after", fl["layernorm_after"])
        att = fl["attention"]
        for name in ("query", "key", "value"):
            _linear(sd, f"{tl}.attention.attention.{name}", att[name])
        _linear(sd, f"{tl}.attention.output.dense", att["output"])
        _linear(sd, f"{tl}.intermediate.dense", fl["intermediate"])
        _linear(sd, f"{tl}.output.dense", fl["mlp_output"])
    _norm(sd, "image_tokenizer.model.layernorm", vit["layernorm"])

    sd["tokenizer.embeddings"] = _t(params["tokenizer"]["embeddings"])

    bb = params["backbone"]
    _norm(sd, "backbone.norm", bb["norm"])
    _linear(sd, "backbone.proj_in", bb["proj_in"])
    _linear(sd, "backbone.proj_out", bb["proj_out"])
    for i in _numbered(bb, "blocks"):
        fb = bb[f"blocks_{i}"]
        tb = f"backbone.transformer_blocks.{i}"
        for norm in ("norm1", "norm2", "norm3"):
            _norm(sd, f"{tb}.{norm}", fb[norm])
        for attn in ("attn1", "attn2"):
            for proj in ("to_q", "to_k", "to_v"):
                _linear(sd, f"{tb}.{attn}.{proj}", fb[attn][proj])
            _linear(sd, f"{tb}.{attn}.to_out.0", fb[attn]["to_out"])
        _linear(sd, f"{tb}.ff.net.0.proj", fb["ff"]["net_0"]["proj"])
        _linear(sd, f"{tb}.ff.net.2", fb["ff"]["net_2"])

    up = params["post_processor"]["upsample"]
    k = np.asarray(up["kernel"])[::-1, ::-1]  # undo the flip of the forward conversion
    sd["post_processor.upsample.weight"] = _t(k.transpose(2, 3, 0, 1))
    sd["post_processor.upsample.bias"] = _t(up["bias"])

    layers = params["decoder"]["layers"]
    hidden = _numbered(layers, "dense")
    for n, name in enumerate([f"dense_{i}" for i in hidden] + ["dense_out"]):
        _linear(sd, f"decoder.layers.{2 * n}", layers[name])
    return sd
