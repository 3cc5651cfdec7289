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

  BatchNorm      mean/var (batch_stats)  -> running_mean/running_var

Only transposes and flips, so the round trip is exact.

``sf3d_params_from_jax`` is the inverse of ``convert_sf3d_state_dict`` for
the SF3D stack (``systems/sf3d.py:SF3DModule``): the same rules, plus CLIP's
packed ``in_proj_weight`` (the Dense kernel transposed) and LayerScale's
``lambda1`` as they are.

``u2net_params_from_jax`` does the same for the JAX package's u2net (the
inverse of its ``convert_u2net_state_dict``), and
``try_load_u2net_state_dict`` reads ``u2net.onnx`` from the checkpoint
directory (``$SCULPTMATE_CHECKPOINTS``, else ``checkpoints/`` in the
package) through ``runtime/onnx_lite.py``.

``read_safetensors`` reads a ``.safetensors`` file without the
``safetensors`` package, and ``load_sf3d_state_dict`` turns the reference's
SF3D ``model.safetensors`` into the port's f32 state dict, accepting what
the JAX package's ``load_sf3d_checkpoint`` accepts.
"""

from __future__ import annotations

import json
import math
import os
import re
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

CHECKPOINT_DIR = os.environ.get(
    "SCULPTMATE_CHECKPOINTS",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "checkpoints"),
)
# the u2net parameters among an ONNX file's initializers (it holds graph
# constants too)
_U2NET_KEY = re.compile(r"(stage\d+d?|side\d+|outconv)\.")


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


def _conv(sd, prefix: str, p: Mapping) -> None:
    sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def u2net_params_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """Flax u2net ``{"params", "batch_stats"}`` -> the port's ``U2Net``
    state dict, under the original U-2-Net names (``stage1.rebnconvin
    .conv_s1.weight``, ``.bn_s1.running_mean``, ``side1.weight``, ...)."""
    sd: Dict[str, torch.Tensor] = {}

    def walk(p: Mapping, s: Mapping, path: str) -> None:
        for name, node in p.items():
            prefix = f"{path}{name}"
            if "conv" in node and "bn" in node:  # a REBNCONV
                _conv(sd, f"{prefix}.conv_s1", node["conv"])
                bn, stats = node["bn"], s[name]["bn"]
                sd[f"{prefix}.bn_s1.weight"] = _t(bn["scale"])
                sd[f"{prefix}.bn_s1.bias"] = _t(bn["bias"])
                sd[f"{prefix}.bn_s1.running_mean"] = _t(stats["mean"])
                sd[f"{prefix}.bn_s1.running_var"] = _t(stats["var"])
            elif "kernel" in node:  # a side head or the fusing conv
                _conv(sd, prefix, node)
            else:
                walk(node, s.get(name, {}), f"{prefix}.")

    walk(variables["params"], variables.get("batch_stats", {}), "")
    return sd


def u2net_state_dict_from_onnx(path: str) -> Dict[str, torch.Tensor]:
    """The u2net parameters among an ONNX file's initializers, under the
    port's ``U2Net`` names."""
    from sculptmate_tpu_torch.runtime.onnx_lite import read_initializers

    return {k: _t(v) for k, v in read_initializers(path).items() if _U2NET_KEY.match(k)}


def try_load_u2net_state_dict() -> Optional[Dict[str, torch.Tensor]]:
    """The u2net parameters of ``u2net.onnx`` in the checkpoint directory,
    or None when the file is absent."""
    path = os.path.join(CHECKPOINT_DIR, "u2net.onnx")
    if not os.path.isfile(path):
        return None
    return u2net_state_dict_from_onnx(path)


def _dense_stack(sd, prefix: str, layers: Sequence[Mapping]) -> None:
    """Linears of a reference ``nn.Sequential`` of Linear and activation
    modules: the Linears sit at indices 0, 2, 4, ..."""
    for n, p in enumerate(layers):
        _linear(sd, f"{prefix}.{2 * n}", p)


def sf3d_params_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ``SF3DModule`` params -> the port's ``SF3DModule`` state dict,
    under the reference checkpoint's keys (the inverse of the JAX package's
    ``convert_sf3d_state_dict``)."""
    sd: Dict[str, torch.Tensor] = {}
    _linear(sd, "camera_embedder.linear", params["camera_embedder"]["linear"])

    dv = params["image_tokenizer"]["dinov2"]
    emb = "image_tokenizer.model.embeddings"
    sd[f"{emb}.cls_token"] = _t(dv["cls_token"])
    sd[f"{emb}.position_embeddings"] = _t(dv["pos_embed"])
    _conv(sd, f"{emb}.patch_embeddings.projection", dv["patch_embed"])
    for i in _numbered(dv, "layer"):
        fl = dv[f"layer_{i}"]
        tl = f"image_tokenizer.model.encoder.layer.{i}"
        _norm(sd, f"{tl}.norm1", fl["norm1"])
        _norm(sd, f"{tl}.norm2", fl["norm2"])
        for name in ("query", "key", "value"):
            _linear(sd, f"{tl}.attention.attention.{name}", fl[name])
        _linear(sd, f"{tl}.attention.output.dense", fl["attn_output"])
        _linear(sd, f"{tl}.mlp.fc1", fl["mlp_fc1"])
        _linear(sd, f"{tl}.mlp.fc2", fl["mlp_fc2"])
        sd[f"{tl}.layer_scale1.lambda1"] = _t(fl["layer_scale1"]["lambda1"])
        sd[f"{tl}.layer_scale2.lambda1"] = _t(fl["layer_scale2"]["lambda1"])
        for mod in ("norm1_modulation", "norm2_modulation"):
            _linear(sd, f"{tl}.{mod}.linear2", fl[mod]["linear2"])
    _norm(sd, "image_tokenizer.model.layernorm", dv["layernorm"])

    sd["tokenizer.embeddings"] = _t(params["tokenizer"]["embeddings"])

    bb = params["backbone"]
    _norm(sd, "backbone.norm_triplane", bb["norm_triplane"])
    for name in ("norm_image", "norm_latent"):
        _norm(sd, f"backbone.{name}", bb[name])
    for name in ("proj_triplane", "proj_image", "proj_latent", "proj_out"):
        _linear(sd, f"backbone.{name}", bb[name])
    sd["backbone.latent_init"] = _t(bb["latent_init"])

    def attn(prefix, p):
        for w in ("wq", "wk", "wv", "proj"):
            _linear(sd, f"{prefix}.{w}", p[w])

    def ff(prefix, p):
        _linear(sd, f"{prefix}.net.0.proj", p["net_0"]["proj"])
        _linear(sd, f"{prefix}.net.2", p["net_2"])

    for i in _numbered(bb, "main_blocks"):
        fb, tb = bb[f"main_blocks_{i}"], f"backbone.main_blocks.{i}"
        for fuse in ("fuse_block_in", "fuse_block_out"):
            _norm(sd, f"{tb}.{fuse}.norm_z1", fb[fuse]["norm_z1"])
            _norm(sd, f"{tb}.{fuse}.norm_z2", fb[fuse]["norm_z2"])
            attn(f"{tb}.{fuse}.attn", fb[fuse]["attn"])
            ff(f"{tb}.{fuse}.ff", fb[fuse]["ff"])
        for j in _numbered(fb, "transformer_block"):
            fj, tj = fb[f"transformer_block_{j}"], f"{tb}.transformer_block.{j}"
            for norm in ("norm1", "norm2", "norm3"):
                _norm(sd, f"{tj}.{norm}", fj[norm])
            attn(f"{tj}.attn1", fj["attn1"])
            attn(f"{tj}.attn2", fj["attn2"])
            ff(f"{tj}.ff", fj["ff"])

    pp = params["post_processor"]
    for n in _numbered(pp, "conv"):
        _conv(sd, f"post_processor.upsample.{2 * n}", pp[f"conv_{n}"])

    for key, head in params["decoder"].items():
        hidden = _numbered(head, "dense")
        _dense_stack(sd, f"decoder.heads.{key[len('head_'):]}", [head[f"dense_{i}"] for i in hidden] + [head["dense_out"]])

    est = params["image_estimator"]
    cv, vis = est["clip"], "image_estimator.model.visual"
    sd[f"{vis}.conv1.weight"] = _t(np.asarray(cv["patch_embed"]["kernel"]).transpose(3, 2, 0, 1))
    sd[f"{vis}.class_embedding"] = _t(cv["class_embedding"])
    sd[f"{vis}.positional_embedding"] = _t(cv["positional_embedding"])
    sd[f"{vis}.proj"] = _t(cv["proj"])
    _norm(sd, f"{vis}.ln_pre", cv["ln_pre"])
    _norm(sd, f"{vis}.ln_post", cv["ln_post"])
    for i in _numbered(cv, "block"):
        fb, rb = cv[f"block_{i}"], f"{vis}.transformer.resblocks.{i}"
        _norm(sd, f"{rb}.ln_1", fb["ln_1"])
        _norm(sd, f"{rb}.ln_2", fb["ln_2"])
        sd[f"{rb}.attn.in_proj_weight"] = _t(np.asarray(fb["in_proj"]["kernel"]).T)
        sd[f"{rb}.attn.in_proj_bias"] = _t(fb["in_proj"]["bias"])
        _linear(sd, f"{rb}.attn.out_proj", fb["out_proj"])
        _linear(sd, f"{rb}.mlp.c_fc", fb["mlp_fc"])
        _linear(sd, f"{rb}.mlp.c_proj", fb["mlp_proj"])
    for key in est:
        if key.endswith("_shared"):
            name, shared = key[: -len("_shared")], est[key]
            _dense_stack(sd, f"image_estimator.heads.{name}.0", [shared[f"dense_{i}"] for i in _numbered(shared, "dense")])
            for pi in range(2):
                _dense_stack(sd, f"image_estimator.heads.{name}.{pi + 1}",
                             [est[f"{name}_p{pi}"]["dense_0"], est[f"{name}_p{pi}_out"]])

    ge = params["global_estimator"]
    for n in (1, 2):
        _conv(sd, f"global_estimator.layers.{2 * (n - 1)}", ge[f"conv{n}"])
    for key in ge:
        if key.endswith("_stack"):
            name, stack = key[: -len("_stack")], ge[key]
            _dense_stack(sd, f"global_estimator.heads.{name}",
                         [stack[f"dense_{i}"] for i in _numbered(stack, "dense")] + [ge[f"{name}_out"]])
    return sd


# -- safetensors ------------------------------------------------------------

_ST_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16, "I64": torch.int64,
              "I32": torch.int32}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file -> {name: CPU tensor}, parsed here: an 8-byte
    little-endian header length, a JSON header of ``dtype``, ``shape`` and
    ``data_offsets`` (relative to the end of the header) per tensor, then
    the raw little-endian buffers. F32, F16, BF16, I64 and I32 are read;
    another dtype, an offset outside the file or a buffer whose size is not
    its shape's raises ``ValueError`` naming the tensor."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) < 8:
            raise ValueError(f"{path}: not a safetensors file (no 8-byte header length)")
        n = int.from_bytes(head, "little")
        if 8 + n > size:
            raise ValueError(f"{path}: its {n}-byte header runs past the end of the file ({size} bytes)")
        header = json.loads(f.read(n))
        base = 8 + n
        out = {}
        for name, info in header.items():
            if name == "__metadata__":
                continue
            dt = _ST_DTYPES.get(info.get("dtype"))
            if dt is None:
                raise ValueError(f"{path}: tensor {name!r} has dtype {info.get('dtype')!r}; "
                                 f"read are {sorted(_ST_DTYPES)}")
            start, end = info["data_offsets"]
            shape = [int(d) for d in info["shape"]]
            nbytes = math.prod(shape) * torch.empty((), dtype=dt).element_size()
            if not (0 <= start <= end and base + end <= size):
                raise ValueError(f"{path}: tensor {name!r} at bytes [{start}, {end}) lies outside the file's "
                                 f"{size - base} data bytes")
            if end - start != nbytes:
                raise ValueError(f"{path}: tensor {name!r} holds {end - start} bytes, its shape {shape} "
                                 f"needs {nbytes}")
            buf = bytearray(nbytes)
            f.seek(base + start)
            f.readinto(buf)
            t = torch.frombuffer(buf, dtype=dt) if nbytes else torch.empty(0, dtype=dt)
            out[name] = t.reshape(shape)
    return out


# keys the JAX package's convert_sf3d_state_dict reads only when present:
# the AdaLN projections, the backbone's image-token norm and projection, and
# the CLIP image encoder (a missing one keeps the module's seeded value: zero
# modulations, as the JAX package initialises them)
_SF3D_OPTIONAL = re.compile(
    r"image_tokenizer\.model\.encoder\.layer\.\d+\.norm[12]_modulation\.linear2\."
    r"|backbone\.(norm|proj)_image\."
    r"|image_estimator\.model\.visual\."
)


def is_optional_sf3d_key(key: str) -> bool:
    """Whether an SF3D state-dict key may be missing from a checkpoint."""
    return _SF3D_OPTIONAL.match(key) is not None


def _indices(sd, pattern: str) -> List[int]:
    return sorted({int(m.group(1)) for k in sd if (m := re.match(pattern, k))})


def _count(sd, pattern: str, what: str) -> int:
    found = _indices(sd, pattern)
    if not found:
        raise KeyError(f"SF3D checkpoint has no {what}")
    return 1 + max(found)


def sf3d_checkpoint_keys(sd: Mapping) -> List[str]:
    """The keys of a reference SF3D state dict that the JAX package's
    ``convert_sf3d_state_dict`` reads, in its order: every key it reads
    unconditionally must be there (``KeyError`` names the first missing
    one), the keys it reads only when present are taken when they are."""
    keys: List[str] = []

    def need(k):
        if k not in sd:
            raise KeyError(f"SF3D checkpoint lacks {k!r}")
        keys.append(k)

    def opt(k):
        if k in sd:
            keys.append(k)

    def linear(prefix):  # Linear and Conv: the bias is optional
        need(f"{prefix}.weight")
        opt(f"{prefix}.bias")

    def norm(prefix):
        need(f"{prefix}.weight")
        need(f"{prefix}.bias")

    linear("camera_embedder.linear")
    emb = "image_tokenizer.model.embeddings"
    need(f"{emb}.cls_token")
    need(f"{emb}.position_embeddings")
    linear(f"{emb}.patch_embeddings.projection")
    for i in range(_count(sd, r"image_tokenizer\.model\.encoder\.layer\.(\d+)\.", "DINOv2 layers")):
        tl = f"image_tokenizer.model.encoder.layer.{i}"
        norm(f"{tl}.norm1")
        norm(f"{tl}.norm2")
        for name in ("attention.attention.query", "attention.attention.key", "attention.attention.value",
                     "attention.output.dense", "mlp.fc1", "mlp.fc2"):
            linear(f"{tl}.{name}")
        need(f"{tl}.layer_scale1.lambda1")
        need(f"{tl}.layer_scale2.lambda1")
        for mod in ("norm1_modulation", "norm2_modulation"):
            if f"{tl}.{mod}.linear2.weight" in sd:
                linear(f"{tl}.{mod}.linear2")
    norm("image_tokenizer.model.layernorm")
    need("tokenizer.embeddings")

    norm("backbone.norm_triplane")
    linear("backbone.proj_triplane")
    if "backbone.norm_image.weight" in sd:
        norm("backbone.norm_image")
        linear("backbone.proj_image")
    norm("backbone.norm_latent")
    linear("backbone.proj_latent")
    need("backbone.latent_init")
    linear("backbone.proj_out")

    def cross_attn(prefix):
        for w in ("wq", "wk", "wv", "proj"):
            linear(f"{prefix}.{w}")

    def ff(prefix):
        linear(f"{prefix}.net.0.proj")
        linear(f"{prefix}.net.2")

    for i in range(_count(sd, r"backbone\.main_blocks\.(\d+)\.", "backbone blocks")):
        tb = f"backbone.main_blocks.{i}"
        for fuse in ("fuse_block_in", "fuse_block_out"):
            if f"{tb}.{fuse}.norm_x.weight" in sd:
                norm(f"{tb}.{fuse}.norm_x")
            norm(f"{tb}.{fuse}.norm_z1")
            norm(f"{tb}.{fuse}.norm_z2")
            cross_attn(f"{tb}.{fuse}.attn")
            ff(f"{tb}.{fuse}.ff")
        for j in range(_count(sd, rf"backbone\.main_blocks\.{i}\.transformer_block\.(\d+)\.", f"blocks in {tb}")):
            tj = f"{tb}.transformer_block.{j}"
            for n in ("norm1", "norm2", "norm3"):
                norm(f"{tj}.{n}")
            cross_attn(f"{tj}.attn1")
            cross_attn(f"{tj}.attn2")
            ff(f"{tj}.ff")

    for i in _indices(sd, r"post_processor\.upsample\.(\d+)\.weight"):
        linear(f"post_processor.upsample.{i}")
    for name in sorted({m.group(1) for k in sd if (m := re.match(r"decoder\.heads\.([^.]+)\.", k))}):
        for i in _indices(sd, rf"decoder\.heads\.{re.escape(name)}\.(\d+)\.weight"):
            linear(f"decoder.heads.{name}.{i}")

    vis = "image_estimator.model.visual"
    if f"{vis}.conv1.weight" in sd:
        need(f"{vis}.conv1.weight")
        need(f"{vis}.class_embedding")
        need(f"{vis}.positional_embedding")
        norm(f"{vis}.ln_pre")
        norm(f"{vis}.ln_post")
        need(f"{vis}.proj")
        for i in range(_count(sd, rf"{re.escape(vis)}\.transformer\.resblocks\.(\d+)\.", "CLIP blocks")):
            rb = f"{vis}.transformer.resblocks.{i}"
            norm(f"{rb}.ln_1")
            norm(f"{rb}.ln_2")
            need(f"{rb}.attn.in_proj_weight")
            need(f"{rb}.attn.in_proj_bias")
            linear(f"{rb}.attn.out_proj")
            linear(f"{rb}.mlp.c_fc")
            linear(f"{rb}.mlp.c_proj")
    for name in sorted({m.group(1) for k in sd if (m := re.match(r"image_estimator\.heads\.([^.]+)\.", k))}):
        for i in _indices(sd, rf"image_estimator\.heads\.{re.escape(name)}\.0\.(\d+)\.weight"):
            linear(f"image_estimator.heads.{name}.0.{i}")
        for pi in (1, 2):
            linear(f"image_estimator.heads.{name}.{pi}.0")
            linear(f"image_estimator.heads.{name}.{pi}.2")

    for i in _indices(sd, r"global_estimator\.layers\.(\d+)\.weight"):
        linear(f"global_estimator.layers.{i}")
    for name in sorted({m.group(1) for k in sd if (m := re.match(r"global_estimator\.heads\.([^.]+)\.", k))}):
        for i in _indices(sd, rf"global_estimator\.heads\.{re.escape(name)}\.(\d+)\.weight"):
            linear(f"global_estimator.heads.{name}.{i}")
    return keys


def load_sf3d_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The reference's SF3D ``model.safetensors`` -> the f32 state dict that
    ``systems/sf3d.py:SF3D(state_dict=...)`` takes: the keys the JAX
    package's loader reads (``sf3d_checkpoint_keys``), each as f32; keys
    neither package uses are dropped. The fuse blocks' ``norm_x`` (read by
    the JAX converter, unused by both packages' modules) is dropped too."""
    sd = read_safetensors(path)
    return {k: sd[k].float() for k in sf3d_checkpoint_keys(sd) if ".norm_x." not in k}
