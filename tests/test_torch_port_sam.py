"""Port parity for SAM: ``sculptmate_tpu_torch.frontend.sam`` against
``sculptmate_tpu.frontend.sam`` on the same weights and numpy inputs (CPU,
f32; 1e-4 of max |ref|). A tiny model: dim 32, depth 2, 2 heads, 128^2
input (an 8^2 grid, so windows of 14 and of 6 pad it), the full-width
prompt encoder and mask decoder, every LayerNorm, bias, position table and
embedding randomized.

The port follows the published SAM recipe where the JAX package departs
from it (``frontend/sam.py``'s docstring lists where). Each difference has
a test here that shows it, and the comparisons neutralise it on the JAX
side: (a) window padding of ``norm1``'s output, not of its input; (b) the
no-mask dense embedding added to the image embedding; (c) points at pixel
centres; (d) no residual around the first two-way block's self-attention;
(e) the published global-attention blocks of ViT-L and ViT-H; (f) the
two-way transformer's LayerNorm eps."""

import dataclasses
import functools
import json

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from sculptmate_tpu.frontend import sam as jsam
from sculptmate_tpu.runtime.checkpoint import convert_sam_state_dict
from sculptmate_tpu_torch.frontend import sam as psam
from sculptmate_tpu_torch.runtime import checkpoint
from sculptmate_tpu_torch.runtime.checkpoint import sam_params_from_jax

GRID = 8  # tokens a side of a 128^2 input


def _close(got, ref, tol=1e-4):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= tol * scale, f"max |err| {err} > {tol} * {scale}"
    return err / scale


def _far(got, ref, tol=1e-4):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert np.abs(got - ref).max() > 10 * tol * np.abs(ref).max()


def _tiny(window_size=14, global_attn=(2, 5, 8, 11), seed=6):
    """The port's tiny Sam with every parameter drawn from a seed: lecun
    kernels, unit normal embeddings, and N(0, 0.2) norms (around 1), biases,
    position tables; and its JAX params from the JAX package's converter."""
    net = psam.Sam(32, 2, 2, global_attn, img_size=128)
    if window_size != 14:
        net.image_encoder = psam.ImageEncoderViT(32, 2, 2, window_size, global_attn, img_size=128)
    net.reset_parameters(torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith("bias") or "rel_pos" in name or name.endswith("pos_embed"):
                p.copy_(torch.from_numpy(0.2 * rng.standard_normal(p.shape).astype(np.float32)))
            elif "norm" in name or "neck.1" in name or "neck.3" in name or "upscaling.1" in name:
                p.copy_(torch.from_numpy(1 + 0.2 * rng.standard_normal(p.shape).astype(np.float32)))
    sd = {k: v.numpy() for k, v in net.state_dict().items()}
    return net.eval(), jax.tree.map(jnp.asarray, convert_sam_state_dict(sd))


def _zero_norm1_bias(net, params):
    """Both sides with every encoder block's norm1 bias zero: then LN(0) of
    a padded token is 0 in the JAX package too, and (a) does not show."""
    with torch.no_grad():
        for blk in net.image_encoder.blocks:
            blk.norm1.bias.zero_()
    params = jax.tree.map(lambda x: x, params)
    for name, blk in params["image_encoder"].items():
        if name.startswith("block_"):
            blk["norm1"] = {**blk["norm1"], "bias": jnp.zeros_like(blk["norm1"]["bias"])}
    return params


def _pad_norm1_output_with_zeros(next_fun, args, kwargs, context):
    """(a) on the JAX side: a windowed block's norm1 output is zero on the
    padded tokens, as upstream pads after norm1."""
    out = next_fun(*args, **kwargs)
    m = context.module
    if (context.method_name == "__call__" and m.name == "norm1" and isinstance(m.parent, jsam.SAMBlock)
            and out.shape[1] > GRID):
        keep = jnp.arange(out.shape[1]) < GRID
        out = out * keep[None, :, None, None] * keep[None, None, :, None]
    return out


def _no_first_residual(next_fun, args, kwargs, context):
    """(d) on the JAX side: block 0 adds its self-attention to the tokens;
    subtracting the tokens here leaves the self-attention alone, as upstream."""
    out = next_fun(*args, **kwargs)
    m = context.module
    if (context.method_name == "__call__" and isinstance(m, jsam.TwoWayAttention) and m.name == "self_attn"
            and m.parent.name == "block_0"):
        out = out - args[2]
    return out


@functools.lru_cache(maxsize=None)
def _jax_encoder(window_size=14, global_attn=(2, 5, 8, 11), pad_after_norm=False):
    """The JAX image encoder, jitted, with (a) neutralised when asked."""
    enc = jsam.SAMImageEncoder(32, 2, 2, window_size, global_attn)

    def run(params, x):
        if pad_after_norm:
            with nn.intercept_methods(_pad_norm1_output_with_zeros):
                return enc.apply({"params": params["image_encoder"]}, x)
        return enc.apply({"params": params["image_encoder"]}, x)

    return jax.jit(run)


def _jax_decode(params, emb, pts, lbl, dense=True, shift=True, first_residual=True):
    """The JAX decode with (b), (c) and (d) neutralised unless switched off:
    the no-mask embedding added to emb (NHWC), the points shifted by half a
    pixel, block 0's residual taken out."""
    if dense:
        emb = emb + params["prompt_encoder"]["no_mask_embed"][0]
    if shift:
        pts = pts + 0.5
    run = lambda: jsam.Sam(32, 2, 2).apply({"params": params}, emb, pts, lbl, method=jsam.Sam.decode)  # noqa: E731
    if first_residual:
        with nn.intercept_methods(_no_first_residual):
            return run()
    return run()


@functools.lru_cache(maxsize=None)
def _jax_decoder(dense=True, shift=True, first_residual=True):
    return jax.jit(functools.partial(_jax_decode, dense=dense, shift=shift, first_residual=first_residual))


@pytest.fixture(scope="module")
def tiny():
    return _tiny()


def _prompt(B):
    """A positive point, a negative one, a box and the padding point."""
    pts = np.array([[300.0, 410.5], [700.0, 120.0], [100.0, 150.0], [800.0, 900.0], [0.0, 0.0]], np.float32)
    lbl = np.array([1, 0, 2, 3, -1], np.int64)
    return np.repeat(pts[None], B, 0) + np.arange(B, dtype=np.float32)[:, None, None] * 17, np.repeat(lbl[None], B, 0)


def test_window_and_rel_pos_helpers_match_jax(rng):
    """Window partition (the port pads; the JAX package is handed padded
    input) and its inverse; the relative position tables at their own
    length and linearly resized up; the decomposed bias."""
    x = rng.standard_normal((2, 8, 8, 5)).astype(np.float32)
    got, pad_hw = psam._window_partition(torch.from_numpy(x), 6)
    ref = jsam._window_partition(jnp.pad(jnp.asarray(x), ((0, 0), (0, 4), (0, 4), (0, 0))), 6)
    assert pad_hw == (12, 12)
    _close(got, ref, tol=0)
    back = psam._window_unpartition(got, 6, pad_hw, (8, 8))
    assert torch.equal(back, torch.from_numpy(x))
    for n in (15, 9):  # 2 x 8 - 1, and a shorter table resized up to it
        table = rng.standard_normal((n, 4)).astype(np.float32)
        _close(psam._get_rel_pos(8, torch.from_numpy(table)), jsam._get_rel_pos(8, jnp.asarray(table)), tol=1e-6)
    q = rng.standard_normal((3, 48, 4)).astype(np.float32)
    rh, rw = (rng.standard_normal((s, s, 4)).astype(np.float32) for s in (6, 8))
    _close(psam._rel_pos_bias(*(torch.from_numpy(a) for a in (q, rh, rw)), 6, 8),
           jsam._rel_pos_bias(jnp.asarray(rh), jnp.asarray(rw), jnp.asarray(q), 6, 8), tol=1e-6)


@pytest.mark.parametrize("window_size,global_attn", [(14, (2, 5, 8, 11)), (6, (1,))])
def test_encoder_matches_jax(rng, window_size, global_attn):
    """The image encoder with norm1's biases zero, where (a) cannot show:
    both blocks windowed with window 14 (the 8^2 grid padded to 14^2), and
    window 6 (padded to 12^2) then a global block."""
    net, params = _tiny(window_size, global_attn)
    params = _zero_norm1_bias(net, params)
    x = rng.standard_normal((2, 128, 128, 3)).astype(np.float32)
    ref = _jax_encoder(window_size, global_attn)(params, jnp.asarray(x))
    with torch.no_grad():
        got = net.encode(torch.from_numpy(x).permute(0, 3, 1, 2))
    _close(got.permute(0, 2, 3, 1), ref)


@pytest.mark.parametrize("window_size,global_attn", [(14, (2, 5, 8, 11)), (6, (1,))])
def test_window_padding_after_norm1(rng, window_size, global_attn):
    """(a) With nonzero norm1 biases the JAX encoder's padded tokens carry
    the bias into every window's attention and disagree with the port; the
    JAX encoder with norm1's padded outputs zeroed (upstream's padding)
    agrees with it."""
    net, params = _tiny(window_size, global_attn)
    x = rng.standard_normal((1, 128, 128, 3)).astype(np.float32)
    with torch.no_grad():
        got = net.encode(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close(got, _jax_encoder(window_size, global_attn, True)(params, jnp.asarray(x)))
    _far(got, _jax_encoder(window_size, global_attn)(params, jnp.asarray(x)))


def test_decode_matches_jax(rng, tiny):
    """Masks (B, 4, 32, 32) and IoU predictions for a batch of two: points,
    a box and the padding point, with (b), (c) and (d) neutralised."""
    net, params = tiny
    emb = rng.standard_normal((2, 256, GRID, GRID)).astype(np.float32)
    pts, lbl = _prompt(2)
    ref_m, ref_iou = _jax_decoder()(params, jnp.asarray(emb.transpose(0, 2, 3, 1)), jnp.asarray(pts),
                                    jnp.asarray(lbl))
    with torch.no_grad():
        got_m, got_iou = net.decode(torch.from_numpy(emb), torch.from_numpy(pts), torch.from_numpy(lbl))
    assert got_m.shape == (2, 4, 4 * GRID, 4 * GRID)
    _close(got_m, ref_m)
    _close(got_iou, ref_iou)


@pytest.mark.parametrize("divergence", ["dense", "shift", "first_residual"])
def test_decoder_divergences(rng, tiny, divergence):
    """(b) the no-mask dense embedding, (c) the half-pixel shift and (d) the
    residual around block 0's self-attention: each left in place on the JAX
    side, with the other two neutralised, the masks disagree."""
    net, params = tiny
    emb = rng.standard_normal((1, 256, GRID, GRID)).astype(np.float32)
    pts, lbl = _prompt(1)
    ref, _ = _jax_decoder(**{divergence: False})(params, jnp.asarray(emb.transpose(0, 2, 3, 1)), jnp.asarray(pts),
                                                 jnp.asarray(lbl))
    with torch.no_grad():
        got, _ = net.decode(torch.from_numpy(emb), torch.from_numpy(pts), torch.from_numpy(lbl))
    _far(got, ref)


def test_published_global_blocks_and_decoder_eps(monkeypatch, tiny):
    """(e) The port's ViT-L and ViT-H take global attention at their own
    blocks, and a session builds its variant's; the JAX package's ``Sam``
    cannot set them, so every variant keeps ViT-B's (2, 5, 8, 11). (f) The
    two-way transformer's LayerNorms take torch's default eps, 1e-5, where
    the JAX package's take flax's 1e-6 (below the tolerance of the
    comparisons above)."""
    net, _ = tiny
    norms = [m for m in net.mask_decoder.transformer.modules() if isinstance(m, torch.nn.LayerNorm)]
    assert len(norms) == 9 and {m.eps for m in norms} == {1e-5}
    assert {m.eps for m in net.image_encoder.modules() if isinstance(m, torch.nn.LayerNorm)} == {1e-6}
    assert jsam.nn.LayerNorm().epsilon == 1e-6
    assert psam.SAM_SIZES["vit_b"][3] == (2, 5, 8, 11)
    assert psam.SAM_SIZES["vit_l"][3] == (5, 11, 17, 23)
    assert psam.SAM_SIZES["vit_h"][3] == (7, 15, 23, 31)
    assert "global_attn_indexes" not in {f.name for f in dataclasses.fields(jsam.Sam)}
    assert jsam.SAMImageEncoder.global_attn_indexes == (2, 5, 8, 11)
    monkeypatch.setitem(psam.SAM_SIZES, "tiny", (32, 3, 2, (1,)))
    sess = psam.SamSession(variant="tiny", device="cpu")
    assert [b.window_size for b in sess.module.image_encoder.blocks] == [14, 0, 14]


@pytest.mark.parametrize("prompt", [
    [{"type": "point", "data": [10, 20], "label": 1}, {"type": "rectangle", "data": [1, 2, 30, 40]}],
    json.dumps([{"type": "point", "data": [5.5, 6]}, {"type": "point", "data": [7, 8], "label": 0}]),
])
def test_get_input_points_matches_jax(prompt):
    ref, got = jsam.get_input_points(prompt), psam.get_input_points(prompt)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    with pytest.raises(ValueError, match="at least one"):
        psam.get_input_points("[]")


def test_official_state_dict_loads(tiny, tmp_path, monkeypatch):
    """The JAX params bridged to the official names (``sam_params_from_jax``)
    are the port's state dict bitwise and go back to the same JAX params; as
    ``sam_vit_b.pth`` with the official ``mask_downscaling`` entries beside
    them, ``try_load_sam_state_dict`` drops exactly those and the rest loads
    strictly."""
    net, params = tiny
    sd = sam_params_from_jax(jax.tree.map(np.asarray, params))
    own = net.state_dict()
    assert set(sd) == set(own) and all(torch.equal(sd[k], own[k]) for k in sd)
    back = convert_sam_state_dict({k: v.numpy() for k, v in sd.items()})
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)))
    official = dict(sd)
    official["prompt_encoder.mask_downscaling.0.weight"] = torch.zeros(4, 1, 2, 2)
    official["prompt_encoder.mask_downscaling.1.bias"] = torch.zeros(4)
    monkeypatch.setattr(checkpoint, "CHECKPOINT_DIR", str(tmp_path))
    assert checkpoint.try_load_sam_state_dict("vit_b") is None
    torch.save(official, tmp_path / "sam_vit_b.pth")
    loaded = checkpoint.try_load_sam_state_dict("vit_b")
    assert set(official) - set(loaded) == {k for k in official if "mask_downscaling" in k}
    psam.Sam(32, 2, 2, img_size=128).load_state_dict(loaded, strict=True)


@pytest.fixture(scope="module")
def sessions(tiny):
    """The tiny model as a port ``SamSession`` on the CPU and as a JAX
    session at the 1024^2 frame (a 64^2 position table), the JAX encode
    and decode neutralised for (a)-(d)."""
    net, params = tiny
    full = psam.Sam(32, 2, 2)  # the same weights at the 1024^2 frame: a 64^2 position table
    sd = dict(net.state_dict())
    sd["image_encoder.pos_embed"] = sd["image_encoder.pos_embed"].repeat(1, 8, 8, 1)
    full.load_state_dict(sd)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(psam.SAM_SIZES, "tiny", (32, 2, 2, (2, 5, 8, 11)))
        port = psam.SamSession(state_dict=full.state_dict(), variant="tiny", device="cpu")
    jparams = {**params, "image_encoder": {**params["image_encoder"],
                                           "pos_embed": jnp.asarray(sd["image_encoder.pos_embed"].numpy())}}
    jsess = object.__new__(jsam.SamSession)
    jsess.variables = {"params": jparams}

    def encode(v, img):
        with nn.intercept_methods(_pad_norm1_output_with_zeros_1024):
            return jsam.SAMImageEncoder(32, 2, 2).apply({"params": v["params"]["image_encoder"]}, img)

    jsess._encode = jax.jit(encode)
    jsess._decode = lambda v, emb, pts, lbl: _jax_decoder()(v["params"], emb, pts, lbl)
    return port, jsess


def _mask_agrees(got, ref, share=0.01):
    """8-bit masks that agree but where a mask logit lies within float
    noise of 0: at most ``share`` of the pixels more than 1 apart."""
    diff = np.abs(np.asarray(got).astype(int) - np.asarray(ref).astype(int))
    assert (diff > 1).mean() <= share, (diff > 1).mean()


def test_session_predict_matches_jax(sessions):
    """``SamSession.predict`` on a 96 x 80 image with a point and a box:
    the same 1024^2 canvas, prompt scaling and padding point, best-IoU mask
    and resizes as the JAX session, whose encode and decode are neutralised
    for (a)-(d). The 8-bit masks agree but where a mask logit lies within
    float noise of 0."""
    port, jsess = sessions
    img = Image.fromarray((np.random.default_rng(7).random((80, 96, 3)) * 255).astype(np.uint8))
    prompt = [{"type": "point", "data": [40, 30], "label": 1}, {"type": "rectangle", "data": [10, 5, 90, 70]}]
    ref, got = jsess.predict(img, sam_prompt=prompt), port.predict(img, sam_prompt=prompt)
    assert len(got) == len(ref) == 1 and got[0].size == ref[0].size == (96, 80)
    _mask_agrees(got[0], ref[0])


# -- the SAM cutout helpers of frontend/preprocess.py --

BBOX = (70.5, 50.0, 119.0, 95.0)  # its mask leaves ~5 % of the image out


def _cutout_image():
    """A seeded 120 x 96 RGB image: noise under a bright disc."""
    rng = np.random.default_rng(11)
    img = rng.random((96, 120, 3)) * 120
    yy, xx = np.mgrid[:96, :120]
    img[(yy - 46) ** 2 + (xx - 58) ** 2 < 30**2] += 130
    return img.clip(0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def jax_cutout(sessions):
    from sculptmate_tpu.frontend.preprocess import sam_segment as j_segment

    return j_segment(Image.fromarray(_cutout_image()), BBOX, session=sessions[1])


def test_sam_segment_matches_jax(sessions, jax_cutout):
    """The port's ``sam_segment`` on a PIL image against the JAX
    package's, on the same seeded tiny SAM with (a)-(d) neutralised on the
    JAX side (the box corners take the half-pixel shift of (c) too): an
    RGBA image of the input's size, the RGB equal, the SAM mask as alpha
    agreeing as ``predict``'s does."""
    from sculptmate_tpu_torch.frontend.preprocess import sam_segment

    got = sam_segment(Image.fromarray(_cutout_image()), BBOX, session=sessions[0])
    assert got.mode == jax_cutout.mode == "RGBA" and got.size == jax_cutout.size == (120, 96)
    g, r = np.asarray(got), np.asarray(jax_cutout)
    assert np.array_equal(g[..., :3], r[..., :3])
    assert 0.02 < (r[..., 3] < 128).mean() < 0.98
    _mask_agrees(g[..., 3], r[..., 3])


def test_sam_segment_without_pil_matches_jax(sessions, jax_cutout, monkeypatch):
    """On an (H, W, 4) uint8 array ``sam_segment`` runs with no PIL
    (``SamSession.predict_rgb``: the resizes in f32 on the session's
    device): an (H, W, 4) array, the RGB the input's, the alpha the JAX
    package's within PIL's fixed-point rounding (at most 1 % of the pixels
    more than 1 apart)."""
    import sys

    from sculptmate_tpu_torch.frontend.preprocess import sam_segment

    rgba = np.concatenate([_cutout_image(), np.full((96, 120, 1), 7, np.uint8)], axis=-1)
    with monkeypatch.context() as mp:
        mp.setitem(sys.modules, "PIL", None)
        got = sam_segment(rgba, BBOX, session=sessions[0])
    assert got.dtype == np.uint8 and got.shape == (96, 120, 4)
    assert np.array_equal(got[..., :3], rgba[..., :3])
    _mask_agrees(got[..., 3], np.asarray(jax_cutout)[..., 3])


def _rgba_image(seed, empty=False):
    """A seeded 150 x 130 RGBA image: noise, its alpha a soft blob (values
    0..255, some 1 and 2 at the rim), or zero."""
    rng = np.random.default_rng(seed)
    arr = (rng.random((150, 130, 4)) * 255).astype(np.uint8)
    yy, xx = np.mgrid[:150, :130]
    r = np.sqrt((yy - 70.0) ** 2 / 1.6 + (xx - 52.0) ** 2)
    arr[..., 3] = 0 if empty else np.clip(255 * (40 - r) / 8, 0, 255).astype(np.uint8)
    if not empty:
        arr[66:70, 90:93, 3] = (1, 2, 1)  # alpha 1 is not foreground, 2 is
    return Image.fromarray(arr, mode="RGBA")


@pytest.mark.parametrize("lower_contrast,rescale,empty", [(True, True, False), (False, True, False),
                                                           (True, False, False), (True, True, True)])
def test_image_preprocess_sam_matches_jax(lower_contrast, rescale, empty):
    """``image_preprocess_sam`` byte-equal to the JAX package's on a
    seeded RGBA image, with and without the contrast lowering and the
    rescale, and on an empty alpha; the same scale."""
    from sculptmate_tpu.frontend.preprocess import image_preprocess_sam as j_pre
    from sculptmate_tpu_torch.frontend.preprocess import image_preprocess_sam

    img = _rgba_image(3, empty)
    got, scale = image_preprocess_sam(img, lower_contrast=lower_contrast, rescale=rescale)
    ref, jscale = j_pre(img, lower_contrast=lower_contrast, rescale=rescale)
    assert got.mode == ref.mode == "RGB" and got.size == ref.size
    assert got.size == ((130, 150) if empty else (1024, 1024))
    assert np.array_equal(np.asarray(got), np.asarray(ref)) and scale == jscale


def _pad_norm1_output_with_zeros_1024(next_fun, args, kwargs, context):
    """(a) at the 1024^2 frame (a 64^2 grid padded to 70^2)."""
    out = next_fun(*args, **kwargs)
    m = context.module
    if (context.method_name == "__call__" and m.name == "norm1" and isinstance(m.parent, jsam.SAMBlock)
            and out.shape[1] > 64):
        keep = jnp.arange(out.shape[1]) < 64
        out = out * keep[None, :, None, None] * keep[None, None, :, None]
    return out
