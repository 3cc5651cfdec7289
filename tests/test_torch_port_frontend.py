"""Port parity: the frontend slice (dynamic-window resample, fused and host
preprocessing, u2net, matting, the u2net weight bridge and its ONNX loader)
against the JAX package, on the CPU in f32, on the same seeded inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from sculptmate_tpu.frontend import matting as jmatting
from sculptmate_tpu.frontend import preprocess as jpre
from sculptmate_tpu.frontend.u2net import U2Net as JU2Net
from sculptmate_tpu.ops import warp as jwarp
from sculptmate_tpu.runtime.checkpoint import convert_u2net_onnx, convert_u2net_state_dict
from sculptmate_tpu_torch.frontend import matting, preprocess
from sculptmate_tpu_torch.frontend.u2net import U2Net
from sculptmate_tpu_torch.ops import warp
from sculptmate_tpu_torch.runtime import checkpoint
from sculptmate_tpu_torch.runtime.checkpoint import u2net_params_from_jax


@pytest.fixture(scope="module")
def jax_u2net():
    """One JAX u2net per variant, built on first use: (module, variables).
    The full variant's variables are those of a JAX ``U2NetMatting``."""
    made = {}

    def get(variant):
        if variant not in made:
            if variant == "full":
                jm = jmatting.U2NetMatting(seed=0)
                made[variant] = (jm.module, jm.variables, jm)
            else:
                module = JU2Net(variant=variant)
                v = jax.jit(module.init)(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3), jnp.float32))
                made[variant] = (module, v, None)
        return made[variant]

    return get


def _port_u2net(variant, variables):
    net = U2Net(variant)
    net.load_state_dict(u2net_params_from_jax(jax.tree.map(np.asarray, variables)))
    return net.eval()


# (src, out, start, stop): downscale, upscale, a window partly outside the
# image on both sides, and one past its end
WINDOWS = [(64, 24, 3.5, 60.25), (20, 48, 2.0, 17.5), (40, 32, -9.75, 52.5), (30, 16, 22.0, 41.0)]


@pytest.mark.parametrize("method", ["lanczos3", "linear"])
@pytest.mark.parametrize("src,out,start,stop", WINDOWS)
def test_resample_matrix_matches_jax(method, src, out, start, stop):
    """The (out, src) matrix within 1e-6 of the JAX one, and the batched
    form (one window per image) equal to the single ones."""
    ref = np.asarray(jwarp.resample_matrix(src, out, jnp.float32(start), jnp.float32(stop), method))
    got = warp.resample_matrix(src, out, start, stop, method).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    starts = torch.tensor([start, start + 1.25])
    stops = torch.tensor([stop, stop - 0.5])
    batched = warp.resample_matrix(src, out, starts, stops, method)
    for b in range(2):
        single = warp.resample_matrix(src, out, float(starts[b]), float(stops[b]), method)
        assert torch.equal(batched[b], single)


def _rgba_pair(rng, H=48, W=40):
    """Two RGBA images with different alpha bboxes (one touching an edge)."""
    rgba = rng.random((2, H, W, 4)).astype(np.float32)
    rgba[..., 3] = 0.0
    rgba[0, 10:30, 6:22, 3] = rng.random((20, 16)).astype(np.float32) * 0.9 + 0.1
    rgba[1, 2:47, 25:40, 3] = 1.0
    return rgba


@pytest.mark.parametrize("ratio,out_size", [(0.75, 32), (0.85, 56)])
def test_preprocess_batch_device_matches_jax(rng, ratio, out_size):
    """The fused crop/pad/Lanczos preprocess on B = 2 images with different
    bboxes, within 1e-5; the one-image form agrees."""
    rgba = _rgba_pair(rng)
    ref = np.asarray(jpre.preprocess_batch_device(jnp.asarray(rgba), ratio=ratio, out_size=out_size))
    got = preprocess.preprocess_batch_device(torch.from_numpy(rgba), ratio=ratio, out_size=out_size)
    assert got.shape == (2, out_size, out_size, 3)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
    one = preprocess.preprocess_device_one(torch.from_numpy(rgba[1]), ratio=ratio, out_size=out_size)
    np.testing.assert_allclose(one.numpy(), ref[1], rtol=0, atol=1e-5)


class _FakeSession:
    """Stub matting session: alpha = luminance threshold (deterministic)."""

    def predict_mask(self, image):
        arr = np.asarray(image.convert("L"))
        return Image.fromarray(np.where(arr > 40, 255, 0).astype(np.uint8), mode="L")


def _test_image(size, box):
    img = np.zeros((size, size, 3), np.uint8)
    y0, y1, x0, x1 = box
    img[y0:y1, x0:x1] = (200, 80, 50)
    return Image.fromarray(img)


@pytest.mark.parametrize(
    "size,box,ratio,use_alpha",
    [
        (300, (80, 220, 60, 260), 0.75, False),
        (300, (80, 220, 60, 260), 0.85, True),
        (300, (100, 140, 100, 160), 0.75, False),  # too small: rejected (None)
    ],
)
def test_preprocess_image_matches_jax(size, box, ratio, use_alpha):
    """The host path with a stub session: byte-equal to the JAX output."""
    img = _test_image(size, box)
    ref = jpre.preprocess_image(img, ratio=ratio, use_alpha=use_alpha, session=_FakeSession())
    got = preprocess.preprocess_image(img, ratio=ratio, use_alpha=use_alpha, session=_FakeSession())
    if ref is None:
        assert got is None
        return
    assert got.mode == ref.mode and got.size == ref.size
    assert np.array_equal(np.asarray(got), np.asarray(ref))


@pytest.mark.parametrize("variant,size", [("small", 64), ("small", 72), ("full", 64)])
def test_u2net_matches_jax(jax_u2net, rng, variant, size):
    """d0 and every side output within 1e-4 of max |.| of the JAX output.
    72^2 pins the flooring max pool (72 -> 36 -> 18 -> 9 -> 4 -> 2 -> 1)."""
    module, variables, _ = jax_u2net(variant)
    x = rng.standard_normal((1, size, size, 3)).astype(np.float32)
    d0, sides = module.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        g0, gsides = _port_u2net(variant, variables)(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(gsides) == len(sides) == 6
    for ref, got in [(d0, g0)] + list(zip(sides, gsides)):
        ref = np.asarray(ref).transpose(0, 3, 1, 2)
        assert got.shape == ref.shape
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4 * np.abs(ref).max())


def test_predict_mask_batch_matches_jax(jax_u2net, rng):
    """The full u2net's masks on B = 2 images at 320^2, within 1e-5."""
    _, variables, jm = jax_u2net("full")
    port = matting.U2NetMatting(state_dict=u2net_params_from_jax(jax.tree.map(np.asarray, variables)), device="cpu")
    imgs = rng.random((2, matting.U2NET_SIZE, matting.U2NET_SIZE, 3)).astype(np.float32)
    imgs[1] *= 0.5  # the per-image /max
    ref = np.asarray(jm.predict_mask_batch(jnp.asarray(imgs)))
    got = port.predict_mask_batch(torch.from_numpy(imgs))
    assert got.shape == (2, 320, 320)
    assert float(got.min()) == 0.0 and float(got.max()) == pytest.approx(1.0)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


def test_u2net_weight_bridge_round_trip(jax_u2net):
    """flax variables -> the port's state dict -> the JAX package's
    ``convert_u2net_state_dict``: the same tree, bitwise; the state dict
    loads strictly."""
    _, variables, _ = jax_u2net("full")
    variables = jax.tree.map(np.asarray, variables)
    sd = u2net_params_from_jax(variables)
    U2Net("full").load_state_dict(sd)
    back = convert_u2net_state_dict({k: v.numpy() for k, v in sd.items()})
    flat_a = jax.tree_util.tree_flatten_with_path(variables)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        assert np.array_equal(a, flat_b[path]), path


def test_onnx_loader_matches_jax(jax_u2net, tmp_path, monkeypatch, rng):
    """A synthetic u2net.onnx (its initializers under the original names,
    plus a graph constant) read by ``try_load_u2net_state_dict`` gives the
    same network output as the JAX ``convert_u2net_onnx`` path; without the
    file it returns None."""
    from test_onnx_lite import write_onnx

    monkeypatch.setattr(checkpoint, "CHECKPOINT_DIR", str(tmp_path))
    assert checkpoint.try_load_u2net_state_dict() is None
    module, variables, _ = jax_u2net("small")
    tensors = {k: v.numpy() for k, v in u2net_params_from_jax(jax.tree.map(np.asarray, variables)).items()}
    tensors["onnx::Resize_1"] = np.array([1.0, 1.0, 2.0, 2.0], np.float32)
    write_onnx(tmp_path / "u2net.onnx", tensors)

    sd = checkpoint.try_load_u2net_state_dict()
    assert "onnx::Resize_1" not in sd
    net = U2Net("small")
    net.load_state_dict(sd)
    x = rng.standard_normal((1, 32, 32, 3)).astype(np.float32)
    ref = np.asarray(module.apply(convert_u2net_onnx(str(tmp_path / "u2net.onnx")), jnp.asarray(x))[0])
    with torch.no_grad():
        got = net.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))[0].numpy()
    np.testing.assert_allclose(got, ref.transpose(0, 3, 1, 2), rtol=0, atol=1e-4 * np.abs(ref).max())


class _GraySession:
    """Stub session with a partial-alpha mask."""

    def predict_mask(self, image):
        w, h = image.size
        mask = np.zeros((h, w), np.uint8)
        mask[: h // 2] = 255
        mask[h // 2 :] = 100
        return Image.fromarray(mask, mode="L")


class _ThreeMaskSession:
    """Stub multi-mask session: three horizontal bands."""

    def predict(self, image, **kwargs):
        w, h = image.size
        masks = []
        for third in range(3):
            m = np.zeros((h, w), np.uint8)
            m[third * h // 3 : (third + 1) * h // 3] = 255
            masks.append(Image.fromarray(m, mode="L"))
        return masks


@pytest.mark.parametrize(
    "session,kwargs",
    [
        (_GraySession, {}),
        (_GraySession, {"putalpha": True}),
        (_GraySession, {"only_mask": True, "bgcolor": (0, 255, 0, 255)}),
        (_GraySession, {"bgcolor": (0, 255, 0, 255)}),
        (_GraySession, {"post_process": True}),
        (_ThreeMaskSession, {}),
        (_ThreeMaskSession, {"only_mask": True}),
        (_ThreeMaskSession, {"bgcolor": (255, 0, 0, 255)}),
    ],
)
def test_remove_matches_jax(session, kwargs):
    """``remove`` option for option, byte-equal to the JAX package's."""
    img = Image.fromarray(np.full((9, 6, 3), (200, 80, 50), np.uint8))
    ref = jmatting.remove(img, session=session(), **kwargs)
    got = matting.remove(img, session=session(), **kwargs)
    assert got.mode == ref.mode and got.size == ref.size
    assert np.array_equal(np.asarray(got), np.asarray(ref))


def test_remove_refuses_unported_sessions():
    img = Image.fromarray(np.zeros((4, 4, 3), np.uint8))
    with pytest.raises(NotImplementedError, match="item 13"):
        matting.remove(img, session_name="isnet-anime")
