"""Port parity for the session zoo: ISNet, the session registry, the cloth
session and ``remove(session_name=...)`` of ``sculptmate_tpu_torch.frontend``
against ``sculptmate_tpu.frontend`` on the same weights and numpy inputs
(CPU, f32). Network outputs within 1e-4 of max |ref|.

The weights are seeded in the port and handed to the JAX package through
its own converters (``convert_isnet_state_dict``, ``convert_u2net_state_dict``,
or an ONNX file both packages read), which compile nothing; a JAX ``init``
would compile the whole network's forward once more."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from sculptmate_tpu.frontend import matting as jmatting
from sculptmate_tpu.frontend import sessions as jsessions
from sculptmate_tpu.frontend.isnet import ISNet as JISNet
from sculptmate_tpu.runtime import checkpoint as jcheckpoint
from sculptmate_tpu.runtime.checkpoint import convert_isnet_onnx, convert_isnet_state_dict, convert_u2net_state_dict
from sculptmate_tpu_torch.frontend import matting, sessions
from sculptmate_tpu_torch.frontend.isnet import ISNet
from sculptmate_tpu_torch.frontend.u2net import U2Net
from sculptmate_tpu_torch.runtime import checkpoint
from sculptmate_tpu_torch.runtime.checkpoint import isnet_params_from_jax, u2net_params_from_jax


def _seeded(net, seed):
    """Seeded weights, then every BatchNorm's scale, bias and running
    statistics redrawn (numpy seed ``seed``): at their defaults (1, 0, 0, 1)
    a swapped mean and variance would pass."""
    net.reset_parameters(torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32)))
                m.bias.copy_(torch.from_numpy(0.1 * rng.standard_normal(n).astype(np.float32)))
                m.running_mean.copy_(torch.from_numpy(0.1 * rng.standard_normal(n).astype(np.float32)))
                m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32)))
    return net.eval()


def _numpy_sd(net):
    return {k: v.numpy() for k, v in net.state_dict().items() if not k.endswith("num_batches_tracked")}


@pytest.fixture(scope="module")
def isnet():
    """The port's ISNet (seed 3, random BatchNorm), its JAX variables, a 64^2
    input and the JAX network's (d1, sides) on it."""
    net = _seeded(ISNet(), 3)
    variables = convert_isnet_state_dict(_numpy_sd(net))
    x = np.random.default_rng(3).standard_normal((1, 64, 64, 3)).astype(np.float32)
    ref = jax.jit(JISNet().apply)(variables, jnp.asarray(x))
    return net, variables, x, ref


def _close(got, ref, tol=1e-4):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= tol * scale, f"max |err| {err} > {tol} * {scale}"


def test_isnet_matches_jax(isnet):
    """Full widths on a 64^2 input: d1 and all six side outputs; the JAX
    variables bridged back by ``isnet_params_from_jax`` are the port's
    state dict, bitwise, under the ISNetDIS names."""
    net, variables, x, (d1, sides) = isnet
    with torch.no_grad():
        g1, gsides = net(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(gsides) == len(sides) == 6
    for got, ref in [(g1, d1)] + list(zip(gsides, sides)):
        _close(got, np.asarray(ref).transpose(0, 3, 1, 2))
    back = isnet_params_from_jax(jax.tree.map(np.asarray, variables))
    own = net.state_dict()
    assert "conv_in.conv.weight" in back and "conv_in.bn.running_var" in back
    assert set(back) == {k for k in own if not k.endswith("num_batches_tracked")}
    assert all(torch.equal(back[k], own[k]) for k in back)


def test_isnet_onnx_loads_as_jax(isnet, tmp_path, monkeypatch):
    """An ``isnet-anime.onnx`` (the network's initializers under the ISNetDIS
    names, plus a graph constant) read by ``try_load_session_state_dict``
    gives the output the JAX ``convert_isnet_onnx`` gives."""
    from test_onnx_lite import write_onnx

    net, _, x, (d1, _) = isnet
    monkeypatch.setattr(checkpoint, "CHECKPOINT_DIR", str(tmp_path))
    assert checkpoint.try_load_session_state_dict("isnet-anime") is None
    tensors = _numpy_sd(net)
    tensors["onnx::Resize_1"] = np.array([1.0, 1.0, 2.0, 2.0], np.float32)
    write_onnx(tmp_path / "isnet-anime.onnx", tensors)
    loaded = ISNet()
    loaded.load_state_dict(checkpoint.try_load_session_state_dict("dis_anime"))
    variables = convert_isnet_onnx(str(tmp_path / "isnet-anime.onnx"))
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(variables),
                                                     jax.tree.leaves(convert_isnet_state_dict(_numpy_sd(net)))))
    with torch.no_grad():
        got = loaded.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))[0]
    _close(got, np.asarray(d1).transpose(0, 3, 1, 2))


def _network(module):
    """(class name, U2Net variant, output channels) of a flax or torch
    matting network."""
    if type(module).__name__ == "U2Net":
        return "U2Net", module.variant, module.out_channels
    return type(module).__name__, None, None


@pytest.mark.parametrize("name", sorted(jsessions._REGISTRY))
def test_registry_matches_jax(name):
    """Every registry name: the same input size, normalisation and network
    (class, u2net widths, output channels), and the same weights file."""
    jcls, pcls = jsessions._REGISTRY[name], sessions._REGISTRY[name]
    assert tuple(pcls.input_size) == tuple(jcls.input_size)
    assert tuple(pcls.mean) == tuple(jcls.mean) and tuple(pcls.std) == tuple(jcls.std)
    jnet = jcls.build_module(object.__new__(jcls))
    pnet = pcls.build_module(object.__new__(pcls))
    assert _network(pnet) == _network(jnet)
    assert pcls.weights_file == jcheckpoint._SESSION_WEIGHTS[name][0]
    assert set(sessions._REGISTRY) == set(jsessions._REGISTRY)


def test_new_session_refuses_unknown_names():
    with pytest.raises(ValueError, match="unknown session 'nope'"):
        sessions.new_session("nope", device="cpu")


def test_default_session_is_the_registry_u2net(tmp_path, monkeypatch):
    """One u2net path: ``default_session``, ``new_session("u2net")`` and its
    alias ``u2net_custom`` give the same ``U2NetMatting`` object on a
    device, and ``try_load_u2net_state_dict`` reads the registry's blob."""
    monkeypatch.setattr(checkpoint, "CHECKPOINT_DIR", str(tmp_path))
    sessions.new_session.cache_clear()
    try:
        s = matting.default_session("cpu")
        assert type(s) is matting.U2NetMatting
        assert sessions.new_session("u2net", device="cpu") is s
        assert sessions.new_session("u2net_custom", torch.device("cpu")) is s
        assert checkpoint.try_load_u2net_state_dict() is None
        assert checkpoint.try_load_session_state_dict("nope") is None
    finally:
        sessions.new_session.cache_clear()


class _JCloth(jsessions.ClothSegSession):
    input_size = (64, 64)


class _Cloth(sessions.ClothSegSession):
    input_size = (64, 64)


@pytest.fixture(scope="module")
def cloth():
    """The cloth network (seed 4, random BatchNorm, its output biases set so
    that each class's mean logit on the test image is 0, so every class wins
    somewhere) as a JAX and a port session at 64^2, the JAX variables and
    the test image."""
    net = _seeded(U2Net(out_channels=4), 4)
    imgs = np.random.default_rng(4).random((1, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        d0 = _Cloth(state_dict=net.state_dict(), device="cpu")._logits(torch.from_numpy(imgs))
        net.outconv.bias.sub_(d0.mean(dim=(0, 2, 3)))
    variables = convert_u2net_state_dict(_numpy_sd(net))
    return _JCloth(params=variables), _Cloth(state_dict=net.state_dict(), device="cpu"), variables, imgs


def test_cloth_seg_matches_jax(cloth):
    """The class map (argmax of d0's log-softmax) of a 64^2 image, equal to
    the JAX one, and the PIL masks: all three without a category, one with
    ``cc`` or ``cloth_category``, byte-equal. The four-channel head bridges
    back through ``u2net_params_from_jax`` bitwise."""
    jsess, psess, variables, imgs = cloth
    back = u2net_params_from_jax(jax.tree.map(np.asarray, variables))
    own = psess.module.state_dict()
    assert back["outconv.weight"].shape == (4, 24, 1, 1)
    assert all(torch.equal(back[k], own[k]) for k in back)
    ref = np.asarray(jsess._predict(jsess.variables, jnp.asarray(imgs)))
    got = psess.predict_classes_batch(torch.from_numpy(imgs)).numpy()
    assert got.shape == (1, 64, 64) and np.array_equal(got, ref)
    assert set(np.unique(got)) == {0, 1, 2, 3}
    np.testing.assert_array_equal(psess.predict_mask_batch(torch.from_numpy(imgs)).numpy(), got == 1)
    img = Image.fromarray((imgs[0] * 255).astype(np.uint8)).resize((50, 40))
    for kwargs, n in (({}, 3), ({"cc": "lower"}, 1), ({"cloth_category": "full"}, 1), ({"cc": "hat"}, 3)):
        want, have = jsess.predict(img, **kwargs), psess.predict(img, **kwargs)
        assert len(have) == len(want) == n
        for w, h in zip(want, have):
            assert h.size == (50, 40) and np.array_equal(np.asarray(h), np.asarray(w))


def test_remove_by_session_name_matches_jax(tmp_path, monkeypatch):
    """``remove(img, session_name="u2netp")`` in both packages, each reading
    the same seeded ``u2netp.onnx`` from its checkpoint directory through
    its own ``new_session``: the same cutout within one level of the 8-bit
    mask (the masks agree to ~1e-6 before rounding)."""
    from test_onnx_lite import write_onnx

    net = _seeded(U2Net("small"), 5)
    write_onnx(tmp_path / "u2netp.onnx", _numpy_sd(net))
    monkeypatch.setattr(checkpoint, "CHECKPOINT_DIR", str(tmp_path))
    monkeypatch.setattr(jcheckpoint, "CHECKPOINT_DIR", str(tmp_path))
    jsessions.new_session.cache_clear()
    sessions.new_session.cache_clear()
    try:
        rng = np.random.default_rng(5)
        img = Image.fromarray((rng.random((48, 40, 3)) * 255).astype(np.uint8))
        ref = np.asarray(jmatting.remove(img, session_name="u2netp")).astype(np.int16)
        got = np.asarray(matting.remove(img, session_name="u2netp", device="cpu")).astype(np.int16)
        assert isinstance(sessions.new_session("u2netp", device="cpu"), sessions.U2netpSession)
        assert got.shape == ref.shape == (48, 40, 4)
        assert np.abs(got - ref).max() <= 1
    finally:
        jsessions.new_session.cache_clear()
        sessions.new_session.cache_clear()
