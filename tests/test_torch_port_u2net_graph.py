"""The u2net recipe (``SessionBase._predict``) as a replayed CUDA graph on
the card, against the same recipe launched op by op (``_predict_eager``),
and the CPU session, which stays eager.

The card tests import no JAX, so the card's machine runs them without the
suite's conftest:
``python -m pytest --noconftest -m cuda tests/test_torch_port_u2net_graph.py``.
The CPU test imports the JAX package inside its body."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sculptmate_tpu_torch.frontend.matting import U2NET_SIZE, U2NetMatting
from sculptmate_tpu_torch.frontend.sessions import U2netpSession

SESSIONS = {"u2net": U2NetMatting, "u2netp": U2netpSession}
SPANS = ("matting.u2net", "matting.u2net_capture", "matting.u2net_replay")


def _seeded(net, seed):
    """Seeded weights, then every BatchNorm's scale, bias and running
    statistics redrawn: at their defaults a wrong read of them would pass."""
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


def _weights(name, seed):
    cls = SESSIONS[name]
    return _seeded(cls(device="cpu").module, seed).state_dict()


def _session(name, device, seed=5):
    return SESSIONS[name](state_dict=_weights(name, seed), device=device)


def _images(batch, seed, device, size=U2NET_SIZE):
    g = torch.Generator().manual_seed(seed)
    imgs = torch.rand((batch, size, size, 3), generator=g)
    imgs[1::2] *= 0.5  # the per-image /max
    return imgs.to(device)


def _span_counts(fn):
    """``fn()``'s result and how often it opened each of ``SPANS``."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    names = [e.name for e in prof.events()]
    return out, {s: names.count(s) for s in SPANS}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("name", sorted(SESSIONS))
def test_replay_equals_eager(name, batch):
    """The capture's own call and a replay give the eager masks bit for
    bit; two masks held at once are each their own input's (no replay
    writes into a mask already returned); the capture opens its span once,
    every call a replay span."""
    _card()
    sess = _session(name, "cuda")
    a, b = _images(batch, 1, "cuda"), _images(batch, 2, "cuda")
    eager_a, eager_b = sess._predict_eager(a), sess._predict_eager(b)
    assert not torch.equal(eager_a, eager_b)
    got_a, spans = _span_counts(lambda: sess.predict_mask_batch(a))
    assert spans == {"matting.u2net": 1, "matting.u2net_capture": 1, "matting.u2net_replay": 1}
    got_b, spans = _span_counts(lambda: sess.predict_mask_batch(b))
    assert spans == {"matting.u2net": 1, "matting.u2net_capture": 0, "matting.u2net_replay": 1}
    again_a = sess.predict_mask_batch(a)
    assert got_a.shape == (batch, U2NET_SIZE, U2NET_SIZE)
    assert torch.equal(got_a, eager_a) and torch.equal(got_b, eager_b) and torch.equal(again_a, eager_a)
    assert len({got_a.data_ptr(), got_b.data_ptr(), again_a.data_ptr()}) == 3
    assert len(sess._graphs) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SESSIONS))
def test_predict_mask_device_equals_eager(name, monkeypatch):
    """``predict_mask_device``'s uint8 mask and bbox on a 640 x 480 photo,
    replayed, equal those of the eager recipe."""
    _card()
    sess = _session(name, "cuda")
    photo = (255 * _images(1, 3, "cpu", 640)[0, :480]).to(torch.uint8).cuda()
    mask, bbox = sess.predict_mask_device(photo)
    mask2, bbox2 = sess.predict_mask_device(photo)
    assert len(sess._graphs) == 1
    monkeypatch.setattr(sess, "_predict", sess._predict_eager)
    want, want_bbox = sess.predict_mask_device(photo)
    assert mask.shape == (480, 640) and mask.dtype == torch.uint8
    assert torch.equal(mask, want) and torch.equal(bbox, want_bbox)
    assert torch.equal(mask2, want) and torch.equal(bbox2, want_bbox)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SESSIONS))
def test_each_shape_captures_its_own_graph(name):
    """B = 1, then B = 8: a second graph; B = 1 again replays the first with
    no new capture, still equal to the eager masks."""
    _card()
    sess = _session(name, "cuda")
    one, eight = _images(1, 4, "cuda"), _images(8, 5, "cuda")
    first = sess.predict_mask_batch(one)
    assert torch.equal(sess.predict_mask_batch(eight), sess._predict_eager(eight))
    assert len(sess._graphs) == 2
    got, spans = _span_counts(lambda: sess.predict_mask_batch(one))
    assert spans["matting.u2net_capture"] == 0 and spans["matting.u2net_replay"] == 1
    assert torch.equal(got, sess._predict_eager(one)) and torch.equal(got, first)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SESSIONS))
def test_weights_loaded_in_place_reach_the_replay(name):
    """``load_state_dict`` after a capture: the next replay gives the new
    weights' masks, as the eager recipe does, with no new capture."""
    _card()
    sess = _session(name, "cuda")
    imgs = _images(1, 6, "cuda")
    before = sess.predict_mask_batch(imgs)
    sess.module.load_state_dict(_weights(name, 7))
    after = sess.predict_mask_batch(imgs)
    assert not torch.equal(after, before)
    assert torch.equal(after, sess._predict_eager(imgs))
    assert len(sess._graphs) == 1


@pytest.mark.cuda
def test_inside_a_capture_the_recipe_is_eager():
    """Called while another CUDA graph captures (``chip_smoke.cuda_ms``
    times a session so), the recipe is captured op by op into that graph:
    no graph of the session's own, and the outer replay gives the eager
    masks."""
    _card()
    sess = _session("u2netp", "cuda")
    imgs = _images(1, 8, "cuda")
    want = sess._predict_eager(imgs)
    torch.cuda.synchronize()
    outer = torch.cuda.CUDAGraph()
    with torch.cuda.graph(outer):
        got = sess.predict_mask_batch(imgs)
    outer.replay()
    torch.cuda.synchronize()
    assert sess._graphs == {} and torch.equal(got, want)


def test_cpu_session_stays_eager(monkeypatch):
    """A CPU session opens no capture or replay span and makes no graph
    (a capture would raise here); its masks are the eager recipe's, bit for
    bit, and within 1e-5 of the JAX u2netp's on the same weights."""
    import jax.numpy as jnp

    from sculptmate_tpu.frontend import sessions as jsessions
    from sculptmate_tpu.runtime.checkpoint import convert_u2net_state_dict

    sess = _session("u2netp", "cpu")
    monkeypatch.setattr(sess, "_capture", lambda img: pytest.fail("a CPU session captured a graph"))
    imgs = _images(2, 9, "cpu", 64)
    got, spans = _span_counts(lambda: sess.predict_mask_batch(imgs))
    assert spans == {"matting.u2net": 1, "matting.u2net_capture": 0, "matting.u2net_replay": 0}
    assert sess._graphs == {} and got.shape == (2, 64, 64)
    assert torch.equal(got, sess._predict_eager(imgs))
    sd = {k: v.numpy() for k, v in sess.module.state_dict().items() if not k.endswith("num_batches_tracked")}
    jsess = jsessions.U2netpSession(params=convert_u2net_state_dict(sd))
    ref = np.asarray(jsess._predict(jsess.variables, jnp.asarray(imgs.numpy())))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
