"""Port parity of the novel-view slice on the CPU: the plain version of
kernel K4 (the scattered triplane query) and its packing, the cameras and
rays, ``TSR.render_views`` and the ``render`` command line, each against the
JAX package on the same seeded inputs and weights."""

import json
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from sculptmate_tpu.ops import rays as jrays
from sculptmate_tpu.ops.density_grid import DensityGridSpec as JSpec
from sculptmate_tpu.ops.density_grid import query_triplane_points as j_query
from sculptmate_tpu.systems.tsr import TSR as JTSR
from sculptmate_tpu.systems.tsr import TSRConfig as JTSRConfig
from sculptmate_tpu_torch.ops import density_grid as dg
from sculptmate_tpu_torch.ops import rays
from sculptmate_tpu_torch.ops.grid_sample import sample_triplane
from sculptmate_tpu_torch.runtime.checkpoint import tsr_params_from_jax
from sculptmate_tpu_torch.systems.tsr import TSR, TSRConfig

SMALL = dict(
    cond_image_size=64, plane_size=8, num_channels=64, num_attention_heads=4,
    attention_head_dim=16, num_layers=2, cross_attention_dim=64, vit_hidden_size=64,
    vit_num_layers=2, vit_num_heads=4, vit_intermediate_size=128,
)
LAYERS = [(120, 64)] + [(64, 64)] * 8 + [(64, 4)]  # TripoSR's decoder
K4_MODEL_SHARE = 0.05  # see test_triplane_tanh_model_matches_plain
# At the fan-in scale K4 is held to twice the plain bf16 version's own error:
# see _plain_noise
K4_NOISE_FACTOR = 2.0


def _decoder(rng):
    """Fan-in normal weights and N(0, 0.5) biases (a checkpoint's are not
    zero), as (kernel (in, out), bias) numpy pairs."""
    return [(rng.standard_normal((i, o)).astype(np.float32) / np.sqrt(i),
             0.5 * rng.standard_normal(o).astype(np.float32)) for i, o in LAYERS]


def _points(rng, n, radius):
    """Flat world coords, a tenth of them outside the box (zero-padding taps)."""
    return [(rng.uniform(-1.1, 1.1, n) * radius).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_triplane_points_plain_matches_jax(dtype):
    """K4's plain version against ``query_triplane_points`` on (3, 40, 24,
    20) planes and 3000 points. f32: within 2e-5 of each output's largest
    value (sum order only). bf16: within 2^-6 of each output's largest value
    (four bf16 ulps at most): the two frameworks round the bf16 products at
    other places, and the output layer is itself rounded to bf16."""
    rng = np.random.default_rng(0)
    planes = rng.standard_normal((3, 40, 24, 20)).astype(np.float32)
    w = _decoder(rng)
    pts = _points(rng, 3000, 0.87)
    ref = j_query(jnp.asarray(planes), [(jnp.asarray(a), jnp.asarray(b)) for a, b in w], *map(jnp.asarray, pts),
                  JSpec(radius=0.87, compute_dtype=getattr(jnp, dtype)))
    out = dg.triplane_points_plain(torch.from_numpy(planes), [(torch.from_numpy(a), torch.from_numpy(b)) for a, b in w],
                                   *map(torch.from_numpy, pts),
                                   dg.DensityGridSpec(radius=0.87, compute_dtype=getattr(torch, dtype)))
    assert out.shape == (5, 3000) and out.dtype == torch.float32
    want = np.concatenate([np.asarray(ref["density"])[None], np.asarray(ref["density_act"])[None],
                           np.asarray(ref["color"])])
    got = out.numpy()
    for k in range(5):
        limit = (2e-5 if dtype == "float32" else 2.0**-6) * np.abs(want[k]).max()
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=limit)
    # the dict front end is the same numbers
    q = dg.query_triplane_points(torch.from_numpy(planes), [(torch.from_numpy(a), torch.from_numpy(b)) for a, b in w],
                                 *map(torch.from_numpy, pts), dg.DensityGridSpec(radius=0.87))
    assert q["color"].shape == (3, 3000) and q["density"].shape == (3000,)


def _unpack_k4(W, bias):
    """Kernel K4's packed decoder read back on the CPU: the swizzle is its
    own inverse -> (first layer (64, 128), hidden (8, 64, 64), output tile
    (8, 64), as (out, in) f32 of the bf16 rows; b1 (64,), hidden biases
    (8, 64), output bias (8,))."""
    rows = dg.swizzle_128b(W.float())
    assert rows.shape == (2 * 64 + 8 * 64 + 8, 64)
    first = torch.cat([rows[:64], rows[64:128]], dim=1)
    return first, rows[128:640].reshape(8, 64, 64), rows[640:], bias[:64], bias[64:576].reshape(8, 64), bias[576:]


def test_triplane_packing_layout():
    """``pack_triplane_weights``: swizzled bf16 rows which, unswizzled and
    doubled, are exactly the plain version's bf16 weights (the first layer's
    120 inputs padded to 128 with zeros, the output tile's 4 channels then 4
    zero rows, not halved); f32 biases, halved but the output's, which are
    exactly the plain version's bf16 biases."""
    rng = np.random.default_rng(1)
    w = [(torch.from_numpy(a), torch.from_numpy(b)) for a, b in _decoder(rng)]
    W, bias = dg.pack_triplane_weights(w, "cpu")
    assert W.dtype == torch.bfloat16 and W.shape == (648, 64) and bias.dtype == torch.float32 and bias.shape == (584,)
    bf = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
    first, hidden, out, b1, bh, bo = _unpack_k4(W, bias)
    assert torch.equal(2 * first[:, :120], bf(w[0][0]).t()) and not first[:, 120:].any()
    for layer in range(8):
        assert torch.equal(2 * hidden[layer], bf(w[1 + layer][0]).t())
        assert torch.equal(2 * bh[layer], bf(w[1 + layer][1]))
    assert torch.equal(out[:4], bf(w[-1][0]).t()) and not out[4:].any()
    assert torch.equal(2 * b1, bf(w[0][1])) and torch.equal(bo[:4], bf(w[-1][1])) and not bo[4:].any()
    # the 128-byte swizzle: 16-byte chunk q of row r sits at chunk q ^ (r % 8)
    rows = dg.swizzle_128b(W.float())
    for r in (0, 5, 13, 647):
        for q in range(8):
            assert torch.equal(W[r, 8 * (q ^ (r % 8)) : 8 * (q ^ (r % 8)) + 8].float(), rows[r, 8 * q : 8 * q + 8])


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "float16"])
def test_triplane_planes_layout(dtype):
    """``pack_triplane_inputs``' planes: channels last, bf16 codes as bf16
    (80-byte taps), any other dtype as f32 (160 bytes, so f32 codes are never
    rounded to bf16), equal to the codes' own values."""
    rng = np.random.default_rng(1)
    planes = torch.from_numpy(rng.standard_normal((3, 40, 6, 5)).astype(np.float32)).to(getattr(torch, dtype))
    w = [(torch.from_numpy(a), torch.from_numpy(b)) for a, b in _decoder(rng)]
    p, W, bias = dg.pack_triplane_inputs(planes, w)
    assert p.dtype == (torch.bfloat16 if dtype == "bfloat16" else torch.float32) and p.is_contiguous()
    assert p.shape == (3, 6, 5, 40) and torch.equal(p.float(), planes.float().permute(0, 2, 3, 1))
    want_W, want_bias = dg.pack_triplane_weights(w, "cpu")
    assert torch.equal(W, want_W) and torch.equal(bias, want_bias)


def _k4_model(planes, W, bias, pts, spec):
    """Kernel K4's arithmetic on the CPU from its packed decoder: the plain
    version's bf16 features; each layer's f32 sums plus the halved f32 bias
    rounded once to bf16 as h = x / 2, SiLU as h (1 + tanh h) with tanh
    rounded to bf16 (tanh.approx.bf16x2) and the product-sum rounded to bf16
    (fma.rn.bf16x2); the output's f32 sums plus bias rounded to bf16 before
    the f32 exp and sigmoid."""
    bf = lambda t: t.to(torch.bfloat16).float()  # noqa: E731

    def silu_of_half(x):
        h = bf(x)
        return bf(h * bf(torch.tanh(h)) + h)

    first, hidden, out, b1, bh, bo = _unpack_k4(W, bias)
    r = spec.radius
    feats = bf(sample_triplane(planes, pts[0] / r, pts[1] / r, pts[2] / r, spec.align_corners))
    a = silu_of_half(first[:, :120] @ feats + b1[:, None])
    for layer in range(8):
        a = silu_of_half(hidden[layer] @ a + bh[layer][:, None])
    o = bf(out[:4] @ a + bo[:4, None])
    return torch.cat([o[:1], torch.exp(o[:1] + spec.density_bias), torch.sigmoid(o[1:])])


def test_triplane_tanh_model_matches_plain():
    """A CPU model of the kernel's arithmetic (``_k4_model``, on the packed
    weights) against ``triplane_points_plain`` in bf16 on 4000 points, a
    tenth outside the box, with the decoder's weights at 1.5 times their
    fan-in scale, as the card check scales them (at the fan-in scale d
    spreads over a few bf16 ulps only): each output within K4_MODEL_SHARE
    of its spread, d and exp(d + bias) on the log. The two round at other
    places (the plain version rounds each product to bf16, adds the bias in
    bf16 and rounds SiLU's output; the kernel rounds the f32 sum plus bias
    once and takes tanh in bf16), about one bf16 ulp of each activation,
    which nine layers carry to 3.4 % of the spread here; the card check
    holds the kernel to 10 %."""
    rng = np.random.default_rng(3)
    planes = torch.from_numpy(rng.standard_normal((3, 40, 24, 20)).astype(np.float32)).to(torch.bfloat16)
    w = [(1.5 * torch.from_numpy(a), torch.from_numpy(b)) for a, b in _decoder(rng)]
    pts = [torch.from_numpy(p) for p in _points(rng, 4000, 0.87)]
    spec = dg.DensityGridSpec(radius=0.87, compute_dtype=torch.bfloat16)
    _, W, bias = dg.pack_triplane_inputs(planes, w)
    got = _k4_model(planes, W, bias, pts, spec)
    ref = dg.triplane_points_plain(planes, w, *pts, spec)
    got, ref = (torch.cat([t[:1], t[1:2].log(), t[2:]]) for t in (got, ref))
    for k in range(5):
        spread = (ref[k] - ref[k].mean()).abs().max()
        assert (got[k] - ref[k]).abs().max() <= K4_MODEL_SHARE * spread, k


def _on_log(out):
    """K4's outputs with exp(d + bias) on its log, as the checks compare them."""
    return torch.cat([out[:1], out[1:2].log(), out[2:]])


def _plain_noise(planes, w, pts, spec):
    """The plain version in bf16 and its own error per output: its largest
    distance from the same function in f32 on the same bf16 weights and
    planes -> (bf16 outputs, errors). At the decoder's fan-in scale an
    output spreads over a few bf16 ulps of its largest value, and a tenth of
    the spread can be less than this error. Two versions each no farther
    from the f32 function than the plain bf16 one lie within twice the
    error of each other: K4_NOISE_FACTOR."""
    ref = _on_log(dg.triplane_points_plain(planes, w, *pts, spec))
    bf = [(a.to(torch.bfloat16).float(), b.to(torch.bfloat16).float()) for a, b in w]
    f32 = dg.DensityGridSpec(radius=spec.radius, density_bias=spec.density_bias, align_corners=spec.align_corners)
    exact = _on_log(dg.triplane_points_plain(planes.float(), bf, *pts, f32))
    return ref, (ref - exact).abs().amax(dim=1)


@pytest.mark.parametrize("seed", [2, 3, 7])
def test_triplane_tanh_model_within_plain_noise(seed):
    """The CPU model of the kernel's arithmetic (``_k4_model``) with the
    decoder at its fan-in scale, N(0, 0.5) biases, on 10007 points: each
    output within K4_NOISE_FACTOR times the plain bf16 version's own error
    of the plain version."""
    rng = np.random.default_rng(seed)
    w = [(torch.from_numpy(a), torch.from_numpy(b)) for a, b in _decoder(rng)]
    planes = torch.from_numpy(rng.standard_normal((3, 40, 64, 64)).astype(np.float32)).to(torch.bfloat16)
    pts = [torch.from_numpy(p) for p in _points(rng, 10007, 0.87)]
    spec = dg.DensityGridSpec(radius=0.87, compute_dtype=torch.bfloat16)
    _, W, bias = dg.pack_triplane_inputs(planes, w)
    ref, noise = _plain_noise(planes, w, pts, spec)
    err = (_on_log(_k4_model(planes, W, bias, pts, spec)) - ref).abs().amax(dim=1)
    assert (noise > 0).all() and (err <= K4_NOISE_FACTOR * noise).all(), (err / noise).tolist()


def test_tsr_packs_k4_decoder_once():
    """``TSR._k4_inputs``: the code's planes as ``pack_triplane_planes`` lays
    them out each call; the decoder packed once and the same tensors handed
    out until a decoder parameter changes in place, then packed anew."""
    tt = TSR(TSRConfig(**SMALL), dtype=torch.float32, device="cpu")
    code = torch.from_numpy(np.random.default_rng(5).standard_normal((3, 40, 16, 16)).astype(np.float32))
    planes, W, bias = tt._k4_inputs(code)
    assert torch.equal(planes, dg.pack_triplane_planes(code))
    want_W, want_bias = dg.pack_triplane_weights(tt.decoder_weights(), "cpu")
    assert torch.equal(W, want_W) and torch.equal(bias, want_bias)
    _, W2, bias2 = tt._k4_inputs(code.to(torch.bfloat16))
    assert W2 is W and bias2 is bias
    with torch.no_grad():
        tt.module.decoder.layers[0].bias.add_(1.0)
    _, W3, bias3 = tt._k4_inputs(code)
    want_W, want_bias = dg.pack_triplane_weights(tt.decoder_weights(), "cpu")
    assert torch.equal(W3, want_W) and torch.equal(bias3, want_bias) and not torch.equal(bias3, bias)


@pytest.mark.parametrize("elevation", [0.0, 20.0])
def test_rays_match_jax(elevation):
    """The spherical cameras (4 views, 16^2, a 90 degree field of view, so
    that some rays miss the box) and the bbox slab test against the JAX
    package's, within 1e-6."""
    ro, rd = (np.array(a) for a in jrays.get_spherical_cameras(4, elevation, 1.9, 90.0, 16, 16))
    to, td = rays.get_spherical_cameras(4, elevation, 1.9, 90.0, 16, 16)
    assert to.shape == rd.shape == (4, 16, 16, 3)
    np.testing.assert_allclose(to.numpy(), ro, rtol=0, atol=1e-6)
    np.testing.assert_allclose(td.numpy(), rd, rtol=0, atol=1e-6)
    jn, jf, jv = (np.asarray(a) for a in jrays.rays_intersect_bbox(jnp.asarray(ro.reshape(-1, 3)),
                                                                      jnp.asarray(rd.reshape(-1, 3)), 0.87))
    tn, tf, tv = rays.rays_intersect_bbox(torch.from_numpy(ro.reshape(-1, 3)), torch.from_numpy(rd.reshape(-1, 3)),
                                          0.87)
    assert np.array_equal(tv.numpy(), jv) and 0 < jv.sum() < jv.size
    np.testing.assert_allclose(tn.numpy(), jn, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tf.numpy(), jf, rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def render_pair():
    """JAX and port TSRs (the narrow config) with the same weights, and the
    JAX scene codes of one seeded image."""
    jt = JTSR(JTSRConfig(**SMALL), dtype=jnp.float32)
    params = jax.tree.map(np.array, jt.params)
    tt = TSR(TSRConfig(**SMALL), state_dict=tsr_params_from_jax(params), dtype=torch.float32, device="cpu")
    img = np.random.default_rng(42).random((1, 64, 64, 3)).astype(np.float32)
    return jt, tt, np.array(jt.scene_codes(jnp.asarray(img)))


def test_render_views_matches_jax(render_pair):
    """``render_views`` of the narrow model at 2 views, 24^2, 16 samples in
    f32, from the same codes: within 1e-4 (the sample sum and the
    cameras' last bits), views in [0, 1] and partly opaque."""
    jt, tt, codes = render_pair
    kw = dict(n_views=2, height=24, width=24, num_samples=16)
    ref = jt.render_views(jnp.asarray(codes), **kw)
    got = tt.render_views(torch.from_numpy(codes), **kw)
    assert len(got) == len(ref) == 1 and got[0].shape == ref[0].shape == (2, 24, 24, 3)
    np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=1e-4)
    assert got[0].min() >= 0 and got[0].max() <= 1 + 1e-5 and got[0].min() < 0.99


def _png_size(path):
    data = path.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n" and data[12:16] == b"IHDR"
    return struct.unpack(">II", data[16:24])


def test_cli_render_on_cpu(tmp_path, monkeypatch, capsys, render_pair):
    """``render --device cpu`` with the narrow model: exit 0, one valid
    PNG per view at the asked size, the JAX CLI's JSON line."""
    from sculptmate_tpu_torch import cli

    _, tt, _ = render_pair
    monkeypatch.setattr(cli, "TSR", lambda seed, device: tt)
    png = tmp_path / "in.png"
    Image.fromarray(np.random.default_rng(3).integers(0, 255, (40, 40, 3), dtype=np.uint8)).save(png)
    pattern = str(tmp_path / "view_{}.png")
    rc = cli.main(["render", str(png), "-o", pattern, "--n-views", "3", "--size", "12", "--device", "cpu"])
    assert rc == 0
    for i in range(3):
        assert _png_size(tmp_path / f"view_{i}.png") == (12, 12)
        assert np.asarray(Image.open(tmp_path / f"view_{i}.png")).shape == (12, 12, 3)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == {"views": 3, "pattern": pattern}


@pytest.mark.cuda
def test_triplane_points_kernel_matches_plain():
    """K4 on the card against its plain version on the same inputs, bf16
    codes (bf16 taps) and f32 codes (f32 taps). With the decoder's weights
    1.5 times their fan-in scale, as in the card check: each output within
    0.1 of its spread, exp(d + bias) on its log (bf16 rounding at other
    places and the tanh form of SiLU). With the weights at their fan-in
    scale, the main path's: each output within K4_NOISE_FACTOR times the
    plain bf16 version's own error (``_plain_noise``), since there 0.1 of
    the spread can be less than that error."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(2)
    fan_in = [(torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()) for a, b in _decoder(rng)]
    codes = torch.from_numpy(rng.standard_normal((3, 40, 64, 64)).astype(np.float32)).cuda()
    pts = [torch.from_numpy(p).cuda() for p in _points(rng, 10007, 0.87)]
    spec = dg.DensityGridSpec(radius=0.87, compute_dtype=torch.bfloat16)
    for gain in (1.5, 1.0):
        w = [(gain * a, b) for a, b in fan_in]
        for planes in (codes.to(torch.bfloat16), codes):
            launches = dg.triplane_points.launches
            out = _on_log(dg.triplane_points(planes, w, *pts, spec))
            assert dg.triplane_points.launches == launches + 1
            if gain == 1.0:
                ref, noise = _plain_noise(planes, w, pts, spec)
                assert ((out - ref).abs().amax(dim=1) <= K4_NOISE_FACTOR * noise).all()
                continue
            ref = _on_log(dg.triplane_points_plain(planes, w, *pts, spec))
            for k in range(5):
                assert (out[k] - ref[k]).abs().max() <= 0.1 * (ref[k] - ref[k].mean()).abs().max(), k
    with pytest.raises(TypeError, match="bf16"):
        dg.triplane_points(codes, fan_in, *pts, dg.DensityGridSpec(radius=0.87))