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
from sculptmate_tpu_torch.runtime.checkpoint import tsr_params_from_jax
from sculptmate_tpu_torch.systems.tsr import TSR, TSRConfig

SMALL = dict(
    cond_image_size=64, plane_size=8, num_channels=64, num_attention_heads=4,
    attention_head_dim=16, num_layers=2, cross_attention_dim=64, vit_hidden_size=64,
    vit_num_layers=2, vit_num_heads=4, vit_intermediate_size=128,
)
LAYERS = [(120, 64)] + [(64, 64)] * 8 + [(64, 4)]  # TripoSR's decoder


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


def test_triplane_packing_layout():
    """``pack_triplane_inputs``: channels-last f32 planes, and the decoder's
    bf16 rows (out, in) padded as the kernel copies them, biases f32 of the
    bf16 values."""
    rng = np.random.default_rng(1)
    planes = torch.from_numpy(rng.standard_normal((3, 40, 6, 5)).astype(np.float32)).to(torch.bfloat16)
    w = [(torch.from_numpy(a), torch.from_numpy(b)) for a, b in _decoder(rng)]
    p, W, bias = dg.pack_triplane_inputs(planes, w)
    assert p.dtype == torch.float32 and torch.equal(p, planes.float().permute(0, 2, 3, 1))
    bf = lambda t: t.to(torch.bfloat16)  # noqa: E731
    n1, nh = 64 * 136, 64 * 72
    assert W.dtype == torch.bfloat16 and W.numel() == n1 + 8 * nh + 8 * 72
    w1 = W[:n1].reshape(64, 136)
    assert torch.equal(w1[:, :120], bf(w[0][0]).t()) and not w1[:, 120:].any()
    for layer in range(8):
        blk = W[n1 + layer * nh : n1 + (layer + 1) * nh].reshape(64, 72)
        assert torch.equal(blk[:, :64], bf(w[1 + layer][0]).t()) and not blk[:, 64:].any()
    wout = W[n1 + 8 * nh :].reshape(8, 72)
    assert torch.equal(wout[:4, :64], bf(w[-1][0]).t()) and not wout[4:].any() and not wout[:, 64:].any()
    want_bias = torch.cat([bf(b).float() for _, b in w[:-1]] + [bf(w[-1][1]).float(), torch.zeros(4)])
    assert bias.dtype == torch.float32 and torch.equal(bias, want_bias)


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
    """K4 on the card against its plain version on the same bf16 inputs:
    each output within 0.1 of its spread (bf16 rounding at other places)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(2)
    w = [(torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()) for a, b in _decoder(rng)]
    planes = torch.from_numpy(rng.standard_normal((3, 40, 64, 64)).astype(np.float32)).cuda().to(torch.bfloat16)
    pts = [torch.from_numpy(p).cuda() for p in _points(rng, 10007, 0.87)]
    spec = dg.DensityGridSpec(radius=0.87, compute_dtype=torch.bfloat16)
    launches = dg.triplane_points.launches
    out = dg.triplane_points(planes, w, *pts, spec)
    assert dg.triplane_points.launches == launches + 1
    ref = dg.triplane_points_plain(planes, w, *pts, spec)
    for k in range(5):
        assert (out[k] - ref[k]).abs().max() <= 0.1 * (ref[k] - ref[k].mean()).abs().max(), k
    with pytest.raises(TypeError, match="bf16"):
        dg.triplane_points(planes, w, *pts, dg.DensityGridSpec(radius=0.87))
