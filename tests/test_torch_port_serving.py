"""Port parity and contracts of the serving slice on the CPU: the one-card
AssetFarm from raw RGBA to meshes against the JAX AssetFarm, the on-disk
capacity cache, the asynchronous extraction handle, and the ``generate``
command line."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from PIL import Image

from sculptmate_tpu.frontend.matting import U2NetMatting as JMatting
from sculptmate_tpu.ops.density_grid import mlp_weights_from_params, query_density_grid
from sculptmate_tpu.parallel.farm import AssetFarm as JAssetFarm
from sculptmate_tpu.systems.tsr import TSR as JTSR
from sculptmate_tpu.systems.tsr import TSRConfig as JTSRConfig
from sculptmate_tpu_torch.frontend.matting import U2NetMatting
from sculptmate_tpu_torch.geometry import mc_wire
from sculptmate_tpu_torch.parallel.farm import AssetFarm
from sculptmate_tpu_torch.runtime import capacity_cache
from sculptmate_tpu_torch.runtime.checkpoint import tsr_params_from_jax, u2net_params_from_jax
from sculptmate_tpu_torch.systems.tsr import TSR, TSRConfig

SMALL = dict(
    cond_image_size=64, plane_size=8, num_channels=64, num_attention_heads=4,
    attention_head_dim=16, num_layers=2, cross_attention_dim=64, vit_hidden_size=64,
    vit_num_layers=2, vit_num_heads=4, vit_intermediate_size=128,
)
RES = 16


def _margin_threshold(*densities):
    """A threshold at least 1e-3 from every lattice value of every grid (so
    occupancy cannot flip between the two implementations), with 50-98 % of
    the points below it."""
    d = np.sort(np.concatenate([x.ravel() for x in densities]))
    gaps = np.diff(d)
    idx = [i for i in np.nonzero(gaps >= 2e-3)[0] if 0.5 * d.size <= i <= 0.98 * d.size]
    assert idx, "no threshold with a 1e-3 margin"
    return float(d[idx[0]] + d[idx[0] + 1]) / 2


@pytest.fixture(scope="module")
def farms():
    """The JAX AssetFarm on a one-device mesh and the port's, with the same
    narrow TSR weights (the density output channel scaled up, so the
    random-weight field leaves gaps for a margin-safe threshold) and the
    same full-u2net matting weights; plus two raw 64^2 RGBA images."""
    base = JTSR(JTSRConfig(**SMALL), dtype=jnp.float32)
    params = jax.tree.map(np.array, base.params)
    params["decoder"]["layers"]["dense_out"]["kernel"][:, 0] *= 1000.0
    jt = JTSR(JTSRConfig(**SMALL), params=params, dtype=jnp.float32)
    jfarm = JAssetFarm(jt, Mesh(np.array(jax.devices()[:1]), ("dp",)))
    jm = JMatting(seed=0)
    tt = TSR(TSRConfig(**SMALL), state_dict=tsr_params_from_jax(params), dtype=torch.float32, device="cpu")
    tm = U2NetMatting(state_dict=u2net_params_from_jax(jax.tree.map(np.asarray, jm.variables)), device="cpu")
    rgba = np.random.default_rng(0).random((2, 64, 64, 4)).astype(np.float32)
    return jfarm, jm, AssetFarm(tt, device="cpu"), tm, rgba


def test_farm_cond_images_match_jax(farms):
    """Matting at 320^2, mask back to 64^2, fused preprocess: the cond
    images within 1e-4."""
    jfarm, jm, farm, tm, rgba = farms
    ref = np.asarray(jfarm._prep_cond(jnp.asarray(rgba), jm, 0.75))
    got = farm._prep_cond(torch.from_numpy(rgba), tm, 0.75)
    assert got.shape == ref.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4)


def test_farm_meshes_match_jax(farms):
    """``generate_batch_rgba`` from raw RGBA to meshes: equal vertex and
    face counts and faces, vertices within 1e-4, colors within 1/255."""
    jfarm, jm, farm, tm, rgba = farms
    codes = np.asarray(jfarm._front(jm, 0.75)(jfarm.params, jnp.asarray(rgba)))
    w = mlp_weights_from_params(jfarm.params["decoder"]["layers"])
    spec = jfarm.tsr.grid_spec(RES)
    thr = _margin_threshold(*(np.asarray(query_density_grid(jnp.asarray(c), w, spec)) for c in codes))
    ref = jfarm.generate_batch_rgba(jnp.asarray(rgba), matting=jm, resolution=RES, threshold=thr, has_vertex_color=True)
    got = farm.generate_batch_rgba(rgba, matting=tm, resolution=RES, threshold=thr, has_vertex_color=True)
    assert len(got) == len(ref) == 2
    for (vg, fg, cg), (vr, fr, cr) in zip(got, ref):
        assert len(vr) > 0 and vg.shape == vr.shape and fg.shape == fr.shape
        assert np.array_equal(fg, fr)
        np.testing.assert_allclose(vg, vr, rtol=0, atol=1e-4)
        np.testing.assert_allclose(cg, cr, rtol=0, atol=1.0 / 255 + 1e-6)


def test_farm_refuses_what_is_not_ported(farms):
    from sculptmate_tpu_torch.parallel import farm as farm_mod
    from sculptmate_tpu_torch.parallel.mesh import make_mesh

    _, _, farm, _, rgba = farms
    # packed mode is ported (tests/test_torch_port_packed.py); an unknown mode raises
    with pytest.raises(ValueError, match="mode"):
        farm.generate_batch_rgba(rgba, mode="dense")
    # tensor parallelism needs a mesh with a tp axis (tests/test_torch_port_parallel.py)
    with pytest.raises(ValueError, match="tp_axis needs a mesh"):
        AssetFarm(farm.tsr, device="cpu", tp_axis="tp")
    # the sharded functions on a one-device mesh: the density grid in one
    # slab, and a mesh from each extraction
    tsr, mesh = farm.tsr, make_mesh((1,), ("sp",), devices=["cpu"])
    code, w, spec = tsr.scene_codes(rgba[:1, :, :, :3])[0], tsr.decoder_weights(), tsr.grid_spec(RES)
    (slab,) = farm_mod.sharded_density_grid(mesh, code, w, spec)
    thr = float(slab.median())
    assert slab.shape == (RES, RES, RES)
    for fn in (farm_mod.sharded_extract, farm_mod.sharded_extract_wire):
        verts, faces = fn(mesh, code, w, spec, thr)
        assert verts.shape[1] == 3 and len(faces) > 0 and faces.max() < len(verts)
    with pytest.raises(ValueError, match="max_faces"):
        farm.generate_batch_rgba(rgba, max_faces=10)


# -- the capacity cache: the JAX package's cases against the port's module --


@pytest.fixture
def cap_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("SCULPTMATE_CAP_CACHE", str(tmp_path))
    return tmp_path


@pytest.mark.parametrize(
    "stores,expected",
    [
        ([("k", (368640, 128, 50104)), ("k2", [1, 2])], {"k": (368640, 128, 50104), "k2": (1, 2)}),
        ([("k", (10,)), ("k", (20,))], {"k": (20,)}),  # overwrite
    ],
)
def test_capacity_cache_round_trip(cap_dir, stores, expected):
    assert capacity_cache.load("k") is None
    for key, caps in stores:
        capacity_cache.store(key, caps)
    for key, caps in expected.items():
        assert capacity_cache.load(key) == caps
    assert not [p for p in os.listdir(cap_dir) if p.startswith(".capcache-")]  # atomic: no temp files left


def test_capacity_cache_disabled(monkeypatch, tmp_path):
    monkeypatch.setenv("SCULPTMATE_CAP_CACHE", "0")
    capacity_cache.store("k", (1,))
    assert capacity_cache.load("k") is None
    assert not os.path.exists(tmp_path / "capacity_cache.json")


def test_capacity_cache_default_is_the_ports_own(monkeypatch):
    monkeypatch.delenv("SCULPTMATE_CAP_CACHE", raising=False)
    path = capacity_cache._path()
    assert os.path.dirname(path) == os.path.join(os.path.dirname(os.path.dirname(capacity_cache.__file__)), "_build")


@pytest.mark.parametrize(
    "content,expected",
    [
        ("{not json", {"k": None}),
        (json.dumps({"a": "nope", "b": [1, -2], "c": [1.5], "d": [3]}), {"a": None, "b": None, "c": None, "d": (3,)}),
    ],
)
def test_capacity_cache_rejects_bad_files(cap_dir, content, expected):
    (cap_dir / "capacity_cache.json").write_text(content)
    for key, caps in expected.items():
        assert capacity_cache.load(key) == caps
    capacity_cache.store("k", (5,))  # recovers by rewriting
    assert capacity_cache.load("k") == (5,)


def test_capacity_cache_store_is_best_effort(cap_dir, monkeypatch):
    def boom(*a, **k):
        raise OSError("read-only filesystem")

    monkeypatch.setattr(os, "replace", boom)
    capacity_cache.store("k", (1,))  # must not raise
    assert capacity_cache.load("k") is None


@pytest.mark.parametrize(
    "current,observed,kwargs,expected",
    [
        # one giant asset inflated the capacity: shrink to ~1.35x observed
        (17_104_896, 2_900_000, {}, 65536 * -(-int(1.35 * 2_900_000) // 65536)),
        # hysteresis: normal fluctuation keeps a steady capacity
        (4_000_000, 2_000_000, {}, 4_000_000),
        (4_000_000, 2_400_000, {}, 4_000_000),
        (4_000_000, 1_700_000, {}, 4_000_000),
        (3_538_944, 2_900_000, {}, 3_538_944),
        # never below one bucket, always bucket-aligned
        (10_000_000, 0, {}, 65536),
        (10_000_000, 10, {"bucket": 4096}, 4096),
        (10_000_000, 123_456, {"bucket": 4096, "slack": 1.3}, 4096 * -(-int(1.3 * 123_456) // 4096)),
    ],
)
def test_capacity_cache_tighten(current, observed, kwargs, expected):
    assert capacity_cache.tighten(current, observed, **kwargs) == expected


@pytest.fixture(scope="module")
def small_tsr():
    base = JTSR(JTSRConfig(**SMALL), dtype=jnp.float32)
    params = jax.tree.map(np.array, base.params)
    params["decoder"]["layers"]["dense_out"]["kernel"][:, 0] *= 1000.0
    tt = TSR(TSRConfig(**SMALL), state_dict=tsr_params_from_jax(params), dtype=torch.float32, device="cpu")
    codes = tt.scene_codes(np.random.default_rng(42).random((1, 64, 64, 3)).astype(np.float32))
    return tt, codes


def test_tsr_reads_a_persisted_capacity(cap_dir, small_tsr):
    """A capacity learned by one TSR is picked up by a fresh instance; an
    explicit capacity still wins."""
    tt, codes = small_tsr
    (verts, _, _), = tt.extract_mesh(codes, resolution=RES, threshold=0.5, max_verts=64)
    assert len(verts) > 64
    stored = capacity_cache.load(f"torch_tsr_wire_r{RES}")
    assert stored is not None and stored[0] >= len(verts)
    fresh = TSR(tt.config, state_dict=tt.module.state_dict(), dtype=torch.float32, device="cpu")
    assert stored[0] > 8 * RES * RES and fresh.wire_capacities.dispatch(RES) == (stored[0],)  # not the default
    assert fresh.wire_capacities.dispatch(RES, (64,)) == (64,)


def test_async_handle_holds_its_host_copy(small_tsr):
    """``extract_mesh_async`` returns a handle whose host copy is already
    queued (on the CPU: the wire and color bytes themselves, no events),
    and ``extract_mesh_wait`` decodes the same mesh as decoding the
    extraction's output directly."""
    tt, codes = small_tsr
    mv = 3 * RES**3  # every lattice edge: no overflow retry
    h = tt.extract_mesh_async(codes[0], has_vertex_color=True, resolution=RES, threshold=0.5, max_verts=mv)
    assert h.host.events is None and len(h.host.parts) == 2
    assert all(p.device.type == "cpu" and p.dtype == torch.uint8 for p in h.host.parts)
    (verts, faces, colors), (nv, mv_used) = tt.extract_mesh_wait(h)

    wire, rgb = (t.numpy() for t in tt._extract_wire(codes[0], RES, 0.5, mv, True))
    assert mv_used == mv and nv == int(mc_wire.wire_counts(wire, mc_wire.N_WIRE_COUNTS)[0])
    v, f, *_ = mc_wire.decode_wire(wire, (RES,) * 3, mv, has_colors=False)
    scale = 2 * tt.config.radius / (RES - 1.0)
    assert np.array_equal(verts, v * scale - tt.config.radius) and np.array_equal(faces, f)
    assert np.array_equal(colors, rgb.reshape(3, mv)[:, :nv].T.astype(np.float32) / 255.0)


class _LumaSession:
    """Stub matting session: alpha = luminance threshold."""

    def predict_mask(self, image):
        arr = np.asarray(image.convert("L"))
        return Image.fromarray(np.where(arr > 40, 255, 0).astype(np.uint8), mode="L")


def test_cli_generate_on_cpu(tmp_path, monkeypatch, capsys, small_tsr):
    """``generate`` on a PNG with ``--device cpu`` and a narrow model: exit
    0, a GLB, and the JSON line."""
    from sculptmate_tpu_torch import cli
    from sculptmate_tpu_torch.frontend import matting
    from sculptmate_tpu_torch.frontend.preprocess import preprocess_image

    tt, _ = small_tsr
    monkeypatch.setattr(matting, "default_session", lambda device=None: _LumaSession())
    monkeypatch.setattr(cli, "TSR", lambda seed, device: tt)
    img = np.zeros((300, 300, 3), np.uint8)
    img[60:250, 70:230] = np.random.default_rng(3).integers(60, 255, (190, 160, 3))
    png = tmp_path / "in.png"
    Image.fromarray(img).save(png)

    # a threshold at the median of the same cond image's lattice
    cond = np.asarray(preprocess_image(Image.open(png).convert("RGBA"), ratio=0.75, session=_LumaSession()))
    from sculptmate_tpu_torch.ops.density_grid import query_density_grid

    codes = tt.scene_codes(cond[None].astype(np.float32) / 255.0)
    thr = float(query_density_grid(codes[0], tt.decoder_weights(), tt.grid_spec(RES)).median())

    out = tmp_path / "out.glb"
    rc = cli.main(["generate", str(png), "-o", str(out), "--device", "cpu", "--resolution", str(RES),
                   "--threshold", str(thr), "--texture"])
    assert rc == 0
    assert out.read_bytes()[:4] == b"glTF"
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["output"] == str(out) and line["verts"] > 0 and line["faces"] > 0
    assert {"encode_s", "extract_s", "total_s"} <= set(line)


@pytest.mark.cuda
def test_farm_dispatch_makes_no_host_sync():
    """On the card, the farm's front and extraction dispatch for three
    assets run under ``set_sync_debug_mode("error")``: any host sync
    raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # head widths of 64, the only one kernel K1 takes
    cfg = TSRConfig(cond_image_size=64, plane_size=8, num_channels=64, num_attention_heads=1, attention_head_dim=64,
                    num_layers=2, cross_attention_dim=128, vit_hidden_size=128, vit_num_layers=2, vit_num_heads=2,
                    vit_intermediate_size=256)
    tt = TSR(cfg, device="cuda")
    farm = AssetFarm(tt)
    matting = U2NetMatting(device="cuda")
    rgba = torch.rand(3, 64, 64, 4, device="cuda")
    codes = farm._front(rgba[:1], matting, 0.75)  # warm-up: builds kernels, caches
    farm.tsr.extract_mesh_wait(tt.extract_mesh_async(codes[0], True, RES, 0.5))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        handles = [farm.extract_batch_wire_async(farm._front(rgba[i : i + 1], matting, 0.75), RES, 0.5, 0, True)
                   for i in range(3)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for h in handles:
        farm.extract_batch_wire_wait(h)
