"""The extraction capacity policy (``runtime/capacity_cache.Capacities``)
of each of its owners: the TSR's wire and K10 paths and the SF3D's
marching tets, replayed through the models' own ``extract_mesh`` over one
fixed sequence of counts, with the extraction itself faked."""

import types

import numpy as np
import pytest
import torch

from sculptmate_tpu_torch.runtime import capacity_cache
from sculptmate_tpu_torch.systems import sf3d as sf3d_module
from sculptmate_tpu_torch.systems.sf3d import SF3D, SF3DConfig
from sculptmate_tpu_torch.systems.tsr import TSR, TSRConfig

SMALL = dict(
    cond_image_size=64, plane_size=8, num_channels=64, num_attention_heads=4,
    attention_head_dim=16, num_layers=2, cross_attention_dim=64, vit_hidden_size=64,
    vit_num_layers=2, vit_num_heads=4, vit_intermediate_size=128,
)
SF3D_SMALL = dict(
    cond_image_size=56, isosurface_resolution=160, plane_size=8, num_channels=64, num_attention_heads=4,
    attention_head_dim=16, num_latents=32, num_blocks=1, num_basic_blocks=1, upsample_scale_factor=2,
    upsample_conv_layers=2, dinov2_hidden_size=64, dinov2_num_layers=2, dinov2_num_heads=4,
    dinov2_intermediate_size=128, clip_width=64, clip_layers=2, clip_heads=4,
)


def _tsr(monkeypatch, packed: bool):
    """A small TSR whose device work is faked: each scene code is the
    (vertex, face) counts its extraction finds -> (extract(batch of counts,
    capacity given or 0), the capacities dispatched, in order)."""
    model = TSR(TSRConfig(**SMALL), dtype=torch.float32, device="cpu")
    log = []

    def dispatch(code, resolution, threshold, caps, want_colors, packed_):
        log.append(caps)
        return tuple(code.tolist())

    monkeypatch.setattr(model, "_dispatch", dispatch)
    monkeypatch.setattr(model, "_counts", lambda host, packed_: host[: 1 + packed_])
    monkeypatch.setattr(model, "_wire_decode", lambda *args: None)
    monkeypatch.setattr(model, "_packed_finish", lambda *args: None)

    def extract(batch, given):
        model.extract_mesh([torch.tensor(c) for c in batch], resolution=256, max_verts=given,
                           max_faces=given if packed else 0, mode="packed" if packed else "wire")

    return extract, log


def _sf3d(monkeypatch):
    """``_tsr`` for the SF3D: its lattice and MT wire faked, the explicit
    capacity given through ``extract_wire_async``'s pending handle."""
    model = SF3D(SF3DConfig(**SF3D_SMALL), dtype=torch.float32, device="cpu")
    log = []

    def extract_wire(code, threshold, max_verts, weld_eps):
        log.append((max_verts,))
        return tuple(code.tolist())

    monkeypatch.setattr(model, "_extract_wire", extract_wire)
    monkeypatch.setattr(sf3d_module, "_to_host_async", lambda wire: types.SimpleNamespace(wire=lambda: wire))
    monkeypatch.setattr(sf3d_module, "mt_wire", types.SimpleNamespace(
        wire_counts=lambda wire, n: wire, decode_wire=lambda *args, **kw: (np.zeros((1, 3), np.float32), None, None)))

    def extract(batch, given):
        for code in map(torch.tensor, batch):
            model.extract_mesh(code, 0.0, model.extract_wire_async(code, 0.0, given) if given else None)

    return extract, log


# owner -> (a new model's extract and log, its persisted key)
OWNERS = {
    "tsr_wire": (lambda mp: _tsr(mp, False), "torch_tsr_wire_r256"),
    "tsr_packed": (lambda mp: _tsr(mp, True), "torch_tsr_packed_r256"),
    "sf3d": (_sf3d, "torch_sf3d_mt_r160"),
}

# (capacity the caller gives, 0 for none; vertex count) of five extractions:
# small, huge, small, one below the SF3D's default but above what the small
# one left kept, and small under an explicit capacity. The face counts are
# twice the vertex counts.
STEPS = ((0, 100_000), (0, 3_000_000), (0, 100_000), (0, 400_000), (64, 100_000))

# per step (dispatched, grown, persisted), then a fresh owner's dispatch:
# the values the parent commit's ``TSR.extract_mesh`` and
# ``SF3D.extract_mesh`` gave for this sequence, with the same fakes, before
# their capacity code moved into ``Capacities``. Defaults: 524 288 (and
# 1 048 576 faces) at R = 256, 24 x 161^2 = 622 104 at res = 160.
EXPECTED = {
    "tsr_wire": ([
        ((524288,), (), (196608,)),
        ((524288,), ((3604480,),), (3604480,)),
        ((3604480,), (), (196608,)),
        ((524288,), (), (524288,)),
        ((64,), ((131072,),), (131072,)),
    ], (524288,)),
    "tsr_packed": ([
        ((524288, 1048576), (), (196608, 327680)),
        ((524288, 1048576), ((3604480, 7208960),), (3604480, 7208960)),
        ((3604480, 7208960), (), (196608, 327680)),
        ((524288, 1048576), (), (524288, 1048576)),
        ((64, 64), ((131072, 262144),), (131072, 262144)),
    ], (524288, 1048576)),
    "sf3d": ([
        ((622104,), (), (196608,)),
        ((196608,), ((3604480,),), (3604480,)),
        ((3604480,), (), (196608,)),
        ((196608,), ((524288,),), (524288,)),
        ((64,), ((131072,),), (131072,)),
    ], (131072,)),
}


@pytest.mark.parametrize("owner", sorted(OWNERS))
def test_capacity_policy_replays_the_sequence(owner, tmp_path, monkeypatch):
    """Each owner dispatches, grows and persists exactly the capacities
    above, and a fresh owner starts from the persisted one; the fourth
    extraction pins the minimum: the TSR dispatches its default over the
    smaller capacity kept, the SF3D the kept one, and retries."""
    monkeypatch.setenv("SCULPTMATE_CAP_CACHE", str(tmp_path))
    new_model, key = OWNERS[owner]
    extract, log = new_model(monkeypatch)
    steps = []
    for given, nv in STEPS:
        log.clear()
        extract([(nv, 2 * nv)], given)
        steps.append((log[0], tuple(log[1:]), capacity_cache.load(key)))
    expected, fresh = EXPECTED[owner]
    assert steps == expected
    extract, log = new_model(monkeypatch)
    extract([(100_000, 200_000)], 0)
    assert log[0] == fresh
    default, fourth = steps[0][0], steps[3][0]
    assert fourth == default if owner.startswith("tsr") else fourth < default


# two assets, one with many vertices and few faces, one the other way round
BATCH = ((3_000_000, 200_000), (100_000, 6_000_000))

# every capacity dispatched, in order (both assets, then each retry), and the
# one store: the element-wise largest counts and capacities of the batch,
# not the last asset's (the parent commit's values, taken as for EXPECTED)
EXPECTED_BATCH = {
    "tsr_wire": ([(524288,), (524288,), (3604480,)], [(3604480,)]),
    "tsr_packed": ([(524288, 1048576), (524288, 1048576), (3604480, 1048576), (524288, 7208960)],
                   [(3604480, 7208960)]),
}


@pytest.mark.parametrize("owner", sorted(EXPECTED_BATCH))
def test_a_batch_is_kept_once(owner, tmp_path, monkeypatch):
    """``TSR.extract_mesh`` over a batch makes one capacity update for its
    path, from the batch's element-wise largest counts and capacities."""
    monkeypatch.setenv("SCULPTMATE_CAP_CACHE", str(tmp_path))
    stored, store = [], capacity_cache.store
    monkeypatch.setattr(capacity_cache, "store", lambda key, caps: (stored.append(tuple(caps)), store(key, caps)))
    new_model, key = OWNERS[owner]
    extract, log = new_model(monkeypatch)
    extract(BATCH, 0)
    assert (log, stored) == EXPECTED_BATCH[owner]
    assert capacity_cache.load(key) == stored[0]
