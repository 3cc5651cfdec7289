"""The harness end to end on the CPU: tiny cells added from files alone,
driven through ``run.run`` with the chip's look skipped, untraced and
traced; the result line's shape; the traced readers on a recorded event
list; the photo generator."""

import json

import pytest
import torch

import run
from harness.photos import photo, pool_entry
from harness.sample import Keeper
from harness.trace import Trace

E2E_KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


@pytest.mark.parametrize("workload", ["tiny-addon", "tiny-farm"])
@pytest.mark.parametrize("trace", [False, True])
def test_tiny_cell_from_files_alone_runs_correct(tiny_bench, workload, trace):
    out = run.run(workload, 2**40 + 7, 1.0, trace, require_cuda=False, benchmark_path=tiny_bench, device="cpu")
    assert E2E_KEYS <= set(out) and list(out)[-1] == "checks"
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    bench = json.load(open(tiny_bench))
    if trace:
        assert "breakdown" in out and set(out["device"]) >= {"busy_s", "window_s"}
        allowed = {m["name"] for m in bench["per_layer"] if workload in m["workloads"]}
        assert set(out["metrics"]) <= allowed and out["metrics"]
    else:
        want = {"setup_s", "peak_mem_gib"} - {"peak_mem_gib"}  # no device memory on the CPU
        want |= {"latency_p50_s", "latency_p90_s"} if workload == "tiny-addon" else {"assets_per_s"}
        assert want <= set(out["metrics"])
    json.dumps(out)


def test_no_card_exits_without_a_result(tiny_bench, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        run.run("tiny-addon", 1, 1.0, False, benchmark_path=tiny_bench)
    assert e.value.code not in (0, None)


def test_photos_are_the_seeds_alone():
    params = json.load(open(__file__.rsplit("/", 1)[0] + "/tiny/tiny-photo.json"))["photo"]
    a = photo(params, 3 * 2**33 + 1, 5, "cpu")
    assert torch.equal(a, photo(params, 3 * 2**33 + 1, 5, "cpu"))
    assert not torch.equal(a, photo(params, 3 * 2**33 + 1, 6, "cpu"))
    assert not torch.equal(a, photo(params, 3 * 2**33 + 2, 5, "cpu"))
    assert a.shape == (320, 320, 3) and a.dtype == torch.uint8
    # the object covers part of the frame, not all of it
    assert 10 < float(a.float().std()) < 120


def test_every_seed_sends_the_pool_in_another_order():
    params = {"pool": 8}
    a = [pool_entry(params, 2**40 + 1, i) for i in range(16)]
    b = [pool_entry(params, 2**40 + 2, i) for i in range(16)]
    assert sorted(a[:8]) == sorted(a[8:]) == sorted(b[:8]) == list(range(8))
    assert a != b and a == [pool_entry(params, 2**40 + 1, i) for i in range(16)]
    assert pool_entry(params, 5, -3) == -3


def test_keeper_holds_the_largest_and_a_seeded_sample():
    k1, k2 = Keeper(3, 9), Keeper(3, 9)
    for i in range(100):
        k1.offer(i, (i * 37) % 101, i)
        k2.offer(i, (i * 37) % 101, i)
    items = k1.items()
    assert items == k2.items() and items[0][0] == max(range(100), key=lambda i: (i * 37) % 101)
    assert len(items) <= 4


def _trace():
    ms = 1_000_000
    host = {"bench.window": [(0, 1000 * ms)], "tsr.scene_codes": [(10 * ms, 30 * ms), (510 * ms, 530 * ms)],
            "tsr.wire_decode": [(100 * ms, 200 * ms), (600 * ms, 640 * ms)],
            "farm.matting": [(0, 5 * ms)]}
    dev = {"tsr.scene_codes": [(12 * ms, 40 * ms), (512 * ms, 532 * ms)],
           "tsr.density_grid": [(40 * ms, 50 * ms), (532 * ms, 542 * ms)], "farm.matting": [(1 * ms, 4 * ms)]}
    ops = [("flash_fwd_bf16<64>", 12 * ms, 22 * ms), ("gemm", 22 * ms, 40 * ms), ("density_mlp_bf16", 40 * ms, 50 * ms),
           ("fill", 150 * ms, 160 * ms), ("flash_fwd_bf16<64>", 512 * ms, 522 * ms), ("Memcpy DtoH", 522 * ms, 547 * ms)]
    return Trace((0, 1000 * ms), host, dev, ops, {"frontend_ms": [3.0, 5.0, 4.0], "verts": [1000, 3000]})


def test_readers_on_a_recorded_event_list(tiny_bench):
    from harness.cell import load_cell

    t = _trace()
    cell = load_cell("tiny-addon", tiny_bench)
    farm = load_cell("tiny-farm", tiny_bench)
    got = {m: r.read(t, cell) for m, r in cell.readers.items() if m in {x["name"] for x in cell.per_layer}}
    got.update({m: r.read(t, farm) for m, r in farm.readers.items() if m in {x["name"] for x in farm.per_layer}})
    assert got["frontend_ms.single"] == 4.0
    assert got["encode_ms.lean_single"] == pytest.approx(24.0)  # median of 28 and 20
    assert got["wire_decode_ms.lean_single"] == pytest.approx(70.0)
    assert got["wire_decode_ms.farm"] == pytest.approx(70.0)
    assert got["matting_ms.farm"] == pytest.approx(3.0)
    assert t.busy_s == pytest.approx(0.083) and t.window_s == pytest.approx(1.0)
    assert got["device_idle.single"] == pytest.approx(91.7)
    from counts.attention import tsr_bound_s
    from counts.density import lattice_bound_s
    from counts.model import request_flops

    assert got["attention_roofline.lean_single"] == pytest.approx(100 * 2 * tsr_bound_s(cell.config) / 0.020)
    assert got["density_roofline.lean_single"] == pytest.approx(100 * 2 * lattice_bound_s(cell.config, 32) / 0.020)
    flops = request_flops(cell.config, 32, 1000) + request_flops(cell.config, 32, 3000)
    assert got["mfu.single"] == pytest.approx(100 * flops / 1.0 / 989e12)
    bd = t.breakdown()
    assert bd["device_ops"][0][0] == "Memcpy DtoH" and len(bd["device_ops"]) <= 10
    # each gap is named by the innermost span open at its midpoint: the
    # 50-150 ms gap by the decode, the others by the window's own span
    names = dict(bd["idle_gaps"])
    assert names["tsr.wire_decode"] == pytest.approx(0.100)
    assert names["bench.window"] == pytest.approx(0.012 + 0.352 + 0.453)
    assert sum(names.values()) == pytest.approx(t.window_s - t.busy_s)


def test_readers_find_nothing_without_events(tiny_bench):
    from harness.cell import load_cell

    empty = Trace((0, 10), {"bench.window": [(0, 10)]}, {}, [], {})
    for name in ("tiny-addon", "tiny-farm"):
        cell = load_cell(name, tiny_bench)
        for m in cell.per_layer:
            assert cell.readers[m["name"]].read(empty, cell) is None, m["name"]
