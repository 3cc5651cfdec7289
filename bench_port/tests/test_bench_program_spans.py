"""The readers of the program's own spans (the frontend's and the
matting's, the wire decoder's faces, the capacity retries) on a made-up
trace, through the tiny cells that take them from BENCHMARK.json."""

import pytest

from harness.trace import Trace

MS = 1_000_000


def _trace():
    host = {
        "bench.window": [(0, 1000 * MS)],
        # two requests: 100 ms and 60 ms of frontend, of which the matting
        # holds 70 ms and 20 ms
        "frontend.preprocess": [(0, 100 * MS), (500 * MS, 560 * MS)],
        "matting.remove": [(10 * MS, 80 * MS), (505 * MS, 525 * MS)],
        "matting.u2net": [(20 * MS, 24 * MS), (510 * MS, 516 * MS)],
        "tsr.wire_decode": [(200 * MS, 260 * MS), (700 * MS, 740 * MS)],
        "tsr.wire_faces": [(201 * MS, 251 * MS), (701 * MS, 731 * MS)],
        # the first request's lattice overflowed and was evaluated again
        "tsr.density_grid": [(150 * MS, 151 * MS), (170 * MS, 171 * MS)],
        "tsr.capacity_retry": [(169 * MS, 175 * MS)],
    }
    return Trace((0, 1000 * MS), host, {}, [], {})


def _read(cell, trace):
    return {m["name"]: cell.readers[m["name"]].read(trace, cell) for m in cell.per_layer}


def test_program_span_readers(tiny_bench):
    from harness.cell import load_cell

    t = _trace()
    addon = _read(load_cell("tiny-addon", tiny_bench), t)
    farm = _read(load_cell("tiny-farm", tiny_bench), t)
    assert addon["matting_host_ms.single"] == pytest.approx(45.0)  # median of 70 and 20
    # self time outside the matting: 100 - 70 and 60 - 20
    assert addon["frontend_image_ms.single"] == pytest.approx(35.0)
    assert addon["u2net_dispatch_ms.single"] == pytest.approx(5.0)
    assert farm["u2net_dispatch_ms.farm"] == pytest.approx(5.0)
    assert addon["wire_faces_ms.lean_single"] == pytest.approx(40.0)
    assert farm["wire_faces_ms.farm"] == pytest.approx(40.0)
    assert addon["capacity_retries.single"] == pytest.approx(50.0)
    assert farm["capacity_retries.farm"] == pytest.approx(50.0)


def test_program_span_readers_without_their_spans(tiny_bench):
    """Each new reader returns None on a window without its spans; the
    retries read 0 where each asset's lattice ran once, and None where
    lattices ran again with no retry span around them (a program that does
    not mark its retries)."""
    from harness.cell import load_cell

    names = {"matting_host_ms.single", "frontend_image_ms.single", "u2net_dispatch_ms.single",
             "wire_faces_ms.lean_single", "capacity_retries.single", "u2net_dispatch_ms.farm",
             "wire_faces_ms.farm", "capacity_retries.farm"}
    empty = Trace((0, 10), {"bench.window": [(0, 10)]}, {}, [], {})
    got = {}
    for name in ("tiny-addon", "tiny-farm"):
        got.update(_read(load_cell(name, tiny_bench), empty))
    assert names <= set(got) and all(got[n] is None for n in names)
    farm = load_cell("tiny-farm", tiny_bench)
    host = {"bench.window": [(0, 10 * MS)], "tsr.density_grid": [(1 * MS, 2 * MS)],
            "tsr.wire_decode": [(3 * MS, 4 * MS)]}
    assert _read(farm, Trace((0, 10 * MS), host, {}, [], {}))["capacity_retries.farm"] == 0.0
    host["tsr.density_grid"].append((5 * MS, 6 * MS))
    assert _read(farm, Trace((0, 10 * MS), host, {}, [], {}))["capacity_retries.farm"] is None
