"""The readers of ``u2net_replayed.farm`` and ``u2net_replayed.addon`` on a
made-up trace, through the tiny cells that take them from BENCHMARK.json."""

import pytest

from harness.trace import Trace

MS = 1_000_000


def _trace():
    host = {
        "bench.window": [(0, 1000 * MS)],
        "matting.u2net": [(10 * MS, 11 * MS), (500 * MS, 501 * MS)],
    }
    return Trace((0, 1000 * MS), host, {}, [], {})


@pytest.mark.parametrize("cell,name", [("tiny-farm", "u2net_replayed.farm"), ("tiny-addon", "u2net_replayed.addon")])
def test_u2net_replayed_reader(tiny_bench, cell, name):
    """100 where every ``matting.u2net`` call replayed its graph, 0 where
    none did (a program without the span), the share in between, and None
    in a window with no ``matting.u2net``."""
    from harness.cell import load_cell

    reader = load_cell(cell, tiny_bench).readers[name]
    t = _trace()
    assert reader.read(t, None) == 0.0
    t.host_spans["matting.u2net_replay"] = [(10 * MS + 5, 11 * MS - 5), (500 * MS + 5, 501 * MS - 5)]
    assert reader.read(t, None) == pytest.approx(100.0)
    t.host_spans["matting.u2net_replay"].pop()
    assert reader.read(t, None) == pytest.approx(50.0)
    assert reader.read(Trace((0, 10), {"bench.window": [(0, 10)]}, {}, [], {}), None) is None
