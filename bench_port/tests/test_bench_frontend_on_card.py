"""The reader of ``frontend_on_card.addon`` on a made-up trace, through the
tiny add-on cell that takes it from BENCHMARK.json."""

import pytest

from harness.trace import Trace

MS = 1_000_000


def _trace():
    host = {
        "bench.window": [(0, 1000 * MS)],
        "frontend.preprocess": [(0, 100 * MS), (500 * MS, 560 * MS)],
        "matting.remove": [(10 * MS, 80 * MS), (505 * MS, 525 * MS)],
    }
    return Trace((0, 1000 * MS), host, {}, [], {})


def test_frontend_on_card_reader(tiny_bench):
    """``frontend_on_card.addon`` reads 100 where every request's frontend
    ran on the card, 0 where none did (a program without the span), and
    None in a window with no ``frontend.preprocess``."""
    from harness.cell import load_cell

    reader = load_cell("tiny-addon", tiny_bench).readers["frontend_on_card.addon"]
    t = _trace()
    assert reader.read(t, None) == 0.0
    t.host_spans["frontend.on_card"] = [(1 * MS, 99 * MS), (501 * MS, 559 * MS)]
    assert reader.read(t, None) == pytest.approx(100.0)
    t.host_spans["frontend.on_card"].pop()
    assert reader.read(t, None) == pytest.approx(50.0)
    assert reader.read(Trace((0, 10), {"bench.window": [(0, 10)]}, {}, [], {}), None) is None
