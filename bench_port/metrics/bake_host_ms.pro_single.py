"""Median host milliseconds of the program's ``sf3d.unwrap_bake`` span per
request outside the ``sf3d.bake_wait`` it holds: the bake's host work (the
rotation, quantisation and uploads of ``sf3d.bake_prep``, the dispatch,
the PNG encode of ``sf3d.png_encode``). Nothing to read where the program
has no ``sf3d.bake_wait`` span."""

from harness.spans import self_ms


def read(trace, cell):
    if not trace.host_spans.get("sf3d.bake_wait"):
        return None
    return self_ms(trace, "sf3d.unwrap_bake", "sf3d.bake_wait")
