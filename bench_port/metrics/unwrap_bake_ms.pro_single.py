"""Median host milliseconds of the program's ``sf3d.unwrap_bake`` span per
request: the fused UV unwrap and texture bake, dispatched, waited for and
encoded to PNGs."""

from harness.readings import median


def read(trace, cell):
    return median(trace.host_ms("sf3d.unwrap_bake"))
