"""Median host milliseconds of the program's ``sf3d.wire_decode`` span per
request: the native decoder rebuilding the marching-tets faces from the
wire and welding the snapped vertices."""

from harness.readings import median


def read(trace, cell):
    return median(trace.host_ms("sf3d.wire_decode"))
