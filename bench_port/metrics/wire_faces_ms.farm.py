"""Median host milliseconds of the program's ``tsr.wire_faces`` span per
asset of the farm: the native wire decoder rebuilding the faces (one
core)."""

from harness.readings import median


def read(trace, cell):
    return median(trace.host_ms("tsr.wire_faces"))
