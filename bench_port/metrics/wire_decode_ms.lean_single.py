"""Median host milliseconds of the program's ``tsr.wire_decode`` span per
request: the native wire decoder rebuilding the faces, and the colors."""

from harness.readings import median


def read(trace, cell):
    return median(trace.host_ms("tsr.wire_decode"))
