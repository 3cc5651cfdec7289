"""Median host milliseconds of the program's ``matting.u2net`` span per
request: the host's dispatch of the u2net's launches."""

from harness.readings import median


def read(trace, cell):
    return median(trace.host_ms("matting.u2net"))
