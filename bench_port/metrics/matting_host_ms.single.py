"""Median host milliseconds of the program's ``matting.remove`` span per
request: the u2net session's Lanczos to 320^2, the network's dispatch, the
wait for its mask, the Lanczos back up and the cutout."""

from harness.readings import median


def read(trace, cell):
    return median(trace.host_ms("matting.remove"))
