"""Median device range of the farm's ``farm.matting`` span per chunk: the
antialiased resize to 320^2, the u2net and the mask's resize back."""

from harness.readings import median


def read(trace, cell):
    return median(trace.device_ms("farm.matting"))
