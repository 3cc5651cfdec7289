"""Median host milliseconds of the program's ``frontend.preprocess`` span
per request outside the ``matting.remove`` it holds: the bbox, crop and
pads, the composite on gray and the Lanczos to 1024^2."""

from harness.spans import self_ms


def read(trace, cell):
    return self_ms(trace, "frontend.preprocess", "matting.remove")
