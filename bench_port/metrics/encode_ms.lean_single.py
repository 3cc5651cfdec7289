"""Median device range (first kernel's start to last kernel's end) of the
program's ``tsr.scene_codes`` span per request: the ViT, the triplane
backbone and the upsample."""

from harness.readings import median


def read(trace, cell):
    return median(trace.device_ms("tsr.scene_codes"))
