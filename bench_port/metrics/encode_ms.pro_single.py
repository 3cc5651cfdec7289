"""Median device range (first kernel's start to last kernel's end) of the
program's ``sf3d.encode`` span per request: the image's resize, the camera
embedder, DINOv2, the two-stream backbone, the pixel-shuffle upsample and
the CLIP estimator."""

from harness.readings import median


def read(trace, cell):
    return median(trace.device_ms("sf3d.encode"))
