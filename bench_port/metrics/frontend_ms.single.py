"""Median milliseconds of the frontend per request: the benchmark's own
host-clock span around ``preprocess_image`` (matting, crop, pad, Lanczos)."""

from harness.readings import median


def read(trace, cell):
    return median(trace.run.get("frontend_ms") or [])
