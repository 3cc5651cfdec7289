"""Median seconds from the image handed to the entry to the host mesh
arrays returned, over every request of the window (host clock)."""

import numpy as np


def read(stats, cell):
    lat = stats.get("latencies_s") or []
    return float(np.median(lat)) if lat else None
