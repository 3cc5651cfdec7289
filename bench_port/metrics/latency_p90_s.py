"""The 90th percentile (linear interpolation) of the request latencies of
the whole window (host clock)."""

import numpy as np


def read(stats, cell):
    lat = stats.get("latencies_s") or []
    return float(np.percentile(lat, 90)) if lat else None
