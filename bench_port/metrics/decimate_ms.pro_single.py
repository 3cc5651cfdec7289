"""Mean host milliseconds of the program's ``sf3d.decimate`` span per
request: the quadric decimation to the vertex budget. The mean, not the
median: only the requests whose welded mesh is over the budget decimate,
about half of them, so the median would flip between the two groups with
the window's draw of photos."""

import numpy as np


def read(trace, cell):
    ms = trace.host_ms("sf3d.decimate")
    return float(np.mean(ms)) if ms else None
