"""Kernel K5's share of its roofline: the (res + 1)^3 lattice's bound
(``counts/sf3d.py``, the density and vertex-offset heads) per lattice
evaluated over the summed device ranges of the program's ``sf3d.grid``
spans (the plane resampling and the first layer's partial sums included),
in percent."""

from counts.sf3d import grid_bound_s


def read(trace, cell):
    spans = trace.device_ms("sf3d.grid")
    if not spans:
        return None
    return 100.0 * len(spans) * grid_bound_s(cell.config) / (sum(spans) / 1e3)
