"""Kernel K2's share of its roofline: one R^3 lattice's bound per encode
(``counts/density.py``) over the summed device ranges of the program's
``tsr.density_grid`` spans (a capacity retry's second lattice counts as
time, not as work), in percent."""

from counts.density import lattice_bound_s


def read(trace, cell):
    spans = trace.device_ms("tsr.density_grid")
    encodes = len(trace.host_spans.get("tsr.scene_codes", []))
    if not spans or not encodes:
        return None
    bound = encodes * lattice_bound_s(cell.config, cell.traffic["resolution"])
    return 100.0 * bound / (sum(spans) / 1e3)
