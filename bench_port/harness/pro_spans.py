"""Arithmetic on SF3D's own spans that the Pro cells' per-layer readers
(``metrics/*.pro_single.py``) share."""


def retries_per_100(trace):
    """Re-extractions after a capacity overflow (``sf3d.capacity_retry``)
    per 100 lattice evaluations (``sf3d.grid``, the retries' own included).
    None where no lattice was evaluated, and where lattices outnumber the
    extractions (``sf3d.extract``, one an asset) with no retry span: a
    program that evaluated lattices again without marking them, whose
    retries this cannot count."""
    grids = len(trace.host_spans.get("sf3d.grid", []))
    retries = len(trace.host_spans.get("sf3d.capacity_retry", []))
    if not grids or (not retries and grids > len(trace.host_spans.get("sf3d.extract", []))):
        return None
    return 100.0 * retries / grids
