"""Arithmetic on the program's own spans that per-layer readers
(``metrics/*.py``) share: a span's self time outside a child span, and
the capacity retries per lattice evaluation."""

import bisect

from harness.readings import median


def self_ms(trace, parent: str, child: str):
    """Median host milliseconds of ``parent``'s ranges less the parts that
    ``child``'s ranges inside them cover; None without ``parent``."""
    children = trace.host_spans.get(child, [])
    starts = [s for s, _ in children]
    out = []
    for s, e in trace.host_spans.get(parent, []):
        covered, at = 0, s
        for cs, ce in children[bisect.bisect_left(starts, s):bisect.bisect_right(starts, e)]:
            cs, ce = max(cs, at), min(ce, e)
            if ce > cs:
                covered += ce - cs
                at = ce
        out.append((e - s - covered) / 1e6)
    return median(out)


def retries_per_100(trace):
    """Re-extractions after a capacity overflow (``tsr.capacity_retry``)
    per 100 lattice evaluations (``tsr.density_grid``, the retries' own
    included). None where no lattice was evaluated, and where lattices
    outnumber the wire decodes (``tsr.wire_decode``, one an asset) with no
    retry span: a program that evaluated lattices again without marking
    them, whose retries this cannot count."""
    grids = len(trace.host_spans.get("tsr.density_grid", []))
    retries = len(trace.host_spans.get("tsr.capacity_retry", []))
    if not grids or (not retries and grids > len(trace.host_spans.get("tsr.wire_decode", []))):
        return None
    return 100.0 * retries / grids
