"""Capacity retries per 100 lattice evaluations of the Pro requests:
``sf3d.capacity_retry`` spans over ``sf3d.grid`` spans (the retries' own
included), in percent."""

from harness.pro_spans import retries_per_100


def read(trace, cell):
    return retries_per_100(trace)
