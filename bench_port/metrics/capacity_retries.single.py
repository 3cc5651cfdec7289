"""Capacity retries per 100 lattice evaluations of the add-on's requests:
``tsr.capacity_retry`` spans over ``tsr.density_grid`` spans (the
retries' own included), in percent."""

from harness.spans import retries_per_100


def read(trace, cell):
    return retries_per_100(trace)
