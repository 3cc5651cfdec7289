"""Seconds from the process's start to the first timed request: imports,
weights, the program's build (kernel libraries built or loaded), the
iso-level's calibration and the warm-up of the cell's own shapes."""


def read(stats, cell):
    return stats.get("setup_s")
