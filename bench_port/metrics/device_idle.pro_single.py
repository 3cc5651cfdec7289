"""Share of the traced window in which no device operation (kernel, copy
or fill) ran, in percent."""

from harness.readings import idle_percent


def read(trace, cell):
    return idle_percent(trace)
