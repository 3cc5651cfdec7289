"""The whole request's share of the card's bfloat16 peak: the model
operations of the window's completed requests (``counts/model.py``: the
encode, the R^3 lattice MLP, the MLP at every mesh vertex) over the traced
window's seconds and 989 TFLOP/s, in percent."""

from harness.readings import mfu_percent


def read(trace, cell):
    return mfu_percent(trace, cell)
