"""The whole request's share of the card's bfloat16 peak: the model
operations of the window's completed requests (``counts/sf3d.py``: the
encode, the CLIP estimator, the two lattice heads at every point of the
(res + 1)^3 lattice, the two texel heads at every texel of the bake) over
the traced window's seconds and 989 TFLOP/s, in percent."""

from counts import PEAK_BF16_FLOPS
from counts.sf3d import request_flops


def read(trace, cell):
    done = trace.run.get("completed") or 0
    if not done or trace.window_s <= 0:
        return None
    total = done * request_flops(cell.config, cell.traffic["bake_resolution"])
    return 100.0 * total / trace.window_s / PEAK_BF16_FLOPS
