"""Arithmetic the per-layer readers (``metrics/*.py``) share."""

import numpy as np


def median(values):
    return float(np.median(values)) if len(values) else None


def idle_percent(trace):
    if trace.window_s <= 0 or not trace.device_ops:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)


def mfu_percent(trace, cell):
    """Model operations of the window's completed requests over the traced
    window at the card's bfloat16 peak."""
    from counts import PEAK_BF16_FLOPS
    from counts.model import request_flops

    verts = trace.run.get("verts") or []
    if not verts or trace.window_s <= 0:
        return None
    R = cell.traffic["resolution"]
    total = sum(request_flops(cell.config, R, n) for n in verts)
    return 100.0 * total / trace.window_s / PEAK_BF16_FLOPS
