"""Kernel K1's share of its roofline on the Pro requests: the bound of the
window's requests' attention calls (``counts/sf3d.py``: 24 DINOv2 layers,
12 CLIP layers and 4 x 8 backbone calls a request, bfloat16, each input
read once) over the device seconds of every attention kernel in the traced
window (K1's and PyTorch's SDPA's, so that the same work reads the same
whatever implements it), in percent. Nothing to read without an attention
kernel."""

from counts.attention import is_attention_kernel
from counts.sf3d import attention_bound_s


def read(trace, cell):
    seconds = trace.op_seconds(is_attention_kernel)
    encodes = len(trace.host_spans.get("sf3d.encode", []))
    if seconds <= 0 or not encodes:
        return None
    return 100.0 * encodes * attention_bound_s(cell.config) / seconds
