"""Kernel K1's share of its roofline on the Lean encode: the bound of the
window's encodes' attention calls (``counts/attention.py``: 12 ViT layers
and 16 x 2 backbone calls an encode, bfloat16, each input read once) over
the device seconds of every attention kernel in the traced window (K1's
and PyTorch's SDPA's, so that the same work reads the same whatever
implements it), in percent. Nothing to read without an attention kernel."""

from counts.attention import is_attention_kernel, tsr_bound_s


def read(trace, cell):
    seconds = trace.op_seconds(is_attention_kernel)
    encodes = len(trace.host_spans.get("tsr.scene_codes", []))
    if seconds <= 0 or not encodes:
        return None
    return 100.0 * encodes * tsr_bound_s(cell.config) / seconds
