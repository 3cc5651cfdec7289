"""Operation and byte counts from shapes, and the card's published peaks.

The yardstick of the roofline and ``mfu`` metrics, copied from
``chip_smoke.py`` (``bound_ms`` and the K1 and K2 checks' counts) so that
a change to the program cannot move it. Each count says which shapes it
reads and whether it counts operations or bytes; a bound is the larger of
operations over the peak rate and bytes over the peak bandwidth, each input
byte read once and each output byte written once.
"""

# NVIDIA H100 SXM, dense, at its 700 W limit (NVIDIA's data sheet)
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def bound_s(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS) -> float:
    """The least time the card could take: max(operations / peak rate,
    bytes / peak bandwidth), in seconds."""
    return max(flops / peak_flops, nbytes / PEAK_BYTES)
