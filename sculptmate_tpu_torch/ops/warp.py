"""Dynamic-window separable resampling as dense matrix products.

Counterpart of ``sculptmate_tpu/ops/warp.py``. The frontend's crop -> pad ->
resize chain has a data-dependent window (the alpha bbox), so it is written
as one separable resample whose (out, src) matrices are built from window
edges held in tensors: the shapes stay fixed and nothing is read back to
the host. Rows are output pixels, columns source pixels; Lanczos-3 or
linear taps at each output center, the support dilated by the downscale
factor, taps outside the window zeroed and each row renormalised to sum to
1 (a row with no weight is left at 0).

Every window argument may carry leading batch dimensions, so one call
builds a (B, out, src) matrix per image.
"""

from __future__ import annotations

import torch


def _lanczos3(x: torch.Tensor) -> torch.Tensor:
    """Lanczos-3 kernel; ``torch.sinc`` is the normalised sinc."""
    ax = x.abs()
    safe = torch.where(ax < 1e-6, 1e-6, ax)
    k = torch.sinc(safe) * torch.sinc(safe / 3.0)
    k = torch.where(ax < 1e-6, 1.0, k)
    return torch.where(ax < 3.0, k, 0.0)


def resample_matrix(
    src_size: int,
    out_size: int,
    region_start,
    region_stop,
    method: str = "lanczos3",
) -> torch.Tensor:
    """(..., out_size, src_size) matrix resampling the source pixels in
    [region_start, region_stop) onto ``out_size`` output pixels.

    ``region_start``/``region_stop`` are float tensors (or numbers) in
    source pixel units, of any matching batch shape. Output pixel i's
    center maps to ``region_start + (i + 0.5) * scale`` with ``scale =
    region / out_size``."""
    start = torch.as_tensor(region_start, dtype=torch.float32)
    stop = torch.as_tensor(region_stop, dtype=torch.float32, device=start.device)
    start, stop = start[..., None, None], stop[..., None, None]
    region = stop - start
    scale = region / out_size
    support_scale = torch.clamp(scale, min=1.0)

    centers = start + (torch.arange(out_size, dtype=torch.float32, device=start.device)[:, None] + 0.5) * scale
    taps = torch.arange(src_size, dtype=torch.float32, device=start.device) + 0.5
    d = (taps - centers) / support_scale

    if method == "lanczos3":
        w = _lanczos3(d)
    elif method == "linear":
        w = torch.clamp(1.0 - d.abs(), min=0.0)
    else:
        raise ValueError(method)

    in_region = (taps >= start) & (taps < stop)
    w = w * in_region.to(w.dtype)
    denom = w.sum(dim=-1, keepdim=True)
    return w / torch.where(denom == 0, 1.0, denom)


def separable_resample(
    image: torch.Tensor,
    out_hw,
    row_window,
    col_window,
    method: str = "lanczos3",
) -> torch.Tensor:
    """Resample (H, W, C), or (B, H, W, C) with per-image windows: rows in
    ``row_window`` -> out_hw[0], columns in ``col_window`` -> out_hw[1].
    Windows are (start, stop) pairs of scalars, or of (B,) tensors."""
    H, W = image.shape[-3], image.shape[-2]
    Wr = resample_matrix(H, out_hw[0], row_window[0], row_window[1], method).to(image.device)
    Wc = resample_matrix(W, out_hw[1], col_window[0], col_window[1], method).to(image.device)
    x = image.float()
    out = torch.einsum("...oh,...hwc->...owc", Wr, x)
    return torch.einsum("...pw,...owc->...opc", Wc, out)
