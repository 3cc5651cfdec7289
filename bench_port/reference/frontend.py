"""Plain reference of the two frontends: the add-on's host path and the
farm's device path, each around the reference u2net (``reference/u2net.py``).

- ``preprocess_host``: rembg's ``remove`` on a PIL image (Lanczos to 320^2,
  the mask, back to the image's size, ``naive_cutout``), then TripoSR's
  ``preprocessing.py:73-128``: crop to the alpha bbox with its exclusive
  max bound, pad square, pad by ``ratio``, composite on 0.5 gray after the
  cutout's own premultiplication, Lanczos to 1024^2; None when the matte is
  empty or the square is under 250 px. The resizes and the cutout are
  PIL's, as in the published recipe; the network is the reference's.
- ``preprocess_device``: the farm's fused crop -> pad -> composite ->
  resize as one separable Lanczos-3 resample of a window of side
  floor(max(h, w) / ratio) around the alpha bbox's centre, each output row's
  taps renormalised inside the window (the farm's definition of the step).

Imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

OUTPUT_SIZE = 1024
MATTE_SIZE = 320


def preprocess_host(photo, ratio: float, use_alpha: bool, mask_fn):
    """``photo``: a PIL image; ``mask_fn``: (1, 320, 320, 3) [0, 1] tensor
    -> (1, 320, 320) mask. Returns a PIL image (RGB 1024^2, or RGBA at the
    padded size with ``use_alpha``) or None."""
    from PIL import Image

    raw = photo.convert("RGBA") if use_alpha else photo
    small = raw.convert("RGB").resize((MATTE_SIZE, MATTE_SIZE), Image.Resampling.LANCZOS)
    mask = mask_fn(torch.from_numpy(np.asarray(small, dtype=np.float32) / 255.0)[None])[0].cpu().numpy()
    mask_img = Image.fromarray((mask * 255).astype(np.uint8), mode="L").resize(raw.size, Image.Resampling.LANCZOS)
    cutout = Image.composite(raw, Image.new("RGBA", raw.size, 0), mask_img)

    arr = np.asarray(cutout)
    ys, xs = np.where(arr[..., 3] > 0)
    if len(ys) == 0:
        return None
    fg = arr[ys.min() : ys.max(), xs.min() : xs.max()]
    if fg.size == 0:
        return None
    size = max(fg.shape[0], fg.shape[1])
    ph0, pw0 = (size - fg.shape[0]) // 2, (size - fg.shape[1]) // 2
    fg = np.pad(fg, ((ph0, size - fg.shape[0] - ph0), (pw0, size - fg.shape[1] - pw0), (0, 0)))
    new_size = int(size / ratio)
    p0 = (new_size - size) // 2
    fg = np.pad(fg, ((p0, new_size - size - p0), (p0, new_size - size - p0), (0, 0)))
    if use_alpha:
        return Image.fromarray(fg, mode="RGBA")
    f = fg.astype(np.float32) / 255.0
    rgb = f[:, :, :3] * f[:, :, 3:4] + (1 - f[:, :, 3:4]) * 0.5
    out = Image.fromarray((rgb * 255.0).astype(np.uint8))
    if out.size[0] < 250:
        return None
    return out.resize((OUTPUT_SIZE, OUTPUT_SIZE), Image.Resampling.LANCZOS)


def _lanczos3(x: torch.Tensor) -> torch.Tensor:
    ax = x.abs()
    safe = torch.where(ax < 1e-6, 1e-6, ax)
    k = torch.where(ax < 1e-6, 1.0, torch.sinc(safe) * torch.sinc(safe / 3.0))
    return torch.where(ax < 3.0, k, 0.0)


def _window_matrix(src: int, out: int, start: torch.Tensor, stop: torch.Tensor) -> torch.Tensor:
    """(B, out, src) Lanczos-3 weights of output pixel centres over the
    source window [start, stop), the support widened by the downscale
    factor, taps outside the window zeroed, rows renormalised."""
    start, stop = start.float()[:, None, None], stop.float()[:, None, None]
    scale = (stop - start) / out
    centres = start + (torch.arange(out, dtype=torch.float32, device=start.device)[:, None] + 0.5) * scale
    taps = torch.arange(src, dtype=torch.float32, device=start.device) + 0.5
    w = _lanczos3((taps - centres) / scale.clamp(min=1.0))
    w = w * ((taps >= start) & (taps < stop)).float()
    denom = w.sum(-1, keepdim=True)
    return w / torch.where(denom == 0, 1.0, denom)


def preprocess_device(rgba: torch.Tensor, ratio: float, out_size: int, background: float = 0.5) -> torch.Tensor:
    """(B, H, W, 4) float [0, 1] -> (B, out, out, 3)."""
    alpha = rgba[..., 3]
    H, W = alpha.shape[-2:]
    fg = alpha > 0
    rows, cols = fg.any(-1), fg.any(-2)
    ri = torch.arange(H, device=rgba.device)
    ci = torch.arange(W, device=rgba.device)
    y1, y2 = torch.where(rows, ri, H).amin(-1), torch.where(rows, ri, -1).amax(-1)
    x1, x2 = torch.where(cols, ci, W).amin(-1), torch.where(cols, ci, -1).amax(-1)
    h, w = (y2 - y1).float(), (x2 - x1).float()
    side = torch.floor(torch.maximum(h, w) / ratio)
    cy, cx = y1.float() + h / 2, x1.float() + w / 2
    Wr = _window_matrix(H, out_size, cy - side / 2, cy + side / 2)
    Wc = _window_matrix(W, out_size, cx - side / 2, cx + side / 2)
    premult = torch.cat([rgba[..., :3] * rgba[..., 3:4], rgba[..., 3:4]], -1).float()
    x = torch.einsum("boh,bhwc->bowc", Wr, premult)
    x = torch.einsum("bpw,bowc->bopc", Wc, x)
    return (x[..., :3] + background * (1.0 - x[..., 3:4])).clamp(0.0, 1.0)


def matte_device(rgba: torch.Tensor, mask_fn) -> torch.Tensor:
    """The farm's matting of (B, H, W, 4) RGBA: antialiased bilinear to
    320^2, the mask, back to (H, W) the same way, as the new alpha."""
    H, W = rgba.shape[1:3]
    small = F.interpolate(rgba[..., :3].permute(0, 3, 1, 2).float(), size=(MATTE_SIZE, MATTE_SIZE),
                          mode="bilinear", align_corners=False, antialias=True).permute(0, 2, 3, 1)
    mask = mask_fn(small)
    alpha = F.interpolate(mask[:, None], size=(H, W), mode="bilinear", align_corners=False, antialias=True)
    return torch.cat([rgba[..., :3].float(), alpha.permute(0, 2, 3, 1)], -1)
