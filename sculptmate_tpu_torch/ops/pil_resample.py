"""PIL-exact Lanczos resampling of uint8 images, and the add-on's condition
image built inside it (kernel K12, ``csrc/pil_resample.cu``).

Replaces no TPU kernel. The add-on's frontend (``frontend/preprocess.py:
preprocess_image``) resizes with PIL on the host; on the card the same bytes
come from here:

- ``resample_photo``: ``Image.resize(size, LANCZOS)`` of an (H, W, 3) uint8
  photo, divided by 255 in float32 (the matting network's input);
- ``resample_mask``: the same resize of an (H, W) float32 mask read as PIL's
  L image of it (``uint8(255 m)``, truncated), with the bbox of its texels
  above 0 folded in (``bbox_bounds``);
- ``condition_image``: the cutout of a photo under its mask, cropped and
  padded into a square (``Crop``), composited on 0.5 gray in float32 and
  resized to ``out``^2, as ``preprocess_image``'s host path computes it;
- ``padded_cutout``: the same square as RGBA, for the Pro button.

The taps are Pillow's (``Resample.c``: ``precompute_coeffs`` in float64,
``normalize_coeffs_8bpc`` to int32 with 22 fractional bits), built on the
host and kept on the card per (in, out) pair. A CUDA tensor goes to K12; a
CPU tensor to the plain versions beside each wrapper, in int64 arithmetic
(and numpy's float32 steps for the composite), which the tests hold to PIL.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Tuple

import numpy as np
import torch

from sculptmate_tpu_torch.runtime import kernels

PRECISION_BITS = 22  # Pillow's for 8 bits a channel: 32 - 8 - 2
_SRC_U8, _SRC_MASK, _SRC_CONDITION = 0, 1, 2  # pil_resample_h's sources
_OUT_RGB_U8, _OUT_RGB_F32, _OUT_L_BBOX = 0, 1, 2  # pil_resample_v's forms


def _sinc(x: np.ndarray) -> np.ndarray:
    px = x * np.pi
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(x == 0.0, 1.0, np.sin(px) / px)


def _lanczos(x: np.ndarray) -> np.ndarray:
    return np.where((-3.0 <= x) & (x < 3.0), _sinc(x) * _sinc(x / 3), 0.0)


@functools.lru_cache(maxsize=256)
def taps(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pillow's Lanczos taps for ``in_size`` -> ``out_size`` texels along
    one axis: (out, 2) int32 (first texel, count) and (out, ksize) int32
    coefficients with 22 fractional bits, zero past each count. The float64
    arithmetic is ``precompute_coeffs``'s step for step (its sum of weights
    in its order), rounded as ``normalize_coeffs_8bpc`` rounds."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 3.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)  # C's (int) truncates toward zero
    count = np.minimum((center + support + 0.5).astype(np.int64), in_size) - xmin
    j = np.arange(ksize)
    w = np.where(j < count[:, None], _lanczos(((j + xmin[:, None]) - center[:, None] + 0.5) * (1.0 / filterscale)), 0.0)
    total = np.zeros(out_size)
    for col in w.T:
        total += col
    k = np.divide(w, total[:, None], out=w.copy(), where=total[:, None] != 0.0)
    kk = np.trunc(k * (1 << PRECISION_BITS) + np.where(k < 0, -0.5, 0.5)).astype(np.int32)
    return np.stack([xmin, count], axis=1).astype(np.int32), kk


@functools.lru_cache(maxsize=256)
def _taps_on(in_size: int, out_size: int, device: torch.device) -> Tuple[torch.Tensor, int]:
    """``taps`` as K12 reads them, on ``device``: the (first, count) pairs,
    then the coefficient rows, in one int32 tensor; and ksize."""
    bounds, kk = taps(in_size, out_size)
    return torch.from_numpy(np.concatenate([bounds.ravel(), kk.ravel()])).to(device), kk.shape[1]


def _lib():
    lib = kernels.load("pil_resample")
    if lib.pil_resample_h.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.pil_resample_h.argtypes = [i, p, p] + [i] * 10 + [p, i, i, p, p]
        lib.pil_resample_v.argtypes = [i, p, i, p, i, i, p, p, p]
        lib.pil_cutout_rgba.argtypes = [p, p] + [i] * 9 + [p, p]
        for fn in (lib.pil_resample_h, lib.pil_resample_v, lib.pil_cutout_rgba):
            fn.restype = ctypes.c_int
    return lib


def _two_passes(source: int, form: int, src: torch.Tensor, in_hw: Tuple[int, int], size: Tuple[int, int],
                out: torch.Tensor, mask=None, crop_args=(0,) * 8, bbox=None) -> None:
    """K12's two launches of one resize on ``src``'s stream: the horizontal
    pass from ``source`` into an 8-bit intermediate, the vertical pass into
    ``out`` in ``form``."""
    lib = _lib()
    (H, W), (w, h) = in_hw, size
    th, kh = _taps_on(W, w, src.device)
    tv, kv = _taps_on(H, h, src.device)
    tmp = torch.empty((H, w, 1 if source == _SRC_MASK else 3), dtype=torch.uint8, device=src.device)
    stream = torch.cuda.current_stream(src.device).cuda_stream
    err = lib.pil_resample_h(source, src.data_ptr(), None if mask is None else mask.data_ptr(), *crop_args, H, W,
                             th.data_ptr(), kh, w, tmp.data_ptr(), stream)
    kernels.check(err, "pil_resample_h")
    err = lib.pil_resample_v(form, tmp.data_ptr(), w, tv.data_ptr(), kv, h, out.data_ptr(),
                             None if bbox is None else bbox.data_ptr(), stream)
    kernels.check(err, "pil_resample_v")


def _div255f(x: torch.Tensor) -> torch.Tensor:
    """float32 x / 255, rounded once, on any device: PyTorch on CUDA divides
    by a Python number as a multiply by its reciprocal, so the divisor is a
    tensor."""
    return x.float() / torch.tensor(255.0, device=x.device)


def _pass_plain(x: torch.Tensor, axis: int, out_size: int) -> torch.Tensor:
    """One of Pillow's passes along ``axis`` of a uint8 tensor, in int64:
    the taps' sum plus half a unit, clipped to 8 bits."""
    bounds, kk = taps(x.shape[axis], out_size)
    first = torch.from_numpy(bounds[:, 0]).long().to(x.device)
    kk = torch.from_numpy(kk).long().to(x.device)
    shape = [1] * x.dim()
    shape[axis] = out_size
    acc = None
    for j in range(kk.shape[1]):
        idx = (first + j).clamp(max=x.shape[axis] - 1)  # past a texel's count its coefficient is 0
        term = x.index_select(axis, idx).long() * kk[:, j].view(shape)
        acc = term + (1 << (PRECISION_BITS - 1)) if acc is None else acc.add_(term)
    return (acc >> PRECISION_BITS).clamp_(0, 255).to(torch.uint8)


def resample_plain(src: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Plain version of K12's resize: ``Image.resize(size, LANCZOS)`` of an
    (H, W, C) uint8 image (C 1 for L, 3 for RGB) -> (h, w, C) uint8, ``size``
    = (w, h) as PIL takes it; the horizontal pass first, as Pillow runs it."""
    w, h = size
    return _pass_plain(_pass_plain(src, 1, w), 0, h)


def resample_photo_plain(photo: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Plain version of ``resample_photo``."""
    return _div255f(resample_plain(photo, size))


def resample_photo(photo: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """The matting network's input: an (H, W, 3) uint8 photo resized as
    ``Image.resize(size, LANCZOS)`` and divided by 255 in float32, (h, w, 3),
    the bytes of ``SessionBase._small``. K12 on a CUDA tensor (two
    launches), the plain version on a CPU tensor; other layouts raise."""
    if photo.dim() != 3 or photo.shape[2] != 3 or photo.dtype != torch.uint8 or not photo.is_contiguous():
        raise ValueError(f"resample_photo takes a contiguous (H, W, 3) uint8 photo, got {photo.dtype} "
                         f"{tuple(photo.shape)}")
    if not photo.is_cuda:
        return resample_photo_plain(photo, size)
    out = torch.empty((size[1], size[0], 3), dtype=torch.float32, device=photo.device)
    _two_passes(_SRC_U8, _OUT_RGB_F32, photo, photo.shape[:2], size, out)
    resample_photo.launches += 2
    return out


resample_photo.launches = 0


def _encoded_bbox(mask: torch.Tensor) -> torch.Tensor:
    """An (H, W) mask's bbox of texels above 0 as K12 folds it:
    (H - y1, y2 + 1, W - x1, x2 + 1), all 0 for an empty mask."""
    fg = mask > 0
    rows, cols = fg.any(dim=1).nonzero()[:, 0], fg.any(dim=0).nonzero()[:, 0]
    if rows.numel() == 0:
        return torch.zeros(4, dtype=torch.int32, device=mask.device)
    H, W = mask.shape
    bounds = [H - int(rows[0]), int(rows[-1]) + 1, W - int(cols[0]), int(cols[-1]) + 1]
    return torch.tensor(bounds, dtype=torch.int32, device=mask.device)


def bbox_bounds(bbox: torch.Tensor, H: int, W: int) -> Tuple[int, int, int, int]:
    """``resample_mask``'s bbox on the host (a wait for the card): (y1, y2,
    x1, x2) with the last texels' indices as the max bounds; y1 = H, y2 = -1
    (x likewise) for an empty mask."""
    a, b, c, d = bbox.tolist()
    return H - a, b - 1, W - c, d - 1


def resample_mask_plain(mask: torch.Tensor, size: Tuple[int, int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``resample_mask``."""
    out = resample_plain((mask * 255).to(torch.uint8)[..., None], size)[..., 0]
    return out, _encoded_bbox(out)


def resample_mask(mask: torch.Tensor, size: Tuple[int, int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The matting's mask at the photo's size: PIL's L image of an (H, W)
    float32 mask in [0, 1] (``uint8(255 m)``, truncated) resized as
    ``Image.resize(size, LANCZOS)`` -> (h, w) uint8, the bytes of
    ``SessionBase.predict_mask``, and the int32 (4,) bbox of its texels above
    0 (``bbox_bounds`` reads it). K12 on a CUDA tensor (two launches, the
    bbox folded into the second), the plain version on a CPU tensor; other
    layouts raise."""
    if mask.dim() != 2 or mask.dtype != torch.float32 or not mask.is_contiguous():
        raise ValueError(f"resample_mask takes a contiguous (H, W) float32 mask, got {mask.dtype} "
                         f"{tuple(mask.shape)}")
    if not mask.is_cuda:
        return resample_mask_plain(mask, size)
    out = torch.empty((size[1], size[0]), dtype=torch.uint8, device=mask.device)
    bbox = torch.empty(4, dtype=torch.int32, device=mask.device)
    _two_passes(_SRC_MASK, _OUT_L_BBOX, mask, mask.shape, size, out, bbox=bbox)
    resample_mask.launches += 2
    return out, bbox


resample_mask.launches = 0


@dataclasses.dataclass(frozen=True)
class Crop:
    """Where a photo's cutout sits in the padded square of side ``side``:
    square rows [oy, oy + hc) and columns [ox, ox + wc) hold the photo's
    texels from (y1, x1) on; the rest is empty."""

    y1: int
    x1: int
    hc: int
    wc: int
    oy: int
    ox: int
    side: int

    def args(self, photo: torch.Tensor) -> tuple:
        """K12's (oy, ox, hc, wc, y1, x1, photo_h, photo_w)."""
        return self.oy, self.ox, self.hc, self.wc, self.y1, self.x1, photo.shape[0], photo.shape[1]


def _check_cutout(photo: torch.Tensor, mask: torch.Tensor, crop: Crop) -> None:
    H, W = photo.shape[:2]
    if (photo.dim() != 3 or photo.shape[2] != 3 or photo.dtype != torch.uint8 or mask.shape != (H, W)
            or mask.dtype != torch.uint8 or not photo.is_contiguous() or not mask.is_contiguous()
            or mask.device != photo.device):
        raise ValueError(f"takes a contiguous (H, W, 3) uint8 photo and its (H, W) uint8 mask on one device, got "
                         f"{photo.dtype} {tuple(photo.shape)} and {mask.dtype} {tuple(mask.shape)}")
    if not (0 <= crop.y1 and crop.y1 + crop.hc <= H and 0 <= crop.x1 and crop.x1 + crop.wc <= W and 0 <= crop.oy
            and crop.oy + crop.hc <= crop.side and 0 <= crop.ox and crop.ox + crop.wc <= crop.side):
        raise ValueError(f"{crop} does not fit a {H} x {W} photo")


def _div255(a: torch.Tensor) -> torch.Tensor:
    """Pillow's DIV255 (``Paste.c``): a / 255 rounded, for a in [0, 255^2]."""
    t = a + 128
    return (t + (t >> 8)) >> 8


def _square_plain(photo: torch.Tensor, mask: torch.Tensor, crop: Crop, rgba: bool) -> torch.Tensor:
    """The padded square, plainly: the photo's cutout under its mask
    (``Image.composite`` onto an empty RGBA canvas, ``Paste.c``'s blend), as
    RGBA with zeros around it, or composited on 0.5 gray with numpy's float32
    steps (each rounded on its own) and truncated, gray 127 around it."""
    c = photo[crop.y1:crop.y1 + crop.hc, crop.x1:crop.x1 + crop.wc].long()
    m = mask[crop.y1:crop.y1 + crop.hc, crop.x1:crop.x1 + crop.wc].long()[..., None]
    cut, a = _div255(c * m), _div255(255 * m)
    if rgba:
        region, fill = torch.cat([cut, a], dim=-1).to(torch.uint8), 0
    else:
        fc, fa = _div255f(cut), _div255f(a)
        region, fill = ((fc * fa + (1 - fa) * 0.5) * 255).to(torch.uint8), 127
    out = torch.full((crop.side, crop.side, region.shape[-1]), fill, dtype=torch.uint8, device=photo.device)
    out[crop.oy:crop.oy + crop.hc, crop.ox:crop.ox + crop.wc] = region
    return out


def condition_image_plain(photo: torch.Tensor, mask: torch.Tensor, crop: Crop, out_size: int) -> torch.Tensor:
    """Plain version of K12's condition image: the gray-composited square,
    then ``resample_plain`` to ``out_size``^2."""
    return resample_plain(_square_plain(photo, mask, crop, rgba=False), (out_size, out_size))


def condition_image(photo: torch.Tensor, mask: torch.Tensor, crop: Crop, out_size: int) -> torch.Tensor:
    """The add-on's condition image: the (H, W, 3) uint8 photo's cutout under
    its (H, W) uint8 mask, placed in the padded square ``crop`` describes,
    composited on 0.5 gray and resized to (out_size, out_size, 3) uint8, the
    bytes ``preprocess_image``'s host path gives. K12 on CUDA tensors (two
    launches; the square is never stored), the plain version on CPU ones."""
    _check_cutout(photo, mask, crop)
    if not photo.is_cuda:
        return condition_image_plain(photo, mask, crop, out_size)
    out = torch.empty((out_size, out_size, 3), dtype=torch.uint8, device=photo.device)
    _two_passes(_SRC_CONDITION, _OUT_RGB_U8, photo, (crop.side, crop.side), (out_size, out_size), out, mask=mask,
                crop_args=crop.args(photo))
    condition_image.launches += 2
    return out


condition_image.launches = 0


def padded_cutout_plain(photo: torch.Tensor, mask: torch.Tensor, crop: Crop) -> torch.Tensor:
    """Plain version of K12's padded RGBA square."""
    return _square_plain(photo, mask, crop, rgba=True)


def padded_cutout(photo: torch.Tensor, mask: torch.Tensor, crop: Crop) -> torch.Tensor:
    """The Pro button's (side, side, 4) uint8 square: the photo's cutout
    under its mask where ``crop`` places it, zeros around it. K12's gather on
    CUDA tensors (one launch), the plain version on CPU ones."""
    _check_cutout(photo, mask, crop)
    if not photo.is_cuda:
        return padded_cutout_plain(photo, mask, crop)
    out = torch.empty((crop.side, crop.side, 4), dtype=torch.uint8, device=photo.device)
    err = _lib().pil_cutout_rgba(photo.data_ptr(), mask.data_ptr(), *crop.args(photo), crop.side, out.data_ptr(),
                                 torch.cuda.current_stream(photo.device).cuda_stream)
    kernels.check(err, "pil_cutout_rgba")
    padded_cutout.launches += 1
    return out


padded_cutout.launches = 0
