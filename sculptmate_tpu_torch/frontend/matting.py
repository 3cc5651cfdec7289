"""Background removal (``rembg.remove``) on the port's u2net.

Counterpart of ``sculptmate_tpu/frontend/matting.py``, after the reference's
``rembg/bg.py:149-238`` with the u2net session recipe
(``rembg/sessions/u2net.py:16-46``, ``sessions/base.py:44-69``):

  input -> Lanczos to 320^2 -> /max -> ImageNet mean/std -> u2net ->
  sigmoid of d0, min-max normalised -> mask back to the input size -> alpha.

The network and its normalisation run on the device in f32
(``U2NetMatting.predict_mask_batch``). The host surface (``predict_mask``,
``remove``) works on PIL images; PIL and cv2 are imported inside the
functions that use them, so the device path needs neither.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from sculptmate_tpu_torch.frontend.u2net import U2Net
from sculptmate_tpu_torch.runtime.device import resolve_device

U2NET_SIZE = 320
_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


class U2NetMatting:
    """The full u2net on a device, and its mask predictor.

    ``state_dict`` holds the original U-2-Net names (``u2net.onnx``'s
    initializers); without one the weights are random from ``seed``.
    ``device`` defaults to the card and raises without one (pass
    ``device="cpu"`` for the CPU)."""

    def __init__(self, state_dict=None, seed: int = 0, device=None):
        self.device = resolve_device(device)
        with torch.device(self.device):
            self.module = U2Net()
        if state_dict is None:
            self.module.reset_parameters(torch.Generator(device=self.device).manual_seed(seed))
        else:
            self.module.load_state_dict(state_dict)
        self.module.eval().requires_grad_(False)
        self._mean = torch.tensor(_MEAN, device=self.device)
        self._std = torch.tensor(_STD, device=self.device)

    @torch.inference_mode()
    def _predict(self, img: torch.Tensor) -> torch.Tensor:
        """(B, 320, 320, 3) raw [0, 1]-ish on the device -> (B, 320, 320)
        masks in [0, 1]: per-image /max, ImageNet normalisation, sigmoid of
        d0, per-image min-max."""
        maxv = img.amax(dim=(1, 2, 3), keepdim=True).clamp(min=1e-6)
        x = (img / maxv - self._mean) / self._std
        d0, _ = self.module(x.permute(0, 3, 1, 2))
        pred = torch.sigmoid(d0[:, 0])
        mn = pred.amin(dim=(1, 2), keepdim=True)
        mx = pred.amax(dim=(1, 2), keepdim=True)
        return (pred - mn) / (mx - mn).clamp(min=1e-8)

    def predict_mask_batch(self, images: torch.Tensor) -> torch.Tensor:
        """Device path: (B, 320, 320, 3) in [0, 1] -> (B, 320, 320) masks."""
        return self._predict(images.to(self.device, torch.float32))

    def predict_mask(self, image):
        """PIL image -> PIL 'L' mask at the image's size."""
        from PIL import Image

        small = image.convert("RGB").resize((U2NET_SIZE, U2NET_SIZE), Image.Resampling.LANCZOS)
        arr = torch.from_numpy(np.asarray(small, dtype=np.float32) / 255.0)
        mask = self.predict_mask_batch(arr[None])[0].cpu().numpy()
        mask_img = Image.fromarray((mask * 255).astype(np.uint8), mode="L")
        return mask_img.resize(image.size, Image.Resampling.LANCZOS)

    def predict(self, image, *args, **kwargs):
        """Session surface: a list of masks (``rembg/sessions/base.py:17-31``)."""
        return [self.predict_mask(image)]


@functools.lru_cache(maxsize=2)
def default_session(device=None) -> U2NetMatting:
    """The u2net session: ``u2net.onnx``'s weights when the checkpoint
    directory holds it, else random weights (seed 0)."""
    from sculptmate_tpu_torch.runtime.checkpoint import try_load_u2net_state_dict

    return U2NetMatting(state_dict=try_load_u2net_state_dict(), device=device)


def post_process_mask(mask: np.ndarray) -> np.ndarray:
    """Morphological open + Gaussian blur + threshold (``bg.py:97-107``)."""
    import cv2

    kernel = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (3, 3))
    m = cv2.morphologyEx(mask, cv2.MORPH_OPEN, kernel)
    m = cv2.GaussianBlur(m, (5, 5), sigmaX=2, sigmaY=2, borderType=cv2.BORDER_DEFAULT)
    return np.where(m < 127, 0, 255).astype(np.uint8)


def _concat_v_multi(imgs):
    """Vertical concat of cutouts onto RGBA canvases (``bg.py:64-94``): the
    width comes from the first image, each next one pasted below."""
    from PIL import Image

    pivot = imgs[0]
    for im in imgs[1:]:
        dst = Image.new("RGBA", (pivot.width, pivot.height + im.height))
        dst.paste(pivot, (0, 0))
        dst.paste(im, (0, pivot.height))
        pivot = dst
    return pivot


def remove(
    image,
    session=None,
    session_name: Optional[str] = None,
    post_process: bool = False,
    only_mask: bool = False,
    putalpha: bool = False,
    bgcolor=None,
    **session_kwargs,
):
    """``rembg.remove`` on a PIL image, option for option (``bg.py:149-238``):

    - EXIF re-orientation first (``bg.py:128-138,198``);
    - default: ``naive_cutout``, the image composited onto an empty RGBA
      canvas through the mask (``bg.py:33-46,217``);
    - ``putalpha=True``: the original RGB with the mask as alpha;
    - ``only_mask=True``: the mask(s), ``bgcolor`` ignored (``bg.py:225``);
    - ``post_process``: open + blur + threshold (``bg.py:97-107``);
    - ``bgcolor``: an RGBA tuple composited behind the cutout;
    - several masks give one cutout each, concatenated vertically; extra
      kwargs go to the session's ``predict``.

    ``session`` is any object with ``predict`` (a list of masks) or
    ``predict_mask``. Only the u2net session is ported: another
    ``session_name`` raises."""
    from PIL import Image, ImageOps

    if session is None and session_name not in (None, "u2net"):
        raise NotImplementedError(
            f"session {session_name!r}: only the u2net session is ported; the other "
            "sessions (frontend/sessions.py) are ROADMAP item 13"
        )
    session = session or default_session()
    image = ImageOps.exif_transpose(image)
    if hasattr(session, "predict"):
        masks = session.predict(image, **session_kwargs)
    else:
        masks = [session.predict_mask(image)]

    cutouts = []
    for mask in masks:
        if post_process:
            mask = Image.fromarray(post_process_mask(np.asarray(mask)))
        if only_mask:
            cutout = mask
        elif putalpha:
            cutout = image.convert("RGB").copy()
            cutout.putalpha(mask)
        else:
            empty = Image.new("RGBA", image.size, 0)
            cutout = Image.composite(image, empty, mask)
        cutouts.append(cutout)

    cutout = _concat_v_multi(cutouts) if cutouts else image
    if bgcolor is not None and not only_mask:
        bg = Image.new("RGBA", cutout.size, tuple(bgcolor))
        bg.paste(cutout, mask=cutout)  # the cutout's alpha is the paste mask
        cutout = bg
    return cutout
