"""Image preprocessing: matte -> bbox crop -> square pad -> ratio pad -> resize.

Counterpart of ``sculptmate_tpu/frontend/preprocess.py``.

- ``preprocess_image`` (``preprocess_image_host``, PIL): the reference's
  ``preprocessing.py:73-128`` with its quirks: the bbox crop takes
  ``alpha.max()`` as an exclusive bound (dropping the last foreground row
  and column), the gray composite comes before the uint8 quantization, and
  an input whose padded square is narrower than 250 px is rejected (None).
  It runs inside a
  ``torch.profiler`` span, ``frontend.preprocess``, with the matting's
  ``matting.*`` spans and its own ``frontend.crop_pad``,
  ``frontend.composite`` and ``frontend.resize`` inside. With an RGB photo
  and a ``SessionBase`` on the card (``takes_card_path``) the same bytes
  come from ``preprocess_image_device`` instead, inside a
  ``frontend.on_card`` span.
- ``preprocess_image_device``: that chain on the matting session's device,
  with no PIL between the photo's upload and the result's copy back: the
  photo goes up from one pinned block, kernel K12 (``ops/pil_resample.py``)
  makes PIL's Lanczos resizes, the cutout and the gray composite byte for
  byte, and the bbox is the one value the host waits for.
- ``preprocess_batch_device`` (any device): the batched serving path. The
  alpha bbox is a masked min/max on the device, and the whole crop -> pad ->
  Lanczos resize chain is one dynamic-window separable resample
  (``ops/warp.py``): fixed shapes, no host sync.
- ``sam_segment`` and ``image_preprocess_sam``: the reference's dormant SAM
  cutout path (``preprocessing.py:22-70``): a box-prompted SAM mask as
  alpha, then the contrast lowering, recentre, 1024^2 Lanczos resize and
  white composite (host, PIL).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch.profiler import record_function

from sculptmate_tpu_torch.ops.warp import separable_resample

OUTPUT_SIZE = 1024


def preprocess_image(image, ratio: float = 0.85, use_alpha: bool = False, session=None):
    """A PIL image matted (``remove``), cropped to the alpha bbox, padded
    square, padded by ``ratio``; RGBA when ``use_alpha``, else composited on
    0.5 gray and Lanczos-resized to 1024^2. None when the matte is empty or
    the padded square is under 250 px. ``session`` defaults to
    ``default_session()`` on the card, as ``remove`` takes it. The host path
    (``preprocess_image_host``), or where ``takes_card_path`` holds the same
    bytes from ``preprocess_image_device`` on the card."""
    with record_function("frontend.preprocess"):
        if session is None and torch.cuda.is_available():
            from sculptmate_tpu_torch.frontend.matting import default_session

            session = default_session()  # kept per device by ``new_session``
        if takes_card_path(image, session):
            with record_function("frontend.on_card"):
                return preprocess_image_device(image, ratio, use_alpha, session)
        return preprocess_image_host(image, ratio, use_alpha, session)


def preprocess_image_host(image, ratio: float = 0.85, use_alpha: bool = False, session=None):
    """``preprocess_image``'s host path (PIL and numpy), whatever the
    session's device."""
    import numpy as np
    from PIL import Image

    from sculptmate_tpu_torch.frontend.matting import remove

    input_raw = image.convert("RGBA") if use_alpha else image
    input_raw = remove(input_raw, session=session)

    with record_function("frontend.crop_pad"):
        arr = np.asarray(input_raw)
        ys, xs = np.where(arr[..., 3] > 0)
        if len(ys) == 0:
            return None
        y1, y2, x1, x2 = ys.min(), ys.max(), xs.min(), xs.max()
        fg = arr[y1:y2, x1:x2]  # exclusive max bound, as in the reference
        if fg.size == 0:
            return None

        size = max(fg.shape[0], fg.shape[1])
        ph0, pw0 = (size - fg.shape[0]) // 2, (size - fg.shape[1]) // 2
        ph1, pw1 = size - fg.shape[0] - ph0, size - fg.shape[1] - pw0
        fg = np.pad(fg, ((ph0, ph1), (pw0, pw1), (0, 0)), mode="constant")

        new_size = int(size / ratio)
        p0 = (new_size - size) // 2
        p1 = new_size - size - p0
        fg = np.pad(fg, ((p0, p1), (p0, p1), (0, 0)), mode="constant")

    if use_alpha:
        return Image.fromarray(fg, mode="RGBA")

    with record_function("frontend.composite"):
        f = fg.astype(np.float32) / 255.0
        rgb = f[:, :, :3] * f[:, :, 3:4] + (1 - f[:, :, 3:4]) * 0.5
        out = Image.fromarray((rgb * 255.0).astype(np.uint8))
    if out.size[0] < 250:
        return None
    with record_function("frontend.resize"):
        return out.resize((OUTPUT_SIZE, OUTPUT_SIZE), Image.Resampling.LANCZOS)


def takes_card_path(image, session) -> bool:
    """Whether ``preprocess_image`` makes this input's bytes on the card: an
    RGB PIL photo and a ``SessionBase`` that takes the device chain
    (``SessionBase.takes_device_chain``). Other inputs and sessions keep the
    host path."""
    from sculptmate_tpu_torch.frontend.matting import SessionBase

    return getattr(image, "mode", None) == "RGB" and isinstance(session, SessionBase) and session.takes_device_chain()


def _host_photo(image, device: torch.device) -> torch.Tensor:
    """An RGB PIL image as an (H, W, 3) uint8 host tensor, pinned where it is
    bound for the card so that its copies there do not wait; PyTorch's
    caching host allocator hands the block back, request after request, once
    they have landed."""
    import numpy as np

    arr = np.asarray(image)
    host = torch.empty(arr.shape, dtype=torch.uint8, pin_memory=device.type == "cuda")
    host.numpy()[...] = arr
    return host


def _image_from(out: torch.Tensor):
    """An (H, W, 3 or 4) uint8 tensor as a PIL image that owns its memory;
    from the card through a pinned block."""
    import numpy as np
    from PIL import Image

    if out.is_cuda:
        host = torch.empty(out.shape, dtype=torch.uint8, pin_memory=True)
        host.copy_(out, non_blocking=True)
        torch.cuda.current_stream(out.device).synchronize()
        out = host
    arr = out.numpy()
    # fromarray copies an RGB array but maps an RGBA one, which would keep the block
    return Image.fromarray(np.array(arr) if arr.shape[-1] == 4 else arr)


def preprocess_image_device(image, ratio: float, use_alpha: bool, session):
    """``preprocess_image``'s bytes for an RGB PIL photo, made on the
    matting session's device (a ``SessionBase``): EXIF re-orientation on the
    host, ``SessionBase.predict_mask_device`` (K12's
    Lanczos to the network's input, the network, K12's Lanczos of the L mask
    back with its bbox), the bbox to the host (the one wait), the crop's and
    pads' sizes worked out as the host path does, then K12's condition image
    (or, with ``use_alpha``, the padded RGBA cutout) copied back. None where
    the host path gives None. The photo goes up twice from the same pinned
    block, so that no copy of it is on the card while the network runs: the
    add-on's memory peak. On a CPU session K12's plain versions run."""
    from PIL import ImageOps

    from sculptmate_tpu_torch.ops.pil_resample import Crop, bbox_bounds, condition_image, padded_cutout

    with record_function("matting.remove"):
        image = ImageOps.exif_transpose(image)
        with record_function("matting.upload"):
            host = _host_photo(image, session.device)
        mask, bbox = session.predict_mask_device(host)
        with record_function("matting.bbox_to_host"):
            y1, y2, x1, x2 = bbox_bounds(bbox, *host.shape[:2])
    hc, wc = y2 - y1, x2 - x1  # exclusive max bound, as in the reference; negative when empty
    if hc <= 0 or wc <= 0:
        return None
    size = max(hc, wc)
    new_size = int(size / ratio)
    p0 = (new_size - size) // 2
    crop = Crop(y1, x1, hc, wc, p0 + (size - hc) // 2, p0 + (size - wc) // 2, new_size)
    if use_alpha:
        with record_function("frontend.crop_pad"):
            out = padded_cutout(host.to(session.device, non_blocking=True), mask, crop)
    elif new_size < 250:
        return None
    else:
        with record_function("frontend.resize"):
            out = condition_image(host.to(session.device, non_blocking=True), mask, crop, OUTPUT_SIZE)
    with record_function("frontend.to_host"):
        return _image_from(out)


def sam_segment(image, bbox, session=None):
    """SAM-assisted cutout (the reference's dormant ``sam_out_nosave``,
    ``preprocessing.py:22-39``): the mask of SAM prompted with the box
    ``bbox`` (x1, y1, x2, y2 in pixels) as alpha, through
    ``SamSession.predict_rgb``. ``image``: a PIL image -> an RGBA PIL
    image, as the JAX package's; or an (H, W, 3 or 4) uint8 array -> an
    (H, W, 4) uint8 array, with no PIL. ``session``: the port's
    ``SamSession``, by default ``new_session("sam")`` on the card; a CPU
    session keeps it on the CPU."""
    import json

    import numpy as np

    if session is None:
        from sculptmate_tpu_torch.frontend.sessions import new_session

        session = new_session("sam")
    prompt = json.dumps([{"type": "rectangle", "data": list(map(float, bbox))}])
    is_array = isinstance(image, np.ndarray)
    rgb = np.ascontiguousarray(image[..., :3]) if is_array else np.array(image.convert("RGB"))
    out = np.concatenate([rgb, session.predict_rgb(rgb, prompt).cpu().numpy()[..., None]], axis=-1)
    if is_array:
        return out
    from PIL import Image

    return Image.fromarray(out, mode="RGBA")


def image_preprocess_sam(input_image, lower_contrast: bool = True, rescale: bool = True):
    """The reference's dormant SAM-path preprocessing
    (``preprocessing.py:42-70``) on an RGBA PIL image: optionally the
    contrast lowered (x 0.8, alpha over 200 made opaque again), the alpha
    bbox recentred on a square canvas (its side the bbox's larger side /
    0.75 with ``rescale``, else the input's height), Lanczos to 1024^2 and
    composited on white. Returns (RGB image, the input's height over the
    bbox width)."""
    import numpy as np
    from PIL import Image

    arr = np.asarray(input_image).copy()
    in_w = arr.shape[0]

    if lower_contrast:
        # convertScaleAbs(alpha=0.8): scale + clip, then re-solidify alpha
        arr = np.clip(arr.astype(np.float32) * 0.8, 0, 255).astype(np.uint8)
        arr[arr[..., -1] > 200, -1] = 255

    alpha = np.asarray(input_image)[..., -1]
    ys, xs = np.where(alpha > 1)
    if len(ys) == 0:
        return input_image.convert("RGB"), 1.0
    y, x = ys.min(), xs.min()
    h = ys.max() - ys.min() + 1
    w = xs.max() - xs.min() + 1
    max_size = max(w, h)
    side_len = int(max_size / 0.75) if rescale else in_w
    scale = in_w / w
    padded = np.zeros((side_len, side_len, 4), np.uint8)
    center = side_len // 2
    padded[center - h // 2 : center - h // 2 + h, center - w // 2 : center - w // 2 + w] = arr[y : y + h, x : x + w]
    rgba = Image.fromarray(padded).resize((OUTPUT_SIZE, OUTPUT_SIZE), Image.Resampling.LANCZOS)
    f = np.asarray(rgba).astype(np.float32) / 255.0
    rgb = f[..., :3] * f[..., -1:] + (1 - f[..., -1:])
    return Image.fromarray((rgb * 255).astype(np.uint8)), scale


def _alpha_bbox(alpha: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Masked bbox of alpha > 0 for (B, H, W) planes: (B,) y1, y2, x1, x2,
    the max bounds being the last foreground index, as ``np.where().max()``
    gives them. An empty plane gives y1 = H, y2 = -1 (x likewise)."""
    H, W = alpha.shape[-2:]
    fg = alpha > 0
    rows, cols = fg.any(dim=-1), fg.any(dim=-2)
    ridx = torch.arange(H, device=alpha.device)
    cidx = torch.arange(W, device=alpha.device)
    y1 = torch.where(rows, ridx, H).amin(dim=-1)
    y2 = torch.where(rows, ridx, -1).amax(dim=-1)
    x1 = torch.where(cols, cidx, W).amin(dim=-1)
    x2 = torch.where(cols, cidx, -1).amax(dim=-1)
    return y1, y2, x1, x2


def preprocess_batch_device(
    rgba: torch.Tensor, ratio: float, out_size: int = OUTPUT_SIZE, background: float = 0.5
) -> torch.Tensor:
    """Fused preprocessing of (B, H, W, 4) float [0, 1] images -> (B, out,
    out, 3), on the images' device.

    Equivalent to crop(bbox) -> square pad -> ratio pad -> gray composite ->
    Lanczos resize: each output canvas maps to a centered source window of
    side ``floor(max(h, w) / ratio)`` around its bbox center, with h and w
    the exclusive-style extents ``y2 - y1`` and ``x2 - x1``. Pixels outside
    the image contribute alpha 0 (composited to ``background``)."""
    y1, y2, x1, x2 = _alpha_bbox(rgba[..., 3])
    h = (y2 - y1).float()
    w = (x2 - x1).float()
    size = torch.maximum(h, w)
    new_size = torch.floor(size / ratio)

    # center of the cropped region in source pixels
    cy = y1.float() + h / 2.0
    cx = x1.float() + w / 2.0
    row_win = (cy - new_size / 2.0, cy + new_size / 2.0)
    col_win = (cx - new_size / 2.0, cx + new_size / 2.0)

    alpha = rgba[..., 3:4]
    premult = torch.cat([rgba[..., :3] * alpha, alpha], dim=-1)
    out = separable_resample(premult, (out_size, out_size), row_win, col_win)
    rgb = out[..., :3] + background * (1.0 - out[..., 3:4])
    return rgb.clamp(0.0, 1.0)


def preprocess_device_one(
    rgba: torch.Tensor, ratio: float, out_size: int = OUTPUT_SIZE, background: float = 0.5
) -> torch.Tensor:
    """``preprocess_batch_device`` of one (H, W, 4) image -> (out, out, 3)."""
    return preprocess_batch_device(rgba[None], ratio, out_size, background)[0]
