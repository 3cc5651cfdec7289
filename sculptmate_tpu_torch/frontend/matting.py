"""Background removal (``rembg.remove``) on the port's matting sessions.

Counterpart of ``sculptmate_tpu/frontend/matting.py``, after the reference's
``rembg/bg.py:149-238`` with the u2net session recipe
(``rembg/sessions/u2net.py:16-46``, ``sessions/base.py:44-69``):

  input -> Lanczos to 320^2 -> /max -> ImageNet mean/std -> u2net ->
  sigmoid of d0, min-max normalised -> mask back to the input size -> alpha.

``SessionBase`` is that recipe for any network and input size; the other
sessions (``frontend/sessions.py``) derive from it. The network and its
normalisation run on the device in f32 (``predict_mask_batch``); on the card
as a CUDA graph per input shape, captured once and replayed with one launch
(``SessionBase._predict``), on the CPU op by op. The host
surface (``predict_mask``, ``remove``) works on PIL images; PIL and cv2 are
imported inside the functions that use them, so the device path needs
neither. Each stage runs inside a ``torch.profiler`` span named
``matting.<stage>``: the network (``matting.u2net``, on the device path
too, with ``matting.u2net_capture`` and ``matting.u2net_replay`` inside it
on the card) and, on the host surface, the resizes, the mask's copy to the host and
the cutout, all inside ``matting.remove``. ``predict_mask_device`` is the
host surface's recipe on the device, PIL's bytes from kernel K12
(``frontend/preprocess.py:preprocess_image_device`` takes it on the card).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from sculptmate_tpu_torch.frontend.u2net import U2Net
from sculptmate_tpu_torch.runtime.checkpoint import U2NET_KEY, try_load_onnx_state_dict
from sculptmate_tpu_torch.runtime.device import resolve_device

U2NET_SIZE = 320
_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


class SessionBase:
    """A matting network on a device and its mask recipe (``rembg/sessions/
    base.py``): resize to ``input_size``, /max, mean/std, the network,
    sigmoid of d0, per-image min-max. Subclasses pick the network
    (``build_module``), its input size and normalisation, and its ONNX blob
    (``weights_file``) with the initializer names that are the network's
    parameters (``weights_key``).

    ``state_dict`` holds the network's weights under the original torch
    names; without one and with ``load_weights``, ``weights_file`` is read
    from the checkpoint directory where it is there; else the weights are
    random from ``seed``. ``device`` defaults to the card and raises without
    one (pass ``device="cpu"`` for the CPU)."""

    input_size: Tuple[int, int] = (U2NET_SIZE, U2NET_SIZE)
    mean: Tuple[float, float, float] = _MEAN
    std: Tuple[float, float, float] = _STD
    weights_file: str = "u2net.onnx"
    weights_key = U2NET_KEY

    def __init__(self, state_dict=None, seed: int = 0, load_weights: bool = False, device=None):
        self.device = resolve_device(device)
        with torch.device(self.device):
            self.module = self.build_module()
        if state_dict is None and load_weights:
            state_dict = try_load_onnx_state_dict(self.weights_file, self.weights_key)
        if state_dict is None:
            self.module.reset_parameters(torch.Generator(device=self.device).manual_seed(seed))
        else:
            self.module.load_state_dict(state_dict)
        self.module.eval().requires_grad_(False)
        self._mean = torch.tensor(self.mean, device=self.device)
        self._std = torch.tensor(self.std, device=self.device)
        self._graphs = {}  # (shape, dtype, TF32) -> (CUDA graph, static input, static output)

    def build_module(self) -> torch.nn.Module:
        return U2Net()

    def _logits(self, img: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) raw [0, 1]-ish -> d0 (B, C, H, W): per-image /max,
        then the session's normalisation."""
        maxv = img.amax(dim=(1, 2, 3), keepdim=True).clamp(min=1e-6)
        x = (img / maxv - self._mean) / self._std
        return self.module(x.permute(0, 3, 1, 2))[0]

    @torch.inference_mode()
    def _predict_eager(self, img: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) on the device -> (B, H, W) masks in [0, 1]: sigmoid
        of d0, per-image min-max, launched op by op."""
        pred = torch.sigmoid(self._logits(img)[:, 0])
        mn = pred.amin(dim=(1, 2), keepdim=True)
        mx = pred.amax(dim=(1, 2), keepdim=True)
        return (pred - mn) / (mx - mn).clamp(min=1e-8)

    @torch.inference_mode()
    def _predict(self, img: torch.Tensor) -> torch.Tensor:
        """``_predict_eager``'s masks. On a CUDA session, outside a capture,
        the recipe is a CUDA graph, one per input shape, dtype and cuDNN
        TF32 setting, captured the first time that key is seen
        (``matting.u2net_capture``) and then replayed (``matting.u2net_replay``,
        the capture's own call too): the input copied into the graph's
        static buffer, one graph launch on the current stream, and a fresh
        copy of the static output, so a mask the caller holds is never
        overwritten by a later call. The graph reads the module's parameter
        storages, so weights loaded in place (``load_state_dict``) reach the
        next replay. Calls of one session are expected on one stream."""
        if self.device.type != "cuda" or torch.cuda.is_current_stream_capturing():
            return self._predict_eager(img)
        key = (tuple(img.shape), img.dtype, torch.backends.cudnn.allow_tf32)
        with torch.cuda.device(self.device):
            if key not in self._graphs:
                with record_function("matting.u2net_capture"):
                    self._graphs[key] = self._capture(img)
            graph, static_in, static_out = self._graphs[key]
            with record_function("matting.u2net_replay"):
                static_in.copy_(img)
                graph.replay()
                return static_out.clone()

    def _capture(self, img: torch.Tensor):
        """A CUDA graph of ``_predict_eager`` on a static copy of ``img``:
        one eager call on a side stream first (cuDNN's plans and lazy state
        are made outside the capture), then the capture, which holds back
        only this thread's CUDA calls (the add-on's panel generates on a
        worker thread). -> (graph, static input, static output)."""
        static_in = img.clone()
        side, current = torch.cuda.Stream(), torch.cuda.current_stream()
        side.wait_stream(current)
        with torch.cuda.stream(side):
            self._predict_eager(static_in)
        current.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            static_out = self._predict_eager(static_in)
        return graph, static_in, static_out

    def predict_mask_batch(self, images: torch.Tensor) -> torch.Tensor:
        """Device path: (B, H, W, 3) in [0, 1] at ``input_size`` -> (B, H, W)
        masks."""
        with record_function("matting.u2net"):
            return self._predict(images.to(self.device, torch.float32))

    def _small(self, image) -> torch.Tensor:
        """PIL image -> (1, H, W, 3) in [0, 1] at ``input_size`` (Lanczos)."""
        from PIL import Image

        with record_function("matting.downsize"):
            small = image.convert("RGB").resize(self.input_size, Image.Resampling.LANCZOS)
            return torch.from_numpy(np.asarray(small, dtype=np.float32) / 255.0)[None]

    def predict_mask(self, image):
        """PIL image -> PIL 'L' mask at the image's size."""
        from PIL import Image

        mask = self.predict_mask_batch(self._small(image))[0]
        with record_function("matting.mask_to_host"):  # waits for the network
            mask = mask.cpu().numpy()
        with record_function("matting.upsize"):
            mask_img = Image.fromarray((mask * 255).astype(np.uint8), mode="L")
            return mask_img.resize(image.size, Image.Resampling.LANCZOS)

    def predict_mask_device(self, photo: torch.Tensor):
        """``predict_mask``'s bytes from an (H, W, 3) uint8 photo, with no
        PIL, on the session's device: K12's Lanczos to ``input_size`` as
        float32 x / 255, the network, and K12's Lanczos of the mask's L image
        back to (H, W) (``ops/pil_resample.py``). A host ``photo`` (pinned,
        for the card) goes up for the downsize alone and is gone from the
        device before the network runs. Returns the (H, W) uint8 mask on the
        device and the int32 bbox of its texels above 0 (``bbox_bounds``
        reads it)."""
        from sculptmate_tpu_torch.ops.pil_resample import resample_mask, resample_photo

        H, W = photo.shape[:2]
        with record_function("matting.downsize"):
            small = resample_photo(photo.to(self.device, non_blocking=True), self.input_size)
        mask = self.predict_mask_batch(small[None])[0]
        with record_function("matting.upsize"):
            return resample_mask(mask, (W, H))

    def takes_device_chain(self) -> bool:
        """Whether ``predict_mask_device`` gives this session's ``predict``
        bytes on the card: a CUDA session that keeps the base class's
        one-mask recipe (``predict``, ``predict_mask``, ``_small``)."""
        own = all(getattr(type(self), n) is getattr(SessionBase, n) for n in ("predict", "predict_mask", "_small"))
        return own and self.device.type == "cuda"

    def predict(self, image, *args, **kwargs):
        """Session surface: a list of masks (``rembg/sessions/base.py:17-31``)."""
        return [self.predict_mask(image)]


class U2NetMatting(SessionBase):
    """The full u2net at 320^2 (``sessions/u2net.py``), the default session
    and the registry's ``u2net`` (``u2net.onnx``'s initializers as its state
    dict)."""


def default_session(device=None) -> U2NetMatting:
    """The registry's ``u2net`` session (``frontend/sessions.py:new_session``):
    ``u2net.onnx``'s weights when the checkpoint directory holds it, else
    random weights (seed 0)."""
    from sculptmate_tpu_torch.frontend.sessions import new_session

    return new_session("u2net", device)


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
    device=None,
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
    ``predict_mask``; ``session_name`` selects one from
    ``frontend.sessions.new_session`` (an unknown name raises
    ``ValueError``) on ``device``, which defaults to the card."""
    from PIL import Image, ImageOps

    with record_function("matting.remove"):
        if session is None and session_name is not None:
            from sculptmate_tpu_torch.frontend.sessions import new_session

            session = new_session(session_name, device=device)
        session = session or default_session(device)
        image = ImageOps.exif_transpose(image)
        if hasattr(session, "predict"):
            masks = session.predict(image, **session_kwargs)
        else:
            masks = [session.predict_mask(image)]

        with record_function("matting.cutout"):
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
