"""Matting session registry: rembg's session zoo on the port.

Counterpart of ``sculptmate_tpu/frontend/sessions.py``, after
``rembg/session_factory.py`` and ``rembg/sessions/``: u2net, u2netp,
u2net_human_seg, silueta, dis_anime / isnet-anime, dis_general_use /
isnet-general-use, u2net_cloth_seg and u2net_custom, each with its
reference recipe (input size, normalisation, min-max, Lanczos back to the
image's size). Every session runs its network on its device through
``predict_mask_batch`` (tensors at its input size; the cloth session's
``predict_classes_batch``); ``predict`` and ``predict_mask`` are the PIL
host surface. ``sam`` is ``frontend/sam.py:SamSession``.
"""

from __future__ import annotations

import functools
from typing import Dict, Type

import numpy as np
import torch

from sculptmate_tpu_torch.frontend.isnet import ISNet
from sculptmate_tpu_torch.frontend.matting import SessionBase, U2NetMatting
from sculptmate_tpu_torch.frontend.u2net import U2Net
from sculptmate_tpu_torch.runtime.checkpoint import ISNET_KEY
from sculptmate_tpu_torch.runtime.device import resolve_device


class U2netpSession(SessionBase):
    """The small u2net widths (``sessions/u2netp.py``)."""

    weights_file = "u2netp.onnx"

    def build_module(self):
        return U2Net(variant="small")


class U2netHumanSegSession(SessionBase):
    """Same recipe as u2net, human-segmentation weights
    (``sessions/u2net_human_seg.py``)."""

    weights_file = "u2net_human_seg.onnx"


class SiluetaSession(SessionBase):
    """Same architecture and recipe, silueta weights (``sessions/silueta.py``)."""

    weights_file = "silueta.onnx"


class DisSessionBase(SessionBase):
    """ISNet at 1024^2 with std 1 (``sessions/dis_anime.py``)."""

    input_size = (1024, 1024)
    std = (1.0, 1.0, 1.0)
    weights_key = ISNET_KEY

    def build_module(self):
        return ISNet()


class DisAnimeSession(DisSessionBase):
    weights_file = "isnet-anime.onnx"


class DisGeneralSession(DisSessionBase):
    weights_file = "isnet-general-use.onnx"


# cloth palette masks (upper / lower / full), from u2net_cloth_seg.py
_CLOTH_CLASSES = {"upper": 1, "lower": 2, "full": 3}


class ClothSegSession(SessionBase):
    """U2Net with four class channels at 768^2
    (``sessions/u2net_cloth_seg.py:58-145``): the class map is the argmax of
    d0's log-softmax, one mask per cloth class."""

    input_size = (768, 768)
    weights_file = "u2net_cloth_seg.onnx"

    def build_module(self):
        return U2Net(out_channels=4)

    @torch.inference_mode()
    def predict_classes_batch(self, images: torch.Tensor) -> torch.Tensor:
        """Device path: (B, 768, 768, 3) in [0, 1] -> (B, 768, 768) int64
        class map in 0..3."""
        d0 = self._logits(images.to(self.device, torch.float32))
        return torch.argmax(torch.log_softmax(d0, dim=1), dim=1)

    def predict_mask_batch(self, images: torch.Tensor) -> torch.Tensor:
        """(B, 768, 768) masks in {0, 1} of the first class, "upper", the
        mask ``predict_mask`` gives."""
        return (self.predict_classes_batch(images) == _CLOTH_CLASSES["upper"]).float()

    def predict(self, img, *args, **kwargs):
        """PIL image -> the masks of the ``cc`` (or ``cloth_category``)
        class, or of all three classes, at the image's size."""
        from PIL import Image

        classes = self.predict_classes_batch(self._small(img))[0].cpu().numpy()
        cls_img = Image.fromarray(classes.astype(np.uint8), mode="L").resize(img.size, Image.Resampling.NEAREST)
        cls_arr = np.asarray(cls_img)
        category = kwargs.get("cc") or kwargs.get("cloth_category")
        wanted = [category] if category in _CLOTH_CLASSES else list(_CLOTH_CLASSES)
        return [Image.fromarray((cls_arr == _CLOTH_CLASSES[name]).astype(np.uint8) * 255, mode="L")
                for name in wanted]

    def predict_mask(self, image):
        return self.predict(image)[0]


_REGISTRY: Dict[str, Type[SessionBase]] = {
    "u2net": U2NetMatting,
    "u2netp": U2netpSession,
    "u2net_human_seg": U2netHumanSegSession,
    "silueta": SiluetaSession,
    "isnet-anime": DisAnimeSession,
    "dis_anime": DisAnimeSession,
    "isnet-general-use": DisGeneralSession,
    "dis_general_use": DisGeneralSession,
    "u2net_cloth_seg": ClothSegSession,
    "u2net_custom": U2NetMatting,
}


def new_session(model_name: str = "u2net", device=None):
    """Session factory (``rembg/session_factory.py:11-44``): the registry's
    session with its class's weights file from the checkpoint directory
    where it is there (else seeded random weights), or ``SamSession`` for
    ``sam``; an unknown name raises ``ValueError``. ``device`` defaults to
    the card. One session per class and device is kept, so aliases of one
    class share it."""
    if model_name != "sam" and model_name not in _REGISTRY:
        raise ValueError(
            f"unknown session '{model_name}'; available: " + ", ".join(sorted(_REGISTRY) + ["sam"])
        )
    return _session(None if model_name == "sam" else _REGISTRY[model_name], resolve_device(device))


@functools.lru_cache(maxsize=4)
def _session(cls, device: torch.device):
    if cls is None:
        from sculptmate_tpu_torch.frontend.sam import SamSession

        return SamSession(device=device)
    return cls(load_weights=True, device=device)


new_session.cache_clear = _session.cache_clear  # drops the kept sessions
