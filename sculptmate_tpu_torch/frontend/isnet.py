"""ISNet (DIS, Qin et al.): the dis_anime / dis_general_use matting network.

Counterpart of ``sculptmate_tpu/frontend/isnet.py``, in NCHW: a stride-2
input conv with BatchNorm and ReLU and a U^2-Net encoder and decoder of RSU
blocks from ``frontend/u2net.py``, with six 1-channel side heads upsampled
to the input size. The submodules carry the names that the JAX package's
``convert_isnet_state_dict`` reads (``conv_in.conv``, ``conv_in.bn``,
``stage1.rebnconvin.conv_s1``, ``stage5d``, ``side1..6``), so a blob under
those names loads as a state dict. Whether rembg's published
``isnet-*.onnx`` uses the same stem names (and has the stem's BatchNorm and
ReLU at all) is unverified until one is in the repository.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from sculptmate_tpu_torch.frontend.u2net import RSU, RSU4F, _maxpool2, _upsample_like, reset_conv_bn


class _Stem(nn.Module):
    """3x3 stride-2 conv -> BatchNorm -> ReLU, 3 -> 64 channels."""

    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 64, 3, stride=2, padding=1)
        self.bn = nn.BatchNorm2d(64, eps=1e-5)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class ISNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv_in = _Stem()
        self.stage1 = RSU(7, 64, 32, 64)
        self.stage2 = RSU(6, 64, 32, 128)
        self.stage3 = RSU(5, 128, 64, 256)
        self.stage4 = RSU(4, 256, 128, 512)
        self.stage5 = RSU4F(512, 256, 512)
        self.stage6 = RSU4F(512, 256, 512)
        self.stage5d = RSU4F(1024, 256, 512)
        self.stage4d = RSU(4, 1024, 128, 256)
        self.stage3d = RSU(5, 512, 64, 128)
        self.stage2d = RSU(6, 256, 32, 64)
        self.stage1d = RSU(7, 128, 16, 64)
        for i, ch in enumerate((64, 64, 128, 256, 512, 512)):
            setattr(self, f"side{i + 1}", nn.Conv2d(ch, 1, 3, padding=1))

    def forward(self, x) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """x (B, 3, H, W) normalized -> (d1, [d1..d6]) logits, each
        (B, 1, H, W)."""
        enc, h = [], self.conv_in(x)
        for i in range(1, 7):
            h = getattr(self, f"stage{i}")(h)
            enc.append(h)
            if i < 6:
                h = _maxpool2(h)
        dec = [h]  # hx6, then hx5d .. hx1d
        for i in range(5, 0, -1):
            skip = enc[i - 1]
            h = getattr(self, f"stage{i}d")(torch.cat([_upsample_like(h, skip), skip], dim=1))
            dec.append(h)
        sides = [_upsample_like(getattr(self, f"side{i + 1}")(feat), x) for i, feat in enumerate(reversed(dec))]
        return sides[0], sides

    def reset_parameters(self, generator: torch.Generator) -> None:
        reset_conv_bn(self, generator)
