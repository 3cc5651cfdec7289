"""U^2-Net salient-object matting network (Qin et al.) in PyTorch.

Counterpart of ``sculptmate_tpu/frontend/u2net.py``, in NCHW. Submodules
carry the names of the original U-2-Net torch modules (``stage1.rebnconvin
.conv_s1``, ``.bn_s1``, ``stage5d``, ``side1..6``, ``outconv``), which are
the initializer names of ``u2net.onnx``, so its weights load as a state
dict.

Six encoder stages (RSU7/6/5/4/4F/4F) with 2x max pooling between, five
decoder stages on skip concatenations, six side heads fused by a 1x1 conv.
Every conv is 3x3 with BatchNorm on running statistics (eps 1e-5) and ReLU;
the "F" blocks dilate instead of pooling. As in the JAX package, pooling
floors odd sizes (``F.max_pool2d`` without ``ceil_mode``, where the
original repository ceils) and upsampling is bilinear with half-pixel
centers (``align_corners=False``).
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

# (encoder depth/mid/out, decoder depth/mid/out) per stage; "F" = dilated RSU4F
FULL_CONFIG = {
    "enc": [(7, 32, 64), (6, 32, 128), (5, 64, 256), (4, 128, 512), ("F", 256, 512), ("F", 256, 512)],
    "dec": [("F", 256, 512), (4, 128, 256), (5, 64, 128), (6, 32, 64), (7, 16, 64)],
}
# u2netp: uniform small widths (the rembg u2netp.onnx variant)
SMALL_CONFIG = {
    "enc": [(7, 16, 64), (6, 16, 64), (5, 16, 64), (4, 16, 64), ("F", 16, 64), ("F", 16, 64)],
    "dec": [("F", 16, 64), (4, 16, 64), (5, 16, 64), (6, 16, 64), (7, 16, 64)],
}


class REBNCONV(nn.Module):
    """3x3 conv (dilated by ``dilation``) -> BatchNorm -> ReLU."""

    def __init__(self, in_ch: int, out_ch: int, dilation: int = 1):
        super().__init__()
        self.conv_s1 = nn.Conv2d(in_ch, out_ch, 3, padding=dilation, dilation=dilation)
        self.bn_s1 = nn.BatchNorm2d(out_ch, eps=1e-5)

    def forward(self, x):
        return F.relu(self.bn_s1(self.conv_s1(x)))


def _maxpool2(x):
    return F.max_pool2d(x, 2, 2)


def _upsample_like(x, ref):
    return F.interpolate(x, size=ref.shape[-2:], mode="bilinear", align_corners=False)


class RSU(nn.Module):
    """Residual U-block of depth L (RSU7 ... RSU4) with pooling."""

    def __init__(self, depth: int, in_ch: int, mid_ch: int, out_ch: int):
        super().__init__()
        self.depth = depth
        self.rebnconvin = REBNCONV(in_ch, out_ch)
        self.rebnconv1 = REBNCONV(out_ch, mid_ch)
        for i in range(2, depth):
            setattr(self, f"rebnconv{i}", REBNCONV(mid_ch, mid_ch))
        setattr(self, f"rebnconv{depth}", REBNCONV(mid_ch, mid_ch, dilation=2))
        for i in range(depth - 1, 0, -1):
            setattr(self, f"rebnconv{i}d", REBNCONV(2 * mid_ch, out_ch if i == 1 else mid_ch))

    def forward(self, x):
        hxin = self.rebnconvin(x)
        enc = []
        h = hxin
        for i in range(1, self.depth):
            h = getattr(self, f"rebnconv{i}")(h)
            enc.append(h)
            if i != self.depth - 1:
                h = _maxpool2(h)
        h = getattr(self, f"rebnconv{self.depth}")(h)  # bottom, dilated
        for i in range(self.depth - 1, 0, -1):
            skip = enc[i - 1]
            if h.shape[-2:] != skip.shape[-2:]:
                h = _upsample_like(h, skip)
            h = getattr(self, f"rebnconv{i}d")(torch.cat([h, skip], dim=1))
        return hxin + h


class RSU4F(nn.Module):
    """Dilation-only residual U-block (no pooling)."""

    def __init__(self, in_ch: int, mid_ch: int, out_ch: int):
        super().__init__()
        self.rebnconvin = REBNCONV(in_ch, out_ch)
        self.rebnconv1 = REBNCONV(out_ch, mid_ch, dilation=1)
        self.rebnconv2 = REBNCONV(mid_ch, mid_ch, dilation=2)
        self.rebnconv3 = REBNCONV(mid_ch, mid_ch, dilation=4)
        self.rebnconv4 = REBNCONV(mid_ch, mid_ch, dilation=8)
        self.rebnconv3d = REBNCONV(2 * mid_ch, mid_ch, dilation=4)
        self.rebnconv2d = REBNCONV(2 * mid_ch, mid_ch, dilation=2)
        self.rebnconv1d = REBNCONV(2 * mid_ch, out_ch, dilation=1)

    def forward(self, x):
        hxin = self.rebnconvin(x)
        h1 = self.rebnconv1(hxin)
        h2 = self.rebnconv2(h1)
        h3 = self.rebnconv3(h2)
        h4 = self.rebnconv4(h3)
        h3d = self.rebnconv3d(torch.cat([h4, h3], dim=1))
        h2d = self.rebnconv2d(torch.cat([h3d, h2], dim=1))
        return hxin + self.rebnconv1d(torch.cat([h2d, h1], dim=1))


def _make_rsu(spec, in_ch: int) -> nn.Module:
    depth, mid, out = spec
    return RSU4F(in_ch, mid, out) if depth == "F" else RSU(depth, in_ch, mid, out)


class U2Net(nn.Module):
    """U^2-Net; ``variant`` selects the full (u2net.onnx) or small (u2netp)
    widths, ``out_channels`` > 1 gives class maps."""

    def __init__(self, variant: str = "full", out_channels: int = 1):
        super().__init__()
        self.variant, self.out_channels = variant, out_channels
        cfg = FULL_CONFIG if variant == "full" else SMALL_CONFIG
        n_enc, n_dec = len(cfg["enc"]), len(cfg["dec"])
        self.n_enc, self.n_dec = n_enc, n_dec
        enc_out, in_ch = [], 3
        for i, spec in enumerate(cfg["enc"]):
            setattr(self, f"stage{i + 1}", _make_rsu(spec, in_ch))
            in_ch = spec[2]
            enc_out.append(in_ch)
        dec_out = []
        for i, spec in enumerate(cfg["dec"]):
            setattr(self, f"stage{n_dec - i}d", _make_rsu(spec, in_ch + enc_out[n_enc - 2 - i]))
            in_ch = spec[2]
            dec_out.append(in_ch)
        # side heads: d1 from the last decoder stage ... d6 from the bottom
        for i, ch in enumerate(list(reversed(dec_out)) + [enc_out[-1]]):
            setattr(self, f"side{i + 1}", nn.Conv2d(ch, out_channels, 3, padding=1))
        self.outconv = nn.Conv2d((n_dec + 1) * out_channels, out_channels, 1)

    def forward(self, x) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """x (B, 3, H, W) normalized -> (d0, [d1..d6]) logits, each (B,
        out_channels, H, W)."""
        enc = []
        h = x
        for i in range(self.n_enc):
            h = getattr(self, f"stage{i + 1}")(h)
            enc.append(h)
            if i != self.n_enc - 1:
                h = _maxpool2(h)
        dec = [enc[-1]]
        for i in range(self.n_dec):
            skip = enc[self.n_enc - 2 - i]
            h = _upsample_like(h, skip)
            h = getattr(self, f"stage{self.n_dec - i}d")(torch.cat([h, skip], dim=1))
            dec.append(h)
        sides = []
        for i, feat in enumerate(reversed(dec)):
            d = getattr(self, f"side{i + 1}")(feat)
            if d.shape[-2] != x.shape[-2]:
                d = _upsample_like(d, x)
            sides.append(d)
        return self.outconv(torch.cat(sides, dim=1)), sides

    def reset_parameters(self, generator: torch.Generator) -> None:
        reset_conv_bn(self, generator)


@torch.no_grad()
def reset_conv_bn(net: nn.Module, generator: torch.Generator) -> None:
    """Seeded random weights with the JAX package's initializer: lecun
    normal kernels (truncated at two standard deviations), zero biases,
    BatchNorm scale 1, bias 0, running mean 0 and variance 1."""
    for m in net.modules():
        if isinstance(m, nn.Conv2d):
            # the std of a unit normal truncated to [-2, 2]
            std = m.weight[0].numel() ** -0.5 / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
            m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
