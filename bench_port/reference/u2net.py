"""Plain reference of U^2-Net (Qin et al.), rembg's ``u2net`` matting
network, over a state dict under the original module names (the initializer
names of ``u2net.onnx``).

Six encoder stages (RSU7/6/5/4/4F/4F) with 2x max pooling between (floor
of odd sizes), five decoder stages on skip concatenations with bilinear
upsampling (half-pixel centres), six side heads fused by a 1x1 convolution.
Every 3x3 convolution is followed by BatchNorm on running statistics (eps
1e-5) and ReLU. ``param_specs`` gives the seeded initialisation: normal
kernels truncated at two standard deviations with the lecun fan-in scale,
zero biases, identity BatchNorm. Imports nothing of the program.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

from reference.precision import EXACT, Precision
from reference.tsr import Spec

# (depth or "F", mid channels, out channels) per stage
FULL = {
    "enc": [(7, 32, 64), (6, 32, 128), (5, 64, 256), (4, 128, 512), ("F", 256, 512), ("F", 256, 512)],
    "dec": [("F", 256, 512), (4, 128, 256), (5, 64, 128), (6, 32, 64), (7, 16, 64)],
}
SMALL = {
    "enc": [(7, 16, 64), (6, 16, 64), (5, 16, 64), (4, 16, 64), ("F", 16, 64), ("F", 16, 64)],
    "dec": [("F", 16, 64), (4, 16, 64), (5, 16, 64), (6, 16, 64), (7, 16, 64)],
}
_TRUNC_STD = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]


def _rsu_convs(prefix: str, spec, in_ch: int):
    """(name, in, out, dilation) of each REBNCONV of one RSU block."""
    depth, mid, out = spec
    if depth == "F":
        return [(f"{prefix}.rebnconvin", in_ch, out, 1), (f"{prefix}.rebnconv1", out, mid, 1),
                (f"{prefix}.rebnconv2", mid, mid, 2), (f"{prefix}.rebnconv3", mid, mid, 4),
                (f"{prefix}.rebnconv4", mid, mid, 8), (f"{prefix}.rebnconv3d", 2 * mid, mid, 4),
                (f"{prefix}.rebnconv2d", 2 * mid, mid, 2), (f"{prefix}.rebnconv1d", 2 * mid, out, 1)]
    convs = [(f"{prefix}.rebnconvin", in_ch, out, 1), (f"{prefix}.rebnconv1", out, mid, 1)]
    convs += [(f"{prefix}.rebnconv{i}", mid, mid, 1) for i in range(2, depth)]
    convs.append((f"{prefix}.rebnconv{depth}", mid, mid, 2))
    convs += [(f"{prefix}.rebnconv{i}d", 2 * mid, out if i == 1 else mid, 1) for i in range(depth - 1, 0, -1)]
    return convs


def _stages(cfg):
    """(stage name, spec, in channels) of every stage, encoder first."""
    out, in_ch, enc_out = [], 3, []
    for i, spec in enumerate(cfg["enc"]):
        out.append((f"stage{i + 1}", spec, in_ch))
        in_ch = spec[2]
        enc_out.append(in_ch)
    n = len(cfg["dec"])
    dec_out = []
    for i, spec in enumerate(cfg["dec"]):
        out.append((f"stage{n - i}d", spec, in_ch + enc_out[len(enc_out) - 2 - i]))
        in_ch = spec[2]
        dec_out.append(in_ch)
    return out, list(reversed(dec_out)) + [enc_out[-1]]


def param_specs(cfg=FULL, prefix: str = "") -> List[Spec]:
    out: List[Spec] = []
    stages, side_in = _stages(cfg)

    def conv(name, cin, cout, k):
        std = (cin * k * k) ** -0.5 / _TRUNC_STD
        out.append((f"{prefix}{name}.weight", (cout, cin, k, k), ("trunc_normal", std)))
        out.append((f"{prefix}{name}.bias", (cout,), ("zeros",)))

    for name, spec, in_ch in stages:
        for conv_name, cin, cout, _ in _rsu_convs(name, spec, in_ch):
            conv(f"{conv_name}.conv_s1", cin, cout, 3)
            bn = f"{prefix}{conv_name}.bn_s1"
            out += [(f"{bn}.weight", (cout,), ("ones",)), (f"{bn}.bias", (cout,), ("zeros",)),
                    (f"{bn}.running_mean", (cout,), ("zeros",)), (f"{bn}.running_var", (cout,), ("ones",)),
                    (f"{bn}.num_batches_tracked", (), ("count",))]
    for i, ch in enumerate(side_in):
        conv(f"side{i + 1}", ch, 1, 3)
    conv("outconv", len(side_in), 1, 1)
    return out


def _rebnconv(q: Precision, sd, name, x, dilation):
    x = q.conv2d(x, sd[f"{name}.conv_s1.weight"], sd[f"{name}.conv_s1.bias"], padding=dilation, dilation=dilation)
    bn = f"{name}.bn_s1"
    x = F.batch_norm(x, sd[f"{bn}.running_mean"].float(), sd[f"{bn}.running_var"].float(),
                     sd[f"{bn}.weight"].float(), sd[f"{bn}.bias"].float(), False, 0.0, 1e-5)
    return F.relu(x)


def _up(x, ref):
    return F.interpolate(x, size=ref.shape[-2:], mode="bilinear", align_corners=False)


def _rsu(q, sd, prefix, spec, x):
    depth = spec[0]
    c = lambda n, h, d=1: _rebnconv(q, sd, f"{prefix}.{n}", h, d)  # noqa: E731
    hxin = c("rebnconvin", x)
    if depth == "F":
        h1 = c("rebnconv1", hxin)
        h2 = c("rebnconv2", h1, 2)
        h3 = c("rebnconv3", h2, 4)
        h4 = c("rebnconv4", h3, 8)
        h3d = c("rebnconv3d", torch.cat([h4, h3], 1), 4)
        h2d = c("rebnconv2d", torch.cat([h3d, h2], 1), 2)
        return hxin + c("rebnconv1d", torch.cat([h2d, h1], 1))
    enc, h = [], hxin
    for i in range(1, depth):
        h = c(f"rebnconv{i}", h)
        enc.append(h)
        if i != depth - 1:
            h = F.max_pool2d(h, 2, 2)
    h = c(f"rebnconv{depth}", h, 2)
    for i in range(depth - 1, 0, -1):
        skip = enc[i - 1]
        if h.shape[-2:] != skip.shape[-2:]:
            h = _up(h, skip)
        h = c(f"rebnconv{i}d", torch.cat([h, skip], 1))
    return hxin + h


def logits(sd, x: torch.Tensor, cfg=FULL, q: Precision = EXACT) -> torch.Tensor:
    """(B, 3, H, W) normalised input -> the fused d0 logits (B, 1, H, W)."""
    stages, _ = _stages(cfg)
    n_enc, n_dec = len(cfg["enc"]), len(cfg["dec"])
    enc, h = [], x.float()
    for i in range(n_enc):
        name, spec, _ = stages[i]
        h = _rsu(q, sd, name, spec, h)
        enc.append(h)
        if i != n_enc - 1:
            h = F.max_pool2d(h, 2, 2)
    dec = [enc[-1]]
    for i in range(n_dec):
        name, spec, _ = stages[n_enc + i]
        skip = enc[n_enc - 2 - i]
        h = _rsu(q, sd, name, spec, torch.cat([_up(h, skip), skip], 1))
        dec.append(h)
    sides = []
    for i, feat in enumerate(reversed(dec)):
        d = q.conv2d(feat, sd[f"side{i + 1}.weight"], sd[f"side{i + 1}.bias"], padding=1)
        sides.append(d if d.shape[-2:] == x.shape[-2:] else _up(d, x))
    return q.conv2d(torch.cat(sides, 1), sd["outconv.weight"], sd["outconv.bias"])


def masks(sd, images: torch.Tensor, cfg=FULL, q: Precision = EXACT) -> torch.Tensor:
    """rembg's recipe on (B, H, W, 3) images in [0, 1] at the network's
    input size: per-image / max, ImageNet mean and std, the network,
    sigmoid of d0, per-image min-max -> (B, H, W) in [0, 1]."""
    mean = torch.tensor((0.485, 0.456, 0.406), device=images.device)
    std = torch.tensor((0.229, 0.224, 0.225), device=images.device)
    x = images.float()
    x = (x / x.amax(dim=(1, 2, 3), keepdim=True).clamp(min=1e-6) - mean) / std
    pred = torch.sigmoid(logits(sd, x.permute(0, 3, 1, 2), cfg, q)[:, 0])
    mn = pred.amin(dim=(1, 2), keepdim=True)
    mx = pred.amax(dim=(1, 2), keepdim=True)
    return (pred - mn) / (mx - mn).clamp(min=1e-8)
