"""The port's profiler spans on the CPU: the host frontend's ``frontend.*``
and ``matting.*`` spans nest as the benchmark's trace reads them, and the
farm's matting network runs inside ``farm.matting``."""

import numpy as np
import pytest
import torch
from PIL import Image, ImageDraw
from torch.profiler import ProfilerActivity, profile

from sculptmate_tpu_torch.frontend.matting import U2NetMatting
from sculptmate_tpu_torch.frontend.preprocess import preprocess_image
from sculptmate_tpu_torch.parallel.farm import AssetFarm
from sculptmate_tpu_torch.systems.tsr import TSR, TSRConfig

SMALL = dict(
    cond_image_size=64, plane_size=8, num_channels=64, num_attention_heads=4,
    attention_head_dim=16, num_layers=2, cross_attention_dim=64, vit_hidden_size=64,
    vit_num_layers=2, vit_num_heads=4, vit_intermediate_size=128,
)
FRONTEND_SPANS = {"frontend.preprocess", "frontend.crop_pad", "frontend.composite", "frontend.resize"}
MATTING_SPANS = {"matting.remove", "matting.downsize", "matting.u2net", "matting.mask_to_host",
                 "matting.upsize", "matting.cutout"}


@pytest.fixture(scope="module")
def matting():
    return U2NetMatting(seed=0, device="cpu")


def _ranges(prof, prefixes):
    """Host ranges (start, end in us) of the profiled spans whose names
    start with one of ``prefixes``, by name."""
    out = {}
    for e in prof.events():
        if e.name.startswith(prefixes):
            out.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    return out


def _inside(inner, outer):
    return all(any(s0 <= s and e <= e0 for s0, e0 in outer) for s, e in inner)


def test_preprocess_image_spans_nest(matting):
    """Each stage of the add-on's host frontend runs in its span, once: the
    matting's inside ``matting.remove``, which lies inside
    ``frontend.preprocess`` with the crop, the composite and the resize."""
    image = Image.new("RGB", (384, 384), (90, 120, 150))
    ImageDraw.Draw(image).ellipse([64, 64, 320, 320], fill=(200, 60, 40))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = preprocess_image(image, ratio=0.75, session=matting)
    assert out is not None and out.size == (1024, 1024)
    spans = _ranges(prof, ("frontend.", "matting."))
    assert set(spans) == FRONTEND_SPANS | MATTING_SPANS
    assert all(len(r) == 1 for r in spans.values())
    for name in MATTING_SPANS - {"matting.remove"}:
        assert _inside(spans[name], spans["matting.remove"]), name
    for name in FRONTEND_SPANS - {"frontend.preprocess"} | {"matting.remove"}:
        assert _inside(spans[name], spans["frontend.preprocess"]), name
    # the host stages of the frontend itself lie outside the matting
    for name in FRONTEND_SPANS - {"frontend.preprocess"}:
        assert not _inside(spans[name], spans["matting.remove"]), name


def test_farm_matting_spans(matting):
    """The farm's device matting runs the network inside ``farm.matting``;
    the encode is the TSR's own ``tsr.scene_codes``, with no span of the
    farm's around it."""
    tsr = TSR(TSRConfig(**SMALL), seed=0, dtype=torch.float32, device="cpu")
    rgba = np.random.default_rng(0).random((2, 64, 64, 4)).astype(np.float32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        meshes = AssetFarm(tsr, device="cpu").generate_batch_rgba(rgba, matting=matting, resolution=16,
                                                                  threshold=0.0)
    assert len(meshes) == 2
    spans = _ranges(prof, ("farm.", "matting.", "tsr."))
    assert "farm.encode" not in spans
    assert len(spans["matting.u2net"]) == 2 and len(spans["tsr.scene_codes"]) == 2  # one chunk per asset
    assert _inside(spans["matting.u2net"], spans["farm.matting"])
