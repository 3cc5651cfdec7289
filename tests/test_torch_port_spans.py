"""The port's profiler spans on the CPU: the host frontend's ``frontend.*``
and ``matting.*`` spans nest as the benchmark's trace reads them, the
farm's matting network runs inside ``farm.matting``, and SF3D's textured
request runs its CLIP estimator, the fused bake's host parts and a
capacity retry each inside its own span."""

import numpy as np
import pytest
import torch
from PIL import Image, ImageDraw
from torch.profiler import ProfilerActivity, profile

from sculptmate_tpu_torch.frontend.matting import U2NetMatting
from sculptmate_tpu_torch.frontend.preprocess import preprocess_image
from sculptmate_tpu_torch.parallel.farm import AssetFarm
from sculptmate_tpu_torch.systems.sf3d import SF3D, SF3DConfig
from sculptmate_tpu_torch.systems.tsr import TSR, TSRConfig

SMALL = dict(
    cond_image_size=64, plane_size=8, num_channels=64, num_attention_heads=4,
    attention_head_dim=16, num_layers=2, cross_attention_dim=64, vit_hidden_size=64,
    vit_num_layers=2, vit_num_heads=4, vit_intermediate_size=128,
)
SF3D_SMALL = dict(
    cond_image_size=56, isosurface_resolution=14, plane_size=8, num_channels=64, num_attention_heads=4,
    attention_head_dim=16, num_latents=32, num_blocks=1, num_basic_blocks=1, upsample_scale_factor=2,
    upsample_conv_layers=2, dinov2_hidden_size=64, dinov2_num_layers=2, dinov2_num_heads=4,
    dinov2_intermediate_size=128, clip_width=64, clip_layers=2, clip_heads=4,
)
BAKE_SPANS = ("sf3d.bake_prep", "sf3d.bake_wait", "sf3d.png_encode")
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


@pytest.fixture(scope="module")
def sf3d_scene():
    """A tiny SF3D, one RGBA image and an iso-level at the lattice's mean
    density, so that the surface is not empty."""
    model = SF3D(SF3DConfig(**SF3D_SMALL), seed=0, dtype=torch.float32, device="cpu")
    image = np.random.default_rng(7).random((1, 56, 56, 4)).astype(np.float32)
    mask, rgb = model.prepare_image(torch.from_numpy(image))
    codes, _ = model.get_scene_codes(rgb)
    threshold = float(torch.exp(model.query_lattice(codes[0])["density"][0] - 1.0).mean())
    return model, image, threshold


def _keep_capacity(model, mv: int) -> None:
    """Make ``mv`` the SF3D's next vertex capacity, as an extraction that
    filled it would."""
    res = model.config.isosurface_resolution
    model.capacities.keep(res, (mv,), (mv,))
    assert model.capacities.dispatch(res) == (mv,)


def test_sf3d_request_spans(sf3d_scene):
    """A fused textured request: the CLIP estimator once inside
    ``sf3d.encode``; the bake's host preparation, its wait and the PNG
    encode once each, inside ``sf3d.unwrap_bake``; no retry."""
    model, image, threshold = sf3d_scene
    _keep_capacity(model, 1 << 16)  # room for the whole surface, whatever a persisted capacity says
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = model.run_image(image, bake_resolution=32, threshold=threshold, fused=True)
    assert out is not None and len(out["faces"]) > 0
    spans = _ranges(prof, ("sf3d.",))
    for name in ("sf3d.materials", "sf3d.unwrap_bake", *BAKE_SPANS):
        assert len(spans.get(name, [])) == 1, name
    assert _inside(spans["sf3d.materials"], spans["sf3d.encode"])
    for name in BAKE_SPANS:
        assert _inside(spans[name], spans["sf3d.unwrap_bake"]), name
    assert "sf3d.capacity_retry" not in spans


def test_sf3d_capacity_retry_span(sf3d_scene):
    """An extraction that overflows a too-small vertex capacity runs its
    second lattice and marching tets inside one ``sf3d.capacity_retry``."""
    model, image, threshold = sf3d_scene
    _keep_capacity(model, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = model.run_image(image, bake_resolution=32, threshold=threshold, fused=True)
    assert out is not None and len(out["faces"]) > 0
    spans = _ranges(prof, ("sf3d.",))
    assert len(spans["sf3d.capacity_retry"]) == 1 and len(spans["sf3d.grid"]) == 2
    assert sum(_inside([r], spans["sf3d.capacity_retry"]) for r in spans["sf3d.grid"]) == 1
    assert _inside(spans["sf3d.capacity_retry"], spans["sf3d.extract"])
