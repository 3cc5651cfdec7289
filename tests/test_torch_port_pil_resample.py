"""Kernel K12 (``ops/pil_resample.py``): PIL's Lanczos resize, cutout and
gray composite byte for byte. On the CPU its plain versions against PIL's
``Image.resize`` and the add-on's whole chain (``preprocess_image_device``)
against its host path with the same session; on the card (``cuda``) K12
against the plain versions and the card path of ``preprocess_image``
against the host path. Imports no JAX and needs no conftest, so that the
card's tests run on a machine with a card:
``python -m pytest --noconftest tests/test_torch_port_pil_resample.py -q``."""

import numpy as np
import pytest
import torch
from PIL import Image, ImageDraw

from sculptmate_tpu_torch.frontend import matting, preprocess
from sculptmate_tpu_torch.frontend.matting import SessionBase, U2NetMatting
from sculptmate_tpu_torch.frontend.preprocess import (
    preprocess_image,
    preprocess_image_device,
    preprocess_image_host,
    takes_card_path,
)
from sculptmate_tpu_torch.frontend.sessions import ClothSegSession, U2netpSession
from sculptmate_tpu_torch.ops import pil_resample as pr

# (mode, source (w, h), target (w, h)): the add-on's pairs (the photo to the
# u2net's 320^2, its mask back, padded squares to 1024^2), odd, prime and
# non-square sizes, up and down, a side that keeps its size (Pillow skips
# that pass) and the whole resize that Pillow skips
RESIZES = [
    ("RGB", (1024, 1024), (320, 320)),
    ("L", (320, 320), (1024, 1024)),
    ("RGB", (1365, 1365), (1024, 1024)),
    ("RGB", (777, 777), (1024, 1024)),
    ("L", (131, 97), (263, 61)),
    ("RGB", (101, 257), (1024, 1024)),
    ("L", (997, 641), (331, 1009)),
    ("RGB", (300, 420), (300, 200)),
    ("L", (200, 300), (410, 300)),
    ("RGB", (256, 256), (256, 256)),
    ("RGB", (5, 3), (2, 7)),
]


def _noise(rng, mode, size):
    w, h = size
    a = rng.integers(0, 256, (h, w) if mode == "L" else (h, w, 3), dtype=np.uint8)
    # half the rows a smooth ramp, half white noise (Lanczos overshoots both clips there)
    ramp = np.linspace(0, 255, w).astype(np.uint8)
    a[: h // 2] = ramp[None, :, None] if mode == "RGB" else ramp[None]
    return a


@pytest.mark.parametrize("mode,src,dst", RESIZES)
def test_resample_plain_matches_pil(mode, src, dst):
    """K12's plain version gives ``Image.resize(LANCZOS)``'s bytes."""
    a = _noise(np.random.default_rng(42), mode, src)
    ref = np.asarray(Image.fromarray(a).resize(dst, Image.Resampling.LANCZOS))
    got = pr.resample_plain(torch.from_numpy(a if mode == "RGB" else a[..., None]), dst).numpy()
    np.testing.assert_array_equal(got if mode == "RGB" else got[..., 0], ref)


def test_resample_photo_and_mask_forms():
    """The photo's form is the resize's bytes / 255 in float32, as the
    matting's numpy divides them; the mask's reads a float mask as PIL's L
    image of ``uint8(255 m)``, and its bbox is that of the texels above 0
    (``np.where``'s), all-zero when empty."""
    rng = np.random.default_rng(42)
    a = _noise(rng, "RGB", (640, 480))
    small = pr.resample_photo(torch.from_numpy(a), (320, 320))
    ref = np.asarray(Image.fromarray(a).resize((320, 320), Image.Resampling.LANCZOS), dtype=np.float32) / 255.0
    assert small.dtype == torch.float32 and np.array_equal(small.numpy(), ref)
    m = np.zeros((300, 420), np.float32)
    m[40:200, 17:300] = rng.random((160, 283)).astype(np.float32)
    out, bbox = pr.resample_mask(torch.from_numpy(m), (350, 333))
    ref = np.asarray(Image.fromarray((m * 255).astype(np.uint8), mode="L").resize((350, 333), Image.Resampling.LANCZOS))
    np.testing.assert_array_equal(out.numpy(), ref)
    ys, xs = np.where(ref > 0)
    assert pr.bbox_bounds(bbox, 333, 350) == (ys.min(), ys.max(), xs.min(), xs.max())
    _, empty = pr.resample_mask(torch.zeros(30, 40), (50, 60))
    assert pr.bbox_bounds(empty, 60, 50) == (60, -1, 50, -1)


def test_wrappers_refuse_other_layouts():
    """Layouts K12 does not take raise, on the CPU as on the card."""
    with pytest.raises(ValueError):
        pr.resample_photo(torch.zeros(8, 8, 4, dtype=torch.uint8), (4, 4))  # RGBA
    with pytest.raises(ValueError):
        pr.resample_photo(torch.zeros(8, 8, 1, dtype=torch.uint8), (4, 4))  # L
    with pytest.raises(ValueError):
        pr.resample_photo(torch.zeros(8, 8, 3, dtype=torch.uint8).transpose(0, 1), (4, 4))
    with pytest.raises(ValueError):
        pr.resample_mask(torch.zeros(8, 8, dtype=torch.uint8), (4, 4))  # an L image, not the network's mask
    photo, mask = torch.zeros(8, 8, 3, dtype=torch.uint8), torch.zeros(8, 8, dtype=torch.uint8)
    with pytest.raises(ValueError):
        pr.condition_image(photo, mask, pr.Crop(4, 4, 5, 2, 0, 0, 6), 16)  # past the photo's edge
    with pytest.raises(ValueError):
        pr.padded_cutout(photo, mask[:4], pr.Crop(0, 0, 2, 2, 0, 0, 4))


class _RampSession(SessionBase):
    """``SessionBase``'s recipe around a stand-in network on the CPU: the
    mask is a clipped ramp of the small image's brightness, soft at the
    object's edge, so the cutout and composite see every alpha level."""

    def __init__(self, scale=4.0):
        self.device = torch.device("cpu")
        self.scale = scale

    def predict_mask_batch(self, images):
        return ((images.to(torch.float32).mean(-1) - 0.3) * self.scale).clamp(0, 1)


def _photo(size, box, seed=0):
    """Noisy dark backdrop with a bright ellipse in ``box`` (may leave the frame)."""
    w, h = size
    a = (np.random.default_rng(seed).random((h, w, 3)) * 40 + 10).astype(np.uint8)
    image = Image.fromarray(a)
    ImageDraw.Draw(image).ellipse(box, fill=(220, 150, 90))
    return image


# (photo size, ellipse box): centred; off-centre through the top and right
# edges; a tall frame with the object in its corner; a photo whose padded
# square is under 250 px (the Lean path rejects it)
PHOTOS = [
    ((384, 384), [64, 64, 320, 320]),
    ((420, 300), [180, -60, 480, 250]),
    ((300, 420), [0, 0, 120, 300]),
    ((200, 200), [60, 50, 150, 170]),
]


@pytest.mark.parametrize("use_alpha", [False, True])
@pytest.mark.parametrize("ratio", [0.75, 0.85])
@pytest.mark.parametrize("size,box", PHOTOS)
def test_device_chain_matches_host_path(size, box, ratio, use_alpha):
    """The card path's chain on K12's plain versions gives the host path's
    bytes (or its None) with the same CPU session."""
    image, session = _photo(size, box), _RampSession()
    ref = preprocess_image_host(image, ratio, use_alpha, session)
    got = preprocess_image_device(image, ratio, use_alpha, session)
    assert (ref is None) == (not use_alpha and size == (200, 200))  # only a square under 250 px is refused
    if ref is None:
        assert got is None
        return
    assert got.mode == ref.mode == ("RGBA" if use_alpha else "RGB")
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


@pytest.mark.parametrize("use_alpha", [False, True])
def test_device_chain_with_a_u2net(use_alpha):
    """With a real (small, random) u2net the network's input is the host
    path's to the bit, so the mask and the result are too."""
    image, session = _photo((384, 320), [40, 30, 300, 280], seed=3), U2netpSession(device="cpu")
    ref = preprocess_image_host(image, 0.85, use_alpha, session)
    np.testing.assert_array_equal(np.asarray(preprocess_image_device(image, 0.85, use_alpha, session)), np.asarray(ref))


@pytest.mark.parametrize("use_alpha", [False, True])
def test_device_chain_empty_matte(use_alpha):
    """An empty matte gives None on both paths."""
    image, session = _photo((320, 320), [60, 60, 260, 260]), _RampSession(scale=0.0)
    assert preprocess_image_host(image, 0.75, use_alpha, session) is None
    assert preprocess_image_device(image, 0.75, use_alpha, session) is None


def test_takes_card_path():
    """Only an RGB photo with a card ``SessionBase`` keeping the base
    class's one-mask recipe goes to the card; the CPU keeps the host path."""
    rgb = Image.new("RGB", (8, 8))
    card = U2NetMatting.__new__(U2NetMatting)
    card.device = torch.device("cuda", 0)
    cloth = ClothSegSession.__new__(ClothSegSession)
    cloth.device = card.device
    assert takes_card_path(rgb, card)
    assert not takes_card_path(rgb.convert("RGBA"), card)
    assert not takes_card_path(rgb, cloth)
    assert not takes_card_path(rgb, _RampSession())


def test_preprocess_image_takes_the_default_session(monkeypatch):
    """With no session where a card is, ``preprocess_image`` (the add-on
    panel's call) matts with ``default_session()`` as ``remove`` would, so a
    photo takes the card path."""
    card = U2NetMatting.__new__(U2NetMatting)
    card.device = torch.device("cuda", 0)
    taken = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(matting, "default_session", lambda device=None: card)
    monkeypatch.setattr(preprocess, "preprocess_image_device", lambda *args: taken.append(args) or "card")
    assert preprocess_image(Image.new("RGB", (8, 8)), 0.75) == "card"
    assert [a[1:] for a in taken] == [(0.75, False, card)]


def _random_crop(rng, H, W):
    hc, wc = int(rng.integers(1, H)), int(rng.integers(1, W))
    y1, x1 = int(rng.integers(0, H - hc + 1)), int(rng.integers(0, W - wc + 1))
    side = int(max(hc, wc) / 0.75)
    return pr.Crop(y1, x1, hc, wc, (side - hc) // 2, (side - wc) // 2, side)


@pytest.mark.cuda
def test_k12_matches_plain_on_card():
    """K12 gives its plain version's bytes: every resize of ``RESIZES`` (RGB
    in the photo's form, L in the mask's), masks with their bboxes, the
    condition image and the padded cutout (crops at the photo's edges
    included); the wrappers count their launches and refuse other layouts
    on the card too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(42)
    dev = torch.device("cuda")
    n_photo, n_mask = pr.resample_photo.launches, pr.resample_mask.launches
    for mode, src, dst in RESIZES:
        a = torch.from_numpy(_noise(rng, mode, src))
        if mode == "RGB":
            assert torch.equal(pr.resample_photo(a.to(dev), dst).cpu(), pr.resample_photo(a, dst)), (src, dst)
        else:  # the L image as a mask whose uint8(255 m) it is
            m = (a.float() + 0.5) / 255
            got, ref = pr.resample_mask(m.to(dev), dst), pr.resample_mask(m, dst)
            assert torch.equal(got[0].cpu(), ref[0]) and torch.equal(got[1].cpu(), ref[1]), (src, dst)
    for shape, dst in (((320, 320), (1024, 1024)), ((97, 131), (300, 420)), ((40, 30), (30, 40))):
        m = torch.from_numpy(rng.random(shape).astype(np.float32))
        m[: shape[0] // 3] = 0
        for mm in (m, torch.zeros(shape)):
            out, bbox = pr.resample_mask(mm.to(dev), dst)
            ref, ref_bbox = pr.resample_mask(mm, dst)
            assert torch.equal(out.cpu(), ref) and torch.equal(bbox.cpu(), ref_bbox), (shape, dst)
    assert pr.resample_photo.launches - n_photo == 2 * sum(m == "RGB" for m, _, _ in RESIZES)
    assert pr.resample_mask.launches - n_mask == 2 * (sum(m == "L" for m, _, _ in RESIZES) + 6)
    H, W = 700, 530
    photo = torch.from_numpy(rng.integers(0, 256, (H, W, 3), dtype=np.uint8))
    mask = torch.from_numpy(rng.integers(0, 256, (H, W), dtype=np.uint8))
    mask[:, :100] = 0
    crops = [_random_crop(rng, H, W) for _ in range(6)]
    crops += [pr.Crop(0, 0, H, W, 0, 0, H), pr.Crop(3, 0, H - 3, 17, 1, 9, H)]
    n_cond, n_cut = pr.condition_image.launches, pr.padded_cutout.launches
    for crop in crops:
        got = pr.condition_image(photo.to(dev), mask.to(dev), crop, 1024).cpu()
        assert torch.equal(got, pr.condition_image(photo, mask, crop, 1024)), crop
        got = pr.padded_cutout(photo.to(dev), mask.to(dev), crop).cpu()
        assert torch.equal(got, pr.padded_cutout(photo, mask, crop)), crop
    assert pr.condition_image.launches - n_cond == 2 * len(crops)
    assert pr.padded_cutout.launches - n_cut == len(crops)
    torch.cuda.synchronize()
    with pytest.raises(ValueError):
        pr.resample_photo(torch.zeros(8, 8, 4, dtype=torch.uint8, device=dev), (4, 4))
    with pytest.raises(ValueError):
        pr.resample_mask(torch.zeros(8, 8, dtype=torch.int32, device=dev), (4, 4))
    with pytest.raises(ValueError):
        pr.condition_image(photo.to(dev), mask, crops[0], 1024)  # the mask on another device


@pytest.mark.cuda
def test_card_path_matches_host_path():
    """``preprocess_image`` with a card u2net session takes the card path
    (K12's launch counts move, the ``frontend.on_card`` span is there) and
    gives the host path's bytes with the same session, for the Lean and the
    Pro buttons."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    session = U2NetMatting(seed=0, device="cuda")
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # the same mask from the same input on both paths
    try:
        for k, (size, box) in enumerate([((1024, 1024), [200, 150, 800, 900]), ((900, 1200), [500, -100, 1000, 700])]):
            image = _photo(size, box, seed=k)
            for ratio, use_alpha in ((0.75, False), (0.85, True)):
                wrappers = (pr.resample_photo, pr.resample_mask, pr.condition_image, pr.padded_cutout)
                counts = [f.launches for f in wrappers]
                with profile(activities=[ProfilerActivity.CPU]) as prof:
                    got = preprocess_image(image, ratio, use_alpha, session)
                moved = tuple(f.launches - n for f, n in zip(wrappers, counts))
                assert moved == ((2, 2, 0, 1) if use_alpha else (2, 2, 2, 0))
                assert sum(e.name == "frontend.on_card" for e in prof.events()) == 1
                ref = preprocess_image_host(image, ratio, use_alpha, session)
                assert ref is not None and got.mode == ref.mode and got.size == ref.size
                np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
    finally:
        torch.backends.cudnn.deterministic = saved


@pytest.mark.cuda
def test_card_path_without_a_session():
    """The add-on panel's call, ``preprocess_image(photo, ratio,
    use_alpha)`` with no session, takes the card path on
    ``default_session()``: K12's launch counts move, for both buttons."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    image = _photo((1024, 1024), [200, 150, 800, 900], seed=5)
    wrappers = (pr.resample_photo, pr.resample_mask, pr.condition_image, pr.padded_cutout)
    for ratio, use_alpha in ((0.75, False), (0.85, True)):
        counts = [f.launches for f in wrappers]
        got = preprocess_image(image, ratio, use_alpha)
        assert tuple(f.launches - n for f, n in zip(wrappers, counts)) == ((2, 2, 0, 1) if use_alpha else (2, 2, 2, 0))
        assert got.mode == ("RGBA" if use_alpha else "RGB")
