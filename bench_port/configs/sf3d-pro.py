"""The ``sf3d-pro`` configuration: its seeded weights, the program built from
them, the iso-level, and the plain reference.

The weights are made on the device from the configuration's seed in two draws
(``harness/weights.py``) from the parameter lists of the reference modules,
under the published checkpoints' names: Stable Fast 3D's state dict and
u2net's; a third draw makes the triplane smooth (``_smooth_triplane``). The
program receives them as state dicts; the reference reads the same tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from harness.weights import init_tensors
from reference import sf3d as ref_sf3d
from reference import u2net as ref_u2net
from reference.precision import EXACT, exact_float32

# offsets that keep the weight streams apart for one weights seed
_SF3D_STREAM, _U2NET_STREAM, _SMOOTH_STREAM = 0x5F3D, 0x2020, 0x5300


def _generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed((int(seed) * 0x9E3779B1 + stream) % (1 << 63))


def _u2net_widths(config: dict) -> dict:
    return ref_u2net.FULL if config["matting"]["session"] == "u2net" else ref_u2net.SMALL


def make_weights(config: dict, device) -> dict:
    """{"sf3d": state dict, "u2net": state dict}, float32 on ``device``, from
    the configuration's ``weights_seed``: one checkpoint, as a deployment
    serves one, whatever the run seed."""
    seed = config["assumed"]["weights_seed"]
    sf3d = init_tensors(ref_sf3d.param_specs(config), _generator(seed, _SF3D_STREAM, device), device)
    _smooth_triplane(config, sf3d, _generator(seed, _SMOOTH_STREAM, device))
    return {
        "sf3d": sf3d,
        "u2net": init_tensors(ref_u2net.param_specs(_u2net_widths(config)), _generator(seed, _U2NET_STREAM, device),
                              device),
    }


def _smooth_triplane(config: dict, sd: dict, generator: torch.Generator) -> None:
    """Make the triplane smooth across the planes, as a trained model's is
    (the configuration's ``assumed.smooth_triplane``): the
    learned triplane tokens a normal field drawn on a ``grid`` x ``grid``
    lattice per plane and channel and resampled bicubic to the plane size
    (unit variance per channel, then the tokens' N(0, 1) / sqrt(C) scale),
    and the upsample's last convolution the same for the scale_factor^2
    sub-pixels of each output channel, so that the pixel shuffle does not
    set neighbouring texels of the codes apart at random."""
    rule = config["assumed"]["smooth_triplane"]
    C, P = config["tokenizer"]["num_channels"], config["tokenizer"]["plane_size"]
    tokens = sd["tokenizer.embeddings"]
    coarse = torch.randn((3, C, rule["grid"], rule["grid"]), generator=generator, device=tokens.device)
    fine = F.interpolate(coarse, size=(P, P), mode="bicubic", align_corners=False)
    sd["tokenizer.embeddings"] = fine / fine.std(dim=(2, 3), keepdim=True) * C ** -0.5
    po = config["post_processor"]
    last = f"post_processor.upsample.{2 * (po['conv_layers'] - 1)}"
    sub = po["scale_factor"] ** 2
    for name in (f"{last}.weight", f"{last}.bias"):
        sd[name] = sd[name][::sub].repeat_interleave(sub, dim=0).contiguous()


def sf3d_config(config: dict):
    """The port's ``SF3DConfig`` of this configuration file."""
    from sculptmate_tpu_torch.systems.sf3d import SF3DConfig

    v, b, po, ie = config["image_tokenizer"], config["backbone"], config["post_processor"], config["image_estimator"]
    d = config["decoder"]
    return SF3DConfig(
        cond_image_size=config["cond_image_size"], isosurface_resolution=config["isosurface_resolution"],
        isosurface_threshold=config["isosurface_threshold"], radius=config["radius"], weld_eps=config["weld_eps"],
        background_color=tuple(config["background_color"]), default_fovy_deg=config["default_fovy_deg"],
        default_distance=config["default_distance"],
        camera_in_channels=config["camera_embedder"]["in_channels"],
        camera_out_channels=config["camera_embedder"]["out_channels"],
        plane_size=config["tokenizer"]["plane_size"], num_channels=config["tokenizer"]["num_channels"],
        num_attention_heads=b["num_attention_heads"], attention_head_dim=b["attention_head_dim"],
        num_latents=b["num_latents"], num_blocks=b["num_blocks"], num_basic_blocks=b["num_basic_blocks"],
        upsample_out_channels=po["out_channels"], upsample_scale_factor=po["scale_factor"],
        upsample_conv_layers=po["conv_layers"], decoder_heads=tuple(dict(h) for h in d["heads"]),
        decoder_n_neurons=d["n_neurons"], decoder_activation=d["activation"],
        dinov2_hidden_size=v["hidden_size"], dinov2_num_layers=v["num_hidden_layers"],
        dinov2_num_heads=v["num_attention_heads"], dinov2_intermediate_size=v["intermediate_size"],
        clip_width=ie["clip_width"], clip_layers=ie["clip_layers"], clip_heads=ie["clip_heads"])


def build_program(config: dict, weights: dict, device) -> dict:
    """The port's objects for this configuration: the SF3D (bfloat16, the
    add-on's default) and the u2net matting session, from the weights."""
    from sculptmate_tpu_torch.frontend.matting import U2NetMatting
    from sculptmate_tpu_torch.frontend.sessions import U2netpSession
    from sculptmate_tpu_torch.systems.sf3d import SF3D

    session = {"u2net": U2NetMatting, "u2netp": U2netpSession}[config["matting"]["session"]]
    return {"sf3d": SF3D(sf3d_config(config), state_dict=weights["sf3d"], device=device),
            "matting": session(state_dict=weights["u2net"], device=device)}


class Reference:
    """The plain reference of this configuration at one precision (the
    reference proper: float32, TF32 off; the control: rounded operands)."""

    def __init__(self, config: dict, weights: dict, model_q=EXACT, matting_q=EXACT):
        self.config, self.weights = config, weights
        self.model_q, self.matting_q = model_q, matting_q

    def masks(self, images: torch.Tensor) -> torch.Tensor:
        """(B, 320, 320, 3) [0, 1] -> (B, 320, 320) masks."""
        dev = next(iter(self.weights["u2net"].values())).device
        with exact_float32(), torch.no_grad():
            return ref_u2net.masks(self.weights["u2net"], images.to(dev), _u2net_widths(self.config), self.matting_q)

    def encode(self, rgba: torch.Tensor):
        """(1, H, W, 4) RGBA in [0, 1] -> (codes (3, C_out, H', W'),
        roughness, metallic): the model's view of the condition image."""
        sd, c, q = self.weights["sf3d"], self.config, self.model_q
        with exact_float32(), torch.no_grad():
            mask, rgb = ref_sf3d.prepare_image(c, rgba)
            codes = ref_sf3d.scene_codes(sd, c, rgb, q)[0]
            rough, metal = ref_sf3d.materials(sd, c, rgb * mask, q)
        return codes, float(rough[0]), float(metal[0])

    def lattice(self, code: torch.Tensor):
        with exact_float32(), torch.no_grad():
            return ref_sf3d.lattice(self.weights["sf3d"], self.config, code, self.model_q)

    def surface(self, code: torch.Tensor, world: torch.Tensor):
        """(albedo, perturbed normal) at (n, 3) world points."""
        with exact_float32(), torch.no_grad():
            return ref_sf3d.surface_heads(self.weights["sf3d"], self.config, code, world, self.model_q)


def threshold(config: dict, weights: dict, rgba: torch.Tensor) -> float:
    """The iso-level by the configuration's rule, from the reference's codes
    of the calibration condition image ``rgba`` (1, H, W, 4): the highest
    level at which the calibration lattice gives at least ``raw_vertices``
    raw marching-tets vertices, so that every seed's weights give surfaces
    of about one size."""
    rule = config["assumed"]["threshold_rule"]
    ref = Reference(config, weights)
    density, _ = ref.lattice(ref.encode(rgba)[0])
    return ref_sf3d.threshold_for_vertices(density, rule["raw_vertices"])
