"""The ``triposr-lean`` configuration: its seeded weights, the program built
from them, the iso-level, and the plain reference.

The weights are made on the device from the configuration's seed in two draws
(``harness/weights.py``) from the parameter lists of the reference modules,
under the published checkpoint's names: TripoSR's state dict and u2net's.
The program receives them as state dicts; the reference reads the same
tensors.
"""

from __future__ import annotations

import torch

from harness.weights import init_tensors
from reference import tsr as ref_tsr
from reference import u2net as ref_u2net
from reference.precision import EXACT, exact_float32

# offsets that keep the two models' weight streams apart for one weights seed
_TSR_STREAM, _U2NET_STREAM = 0x5151, 0x2020


def _generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed((int(seed) * 0x9E3779B1 + stream) % (1 << 63))


def make_weights(config: dict, device) -> dict:
    """{"tsr": state dict, "u2net": state dict}, float32 on ``device``, from
    the configuration's ``weights_seed``: one checkpoint, as a deployment
    serves one, whatever the run seed."""
    seed = config["assumed"]["weights_seed"]
    return {
        "tsr": init_tensors(ref_tsr.param_specs(config), _generator(seed, _TSR_STREAM, device), device),
        "u2net": init_tensors(ref_u2net.param_specs(_u2net_widths(config)), _generator(seed, _U2NET_STREAM, device),
                              device),
    }


def _u2net_widths(config: dict) -> dict:
    return ref_u2net.FULL if config["matting"]["session"] == "u2net" else ref_u2net.SMALL


def tsr_config(config: dict):
    """The port's ``TSRConfig`` of this configuration file."""
    from sculptmate_tpu_torch.systems.tsr import TSRConfig

    v, b, d = config["image_tokenizer"], config["backbone"], config["decoder"]
    return TSRConfig(
        cond_image_size=config["cond_image_size"], plane_size=config["tokenizer"]["plane_size"],
        num_channels=config["tokenizer"]["num_channels"], num_attention_heads=b["num_attention_heads"],
        attention_head_dim=b["attention_head_dim"], num_layers=b["num_layers"],
        cross_attention_dim=b["cross_attention_dim"], upsample_out_channels=config["post_processor"]["out_channels"],
        decoder_in_channels=d["in_channels"], decoder_n_neurons=d["n_neurons"],
        decoder_n_hidden_layers=d["n_hidden_layers"], decoder_activation=d["activation"],
        radius=config["renderer"]["radius"], density_activation=config["renderer"]["density_activation"],
        density_bias=config["renderer"]["density_bias"], vit_hidden_size=v["hidden_size"],
        vit_num_layers=v["num_hidden_layers"], vit_num_heads=v["num_attention_heads"],
        vit_intermediate_size=v["intermediate_size"], vit_patch_size=v["patch_size"],
        vit_base_image_size=v["base_image_size"])


def build_program(config: dict, weights: dict, device) -> dict:
    """The port's objects for this configuration: the TSR (bfloat16, the
    add-on's default) and the u2net matting session, from the weights."""
    from sculptmate_tpu_torch.frontend.matting import U2NetMatting
    from sculptmate_tpu_torch.frontend.sessions import U2netpSession
    from sculptmate_tpu_torch.systems.tsr import TSR

    session = {"u2net": U2NetMatting, "u2netp": U2netpSession}[config["matting"]["session"]]
    return {"tsr": TSR(tsr_config(config), state_dict=weights["tsr"], device=device),
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

    def codes(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) [0, 1] -> (B, 3, 40, 64, 64) codes."""
        with exact_float32(), torch.no_grad():
            return ref_tsr.scene_codes(self.weights["tsr"], self.config, images, self.model_q)

    def lattice(self, code: torch.Tensor, resolution: int) -> torch.Tensor:
        with exact_float32(), torch.no_grad():
            return ref_tsr.density_lattice(self.weights["tsr"], self.config, code, resolution, self.model_q)

    def colors(self, code: torch.Tensor, world: torch.Tensor) -> torch.Tensor:
        with exact_float32(), torch.no_grad():
            return ref_tsr.colors_at(self.weights["tsr"], self.config, code, world, self.model_q)


def threshold(config: dict, weights: dict, cond: torch.Tensor) -> float:
    """The iso-level by the configuration's rule, from the reference's codes
    of the calibration condition image ``cond`` (1, H, W, 3): the highest
    level at which the calibration lattice has at least ``cut_edges`` cut
    edges, so that every seed's weights give surfaces of about one size."""
    rule = config["assumed"]["threshold_rule"]
    ref = Reference(config, weights)
    lattice = ref.lattice(ref.codes(cond)[0], rule["lattice"])
    return ref_tsr.threshold_for_cut_edges(lattice, rule["cut_edges"])
