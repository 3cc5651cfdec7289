"""The operation and byte counts against hand counts at small shapes."""

import pytest

from counts import PEAK_BF16_FLOPS, PEAK_BYTES, bound_s
from counts import attention, density, model


def test_bound_takes_the_larger_side():
    assert bound_s(989e12, 0) == pytest.approx(1.0)
    assert bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert bound_s(1e9, 1e12) == pytest.approx(1e12 / PEAK_BYTES)


def test_attention_counts_by_hand():
    # 1 x 2 heads, 3 queries, 5 keys, width 4: q k^T 3*5*4 and p v 3*5*4
    # multiply-adds a head, two operations each
    assert attention.flops(1, 3, 5, 2, 4) == 2 * 2 * (3 * 5 * 4 + 3 * 5 * 4)
    # q and the output (3 rows), k and v (5 rows), 2 heads x 4 wide x 2 bytes
    assert attention.nbytes(1, 3, 5, 2, 4) == 2 * 2 * 4 * (3 + 3 + 5 + 5)
    assert attention.call_bound_s(1, 3, 5, 2, 4) == pytest.approx(max(240 / PEAK_BF16_FLOPS, 256 / PEAK_BYTES))
    assert attention.is_attention_kernel("void flash_fwd_bf16<64>(CUtensorMap)")
    assert attention.is_attention_kernel("pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits>")
    assert not attention.is_attention_kernel("sm90_xmma_gemm_bf16bf16_bf16f32")


def _config():
    return {"cond_image_size": 32, "image_tokenizer": {"hidden_size": 8, "num_hidden_layers": 1,
            "num_attention_heads": 2, "intermediate_size": 16, "patch_size": 16},
            "tokenizer": {"plane_size": 2, "num_channels": 4},
            "backbone": {"num_attention_heads": 1, "attention_head_dim": 4, "num_layers": 1, "cross_attention_dim": 8},
            "post_processor": {"out_channels": 3},
            "decoder": {"in_channels": 9, "n_neurons": 2, "n_hidden_layers": 2}}


def test_tsr_attention_calls_and_model_flops_by_hand():
    c = _config()
    # 2 x 2 patches + CLS = 5 image tokens, 3 planes x 2 x 2 = 12 triplane tokens
    assert attention.tsr_calls(c) == [(1, 5, 5, 2, 4), (1, 12, 12, 1, 4), (1, 12, 5, 1, 4)]
    vit = 2 * 4 * (3 * 16 * 16 * 8) + 2 * 5 * (4 * 8 * 8 + 2 * 8 * 16)
    block = 2 * 12 * (4 * 16 + 2 * 16 + 4 * 32 + 4 * 16) + 2 * 5 * 2 * 8 * 4
    backbone = 2 * 12 * 2 * 4 * 4 + block
    upsample = 2 * 12 * 4 * 3 * 4
    attn = attention.flops(1, 5, 5, 2, 4) + attention.flops(1, 12, 12, 1, 4) + attention.flops(1, 12, 5, 1, 4)
    assert model.encode_flops(c) == vit + backbone + upsample + attn
    per_point = 2 * (9 * 2 + 1 * 2 * 2 + 2 * 4)
    assert model.decoder_flops_per_point(c) == per_point
    assert model.request_flops(c, 3, 10) == model.encode_flops(c) + per_point * (27 + 10)


def test_density_counts_by_hand():
    # R = 2: 8 points, one hidden 2 x 2 layer, width 2
    assert density.flops(2, layers=1, width=2) == 8 * (1 * 2 * 2 * 2 + 2 * 2)
    assert density.nbytes(2, layers=1, width=2) == 3 * 2 * 2 * 2 * 2 + 1 * 2 * 2 * 2 + 8 * 4
    c = {"decoder": {"n_hidden_layers": 9, "n_neurons": 64}}
    assert density.lattice_bound_s(c, 256) == pytest.approx(
        max(density.flops(256) / PEAK_BF16_FLOPS, density.nbytes(256) / PEAK_BYTES))
