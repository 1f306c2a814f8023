"""The yardstick's operation and byte counts against hand-worked numbers
at the cells' shapes (granite-3-2b and zamba2-2.7b trained at 4 x 2048)."""

from __future__ import annotations

import json

import pytest

from conftest import BENCH
from yardstick import flops, peaks


def model(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())[
        "model"]


PAIRS = 2048 * 2049 // 2                        # 2,098,176 causal pairs


def test_flash_forward_at_granite_training_shape():
    f, b = flops.flash_fwd(4, 2048, 2048, 32, 8, 64, 2, lse=True)
    assert f == 68_753_031_168 == 4 * 64 * PAIRS * 4 * 32
    # q and o (4 x 2048 x 32 x 64), k and v (8 heads), bf16; the LSE f32
    assert b == 83_886_080 + 1_048_576
    assert flops.bound_seconds(f, b) == pytest.approx(6.9518e-5, rel=1e-4)


def test_flash_forward_served_has_no_lse_and_a_padded_length():
    f, b = flops.flash_fwd(8, 4095, 4095, 32, 32, 80, 2)
    assert f == 4 * 80 * (4095 * 4096 // 2) * 8 * 32
    assert b == 2 * 80 * (2 * 8 * 4095 * 32 + 2 * 8 * 4095 * 32)
    with pytest.raises(ValueError):
        flops.flash_fwd(1, 3, 5, 1, 1, 64, 2)


def test_flash_backward_at_both_training_shapes():
    f, b = flops.flash_bwd(4, 2048, 32, 8, 64, 2)
    assert f == 171_882_577_920                  # five products
    assert b == 167_772_160 + 1_048_576
    f, _ = flops.flash_bwd(4, 2048, 32, 32, 80, 2)
    assert f == 214_853_222_400


def test_mamba2_scan_forward_and_backward_at_zamba2_training_shape():
    f, b = flops.mamba2_fwd(4, 2048, 80, 64, 64, 2)
    assert f == 16_173_236_224 == 2 * 4 * 2048 * (64 * 64 + 80 * 64 * 192)
    # dt f32, x bf16, b and c bf16, A, h0 and h_last f32, y f32
    assert b == (2_621_440 + 83_886_080 + 2_097_152 + 320 + 10_485_760
                 + 167_772_160) == 266_862_912
    # bound by bytes at the TF32 rate for its products
    t = flops.bound_seconds(f, b, peaks.PEAK_TF32_FLOPS)
    assert t == pytest.approx(b / 3.35e12)
    f2, b2 = flops.mamba2_bwd(4, 2048, 80, 64, 64, 2)
    assert f2 == 2 * f
    assert b2 == 2 * (2_621_440 + 83_886_080 + 2_097_152 + 320) \
        + 15_728_640 + 167_772_160 == 360_710_784


def test_granite_training_step():
    layer = (2048 * 2048 + 2 * 2048 * 512 + 2048 * 2048    # q, k, v, o
             + 3 * 2048 * 8192)                            # SwiGLU
    fwd = (2 * 8192 * 40 * layer                            # projections
           + 40 * 4 * 4 * 32 * 64 * PAIRS                   # attention
           + 2 * 8192 * 2048 * 49155)                       # tied unembed
    assert layer == 60_817_408
    assert flops.train_step_flops(model("granite-3-2b"), 4, 2048) \
        == 3 * fwd == 132_770_357_575_680


def test_zamba2_training_step():
    mamba = 2560 * 10240 + 2560 * 128 + 2560 * 80 + 5120 * 2560
    shared = 4 * 2560 * 2560 + 3 * 2560 * 10240
    scan = 2 * 4 * 2048 * (64 * 64 + 80 * 64 * (64 + 2 * 64))
    fwd = (2 * 8192 * (54 * mamba + 9 * shared)
           + 9 * 4 * 4 * 32 * 80 * PAIRS + 54 * scan
           + 2 * 8192 * 2560 * 32000)
    assert mamba == 39_854_080 and shared == 104_857_600
    assert flops.train_step_flops(model("zamba2-2.7b"), 4, 2048) \
        == 3 * fwd == 161_133_675_675_648


def test_prefill_counts_one_unpadded_request_and_its_last_logits():
    m = model("granite-3-2b")
    T = 1000
    want = (2 * T * 40 * 60_817_408 + 40 * 4 * 32 * 64 * (T * (T + 1) // 2)
            + 2 * 2048 * 49155)
    assert flops.prefill_flops(m, T) == want
