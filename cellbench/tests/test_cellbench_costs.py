"""The frozen work counts against hand counts."""

import pytest

from cellbench.harness import manifest


def test_resnet50_forward_is_4_1_gmac():
    cfg = manifest.config("resnet50")
    resnet = manifest.costs("resnet")
    macs = resnet.forward_macs(cfg)
    assert 4.08e9 < macs < 4.12e9   # the published ~4.1 GMAC
    assert resnet.forward_flops(cfg) == 2.0 * macs
    mix = manifest.traffic("train.b256")
    assert resnet.train_step_flops(cfg, mix) == 3 * 2.0 * macs * 256


def test_resnet_stage_one_by_hand():
    cfg = {"image_size": 224, "channels": 3, "stage_sizes": [1],
           "widths": [64], "num_classes": 0}
    got = manifest.costs("resnet").forward_macs(cfg)
    stem = 112 * 112 * 64 * 3 * 49
    block = 56 * 56 * (64 * 64 + 9 * 64 * 64 + 64 * 256 + 64 * 256)
    assert got == stem + block


def test_gpt2_xl_train_flops():
    cfg = manifest.config("gpt2-xl")
    mix = manifest.traffic("train.b8s1024")
    lm = manifest.costs("lm")
    d, L, V, B, S = 1600, 48, 50257, 8, 1024
    dense = 6 * B * S * (L * 12 * d * d + d * V)
    attn = 6 * 2 * L * B * S * S * d // 2
    got = lm.lm_train_flops(B, S, d, L, V)
    assert got == {"dense": dense, "attn": attn, "total": dense + attn}
    assert lm.train_step_flops(cfg, mix) == pytest.approx(8.03e13, rel=2e-3)


def test_causal_attention_bound_by_hand():
    att = manifest.costs("attention")
    b, h, s, d = 8, 25, 1024, 64
    pairs = b * h * s * (s + 1) // 2
    out = att.causal_bounds(b, h, s, d, 2, 989e12, 3.35e12)
    assert out["forward_flops"] == 4 * d * pairs
    assert out["backward_flops"] == 8 * d * pairs
    tensor = b * s * h * d * 2
    assert out["forward_bytes"] == 4 * tensor + b * h * s * 4
    assert out["backward_bytes"] == 8 * tensor + b * h * s * 4
    assert out["forward"] == max(4 * d * pairs / 989e12,
                                 out["forward_bytes"] / 3.35e12)
    assert att.visible_pairs(3) == 6


def test_peaks_match_by_device_name():
    assert manifest.peaks("NVIDIA H100 80GB HBM3")["bf16_flops"] == 989e12
    assert manifest.peaks("NVIDIA A100-SXM4-80GB") is None
