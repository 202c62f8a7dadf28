"""The yardstick's arithmetic against shapes worked by hand."""

import json

import pytest

from benchmark import counts, manifest, weights


def cfg(name):
    return json.loads((manifest.HERE / "configs" / f"{name}.json").read_text())


def test_kernel_1_bounds_at_the_tables_shapes():
    # VGGT global attention of 8 samples: 4·8·16·8232²·64 = 2.2206e12 operations over 989 TFLOP/s
    assert counts.flash_fwd_bound_s((8, 8232, 16, 64)) == pytest.approx(2.2453e-3, rel=1e-4)
    # frame attention of 64 views: the operations bound it, 0.281 ms
    assert counts.flash_fwd_bound_s((64, 1029, 16, 64)) == pytest.approx(0.2807e-3, rel=1e-3)
    # a short causal prefill is bound by its bytes: Q, K, V, O of [1, 183, 32, 128] bf16 with 8 K/V heads
    nbytes = 2 * 183 * 128 * (2 * 32 + 2 * 8)
    assert counts.flash_fwd_bound_s((1, 183, 32, 128), causal=True, kv_heads=8) == pytest.approx(nbytes / 3.35e12)


def test_kernel_2_bound_at_the_w8_shape():
    # 368 rows over 97 int8 cached positions with bf16 scales, 8 K/V heads of 128: bytes bound, 0.0240 ms
    nbytes = 368 * 8 * 97 * (2 * 128 + 2 * 2) + 2 * 2 * 368 * 32 * 128
    got = counts.decode_attention_bound_s(368, 32, 8, 97, 128, kv_bytes=1, scale_bytes=2)
    assert got == pytest.approx(nbytes / 3.35e12) and got == pytest.approx(0.0240e-3, rel=0.01)


def test_the_model_counts():
    s1, s2 = cfg("vggt1b-qwen3-4b-stage1"), cfg("vggt1b-qwen3-4b-stage2-arkit")
    tree = weights.shapes(s1, lora=True)
    n_vis, n_text, n_proj = (weights.count(tree[k]) for k in ("vision", "text", "projector"))
    assert sum(weights.count(t) for t in tree.values()) == pytest.approx(6.166e9, rel=1e-3)
    # the port's bench.train_flops for the stage-1 micro step: 169.6 TFLOP
    assert counts.root_bench_train_flops(s1, 6, n_vis, n_text, n_proj) == pytest.approx(169.60e12, rel=1e-3)
    # this yardstick: the tower's forward (89.5 TFLOP of products, 50 of attention), text 4·N·tokens, ...
    assert counts.train_step_flops(s1, 6) == pytest.approx(196.23e12, rel=1e-3)
    assert counts.vision_forward_flops(s1, 48, 8, 448) == pytest.approx(139.52e12, rel=1e-3)
    assert counts.train_step_flops(s2, 4) == pytest.approx(453.10e12, rel=1e-3)
    assert counts.lora_params(s1) == 36 * 16 * ((2560 + 4096) * 2 + (2560 + 1024) * 2)


def test_launches_match_the_tower():
    s1 = cfg("vggt1b-qwen3-4b-stage1")
    launches = counts.train_flash_launches(s1, 6)
    assert len(launches) == 72
    assert launches.count(((48, 1029, 16, 64), False)) == 48 and launches.count(((6, 8232, 16, 64), False)) == 24
    assert len(counts.qa_flash_launches(s1, 32, 190)) == 108
    valid = [150, 160]
    by_hand = 36 * sum(counts.decode_attention_bound_s(1, 32, 8, n + 1, 128) for n in valid)
    assert counts.qa_decode_bound_s(s1, valid, 1) == pytest.approx(by_hand, rel=0.05)
