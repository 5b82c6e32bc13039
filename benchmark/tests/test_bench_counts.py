"""The benchmark's FLOP and byte counts against sums worked out by hand,
at small shapes."""

from __future__ import annotations

import pytest
import torch

from benchmark import harness
from benchmark.counts import attention, flops
from benchmark.reference import layers, unet

torch.set_num_threads(1)


def test_attention_flops_are_two_products():
    B, N, h, d = 2, 16, 4, 8
    q = torch.zeros(B, N, h, d, device="meta")
    got = flops.count(lambda: layers.attention(q, q, q, layers.FP32))
    assert got == 4 * B * h * N * N * d


@pytest.mark.parametrize("backward", [False, True])
def test_attention_ops_and_bytes(backward):
    B, N, h, d = 3, 64, 8, 32
    ops, nbytes = attention.ops_bytes((B, N, h, d), "bfloat16", backward)
    elems = B * N * h * d
    if backward:
        assert ops == 8 * B * h * N * N * d
        assert nbytes == 8 * elems * 2 + 4 * B * h * N   # q k v o dO, lse; dq dk dv
    else:
        assert ops == 4 * B * h * N * N * d
        assert nbytes == 4 * elems * 2                   # q k v; out


def test_bound_is_the_larger_of_operations_and_bytes():
    peaks = {"flops_per_s": {"bfloat16": 1e12}, "bytes_per_s": 1e9}
    model = {"kind": "DynamicUNet", "T": 10, "channel": 32,
             "channel_mult": [1, 2], "num_res_blocks": 1, "num_heads": 8,
             "dropout": 0.0, "img_size": 16}
    shapes = attention.shapes(model, 2)
    assert shapes == [(2, 8 * 8, 8, 8)] * 4     # 4 middle blocks at 8×8
    want = 0.0
    for s in shapes:
        ops, nbytes = attention.ops_bytes(s, "bfloat16", False)
        want += max(ops / 1e12, nbytes / 1e9)
    assert attention.bound_s(model, 2, "bfloat16", False, peaks) == \
        pytest.approx(want)


def test_conv_dense_and_resampling_flops():
    B, C, H = 2, 32, 8
    x = torch.zeros(B, C, H, H, device="meta")
    with torch.device("meta"):
        conv = layers.Conv(C, 2 * C, 3, layers.FP32)
        dense = layers.Dense(C, 3 * C, layers.FP32)
        down = unet.DownSample(C, layers.FP32)
        up = unet.UpSample(C, layers.FP32)
    assert flops.count(lambda: conv(x)) == 2 * B * H * H * C * 2 * C * 9
    t = torch.zeros(B, 5, C, device="meta")
    assert flops.count(lambda: dense(t)) == 2 * B * 5 * C * 3 * C
    # one 5×5 stride-2 convolution: 25 taps at each of (H/2)² outputs
    assert flops.count(lambda: down(x)) == 2 * B * (H // 2) ** 2 * C * C * 25
    # the transposed 5×5: 25 taps for each input position, then a 3×3
    assert flops.count(lambda: up(x)) == (2 * B * H * H * C * C * 25
                                          + 2 * B * (2 * H) ** 2 * C * C * 9)


def test_window_flops_scale_with_calls_and_batch():
    config = harness.load_json(harness.BENCH_DIR / "configs"
                               / "cfg-cifar10.json")
    per = flops.per_item(config, "sample")
    work = {"kind": "sample", "model_calls": 3, "batch": 160}
    assert flops.window_flops(config, work) == pytest.approx(3 * 160 * per)


def test_training_counts_forward_and_backward():
    config = harness.load_json(harness.BENCH_DIR / "configs"
                               / "flagship256.json")
    config["model"].update(channel=32, channel_mult=[1, 2],
                           num_res_blocks=1, img_size=32)
    config["training"]["loss"] = {"mse": 1.0}   # the U-Net's work alone
    fwd = flops.per_item(config, "sample")
    step = flops.per_item(config, "train")
    # the backward's two products (input and weight) per forward product
    assert 2.5 * fwd < step < 3.5 * fwd
