"""The percentile, spread, rate, traffic and roofline arithmetic against
cases worked by hand."""

import statistics

import numpy as np
import pytest

from benchmark import readers, stats, traffic
from benchmark.rooflines import (decode_step, kernelA, kernelB, kernelC,
                                 kernelD, model, train_step)


def test_percentile_by_hand():
    assert stats.percentile([5.0], 90) == 5.0
    # ranks 0..9: the 90th percentile sits at rank 8.1
    xs = list(range(1, 11))
    assert stats.percentile(xs, 90) == pytest.approx(9.1)
    assert stats.percentile(xs, 50) == pytest.approx(5.5)
    assert stats.percentile([3, 1, 2], 100) == 3
    assert stats.percentile(xs, 90) == pytest.approx(np.percentile(xs, 90))
    with pytest.raises(ValueError):
        stats.percentile([], 50)


def test_spread_by_hand():
    xs = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    q1, _, q3 = statistics.quantiles(xs, n=4)
    # exclusive method: q1 at rank 1.75 -> 10.75, q3 at rank 5.25 -> 14.25
    assert (q1, q3) == (10.75, 14.25)
    assert stats.spread(xs) == pytest.approx(3.5 / 12.5)


def test_bound_and_rates_by_hand():
    b = stats.bound(3.35e9, 1e9)           # 1 ms of bytes, ~1 us of FLOPs
    assert b["bound_ms"] == pytest.approx(1.0) and b["bound_by"] == "bytes"
    b = stats.bound(1.0, 989e9)            # 1 ms of FLOPs
    assert b["bound_ms"] == pytest.approx(1.0)
    assert b["bound_by"] == "operations"
    r = stats.rates(b, 2.0)
    assert r["bound_share"] == pytest.approx(0.5)
    assert r["tflops"] == pytest.approx(989e9 / 2.0 / 1e9)


@pytest.mark.parametrize("T,lens", [(5, [5]), (6, [3, 6, 1]), (8, [0, 9])])
def test_causal_pairs_against_counting(T, lens):
    brute = sum(sum(min(i + 1, n) for i in range(T)) for n in lens)
    assert stats.causal_pairs(T, lens) == brute


def test_flash_kernels_by_hand():
    # n = 2: pairs 3; H = 2, KV = 1, Dh = 4
    f, b = kernelA.causal_row(2, 2, 1, 4)
    assert f == 4 * 3 * 2 * 4
    assert b == 2 * (2 * 2 * 2 * 4 + 2 * 2 * 1 * 4) + 4 * 2 * 2
    fc, bc = kernelC.causal_row(2, 2, 1, 4)
    fd, bd = kernelD.causal_row(2, 2, 1, 4)
    assert (fc, fd) == (6 * 3 * 8, 8 * 3 * 8)
    assert bc == 2 * (16 + 8) * 2 + 2 * 4 * 4 + 2 * 16
    assert bd == 2 * (16 + 8) * 2 + 2 * 4 * 4 + 2 * 2 * 8


def test_kernel_b_by_hand():
    f, b = kernelB.launch([3, 5], H=4, KV=2, Dh=8)
    assert f == 4 * 4 * 8 * 8
    assert b == 2 * 2 * 2 * 8 * 8 + 2 * 2 * 2 * 4 * 8


LC = dict(hidden_size=8, intermediate_size=16, num_layers=2, num_heads=2,
          num_kv_heads=1, head_dim=4, vocab_size=10)


def test_parameter_counts_by_hand():
    # wq 8x8, wk/wv 8x4, wo 8x8, 3 x 8x16, two norms of 8
    assert model.decoder_layer(LC) == 64 + 64 + 64 + 384 + 16
    assert model.head(LC) == 80


def test_decode_step_by_hand():
    dense = 2 * 592 + 80
    f, b = decode_step.decode_step(LC, [4, 6])
    assert f == 2 * dense * 2 + 2 * 4 * 2 * 4 * 10
    assert b == 2 * dense + 2 * 2 * 2 * 1 * 4 * (10 + 2)
    f, b = decode_step.prefill(LC, [3])
    assert f == 2 * 2 * 592 * 3 + 2 * 4 * 2 * 4 * 6 + 2 * 80


def test_train_flops_scale_with_real_tokens_only():
    cfg = dict(llama=dict(LC), siglip=dict(image_size=28, patch_size=14,
                                           hidden_size=8, intermediate_size=8,
                                           num_layers=1, num_heads=2),
               mm=dict(num_image_tokens=4))
    a = train_step.model_flops(cfg, [10], 0, 0)
    b = train_step.model_flops(cfg, [10, 10], 0, 0)
    assert b == 2 * a
    dense = 2 * 592 + 80
    assert a == 6 * dense * 10 + 12 * 2 * 2 * 4 * 55


def test_serve_plan_same_sizes_across_seeds():
    mix = dict(base_seed=1, arrivals=dict(rate_per_s=5.0, order_block=8),
               requests=dict(prompt_tokens=dict(median=50, sigma=0.8, min=8,
                                                max=500),
                             output_tokens=dict(median=20, sigma=0.5, min=4,
                                                max=100),
                             image_share=0.25))
    a = traffic.serve_plan(mix, 1, 10.0, 4.0)
    b = traffic.serve_plan(mix, 2 ** 40 + 3, 10.0, 4.0)
    win = [r for r in a if r["in_window"]]
    assert len(win) == 50 and all(0 <= r["due"] < 10.0 for r in win)
    key = lambda rs: sorted((r["prompt_len"], r["max_new"], r["image"])
                            for r in rs if r["in_window"])
    assert key(a) == key(b)
    assert [r["prompt_len"] for r in a] != [r["prompt_len"] for r in b]
    # each block of 8 holds the same sizes for every seed
    win_b = [r for r in b if r["in_window"]]
    for s in range(0, 50, 8):
        assert key(win[s:s + 8]) == key(win_b[s:s + 8])
    assert 0 < sum(r["image"] for r in win[:24]) < 12


def test_blocked_order_shuffles_within_blocks_only():
    order = traffic.blocked_order(np.random.default_rng(3), 21, 8)
    assert sorted(order) == list(range(21))
    for s in range(0, 21, 8):
        assert sorted(order[s:s + 8]) == list(range(s, min(s + 8, 21)))


def test_train_plan_balances_steps_and_keeps_shares():
    mix = dict(base_seed=3, microbatches=4, mix=[
        dict(kind="image_qa", share=0.5,
             question=dict(median=40, sigma=0.8, min=8, max=256),
             answer=dict(median=120, sigma=0.9, min=8, max=1024)),
        dict(kind="visual_generation", share=0.25,
             prompt=dict(median=30, sigma=0.6, min=8, max=128)),
        dict(kind="text_only", share=0.25,
             length=dict(median=350, sigma=1.0, min=32, max=4000),
             prompt_share=0.3)])
    plan = traffic.train_plan(mix, 16)
    for step in plan:
        kinds = sorted(r["kind"] for r in step)
        assert kinds == ["image_qa", "image_qa", "text_only",
                         "visual_generation"]
    totals = [sum(r["length"] for r in s) for s in plan]
    lengths = sorted(r["length"] for s in plan for r in s)
    # dealt longest first to the lightest step: no step carries more than
    # the lightest plus the longest row
    assert max(totals) - min(totals) <= lengths[-1]


def test_step_lengths_follow_each_row():
    tick = dict(lens0=[10, 5, 7], lens1=[13, 5, 8], admitted=[(1, 4, False)],
                steps=3)
    # row 0 advances 3 times, row 1 was admitted at 4 and advanced once,
    # row 2 advanced once then stopped
    assert readers.step_lengths(tick, 0, False) == [11, 5, 8]
    assert readers.step_lengths(tick, 2, False) == [13, 6, 9]
    assert readers.step_lengths(tick, 2, True) == [13]
    assert readers.step_lengths(tick, 0, True) == [11, 5, 8]
