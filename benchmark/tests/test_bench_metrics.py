"""The per-layer metric readers on hand-made records: a traced serving
slice of two ticks and a traced training step, with device operations
placed by hand on the host clock."""

import pytest

from benchmark import spec as spec_lib
from benchmark.rooflines import kernelA, kernelB, kernelC, kernelD
from benchmark.stats import PEAK_BF16_TFLOPS, bound

LC = dict(hidden_size=8, intermediate_size=16, num_layers=2, num_heads=2,
          num_kv_heads=1, head_dim=4, vocab_size=10, rms_norm_eps=1e-5)
CFG = dict(llama=LC, siglip=dict(image_size=28, patch_size=14,
                                 hidden_size=8, intermediate_size=8,
                                 num_layers=1, num_heads=2),
           mm=dict(num_image_tokens=4))
MS = 1_000_000                          # ns


def read(name, records):
    return spec_lib.metric(name).read(records)


def serve_records():
    # tick 1 admits a 3-token prompt into slot 1, then one decode step;
    # tick 2 is one decode step; two rows, two layers
    ev1 = [("flash_fwd_kernel", 1 * MS, 2 * MS),
           ("rms_norm elementwise", 4 * MS, 1 * MS),
           ("decode_attn_kernel", 5 * MS, 1 * MS),
           ("nvjet_gemm", 6 * MS, 1 * MS),
           ("decode_attn_kernel", 7 * MS, 1 * MS),
           ("Memcpy DtoH", 8 * MS, 1 * MS)]
    ev2 = [("nvjet_gemm", 11 * MS, 1 * MS),
           ("decode_attn_kernel", 12 * MS, 1 * MS),
           ("decode_attn_kernel", 13 * MS, 1 * MS)]
    ticks = [dict(t0=0, t1=10 * MS, traced=True, lens0=[5, 0],
                  lens1=[6, 4], steps=1, prefill=1,
                  admitted=[(1, 3, False)]),
             dict(t0=10 * MS, t1=20 * MS, traced=True, lens0=[6, 4],
                  lens1=[7, 4], steps=1, prefill=0, admitted=[]),
             dict(t0=30 * MS, t1=90 * MS, traced=False, lens0=None,
                  lens1=None, steps=8, prefill=0, admitted=[])]
    events = ev1 + ev2
    busy = [(1 * MS, 3 * MS), (4 * MS, 9 * MS), (11 * MS, 14 * MS)]
    trace = dict(t0=0, t1=20 * MS, events=events, busy=busy, gaps=[])
    return dict(kind="serve", config=CFG, ticks=ticks, spans=[],
                queue=[(-900 * MS, 0.1), (-900 * MS, 0.2), (-900 * MS, 0.3),
                       (-50 * MS, 0.5)],
                gaps=[(-900 * MS, 0.04), (-800 * MS, 0.06), (-10 * MS, 0.05),
                      (5 * MS, 0.5)], trace=trace)


def test_serving_readers_by_hand():
    r = serve_records()
    # the fourth request was admitted after the slice began (at 450 ms)
    assert read("queue_wait_p90_ms", r) == pytest.approx(280.0)
    assert read("queue_wait_p90_ms", dict(r, trace=None)) == pytest.approx(
        440.0)
    assert read("tick_host_ms", r) == pytest.approx(60.0)
    # the fourth request's last token came after the slice began (at 0)
    assert read("token_gap_p90_ms", r) == pytest.approx(58.0)
    assert read("token_gap_p90_ms", dict(r, trace=None)) == pytest.approx(
        368.0)
    # decode phases: from the first kernel B; tick 1: B, gemm, B (the
    # copy is no kernel), tick 2: B, B; over 2 decode steps
    assert read("kernels_per_decode_step", r) == pytest.approx(5 / 2)
    assert read("decode_step_device_ms", r) == pytest.approx(5 / 2)
    assert read("idle_pct.decode", r) == pytest.approx(100 * (1 - 10 / 20))
    # kernel B: tick 1's rows advance and read 6 (5 + 1) and 4 (3 + 1)
    # keys; in tick 2 only row 0 advances (7 keys), slot 1's finished row
    # counts for nothing; each bound once per layer, over 4 ms of B
    b = sum(2 * bound(*reversed(kernelB.launch(l, 2, 1, 4)))["bound_ms"]
            for l in ([6, 4], [7]))
    assert read("kernelB_roofline", r) == pytest.approx(100 * b / 4.0)
    assert read("decode_mfu", r) > 0


def test_readers_find_nothing_without_a_trace():
    r = dict(serve_records(), trace=None)
    for name in ("decode_step_device_ms", "kernels_per_decode_step",
                 "kernelB_roofline", "idle_pct.decode", "decode_mfu"):
        assert read(name, r) is None
    for name in ("flash_roofline.train", "gemm_device_ms.train",
                 "elementwise_device_ms.train", "idle_pct.train",
                 "train_mfu"):
        assert read(name, r) is None
        assert read(name, dict(kind="train", config=CFG, steps=[],
                               trace=None)) is None


def test_training_readers_by_hand():
    L = LC["num_layers"]
    # one traced step of two rows (3 and 5 real tokens); per layer and row
    # A runs twice (forward and recompute), C and D once
    events = ([("flash_fwd_kernel", i * MS, MS) for i in range(8)]
              + [("flash_bwd_dq_kernel", (10 + i) * MS, MS)
                 for i in range(4)]
              + [("flash_bwd_dkv_kernel", (20 + i) * MS, 2 * MS)
                 for i in range(4)]
              + [("nvjet_gemm", 40 * MS, 10 * MS),
                 ("adam elementwise", 60 * MS, 5 * MS)])
    trace = dict(t0=0, t1=100 * MS, events=events,
                 busy=[(0, 30 * MS), (40 * MS, 65 * MS)], gaps=[])
    steps = [dict(t0=0, t1=100 * MS, lens=[3, 5], images=0, ar_targets=0,
                  traced=True)]
    r = dict(kind="train", config=CFG, steps=steps, trace=trace, spans=[])
    assert read("gemm_device_ms.train", r) == pytest.approx(10.0)
    assert read("elementwise_device_ms.train", r) == pytest.approx(5.0)
    assert read("idle_pct.train", r) == pytest.approx(45.0)
    want = 0.0
    for n in (3, 5):
        for mod, per in ((kernelA, 2), (kernelC, 1), (kernelD, 1)):
            f, b = mod.causal_row(n, 2, 1, 4)
            want += L * per * bound(b, f)["bound_ms"]
    assert read("flash_roofline.train", r) == pytest.approx(
        100 * want / (8 + 4 + 8))
    from benchmark.rooflines.train_step import model_flops
    assert read("train_mfu", r) == pytest.approx(
        100 * model_flops(CFG, [3, 5], 0, 0) / (0.1 * PEAK_BF16_TFLOPS * 1e12))
