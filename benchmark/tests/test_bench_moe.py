"""The DeepSeek-V3-block serving cell (`kimivl-a3b-chat`) at a tiny size
on the CPU: its driver end to end, judged as a run judges it (a sound run
is correct; a served token altered, decode steps that leave the latent
cache unwritten, or tokens sent to their worst experts, are not; the fp8
control reads above both limits), the
expert counts it attaches to traced ticks, and its per-layer readers on
hand-made records."""

import copy

import numpy as np
import pytest
import torch

from benchmark import spec as spec_lib
from benchmark.drivers.serve_open_loop_moe import attach_routes
from benchmark.rooflines import kernelG, mla_moe, moe_experts
from benchmark.run import compare, make_ctx, run_cell
from benchmark.stats import bound

WORKLOAD = "kimivl-a3b-chat"
INFO = dict(platform="cpu", kind="cpu", count=1)
# The limits at this size, on the CPU (the cell's own are set from
# readings at its full size on the card), with 16 experts of which a
# token takes 6, as the published 64 and 6 weigh each pick. Six seeds (1,
# 2, 3, 7, 2**31 + 11, 2**33 + 5): the sound program's served tokens
# 0.002-0.039 and picks 0.0006-0.0041 below the reference's best, the
# fp8 control's 0.152-0.381 and 0.034-0.113.
TINY_LIMITS = {"logit_gap_max": 0.08, "route_gap_max": 0.015}


def tiny_cell() -> dict:
    cell = spec_lib.cell(spec_lib.load_spec(), WORKLOAD)
    cfg = copy.deepcopy(cell["config"])
    cfg["llama"].update(hidden_size=64, intermediate_size=96, num_layers=3,
                        num_heads=4, num_kv_heads=4, head_dim=24,
                        kv_lora_rank=32, qk_nope_head_dim=16,
                        qk_rope_head_dim=8, v_head_dim=16,
                        n_routed_experts=16, num_experts_per_tok=6,
                        moe_intermediate_size=32, n_shared_experts=1)
    cfg["siglip"].update(image_size=28, patch_size=14, hidden_size=32,
                         intermediate_size=64, num_layers=2, num_heads=4)
    cfg["mm"]["num_image_tokens"] = 4
    mix = copy.deepcopy(cell["traffic"])
    mix["arrivals"]["rate_per_s"] = 10.0
    mix["requests"]["prompt_tokens"].update(median=20, min=8, max=60)
    mix["requests"]["output_tokens"].update(median=8, min=4, max=16)
    mix["engine"].update(n_slots=8, max_cache_len=256, max_new_tokens_cap=32)
    mix.update(tail_seconds=5, drain_cap_seconds=20)
    mix["check"]["requests"] = 4
    cell.update(config=cfg, traffic=mix, limits={"limits": TINY_LIMITS})
    return cell


def tiny_ctx(seed=2 ** 33 + 5):
    torch.set_num_threads(4)
    cell = tiny_cell()
    return make_ctx(torch, torch.device("cpu"), cell, seed, 2.0, False,
                    lambda *a: None), cell


def test_sound_run_is_correct():
    ctx, cell = tiny_ctx()
    line = run_cell(ctx, cell, INFO)
    assert list(line)[-1] == "compared"
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {"ttft_p90_ms", "out_tok_per_s",
                                    "setup_s"}
    assert line["correct"], line["compared"]


def test_altered_token_is_caught(monkeypatch):
    from metamorph_tpu_torch.inference import serve

    real = serve.llama_lib.lm_head
    monkeypatch.setattr(serve.llama_lib, "lm_head",
                        lambda m, c, h: torch.roll(real(m, c, h), 1, -1))
    ctx, cell = tiny_ctx()
    line = run_cell(ctx, cell, INFO)
    assert not line["correct"], line["compared"]


def test_unwritten_latent_cache_is_caught(monkeypatch):
    """Decode steps that read the latent cache but write nothing to it."""
    from metamorph_tpu_torch.models import mla_moe as block

    real = block.decode_step

    def no_write(model, cfg, x, pos, cache, cache_idx, *a):
        return real(model, cfg, x, pos, {"latent": cache["latent"].clone()},
                    cache_idx, *a)

    monkeypatch.setattr(block, "decode_step", no_write)
    ctx, cell = tiny_ctx()
    line = run_cell(ctx, cell, INFO)
    assert not line["correct"], line["compared"]


def test_wrong_picks_are_caught(monkeypatch):
    """A router that sends each token to its k worst experts."""
    from metamorph_tpu_torch.ops import moe

    def worst(x, router, bias, k, scaling, norm=True):
        scores = torch.sigmoid(x.float() @ router.float())
        idx = torch.topk(-(scores + bias.float()), k, dim=-1).indices
        w = scores.gather(1, idx)
        return idx, w / w.sum(dim=-1, keepdim=True) * scaling

    monkeypatch.setattr(moe, "route", worst)
    ctx, cell = tiny_ctx()
    line = run_cell(ctx, cell, INFO)
    assert not line["correct"], line["compared"]
    assert line["compared"]["route_gap_max"]["value"] > 0.1


def test_control_reads_above_the_limits():
    ctx, cell = tiny_ctx()
    res = spec_lib.driver(cell["traffic"]["driver"]).run(ctx)
    r = res["judge"](("fp32", "fp8"))
    assert r["logit_gap_max"] <= TINY_LIMITS["logit_gap_max"]
    assert r["route_gap_max"] <= TINY_LIMITS["route_gap_max"]
    compared = compare({"logit_gap_max": r["control_gap_max_fp8"],
                        "route_gap_max": r["control_route_gap_max_fp8"]},
                       cell["limits"])
    assert all(c["value"] > c["limit"] for c in compared.values()), compared


def test_routes_go_to_the_tick_they_count():
    """The counts a `step()` harvests belong to the tick before it."""
    ticks = [dict(t0=0, t1=10, traced=False), dict(t0=10, t1=20, traced=True),
             dict(t0=20, t1=30, traced=True)]
    a, b = np.ones((1, 1, 2), int), np.full((1, 1, 2), 2)
    attach_routes(ticks, [(1, None), (11, None), (21, a), (31, b)])
    assert "routes" not in ticks[0]
    assert ticks[1]["routes"] == [[[1, 1]]]
    assert ticks[2]["routes"] == [[[2, 2]]]
    attach_routes(ticks[2:], [(21, a)])
    assert ticks[2]["routes"] is None


MS = 1_000_000
LC = dict(hidden_size=8, intermediate_size=16, num_layers=3, num_heads=2,
          num_kv_heads=2, head_dim=6, vocab_size=10, rms_norm_eps=1e-5,
          kv_lora_rank=4, qk_nope_head_dim=4, qk_rope_head_dim=2,
          v_head_dim=4, n_routed_experts=4, num_experts_per_tok=2,
          moe_intermediate_size=4, n_shared_experts=1,
          first_k_dense_replace=1)
CFG = dict(llama=LC, siglip=dict(image_size=28, patch_size=14,
                                 hidden_size=8, intermediate_size=8,
                                 num_layers=1, num_heads=2),
           mm=dict(num_image_tokens=4))
GMM = "cutlass::device_kernel<GemmUniversal<GroupProblemShape<...>>>"


def records():
    # one traced tick: an admission (slot 1, 3 tokens), then one decode
    # step of both rows: kernel G twice (3 layers would be 3; the reader
    # counts the launches' time as it finds it) and 2 grouped products
    ev = [("cudnn_sdpa", 1 * MS, 2 * MS), (GMM, 3 * MS, 1 * MS),
          ("mla_decode_attn_kernel", 5 * MS, 1 * MS), (GMM, 6 * MS, 2 * MS),
          ("mla_decode_attn_kernel", 8 * MS, 1 * MS), (GMM, 9 * MS, 2 * MS)]
    ticks = [dict(t0=0, t1=12 * MS, traced=True, lens0=[5, 0], lens1=[6, 4],
                  steps=1, prefill=1, admitted=[(1, 3, False)],
                  routes=[[[2, 1, 1, 0], [4, 0, 0, 0]]])]
    trace = dict(t0=0, t1=20 * MS, events=ev, busy=[(1 * MS, 11 * MS)],
                 gaps=[])
    return dict(kind="serve", config=CFG, ticks=ticks, spans=[], queue=[],
                gaps=[], trace=trace)


def read(name, r):
    return spec_lib.metric(name).read(r)


def test_moe_readers_by_hand():
    r = records()
    # the decode step: rows at 6 and 4 keys after their writes
    f, b = kernelG.launch([6, 4], 2, 6, 4)
    assert (f, b) == (2 * 2 * 10 * 10, 2 * 6 * 10 + 2 * 2 * 2 * 10)
    assert read("kernelG_roofline", r) == pytest.approx(
        100 * 3 * bound(b, f)["bound_ms"] / 2.0)
    # the products from kernel G's first launch: 4 ms; layer 1 picks 4
    # over 3 experts, layer 2 picks 4 of one expert
    b1 = bound(*reversed(moe_experts.layer(4, 3, 8, 4)))["bound_ms"]
    b2 = bound(*reversed(moe_experts.layer(4, 1, 8, 4)))["bound_ms"]
    assert moe_experts.layer(4, 1, 8, 4) == (2 * 3 * 8 * 4 * 4,
                                             2 * 3 * 8 * 4 + 2 * 4 * 28)
    assert read("moe_roofline", r) == pytest.approx(100 * (b1 + b2) / 4.0)
    # busiest over mean: 2 / 1 and 4 / 1; p90 of the two
    assert read("expert_load_max_mean", r) == pytest.approx(3.8)
    f, b = mla_moe.decode_step(LC, [6, 4], [3, 1])
    fp, bp = mla_moe.prefill(LC, [3])
    want = bound(b, f)["bound_ms"] + bound(bp, fp)["bound_ms"]
    assert read("decode_mfu.moe", r) == pytest.approx(100 * want / 20.0)
    # a dense cell's records give none of them
    dense = dict(r, config=dict(CFG, llama=dict(
        LC, kv_lora_rank=0, n_routed_experts=0)))
    for name in ("kernelG_roofline", "moe_roofline", "decode_mfu.moe"):
        assert read(name, dense) is None
    for name in ("kernelG_roofline", "moe_roofline", "decode_mfu.moe",
                 "expert_load_max_mean"):
        assert read(name, dict(r, trace=None)) is None


def test_step_roofline_counts_by_hand():
    # attention: wq 8x12, wkv_a 8x6, kv_norm 4, wkv_b 4x16, wo 8x8, norms
    attn = 8 * 12 + 8 * 6 + 4 + 4 * 16 + 8 * 8 + 2 * 8
    assert mla_moe.resident_params(LC) == (
        3 * attn + 3 * 8 * 16 + 2 * (3 * 8 * 4 + 8 * 4) + 8 * 10)
    assert mla_moe.active_params(LC) == (mla_moe.resident_params(LC)
                                         + 2 * 2 * 3 * 8 * 4)
