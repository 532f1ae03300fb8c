"""PyTorch port, the DeepSeek-V3 decoder block (multi-head latent
attention over a latent cache, routed experts with a shared expert) on
the serving path, against the benchmark's plain reference
(`benchmark/reference/mla_moe.py`), and the reference against
transformers' `DeepseekV3ForCausalLM`.

A tiny seeded configuration: 3 layers (1 dense, 2 with experts), 8
experts of which each token takes 2, 1 shared expert, a latent of rank 32
with rope 8, nope 16 and v 16, 4 heads; the JAX package has no such
block, so the reference is the yardstick. Everything runs in float32 on
the CPU (the plain versions of kernel G and of the grouped products).
"""

import copy
import types

import numpy as np
import pytest
import torch

from benchmark import weights_mla_moe as wl
from benchmark.reference import mla_moe as ref
from benchmark.reference.serve import gaps
from metamorph_tpu_torch.config import LlamaConfig, MetaMorphConfig
from metamorph_tpu_torch.constants import IM_START_TOKEN_ID
from metamorph_tpu_torch.inference.serve import Request, ServeEngine
from metamorph_tpu_torch.models import llama as llama_lib
from metamorph_tpu_torch.models import mla_moe
from metamorph_tpu_torch.models.metamorph import MetaMorph, encode_images
from metamorph_tpu_torch.ops import moe
from metamorph_tpu_torch.ops.mla_decode import mla_decode_plain

LLAMA = dict(vocab_size=128258, hidden_size=64, intermediate_size=96,
             num_layers=3, num_heads=4, num_kv_heads=4, head_dim=24,
             rope_theta=800000.0, rms_norm_eps=1e-5,
             max_position_embeddings=512, rope_scaling=False,
             tie_word_embeddings=False, kv_lora_rank=32, qk_nope_head_dim=16,
             qk_rope_head_dim=8, v_head_dim=16, n_routed_experts=8,
             num_experts_per_tok=2, moe_intermediate_size=32,
             n_shared_experts=1, first_k_dense_replace=1,
             routed_scaling_factor=2.446, norm_topk_prob=True)
CFG = {"llama": LLAMA,
       "siglip": dict(image_size=28, patch_size=14, hidden_size=32,
                      intermediate_size=64, num_layers=2, num_heads=4,
                      layer_norm_eps=1e-6, select_layer=-1),
       "mm": dict(projector_type="mlp2x_gelu", vision_head_type="mlp",
                  num_image_tokens=4)}
K = CFG["mm"]["num_image_tokens"]
# Port against reference, both float32: the absorbed decode, SDPA's
# blocked softmax and the grouped products sum in other orders than the
# reference's materialised attention and per-expert loop, which moves
# logits of order 1 by ~1e-6; 1e-4 leaves that room and nothing more (a
# wrong cache row or a wrong expert moves them by order 1).
TOL = 1e-4


def _model(seed, cfg=CFG, dtype=torch.float32):
    mcfg = MetaMorphConfig.from_dict(cfg)
    with torch.no_grad():
        model = MetaMorph(mcfg, dtype=dtype, device="cpu")
        wl.fill_model_(model, cfg, seed)
    model.requires_grad_(False)
    return mcfg, model, wl.weights(cfg, seed, "cpu", torch.float32)


@pytest.fixture(scope="module")
def tiny():
    torch.manual_seed(0)
    return _model(11)


def test_layout_covers_the_module_and_the_config_round_trips(tiny):
    mcfg, model, W = tiny
    names = {n for n, _ in model.named_parameters()}
    names |= {n for n, _ in model.named_buffers()}
    assert names == {n for n, _, _ in wl.layout(CFG)}
    assert mcfg.llama.attention_kind == "mla"
    assert [layer.moe for layer in model.llama.layers] == [False, True, True]
    again = MetaMorphConfig.from_dict(mcfg.to_dict())
    assert again == mcfg
    # a grouped-query config's JSON keeps the keys the JAX package reads
    assert "kv_lora_rank" not in MetaMorphConfig.tiny().to_dict()["llama"]


def test_prefill_then_decode_through_the_latent_cache(tiny):
    """The prompt's prefill, then decode steps that each read the latent
    cache, give the logits of the reference's full forward at every
    position."""
    mcfg, model, W = tiny
    lc = mcfg.llama
    gen = torch.Generator().manual_seed(3)
    ids = torch.randint(0, 5000, (21,), generator=gen)
    want = ref.logits(W, LLAMA, ids)
    P = 13
    cache = llama_lib.init_kv_cache(lc, 2, 32, dtype=torch.float32)
    assert set(cache) == {"latent"}
    assert cache["latent"].shape == (3, 2, 32, 32 + 8)
    emb = llama_lib.embed_tokens(model.llama, ids[None, :P])
    # row 1 of the cache: the rows are addressed, not assumed
    h, _ = llama_lib.prefill(model.llama, lc, emb,
                             torch.arange(P)[None], None, cache,
                             rows=torch.tensor([1]))
    got = [llama_lib.lm_head(model.llama, lc, h[0])]
    assert not cache["latent"][:, 0].any()
    for t in range(P, 21):
        x = llama_lib.embed_tokens(model.llama, ids[t:t + 1]).expand(
            2, 1, -1).contiguous()
        idx = torch.tensor([0, t])
        h, _ = llama_lib.decode_step(model.llama, lc, x, idx[:, None], cache,
                                     idx)
        got.append(llama_lib.lm_head(model.llama, lc, h[1]))
    got = torch.cat(got)
    torch.testing.assert_close(got, want, atol=TOL, rtol=0)


def test_absorbed_decode_equals_expanded_attention(tiny):
    """Kernel G's plain form over the latent rows, with W_UK folded into
    the query and W_UV applied after, gives the expanded attention's last
    position (1e-5: float32, the same products summed in another
    order)."""
    mcfg, model, _ = tiny
    lc = mcfg.llama
    layer = model.llama.layers[1]
    gen = torch.Generator().manual_seed(5)
    T = 9
    h = torch.randn(1, T, 64, generator=gen)
    cos, sin = mla_moe.rope_tables(lc, torch.arange(T)[None])
    q, rows = mla_moe._latent(layer, lc, h, cos, sin)
    want = mla_moe._attn_expanded(layer, lc, q, rows)[0, -1]
    up = mla_moe._up(layer, lc)
    q_abs = torch.einsum("hn,rhn->hr", q[0, -1, :, :16], up[..., :16])
    qg = torch.cat([q_abs, q[0, -1, :, 16:]], -1)[None]
    o = mla_decode_plain(qg, rows, torch.tensor([T]), 32,
                         mla_moe._scale(lc))
    got = torch.einsum("hr,rhv->hv", o[0], up[..., 16:]).reshape(-1)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("case", ["random", "one_takes_all_one_none"])
def test_grouped_experts_equal_the_per_expert_loop(tiny, case):
    """The grouped layer (`ops/moe.py`, inside `mla_moe._ffn`) against the
    reference's loop over experts; with the correction bias set so that
    every token picks expert 3 and none picks expert 5."""
    mcfg, model, W = tiny
    layer = copy.deepcopy(model.llama.layers[2])
    w = ref.layer_weights(W, 2)
    if case != "random":
        bias = torch.zeros(8)
        bias[3], bias[5] = 10.0, -10.0
        layer.e_score_bias.copy_(bias)
        w["e_score_bias"] = bias
    gen = torch.Generator().manual_seed(9)
    h = torch.randn(2, 7, 64, generator=gen)
    idx, _ = moe.route(h.reshape(-1, 64), layer.router, layer.e_score_bias,
                       2, 2.446)
    counts = moe.expert_counts(idx, 8)
    if case != "random":
        assert counts[3] == 14 and counts[5] == 0
    assert int(counts.sum()) == 28
    got = mla_moe._ffn(layer, mcfg.llama, h)
    want = ref.moe(h.reshape(-1, 64), w, LLAMA).view(2, 7, 64)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


def test_routing_picks_on_biased_scores_and_weights_unbiased():
    """Top-k on sigmoid scores plus the bias; the weights are the picked
    experts' unbiased scores, normalised, times the scaling factor."""
    D, E = 4, 6
    router = torch.zeros(D, E)
    x = torch.zeros(1, D)
    x[0, 0] = 1.0
    router[0] = torch.tensor([2.0, 1.0, 0.0, -1.0, -2.0, 3.0])
    bias = torch.tensor([0.0, 0.0, 5.0, 0.0, 0.0, -5.0])
    idx, w = moe.route(x, router, bias, 2, 2.0)
    assert sorted(idx[0].tolist()) == [0, 2]      # 5 loses to its bias
    s = torch.sigmoid(router[0])
    pick = s[idx[0]]
    torch.testing.assert_close(w[0], pick / pick.sum() * 2.0)
    rows = torch.tensor([False])
    assert int(moe.expert_counts(idx, E, rows).sum()) == 0


def _requests(model, mcfg):
    gen = torch.Generator().manual_seed(21)
    px = torch.rand((1, 28, 28, 3), generator=gen) * 2 - 1
    with torch.no_grad():
        img = encode_images(model, mcfg, px)[0]
    prompts = [torch.randint(0, 5000, (n,), generator=gen).numpy()
               .astype(np.int32) for n in (7, 14, 12)]
    reqs = [Request(prompt_ids=prompts[0], max_new_tokens=9, uid="a"),
            Request(prompt_ids=prompts[1], max_new_tokens=11, uid="b"),
            Request(prompt_ids=prompts[2], max_new_tokens=10, uid="img",
                    image_embeds=img.numpy(),
                    image_positions=np.array([2], np.int32))]
    return reqs, prompts, px


def _stand_in_capture(eng):
    """A CPU stand-in for the CUDA graph: each replay re-runs the captured
    tick after checking that the state still holds its static buffers."""
    from metamorph_tpu_torch.inference import serve as S

    def capture(fn):
        bufs = {f: getattr(eng.state, f) for f in S._PLAIN_TICK_FIELDS}
        counts = eng.state.route_counts

        log = eng.state.route_log

        class Rerun:
            def replay(self):
                assert all(getattr(eng.state, f) is b
                           for f, b in bufs.items())
                assert eng.state.route_counts is counts
                assert eng.state.route_log is log
                fn()

        return Rerun()

    return capture


ENGINE = dict(n_slots=4, max_cache_len=64, max_new_tokens_cap=12,
              prefill_buckets=(16, 32), steps_per_sync=4)


@pytest.mark.parametrize("graphed", [False, True])
def test_engine_serves_text_and_images_as_the_reference(tiny, graphed):
    """`ServeEngine` admits text and image requests (the splice on the
    device), decodes them over the latent cache in plain ticks (eager, or
    through the capture seam), and every served token is the reference's
    best at its position; each tick's expert counts cover the active
    rows."""
    mcfg, model, W = tiny
    reqs, prompts, px = _requests(model, mcfg)
    eng = ServeEngine(model, mcfg, **ENGINE)
    eng.log_routes()
    if graphed:
        eng._capture = _stand_in_capture(eng)
    for r in reqs:
        eng.submit(r)
    routes = []
    while eng.pending or any(u is not None for u in eng.slot_uid):
        eng.step()
        if eng.routes is not None:
            routes.append(eng.routes)
    done = {c.uid: c for c in eng.completed}
    assert sorted(done) == ["a", "b", "img"]
    if graphed:
        assert eng.tick_counts["plain_graphed"] > 0
    checked = []
    for r, p in zip(reqs, prompts):
        served = [int(t) for t in done[r.uid].ids]
        if IM_START_TOKEN_ID in served:
            served = served[:served.index(IM_START_TOKEN_ID) + 1]
        c = done[r.uid]
        assert c.routes.shape == (len(p) + c.steps, 2, 2)
        checked.append(dict(prompt_ids=p, served=served,
                            image_at=2 if r.uid == "img" else None,
                            pixels=px if r.uid == "img" else None,
                            routes=c.routes))
    seen = [[] for _ in checked]
    lg = ref.served_logits(W, CFG, checked, seen=seen)
    assert max(gaps(lg, [c["served"] for c in checked])) <= TOL
    # the logged picks are the reference's own (float32 on both sides)
    for c, s in zip(checked, seen):
        T = len(c["prompt_ids"]) + len(c["served"]) - 1
        for m, (choice, _) in enumerate(s):
            picks = torch.as_tensor(c["routes"][:T, m])
            assert ref.route_gap(choice, picks) <= 1e-6
    assert routes and all(r.shape[1:] == (2, 8) for r in routes)
    per = np.concatenate(routes).sum(-1)          # [steps, layers]
    assert (per % 2 == 0).all() and per.max() == 3 * 2
    assert (per[:, 0] == per[:, 1]).all()


def test_graphed_and_eager_engines_serve_the_same_ids(tiny):
    mcfg, model, _ = tiny
    out = []
    for graphed in (False, True):
        reqs, _, _ = _requests(model, mcfg)
        eng = ServeEngine(model, mcfg, **ENGINE)
        if graphed:
            eng._capture = _stand_in_capture(eng)
        for r in reqs:
            eng.submit(r)
        out.append({c.uid: c.ids.tolist() for c in eng.run()})
    assert out[0] == out[1]


def _refusals(mcfg, model, tmp_path):
    from metamorph_tpu_torch.models.lora import add_lora
    from metamorph_tpu_torch.ops.quant import quantize_llama_decode
    from metamorph_tpu_torch.parallel.sharding import apply_tensor_parallel
    from metamorph_tpu_torch.train.train_step import (accum_train_step,
                                                      train_step)
    from metamorph_tpu_torch.train.trainer import TrainerArgs, train

    mesh = types.SimpleNamespace(mesh_dim_names=("data", "fsdp", "tensor"),
                                 mesh=types.SimpleNamespace(shape=(1, 1, 2)))
    lora_cfg = LlamaConfig(**dict(LLAMA, lora_r=4))
    return {
        "spec": lambda: ServeEngine(model, mcfg, spec_k=4),
        "draft": lambda: ServeEngine(model, mcfg, spec_k=2,
                                     draft=(model.llama, mcfg.llama)),
        "fill": lambda: ServeEngine(model, mcfg, fill_chunk=16),
        "kv_int8": lambda: ServeEngine(model, mcfg, kv_int8=True),
        "prefix": lambda: ServeEngine(model, mcfg,
                                      shared_prefix_ids=[1, 2, 3]),
        "int8_weights": lambda: quantize_llama_decode(model.llama),
        "int8_cache": lambda: llama_lib.init_kv_cache(mcfg.llama, 1, 8,
                                                      quantized=True),
        "tensor_parallel": lambda: apply_tensor_parallel(model, mesh),
        "lora": lambda: add_lora(model.llama, 4),
        "lora_config": lambda: llama_lib.Llama(lora_cfg, device="meta"),
        "train": lambda: train(mcfg, TrainerArgs(output_dir=str(tmp_path)),
                               iter(()), device="cpu"),
        "train_step": lambda: train_step({}, {}, None, mcfg, None),
        "accum_train_step": lambda: accum_train_step({}, {}, None, mcfg,
                                                     None),
        "training_forward": lambda: llama_lib.llama_forward(
            model.llama, mcfg.llama, torch.zeros(1, 2, 64),
            torch.arange(2)[None], None),
    }


REFUSED = ("spec", "draft", "fill", "kv_int8", "prefix", "int8_weights",
           "int8_cache", "tensor_parallel", "lora", "lora_config", "train",
           "train_step", "accum_train_step", "training_forward")


@pytest.mark.parametrize("option", REFUSED)
def test_unported_options_are_refused_by_attention_kind(tiny, option,
                                                       tmp_path):
    mcfg, model, _ = tiny
    with pytest.raises(ValueError, match="attention kind 'mla'"):
        _refusals(mcfg, model, tmp_path)[option]()


def test_experts_need_latent_attention():
    with pytest.raises(ValueError, match="latent attention"):
        llama_lib.Llama(LlamaConfig(n_routed_experts=4,
                                    num_experts_per_tok=2), device="meta")


def test_reference_matches_transformers_deepseek_v3():
    """The reference against the published code at the tiny size, weights
    mapped, a nonzero correction bias: float32 on both sides, so only the
    order of sums differs (1e-4 of the logits' scale, relative)."""
    tf = pytest.importorskip("transformers")
    cfg = copy.deepcopy(CFG)
    lc = cfg["llama"]
    lc["vocab_size"] = 512
    W = wl.weights(cfg, 17, "cpu", torch.float32)
    gen = torch.Generator().manual_seed(4)
    for l in (1, 2):
        W[f"llama.layers.{l}.e_score_bias"] = torch.randn(8, generator=gen)
    hc = tf.DeepseekV3Config(
        vocab_size=512, hidden_size=64, intermediate_size=96,
        moe_intermediate_size=32, num_hidden_layers=3,
        num_attention_heads=4, num_key_value_heads=4, n_shared_experts=1,
        n_routed_experts=8, routed_scaling_factor=2.446, kv_lora_rank=32,
        q_lora_rank=None, qk_rope_head_dim=8, v_head_dim=16,
        qk_nope_head_dim=16, n_group=1, topk_group=1, num_experts_per_tok=2,
        first_k_dense_replace=1, norm_topk_prob=True, rope_theta=800000.0,
        rope_scaling=None, rms_norm_eps=1e-5, tie_word_embeddings=False,
        attention_bias=False, max_position_embeddings=512)
    hc._attn_implementation = "eager"
    hf = tf.DeepseekV3ForCausalLM(hc).eval()
    sd = {"model.embed_tokens.weight": W["llama.embed"],
          "model.norm.weight": W["llama.final_norm"],
          "lm_head.weight": W["llama.lm_head"].T}
    names = {"wq": "self_attn.q_proj", "wkv_a": "self_attn.kv_a_proj_with_mqa",
             "wkv_b": "self_attn.kv_b_proj", "wo": "self_attn.o_proj"}
    for l in range(3):
        p, q = f"llama.layers.{l}.", f"model.layers.{l}."
        for a, b in names.items():
            sd[q + b + ".weight"] = W[p + a].T
        sd[q + "self_attn.kv_a_layernorm.weight"] = W[p + "kv_norm"]
        sd[q + "input_layernorm.weight"] = W[p + "input_norm"]
        sd[q + "post_attention_layernorm.weight"] = W[p + "post_attn_norm"]
        mlp = q + ("mlp.shared_experts." if l else "mlp.")
        for a in ("gate", "up", "down"):
            sd[mlp + f"{a}_proj.weight"] = W[p + f"w_{a}"].T
        if l:
            sd[q + "mlp.gate.weight"] = W[p + "router"].T
            sd[q + "mlp.gate.e_score_correction_bias"] = W[p + "e_score_bias"]
            for e in range(8):
                for a in ("gate", "up", "down"):
                    sd[q + f"mlp.experts.{e}.{a}_proj.weight"] = \
                        W[p + f"experts_{a}"][e].T
    missing, unexpected = hf.load_state_dict(
        {k: v.contiguous() for k, v in sd.items()}, strict=False)
    assert not unexpected and not [m for m in missing if "rotary" not in m]
    ids = torch.randint(0, 512, (19,), generator=gen)
    with torch.no_grad():
        want = hf(ids[None]).logits[0].float()
    got = ref.logits(W, lc, ids)
    scale = want.abs().max()
    assert float((got - want).abs().max() / scale) <= 1e-4
