"""PyTorch port, weight-only int8 (`ops/quant.py`, kernel F's plain version
on the CPU), held to the JAX package's `metamorph_tpu/ops/quant.py` with
inputs made by numpy from a seed (mirrors tests/test_quant.py).

Tolerances: int8 values and scales BITWISE (the same fp32 amax, division
and round-half-to-even on both sides); `quantized_matmul` 1e-5 (fp32 sums
in another order); `decode_step` on int8 weights 1e-4 (two layers of fp32
products in another order, as JAX's own quantized-vs-dequantized test
holds it); greedy and engine ids EQUAL; the quantized tree through
`convert` both ways bitwise."""

import ctypes
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metamorph_tpu.config import LlamaConfig as JLlamaConfig
from metamorph_tpu.config import MetaMorphConfig as JConfig
from metamorph_tpu.config import MultimodalConfig as JMM
from metamorph_tpu.config import SiglipConfig as JSiglipConfig
from metamorph_tpu.config import TrainConfig as JTrainConfig
from metamorph_tpu.inference import decode as jdecode
from metamorph_tpu.inference.serve import Request as JRequest
from metamorph_tpu.inference.serve import ServeEngine as JServeEngine
from metamorph_tpu.models import llama as JL
from metamorph_tpu.models import metamorph as JM
from metamorph_tpu.ops import quant as JQ
from metamorph_tpu_torch.config import MetaMorphConfig
from metamorph_tpu_torch.convert import from_jax_params, to_jax_params
from metamorph_tpu_torch.inference import decode
from metamorph_tpu_torch.inference.serve import Request, ServeEngine
from metamorph_tpu_torch.models import llama as L
from metamorph_tpu_torch.models.lora import add_lora
from metamorph_tpu_torch.ops import quant as Q

JCFG = JConfig(llama=JLlamaConfig.tiny(vocab_size=128258),
               siglip=JSiglipConfig.tiny(), mm=JMM(num_image_tokens=3),
               train=JTrainConfig(max_seq_len=64))
CFG = MetaMorphConfig.from_dict(JCFG.to_dict())
NAMES = (("attn", ("wq", "wk", "wv", "wo")),
         ("mlp", ("w_gate", "w_up", "w_down")))


@pytest.fixture(autouse=True)
def _full_fp32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.fixture(scope="module")
def jax_params():
    return JM.init_metamorph_params(jax.random.PRNGKey(7), JCFG,
                                    dtype=jnp.float32)


@pytest.fixture(scope="module")
def pair(jax_params):
    """JAX's quantized tree, and the port's model quantized by the port."""
    qj = dict(jax_params)
    qj["llama"] = JQ.quantize_llama_decode(jax_params["llama"])
    model = from_jax_params(jax.tree.map(np.asarray, jax_params), CFG,
                            device="cpu")
    model.llama = Q.quantize_llama_decode(model.llama)
    return qj, model


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("shape,dtype", [((32, 48), "float32"),
                                         ((64, 256), "float32"),
                                         ((128, 40), "float32"),
                                         ((64, 96), "bfloat16")])
def test_quantize_weight_is_bitwise_jax(shape, dtype):
    rng = np.random.default_rng(0)
    w = jnp.asarray(rng.normal(size=shape).astype(np.float32) * 0.05
                    ).astype(dtype)
    ref = JQ.quantize_weight(w)
    got = Q.quantize_weight(_t(w.astype(jnp.float32)).to(getattr(torch,
                                                                  dtype)))
    assert got.q.dtype == torch.int8 and got.q.shape == shape[::-1]
    np.testing.assert_array_equal(got.q.t().numpy(), np.asarray(ref["int8_q"]))
    np.testing.assert_array_equal(got.scale.numpy(),
                                  np.asarray(ref["scale"])[0])
    assert got.shape == shape
    assert list(got.parameters()) == [] and len(list(got.buffers())) == 2


def test_dequantize_error_bound():
    """Symmetric int8: at most half a quantization step per channel."""
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.normal(size=(32, 48)).astype(np.float32))
    wq = Q.quantize_weight(w)
    back = Q.dequantize_weight(wq, torch.float32)
    assert Q.is_quantized(wq) and not Q.is_quantized(w)
    assert torch.all((back - w).abs() <= wq.scale / 2 + 1e-7)


@pytest.mark.parametrize("lead", [(5,), (2, 3)])
def test_quantized_matmul_matches_jax(lead):
    rng = np.random.default_rng(1)
    x = rng.normal(size=lead + (32,)).astype(np.float32)
    w = rng.normal(size=(32, 48)).astype(np.float32)
    ref = JQ.quantized_matmul(jnp.asarray(x), JQ.quantize_weight(
        jnp.asarray(w)))
    got = Q.quantized_matmul(_t(x), Q.quantize_weight(_t(w)))
    assert got.dtype == torch.float32 and got.shape == lead + (48,)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def _int8_leaves(tree):
    """(path, int8_q, scale) of every int8 leaf of a LLaMA tree."""
    out = [(f"{sub}/{n}", tree["layers"][sub][n]) for sub, ns in NAMES
           for n in ns]
    out.append(("lm_head", tree["lm_head"]["kernel"]))
    return [(p, np.asarray(v["int8_q"]), np.asarray(v["scale"]))
            for p, v in out]


def test_quantize_llama_decode_tree_through_convert(jax_params, pair):
    """The port's `quantize_llama_decode` gives JAX's int8 tree bit for
    bit; JAX's tree carried into the port and back is unchanged; the
    embedding and norms are shared with the bf16 model, not copied."""
    qj, model = pair
    ref = _int8_leaves(qj["llama"])
    for (p, q, s), (_, rq, rs) in zip(_int8_leaves(
            to_jax_params(model)["llama"]), ref):
        assert q.dtype == np.int8 and s.dtype == np.float32, p
        np.testing.assert_array_equal(q, rq, err_msg=p)
        np.testing.assert_array_equal(s, rs, err_msg=p)
    carried = from_jax_params(jax.tree.map(np.asarray, qj), CFG,
                              device="cpu")
    assert isinstance(carried.llama.layers[1].w_up, Q.QuantizedWeight)
    for (p, q, s), (_, rq, rs) in zip(_int8_leaves(
            to_jax_params(carried)["llama"]), ref):
        np.testing.assert_array_equal(q, rq, err_msg=p)
        np.testing.assert_array_equal(s, rs, err_msg=p)
    bf = from_jax_params(jax.tree.map(np.asarray, jax_params), CFG,
                         device="cpu")
    ql = Q.quantize_llama_decode(bf.llama)
    assert ql.embed is bf.llama.embed
    assert ql.layers[0].input_norm is bf.llama.layers[0].input_norm
    assert all(p.dtype == torch.float32 for p in ql.parameters())
    assert not any(p.device.type == "meta" for p in ql.parameters())


def test_quantize_llama_decode_consume_gives_the_same_int8(jax_params,
                                                          pair):
    """With `consume=True` the int8 model is the same bit for bit, and the
    source gives up its decoder linears and head (the CLIs' load); the
    embedding and norms are shared as before."""
    _, model = pair
    bf = from_jax_params(jax.tree.map(np.asarray, jax_params), CFG,
                         device="cpu")
    src = bf.llama
    bf.llama = Q.quantize_llama_decode(src, consume=True)
    for (p, q, s), (_, rq, rs) in zip(
            _int8_leaves(to_jax_params(bf)["llama"]),
            _int8_leaves(to_jax_params(model)["llama"])):
        np.testing.assert_array_equal(q, rq, err_msg=p)
        np.testing.assert_array_equal(s, rs, err_msg=p)
    assert src.lm_head is None
    assert all(getattr(layer, n) is None for layer in src.layers
               for n in Q._DECODE_QUANT_NAMES)
    assert bf.llama.embed is src.embed
    assert bf.llama.layers[1].post_attn_norm is src.layers[1].post_attn_norm


def test_decode_step_and_lm_head_on_int8_match_jax(pair):
    qj, model = pair
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 1, CFG.llama.hidden_size)).astype(np.float32)
    idx = np.asarray([3, 5], np.int32)
    jcache = JL.init_kv_cache(JCFG.llama, 2, 16, jnp.float32)
    jh, _ = JL.decode_step(qj["llama"], JCFG.llama, jnp.asarray(x),
                           jnp.asarray(idx)[:, None], jcache,
                           jnp.asarray(idx))
    cache = L.init_kv_cache(CFG.llama, 2, 16, dtype=torch.float32)
    with torch.no_grad():
        h, _ = L.decode_step(model.llama, CFG.llama, _t(x), _t(idx)[:, None],
                             cache, _t(idx))
        logits = L.lm_head(model.llama, CFG.llama, h)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-4,
                               atol=1e-4)
    jlogits = JL.lm_head(qj["llama"], JCFG.llama, jh)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-4)


def test_greedy_decode_on_int8_matches_jax(pair):
    qj, model = pair
    rng = np.random.default_rng(0)
    ids = rng.integers(10, 1000, (1, 6)).astype(np.int32)
    ref = jdecode.greedy_decode(qj, JCFG, JL.embed_tokens(
        qj["llama"], jnp.asarray(ids)), max_new_tokens=8, max_images=2)
    out = decode.greedy_decode(model, CFG, L.embed_tokens(
        model.llama, _t(ids)), max_new_tokens=8, max_images=2)
    n = int(ref["n_ids"])
    assert int(out["n_ids"]) == n and n >= 1
    np.testing.assert_array_equal(out["ids"][:n].numpy(),
                                  np.asarray(ref["ids"][:n]))


def test_engine_on_int8_matches_single_request_and_jax(pair):
    """Continuous batching over int8 weights: each request's ids equal the
    port's single-request decode on the same weights, and JAX's engine."""
    qj, model = pair
    rng = np.random.default_rng(3)
    reqs = [dict(prompt_ids=rng.integers(10, 1000, (t,)).astype(np.int32),
                 max_new_tokens=b, uid=i)
            for i, (t, b) in enumerate([(5, 6), (9, 7), (4, 8)])]
    kw = dict(n_slots=2, max_cache_len=32, max_new_tokens_cap=8,
              max_images=1, prefill_buckets=(8, 16), steps_per_sync=2)
    eng = ServeEngine(model, CFG, **kw)
    jeng = JServeEngine(qj, JCFG, attn_impl="xla", **kw)
    for r in reqs:
        eng.submit(Request(**r))
        jeng.submit(JRequest(**r))
    done = {c.uid: c for c in eng.run()}
    jdone = {c.uid: c for c in jeng.run()}
    for r in reqs:
        ref = decode.greedy_decode(model, CFG, L.embed_tokens(
            model.llama, _t(r["prompt_ids"])[None]),
            max_new_tokens=r["max_new_tokens"], max_images=1)
        n = int(ref["n_ids"])
        np.testing.assert_array_equal(done[r["uid"]].ids,
                                      ref["ids"][:n].numpy())
        np.testing.assert_array_equal(done[r["uid"]].ids,
                                      jdone[r["uid"]].ids)


def test_lora_applies_on_top_of_a_quantized_dense(jax_params):
    """A layer with LoRA factors, quantized: the factors stay (the same
    tensors) and add on top of the int8 product, as JAX's `_lora_dense`
    does on its quantized tree."""
    import dataclasses

    lcfg = dataclasses.replace(CFG.llama, lora_r=4, lora_alpha=8)
    jlcfg = dataclasses.replace(JCFG.llama, lora_r=4, lora_alpha=8)
    model = from_jax_params(jax.tree.map(np.asarray, jax_params), CFG,
                            device="cpu")
    add_lora(model.llama, 4, seed=1)
    rng = np.random.default_rng(4)
    with torch.no_grad():
        for layer in model.llama.layers:
            layer.wq_lora_b.copy_(torch.from_numpy(rng.normal(
                size=tuple(layer.wq_lora_b.shape)).astype(np.float32)))
    tree = to_jax_params(model)["llama"]
    qtree = JQ.quantize_llama_decode(jax.tree.map(jnp.asarray, tree))
    ql = Q.quantize_llama_decode(model.llama)
    assert ql.layers[0].wq_lora_a is model.llama.layers[0].wq_lora_a
    x = rng.normal(size=(3, CFG.llama.hidden_size)).astype(np.float32)
    jlayer = jax.tree.map(lambda a: a[0], qtree["layers"]["attn"])
    ref = JL._lora_dense(jlayer, "wq", jnp.asarray(x), jlcfg)
    with torch.no_grad():
        got = L._dense(ql.layers[0], "wq", _t(x), lcfg)
        plain = L._dense(ql.layers[0], "wq", _t(x), CFG.llama)  # lora off
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    assert (got - plain).abs().max() > 1e-3


# ---- kernel F's planner: launch arguments worked out on the host ------------

PLAN_SHAPES = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096),
               (4096, 128256), (4144, 1000), (4096, 14344), (64, 48)]


@pytest.mark.parametrize("K,N", PLAN_SHAPES)
@pytest.mark.parametrize("sms,res", [(132, 3), (132, 2), (114, 1), (1, 1)])
def test_gemv_schedule_covers_every_unit_once(K, N, sms, res):
    """The gemv grid's runs cover every (channel tile, k block) unit once,
    in runs of equal length to within one unit; each tile's segments come
    from consecutive CTAs, in order, and are the ones the kernel finds by
    its own arithmetic (the first and last CTA of a tile, each CTA's
    partial slot), with no two partials of shared tiles in one slot."""
    ctas = Q.gemv_ctas(K, N, sms, sms * res)
    assert 1 <= ctas <= sms * min(res, Q.GEMV_CTAS_PER_SM)
    kb, tiles = math.ceil(K / Q.GEMV_BK), math.ceil(N / Q.GEMV_BN)
    units = kb * tiles
    segs = list(Q.gemv_segments(K, N, ctas))
    by_tile = {}
    for c, t, lo, hi, slot in segs:
        by_tile.setdefault(t, []).append((c, lo, hi, slot))
    assert sorted(by_tile) == list(range(tiles))
    shared_slots = []
    for t, parts in by_tile.items():
        assert [p[1] for p in parts] == [0] + [p[2] for p in parts[:-1]]
        assert parts[-1][2] == kb and all(p[1] < p[2] for p in parts)
        cs = [p[0] for p in parts]
        assert cs == list(range(cs[0], cs[-1] + 1))
        first = ((t * kb + 1) * ctas - 1) // units
        last = ((t + 1) * kb * ctas - 1) // units
        assert (first, last) == (cs[0], cs[-1])
        if len(parts) > 1:
            shared_slots += [(c, slot) for c, _, _, slot in parts]
    assert len(set(shared_slots)) == len(shared_slots)
    per_cta = [0] * ctas
    for c, _, lo, hi, _ in segs:
        per_cta[c] += hi - lo
    assert sum(per_cta) == units
    assert max(per_cta) - min(per_cta) <= 1
    assert min(per_cta) >= min(units, Q.GEMV_MIN_UNITS)


def _fake_card(monkeypatch, sms=132):
    """_plan on the CPU: a card of `sms` SMs whose gemv kernel holds 3, 2,
    2, 1 CTAs per SM at 1, 2, 4, 8 n8 tiles and whose tiled kernel holds
    sms / 2 clusters of two, and a descriptor buffer that is never read."""
    calls = []

    def resident(index, form, ng):
        calls.append((index, form, ng))
        return sms * {1: 3, 2: 2, 4: 2, 8: 1}[ng] if form == 0 else sms

    monkeypatch.setattr(Q, "_sm_count", lambda index: sms)
    monkeypatch.setattr(Q, "_resident", resident)
    monkeypatch.setattr(Q, "_qmap",
                        lambda q, form: ctypes.create_string_buffer(128))
    monkeypatch.setattr(Q, "_SCRATCH", {})
    return calls


@pytest.mark.parametrize("N", [1024, 14336, 1000])
def test_kernel_f_grid_depends_on_shape_and_card_only(monkeypatch, N):
    """The planned grid is a function of (K, N, SMs, residency): every row
    count of one gemv bucket gets the same grid, the tiled form one wave
    of two-CTA clusters over pairs of its 128 x 256 tiles, and the form
    switches at GEMV_MAX_M."""
    _fake_card(monkeypatch)
    K = 512
    w = Q.quantize_weight(torch.randn(K, N, generator=torch.Generator(
        ).manual_seed(0)))
    dev = torch.device("cpu")
    for M in (1, 5, 8, 9, 16, 17, 32, 33, 64, 264, 4096):
        (_, _), (m, n, k, form, ctas, ws, ctr), tag, buf = Q._plan(
            w, M, K, dev)
        assert (m, n, k) == (M, N, K) and len(buf) == 128
        if M <= Q.GEMV_MAX_M:
            ng = Q.gemv_ng(M)
            assert (form, tag) == (0, "gemv") and ng * 8 >= M
            assert ctas == Q.gemv_ctas(K, N, 132,
                                       132 * {1: 3, 2: 2, 4: 2, 8: 1}[ng])
            assert ctas <= 132 * Q.GEMV_CTAS_PER_SM
            assert ws is not None and ctr is not None
        else:
            pairs = math.ceil(M / Q.TILED_BM) * math.ceil(
                math.ceil(N / Q.TILED_BN) / 2)
            assert (form, tag) == (1, "tiled")
            assert ctas == 2 * min(pairs, 66) and ws is None and ctr is None
    # one scratch per size: the rows of a bucket share it
    assert len(Q._SCRATCH) == 4


def test_kernel_f_plans_kept_per_rows_depth_device_storage(monkeypatch):
    """A plan is made once per (rows, depth, device, storage) of a weight,
    and the card's residency is queried once per (card, form, bucket): a
    weight whose buffers are replaced is planned again against the new
    storage."""
    calls = _fake_card(monkeypatch)
    monkeypatch.setattr(Q, "_resident", functools.lru_cache(None)(
        Q._resident))
    w = Q.quantize_weight(torch.randn(256, 384))
    dev = torch.device("cpu")
    for M in (8, 300, 8, 7, 300):
        key = (M, 256, None, w.q.data_ptr(), w.scale.data_ptr())
        if key not in w.plans:
            Q._plan(w, M, 256, dev)
    assert sorted(k[0] for k in w.plans) == [7, 8, 300]
    assert calls == [(None, 0, 1), (None, 1, 0)]
    w.q = w.q.clone()
    Q._plan(w, 8, 256, dev)
    assert len(w.plans) == 4
    assert len({k[3] for k in w.plans}) == 2


@pytest.mark.parametrize("K,N,ctas", [(4096, 4096, 128), (14336, 4096, 128),
                                      (4096, 1024, 128), (4096, 14336, 132)])
def test_gemv_grid_prefers_runs_that_fit_tiles(K, N, ctas):
    """On a 132-SM card the gemv grid takes 128 CTAs where 128 splits every
    tile's units evenly (wq / wo, down, wk / wv at 8B width), and the whole
    wave where no grid within 7/8 of it does (gate / up); either way every
    CTA's run lies in one tile or covers whole tiles when it can."""
    assert Q.gemv_ctas(K, N, 132, 396) == ctas
    kb = math.ceil(K / Q.GEMV_BK)
    segs = list(Q.gemv_segments(K, N, ctas))
    if ctas == 128:
        assert all(hi - lo == segs[0][3] - segs[0][2] for _, _, lo, hi, _
                   in segs) and len(segs) == ctas
        assert kb % (segs[0][3] - segs[0][2]) == 0
