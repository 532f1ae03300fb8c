"""PyTorch port, the serving options: the int8 KV cache, prompt-lookup
speculation (`spec_k`) and chunked fill (`fill_chunk`), each held to the
JAX package on the CPU with the same fp32 weights — the model steps
(`decode_chunk_step_batched`, `decode_step_with_chunk`, int8 `prefill` +
`decode_step`, all against JAX's `attn_impl="xla"`), the drafter, and the
whole engine (equal greedy ids, image embeds within 1e-5, the same tick
count and accepted drafts on a model that cycles). Also: the entry points
refuse to fall back to the CPU when no card exists.

Tolerances: hidden states and fp32 cache entries 1e-5 (fp32 on both
sides, two layers, sums in another order). int8 cache entries may differ
by one step on at most 0.1 % of entries (a quotient that lands on a
rounding half in one package and not in the other); their scales are the
amax of K/V entries that the two packages compute to 1e-5, so they are
held to 1e-5 relative (on identical inputs `quantize_kv` agrees to 1e-6,
tests/test_torch_ops.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metamorph_tpu.inference.serve import Request as JRequest
from metamorph_tpu.inference.serve import ServeEngine as JServeEngine
from metamorph_tpu.inference.spec_decode import \
    make_ngram_draft as jax_ngram_draft
from metamorph_tpu.models import llama as JL
from metamorph_tpu.models import metamorph as JM
from metamorph_tpu_torch import convert
from metamorph_tpu_torch.convert import from_jax_params
from metamorph_tpu_torch.inference.serve import Request, ServeEngine
from metamorph_tpu_torch.inference.spec_decode import make_ngram_draft
from metamorph_tpu_torch.models import llama as L
from metamorph_tpu_torch.train import trainer
from tests.test_torch_serve import (CFG, ENGINE, JCFG, _forcing_image_start,
                                    _requests)

H_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def jax_params():
    return JM.init_metamorph_params(jax.random.PRNGKey(7), JCFG,
                                    dtype=jnp.float32)


@pytest.fixture(scope="module")
def pair(jax_params):
    return jax_params, from_jax_params(jax.tree.map(np.asarray, jax_params),
                                       CFG, device="cpu")


def _t(x):
    return torch.from_numpy(np.array(x))


def _assert_caches_match(cache, jcache):
    """Equal caches: fp32 entries and int8 scales within 1e-5; int8 entries
    within one step on at most 0.1 % of entries."""
    assert sorted(cache) == sorted(jcache)
    for name in cache:
        got, ref = cache[name].numpy(), np.asarray(jcache[name])
        if got.dtype == np.int8:
            diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, name
        else:
            np.testing.assert_allclose(got, ref, **H_TOL, err_msg=name)


def _both_caches(jp, quant, B, S, seed):
    """A prefilled cache in both packages: rows of ragged prompt lengths
    (right-padded), so later writes land on stale pad entries."""
    rng = np.random.default_rng(seed)
    T = 12
    ids = rng.integers(10, 1000, (B, T)).astype(np.int32)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T))
    mask = np.ones((B, T), np.int32)
    jcache = JL.init_kv_cache(JCFG.llama, B, S, dtype=jnp.float32,
                              quantized=quant)
    jh, jcache = JL.prefill(jp["llama"], JCFG.llama,
                            JL.embed_tokens(jp["llama"], jnp.asarray(ids)),
                            jnp.asarray(pos), jnp.asarray(mask), jcache)
    return ids, pos, jh, jcache


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_prefill_and_decode_step_match_jax(pair, quant):
    """prefill writes quantized entries for an int8 cache; a ragged decode
    step writes its token's entry and scale and reads them back."""
    jp, model = pair
    B, S = 2, 32
    ids, pos, jh, jcache = _both_caches(jp, quant, B, S, 1)
    cache = L.init_kv_cache(CFG.llama, B, S, dtype=torch.float32,
                            quantized=quant)
    with torch.no_grad():
        h, _ = L.prefill(model.llama, CFG.llama,
                         L.embed_tokens(model.llama, _t(ids)), _t(pos), None,
                         cache)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **H_TOL)
    _assert_caches_match(cache, jcache)
    idx = np.asarray([12, 9], np.int32)
    x_ids = np.asarray([77, 501], np.int32)
    jx = JL.embed_tokens(jp["llama"], jnp.asarray(x_ids))[:, None]
    jh, jcache = JL.decode_step(jp["llama"], JCFG.llama, jx,
                                jnp.asarray(idx)[:, None], jcache,
                                jnp.asarray(idx))
    with torch.no_grad():
        x = L.embed_tokens(model.llama, _t(x_ids))[:, None]
        h, _ = L.decode_step(model.llama, CFG.llama, x, _t(idx)[:, None],
                             cache, _t(idx))
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **H_TOL)
    _assert_caches_match(cache, jcache)


def _port_cache(jcache):
    return {k: _t(v) for k, v in jcache.items()}


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_decode_chunk_step_batched_matches_jax(pair, quant):
    """The verify chunk: each row writes C entries at its own ragged
    write_pos (stale entries past it) and reads keys <= write_pos + c."""
    jp, model = pair
    B, S, C = 3, 40, 4
    ids, pos, _, jcache = _both_caches(jp, quant, B, S, 2)
    cache = _port_cache(jcache)
    rng = np.random.default_rng(3)
    xc = rng.normal(size=(B, C, JCFG.llama.hidden_size)).astype(
        np.float32) * 0.02
    write_pos = np.asarray([12, 5, 30], np.int32)
    rope_pos = write_pos[:, None] + np.arange(C, dtype=np.int32)
    jh, jcache = JL.decode_chunk_step_batched(
        jp["llama"], JCFG.llama, jnp.asarray(xc), jnp.asarray(rope_pos),
        jnp.asarray(write_pos), jnp.zeros((B,), jnp.int32), jcache,
        attn_impl="xla")
    with torch.no_grad():
        h, _ = L.decode_chunk_step_batched(model.llama, CFG.llama, _t(xc),
                                           _t(rope_pos), _t(write_pos), cache)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **H_TOL)
    _assert_caches_match(cache, jcache)


@pytest.mark.parametrize("quant,clen,slot", [(False, 8, 1), (False, 5, 0),
                                             (True, 5, 2)],
                         ids=["fp32-full", "fp32-masked", "int8-masked"])
def test_decode_step_with_chunk_matches_jax(pair, quant, clen, slot):
    """The fused fill step: B decode rows plus one C-token chunk of row
    `slot`, masked past `clen` (masked tokens keep the old entries and
    scales); the fill row's decode write is parked inside the chunk
    region, as the scheduler parks it."""
    jp, model = pair
    B, S, C = 3, 32, 8
    ids, pos, _, jcache = _both_caches(jp, quant, B, S, 4)
    cache = _port_cache(jcache)
    rng = np.random.default_rng(5)
    D = JCFG.llama.hidden_size
    x = rng.normal(size=(B, 1, D)).astype(np.float32) * 0.02
    chunk = rng.normal(size=(C, D)).astype(np.float32) * 0.02
    off = 8
    cache_idx = np.asarray([12, 10, 11], np.int32)
    cache_idx[slot] = off + clen
    chunk_pos = off + np.arange(C, dtype=np.int32)
    chunk_mask = np.arange(C) < clen
    jhd, jhc, jcache = JL.decode_step_with_chunk(
        jp["llama"], JCFG.llama, jnp.asarray(x),
        jnp.asarray(cache_idx)[:, None], jcache, jnp.asarray(cache_idx), jnp.asarray(chunk),
        jnp.asarray(chunk_pos), jnp.asarray(chunk_mask), jnp.int32(slot),
        attn_impl="xla")
    with torch.no_grad():
        hd, hc, _ = L.decode_step_with_chunk(
            model.llama, CFG.llama, _t(x), _t(cache_idx)[:, None], cache,
            _t(cache_idx), _t(chunk), _t(chunk_pos), _t(chunk_mask),
            torch.tensor(slot))
    np.testing.assert_allclose(hd.numpy(), np.asarray(jhd), **H_TOL)
    np.testing.assert_allclose(hc.numpy()[:clen], np.asarray(jhc)[:clen],
                               **H_TOL)
    _assert_caches_match(cache, jcache)


@pytest.mark.parametrize("n_draft", [3, 5])
def test_ngram_draft_matches_jax(n_draft):
    """The vectorised drafter against the JAX one (vmapped) on periodic,
    repeated-phrase and random rows, and on histories shorter than the
    n-gram (where jax.lax.dynamic_slice clamps its start to 0)."""
    rng = np.random.default_rng(n_draft)
    cap = 48
    rows, n_all = [], []
    for kind, n in (("period", 20), ("phrase", 30), ("random", 25),
                    ("short", 1), ("short", 2), ("empty", 0),
                    ("period", 3), ("phrase", 47)):
        ids = np.full((cap,), -1, np.int32)
        if kind == "period":
            ids[:n] = np.tile([5, 6, 7], cap)[:n]
        elif kind == "phrase":
            ids[:n] = np.tile(rng.integers(0, 9, 7), cap)[:n]
            ids[n // 2] = 99
        else:
            ids[:n] = rng.integers(0, 4, n)
        rows.append(ids)
        n_all.append(n)
    ids_all, n_all = np.stack(rows), np.asarray(n_all, np.int32)
    ref = np.asarray(jax.vmap(jax_ngram_draft(n_draft))(
        jnp.asarray(ids_all), jnp.asarray(n_all)))
    got = make_ngram_draft(n_draft)(_t(ids_all), _t(n_all)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert (got >= 0).any()


def _serve_pair(params, kw, reqs=None):
    reqs = _requests() if reqs is None else reqs
    jeng = JServeEngine(params, JCFG, attn_impl="xla", **ENGINE, **kw)
    for r in reqs:
        jeng.submit(JRequest(**r))
    ref = {c.uid: c for c in jeng.run()}
    model = from_jax_params(jax.tree.map(np.asarray, params), CFG,
                            device="cpu")
    eng = ServeEngine(model, CFG, **ENGINE, **kw)
    filled = []
    start_fill = eng._start_fill
    eng._start_fill = lambda slot, req: (filled.append(req.uid),
                                         start_fill(slot, req))
    for r in reqs:
        eng.submit(Request(**r))
    out = {c.uid: c for c in eng.run()}
    assert sorted(map(str, out)) == sorted(map(str, ref))
    for uid, c in ref.items():
        np.testing.assert_array_equal(out[uid].ids, c.ids, err_msg=str(uid))
        assert out[uid].steps == c.steps
        assert out[uid].image_embeds.shape == c.image_embeds.shape
        np.testing.assert_allclose(out[uid].image_embeds, c.image_embeds,
                                   rtol=1e-5, atol=1e-5)
    assert eng.spec_accepted == jeng.spec_accepted
    return ref, eng, filled


def _embeds_requests(params):
    """The text requests pre-fused: [T0, D] prompt embeddings."""
    emb = np.asarray(params["llama"]["embed"]["embedding"])
    return [dict(prompt_embeds=emb[r["prompt_ids"]], uid=r["uid"],
                 max_new_tokens=r["max_new_tokens"])
            for r in _requests() if r["uid"] != "img"]


@pytest.mark.parametrize("variant", [
    "spec_text", "spec_image_generation", "fill", "fill_embeds", "kv_int8",
    "all"])
def test_port_engine_options_match_jax_engine(jax_params, variant):
    kw = {"spec_text": dict(spec_k=4),
          "spec_image_generation": dict(spec_k=4),
          "fill": dict(fill_chunk=4, max_fills=2),
          "fill_embeds": dict(fill_chunk=4, max_fills=2),
          "kv_int8": dict(kv_int8=True),
          "all": dict(spec_k=4, fill_chunk=4, max_fills=2,
                      kv_int8=True)}[variant]
    params = (_forcing_image_start(jax_params)
              if variant == "spec_image_generation" else jax_params)
    reqs = _embeds_requests(params) if variant == "fill_embeds" else None
    ref, eng, filled = _serve_pair(params, kw, reqs)
    if variant == "spec_image_generation":
        assert sum(c.image_embeds.shape[0] for c in ref.values()) > 0
    if "spec_k" in kw:
        assert eng.tick_counts["spec"] > 0
    if variant == "fill_embeds":
        # pre-fused prompts of >= 2 chunks stream through the embeds fill
        assert 1 in filled and eng.tick_counts["fill"] > 0
    elif "fill_chunk" in kw:
        # the image request (11 tokens >= 2 chunks) streams through a fill
        assert "img" in filled and eng.tick_counts["fill"] > 0
    if kw.get("kv_int8"):
        assert eng.state.cache["k"].dtype == torch.int8


def test_port_spec_engine_accepts_like_jax_on_a_periodic_model(jax_params):
    """tests/test_serve_spec.py's forced model whose output cycles 111, 222:
    the port's spec engine takes the same number of scheduler ticks and
    accepts the same number of drafts as the JAX engine, fewer ticks than
    plain decoding, and the same ids."""
    p = jax.tree.map(lambda x: x, jax_params)
    D, V = JCFG.llama.hidden_size, JCFG.llama.vocab_size
    emb = np.asarray(jax_params["llama"]["embed"]["embedding"])
    kernel = np.zeros((D, V), np.float32)
    kernel[:, 111] = emb[222] * 5
    kernel[:, 222] = emb[111] * 5
    p["llama"]["lm_head"]["kernel"] = jnp.asarray(kernel)
    model = from_jax_params(jax.tree.map(np.asarray, p), CFG, device="cpu")
    prompt = np.asarray([111, 222, 111, 222, 111, 222], np.int32)

    def ticks(make, req_cls, spec_k):
        eng = make(spec_k)
        eng.submit(req_cls(prompt_ids=prompt.copy(), max_new_tokens=14,
                           uid="r"))
        t = 0
        while eng.pending or any(u is not None for u in eng.slot_uid):
            eng.step()
            t += 1
        (done,) = eng.completed
        return t, done, eng.spec_accepted

    kw = dict(ENGINE, n_slots=1, steps_per_sync=2)
    port = {k: ticks(lambda s: ServeEngine(model, CFG, spec_k=s, **kw),
                     Request, k) for k in (0, 6)}
    ref = {k: ticks(lambda s: JServeEngine(p, JCFG, spec_k=s,
                                           attn_impl="xla", **kw),
                    JRequest, k) for k in (0, 6)}
    for k in (0, 6):
        assert port[k][0] == ref[k][0], (k, port[k][0], ref[k][0])
        assert port[k][2] == ref[k][2]
        np.testing.assert_array_equal(port[k][1].ids, ref[k][1].ids)
    assert port[6][0] < port[0][0] and port[6][2] > 0


def test_entry_points_need_a_card_unless_told(jax_params, monkeypatch,
                                              tmp_path):
    """Without a CUDA device, train(), init_params and from_jax_params raise
    unless the caller passes device="cpu"; none falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tree = jax.tree.map(np.asarray, jax_params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.init_params(CFG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_jax_params(tree, CFG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trainer.train(CFG, trainer.TrainerArgs(output_dir=str(tmp_path)),
                      iter(()))
    assert not list(tmp_path.iterdir())
    assert convert.init_params(CFG, device="cpu").llama.embed.device.type \
        == "cpu"
