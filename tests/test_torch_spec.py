"""PyTorch port, speculative decode (`inference/spec_decode.py`,
`llama.decode_chunk_step`) and draft-model serving
(`ServeEngine(draft=...)`), held to the JAX package on the CPU with the
same fp32 weights (tiny LLaMA + SigLIP, K=3; tiny fp32 drafters whose JAX
trees cross over through `convert.llama_from_jax_params`).

Greedy ids, step counts and chunk-step counts ("iters") must EQUAL JAX's,
and the ids the port's own `greedy_decode` gives; image embeddings within
1e-5. The model step `decode_chunk_step` is held at 1e-5 (fp32 hiddens and
cache entries, sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metamorph_tpu.config import LlamaConfig as JLlamaConfig
from metamorph_tpu.inference import decode as jdecode
from metamorph_tpu.inference import spec_decode as jspec
from metamorph_tpu.inference.serve import Request as JRequest
from metamorph_tpu.inference.serve import ServeEngine as JServeEngine
from metamorph_tpu.models import llama as JL
from metamorph_tpu_torch.config import LlamaConfig
from metamorph_tpu_torch.constants import IM_END_TOKEN_ID, IM_START_TOKEN_ID
from metamorph_tpu_torch.convert import llama_from_jax_params
from metamorph_tpu_torch.inference import decode, spec_decode
from metamorph_tpu_torch.inference.serve import Request, ServeEngine
from metamorph_tpu_torch.models import llama as L
from tests.test_torch_decode import (  # noqa: F401 (fixtures)
    _embeds, _ids, _left_padded, _port, check_same, forced_pair, jax_params,
    pair)
from tests.test_torch_serve import CFG, JCFG

H_TOL = dict(rtol=1e-5, atol=1e-5)


def _drafter(seed=11, vocab=JCFG.llama.vocab_size):
    """A second random tiny LLaMA (fp32) on both sides."""
    jcfg = JLlamaConfig.tiny(vocab_size=vocab)
    jp = JL.init_llama_params(jax.random.PRNGKey(seed), jcfg,
                              dtype=jnp.float32)
    return (jp, jcfg), (llama_from_jax_params(jax.tree.map(np.asarray, jp),
                                              LlamaConfig.tiny(vocab),
                                              device="cpu"),
                        LlamaConfig.tiny(vocab))


def _periodic(params):
    """A head that maps 111 <-> 222 (after 222 predict 111 and back): the
    stream cycles, so drafts from the history or from the same model
    verify."""
    p = jax.tree.map(lambda x: x, params)
    D, V = JCFG.llama.hidden_size, JCFG.llama.vocab_size
    emb = np.asarray(params["llama"]["embed"]["embedding"])
    kernel = np.zeros((D, V), np.float32)
    kernel[:, 111] = emb[222] * 5
    kernel[:, 222] = emb[111] * 5
    p["llama"]["lm_head"]["kernel"] = jnp.asarray(kernel)
    return p


@pytest.fixture(scope="module")
def periodic_pair(jax_params):
    p = _periodic(jax_params)
    return p, _port(p)


def check_spec(out, ref, plain):
    check_same(out, ref, batched=np.asarray(ref["n_ids"]).ndim == 1)
    assert int(out["iters"]) == int(ref["iters"])
    np.testing.assert_array_equal(np.asarray(out["ids"]),
                                  np.asarray(plain["ids"]))


@pytest.mark.parametrize("quant", [False, True])
@torch.no_grad()
def test_decode_chunk_step_matches_jax(pair, quant):
    """One verify chunk of 5 tokens at offset 6 of row 0 (stale entries
    past it), fp32 or int8 cache."""
    params, model = pair
    cfg, S, C = JCFG.llama, 24, 5
    rng = np.random.default_rng(2)
    xc = rng.normal(size=(C, cfg.hidden_size)).astype(np.float32)
    pos = np.arange(6, 6 + C, dtype=np.int32)
    jc = JL.init_kv_cache(cfg, 1, S, dtype=jnp.float32, quantized=quant)
    tc = L.init_kv_cache(CFG.llama, 1, S, dtype=torch.float32,
                         quantized=quant)
    # a filled history, and stale junk past the chunk
    ids = jnp.asarray(_ids(1, 6))[None]
    _, jc = JL.prefill(params["llama"], cfg, JL.embed_tokens(
        params["llama"], ids), jnp.arange(6)[None], jnp.ones((1, 6)), jc)
    L.prefill(model.llama, CFG.llama, L.embed_tokens(
        model.llama, torch.from_numpy(np.array(ids))),
        torch.arange(6)[None], None, tc)
    for name in ("k", "v"):
        if not quant:
            jc[name] = jc[name].at[:, :, :, 15:].set(7.0)
            tc[name][:, :, :, 15:] = 7.0
    jh, jc = JL.decode_chunk_step(params["llama"], cfg, jnp.asarray(xc),
                                  jnp.asarray(pos), jc)
    th, tc = L.decode_chunk_step(model.llama, CFG.llama,
                                 torch.from_numpy(xc), torch.from_numpy(pos),
                                 tc)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **H_TOL)
    for name in ("k", "v"):
        a, b = tc[name].float().numpy(), np.asarray(jc[name], np.float32)
        if quant:
            assert (np.abs(a - b) > 1).sum() == 0
        else:
            np.testing.assert_allclose(a, b, **H_TOL)


@pytest.mark.parametrize("spec_k", [1, 4, 8])
def test_greedy_decode_spec_matches_jax(pair, spec_k):
    params, model = pair
    for seed in (0, 2):
        ids = _ids(seed, 8)
        je, te = _embeds(params, model, ids)
        kw = dict(max_new_tokens=12, max_images=2, spec_k=spec_k)
        ref = jspec.greedy_decode_spec(params, JCFG, je, jnp.asarray(ids),
                                       **kw)
        out = spec_decode.greedy_decode_spec(model, CFG, te, ids, **kw)
        plain = decode.greedy_decode(model, CFG, te, max_new_tokens=12,
                                     max_images=2)
        check_spec(out, ref, plain)


@pytest.mark.parametrize("case", ["image_mode", "kv_int8", "periodic"])
def test_greedy_decode_spec_variants_match_jax(pair, forced_pair,
                                               periodic_pair, case):
    """Image emission through the chunk loop, the int8 cache, and a
    periodic stream on which prompt lookup accepts."""
    params, model = {"image_mode": forced_pair, "kv_int8": pair,
                     "periodic": periodic_pair}[case]
    ids = (np.asarray([111, 222] * 3, np.int32) if case == "periodic"
           else _ids(3, 5))
    je, te = _embeds(params, model, ids)
    kw = dict(max_new_tokens=14, max_images=2,
              kv_int8=case == "kv_int8")
    ref = jspec.greedy_decode_spec(params, JCFG, je, jnp.asarray(ids),
                                   spec_k=6, **kw)
    out = spec_decode.greedy_decode_spec(model, CFG, te, ids, spec_k=6, **kw)
    check_spec(out, ref, decode.greedy_decode(model, CFG, te, **kw))
    if case == "periodic":
        assert int(out["iters"]) < int(out["steps"])
    if case == "image_mode":
        assert int(out["n_image_tokens"]) > 0


def test_greedy_decode_spec_oracle_draft_fn(pair):
    """A `draft_fn` proposing the true continuation: far fewer chunk steps
    than tokens, and JAX's count of them."""
    params, model = pair
    spec_k, max_new = 8, 16
    ids = _ids(100, 8)
    je, te = _embeds(params, model, ids)
    plain = jdecode.greedy_decode(params, JCFG, je, max_new_tokens=max_new,
                                  max_images=2)
    n = int(plain["n_ids"])
    true = np.full((n + spec_k,), -1, np.int32)
    true[:n] = np.asarray(plain["ids"][:n])
    T0 = len(ids)

    def j_oracle(ids_all, n_all):
        return jax.lax.dynamic_slice(jnp.asarray(true), (n_all - T0,),
                                     (spec_k - 1,))

    def t_oracle(ids_all, n_all):          # the port's batched form
        idx = (n_all.long() - T0)[:, None] + torch.arange(spec_k - 1)
        return torch.from_numpy(true)[idx.clamp(0, len(true) - 1)]

    kw = dict(max_new_tokens=max_new, max_images=2, spec_k=spec_k)
    ref = jspec.greedy_decode_spec(params, JCFG, je, jnp.asarray(ids),
                                   draft_fn=j_oracle, **kw)
    out = spec_decode.greedy_decode_spec(model, CFG, te, ids,
                                         draft_fn=t_oracle, **kw)
    check_spec(out, ref, decode.greedy_decode(model, CFG, te,
                                              max_new_tokens=max_new,
                                              max_images=2))
    assert int(out["iters"]) <= int(out["steps"]) // 2


@pytest.mark.parametrize("case", ["text", "image_mode", "periodic"])
def test_batched_greedy_decode_spec_matches_jax(pair, forced_pair,
                                                periodic_pair, case):
    params, model = {"text": pair, "image_mode": forced_pair,
                     "periodic": periodic_pair}[case]
    if case == "periodic":
        rows = [np.asarray([111, 222, 111, 222], np.int32),
                np.asarray([222, 111], np.int32)]
    else:
        rows = [_ids(15, 3), _ids(16, 6), _ids(17, 4)]
    T0 = max(len(r) for r in rows)
    je, te, mask, ids = _left_padded(params, model, rows, T0)
    kw = dict(max_new_tokens=12, max_images=2)
    ref = jspec.batched_greedy_decode_spec(
        params, JCFG, je, jnp.asarray(mask), jnp.asarray(ids), spec_k=4,
        **kw)
    out = spec_decode.batched_greedy_decode_spec(model, CFG, te, mask, ids,
                                                 spec_k=4, **kw)
    check_spec(out, ref, decode.batched_greedy_decode(model, CFG, te, mask,
                                                      **kw))


@pytest.mark.parametrize("drafter", ["random", "self"])
@pytest.mark.parametrize("head", ["text", "image_mode", "periodic"])
def test_draft_model_spec_matches_jax(pair, forced_pair, periodic_pair,
                                      drafter, head):
    """`greedy_decode_spec_draft_model` with a random tiny drafter (about
    no accepts) and with the main LLaMA as its own drafter (nearly every
    draft verifies)."""
    params, model = {"text": pair, "image_mode": forced_pair,
                     "periodic": periodic_pair}[head]
    (jd, jdc), (td, tdc) = (_drafter() if drafter == "random" else
                            ((params["llama"], JCFG.llama),
                             (model.llama, CFG.llama)))
    ids = (np.asarray([111, 222, 111, 222], np.int32) if head == "periodic"
           else _ids(4, 6))
    je, te = _embeds(params, model, ids)
    kw = dict(max_new_tokens=12, max_images=2, spec_k=5)
    ref = jspec.greedy_decode_spec_draft_model(params, jd, JCFG, jdc, je,
                                               jnp.asarray(ids), **kw)
    out = spec_decode.greedy_decode_spec_draft_model(model, td, CFG, tdc, te,
                                                     ids, **kw)
    check_spec(out, ref, decode.greedy_decode(model, CFG, te,
                                              max_new_tokens=12,
                                              max_images=2))
    if drafter == "self" and head == "periodic":
        assert int(out["iters"]) <= (int(out["steps"]) + 1) // 2


@pytest.mark.parametrize("drafter", ["random", "self"])
def test_batched_draft_model_spec_matches_jax(periodic_pair, pair, drafter):
    params, model = periodic_pair if drafter == "self" else pair
    (jd, jdc), (td, tdc) = (_drafter() if drafter == "random" else
                            ((params["llama"], JCFG.llama),
                             (model.llama, CFG.llama)))
    rows = ([np.asarray([111, 222, 111, 222], np.int32),
             np.asarray([222, 111], np.int32)] if drafter == "self"
            else [_ids(21, 3), _ids(22, 6), _ids(23, 4)])
    T0 = max(len(r) for r in rows)
    je, te, mask, ids = _left_padded(params, model, rows, T0)
    kw = dict(max_new_tokens=12, max_images=2, spec_k=4)
    ref = jspec.batched_greedy_decode_spec_draft_model(
        params, jd, JCFG, jdc, je, jnp.asarray(mask), jnp.asarray(ids), **kw)
    out = spec_decode.batched_greedy_decode_spec_draft_model(
        model, td, CFG, tdc, te, mask, ids, **kw)
    check_spec(out, ref, decode.batched_greedy_decode(
        model, CFG, te, mask, max_new_tokens=12, max_images=2))
    if drafter == "self":
        assert int(out["iters"]) <= (int(np.asarray(out["steps"]).max())
                                     + 1) // 2


def test_generate_spec_and_draft_wiring(pair):
    params, model = pair
    t0 = 9
    ids = _ids(17, t0)
    tokens = np.zeros((1, t0 + 3), np.int32)
    tokens[0, :t0] = ids
    mask = (tokens != 0).astype(np.int32)
    batch = {"tokens": tokens, "attn_mask": mask}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jd, jdc), (td, tdc) = _drafter()
    plain = decode.generate(model, CFG, batch, None, max_new_tokens=8,
                            max_images=1)
    for kw, tkw in ((dict(spec_k=4), dict(spec_k=4)),
                    (dict(spec_k=4, draft=(jd, jdc)),
                     dict(spec_k=4, draft=(td, tdc)))):
        ref = jdecode.generate(params, JCFG, jb, None, max_new_tokens=8,
                               max_images=1, **kw)
        out = decode.generate(model, CFG, batch, None, max_new_tokens=8,
                              max_images=1, **tkw)
        check_spec(out, ref, plain)


def test_spec_custom_stop_ids_through_accept_chain(periodic_pair):
    """A stop id reached through an ACCEPTED draft ends the row there."""
    params, model = periodic_pair
    ids = np.asarray([111, 222] * 3, np.int32)
    je, te = _embeds(params, model, ids)
    kw = dict(max_new_tokens=14, max_images=2, spec_k=6, stop_ids=(222,))
    ref = jspec.greedy_decode_spec(params, JCFG, je, jnp.asarray(ids), **kw)
    out = spec_decode.greedy_decode_spec(model, CFG, te, ids, **kw)
    check_spec(out, ref, decode.greedy_decode(
        model, CFG, te, max_new_tokens=14, max_images=2, stop_ids=(222,)))


def test_drafter_vocabulary_smaller_than_the_main_models(periodic_pair):
    """A drafter with 2 fewer rows than the main model (LLaMA-3.2-1B's
    128256 against 128258) meets <image_start>/<image_end> in the prompt.
    JAX's `jnp.take` gives NaN rows past the table: the drafter's cache
    turns NaN and it proposes token 0 from then on. The port embeds the
    same way (no index error), so drafts, chunk steps and ids equal JAX's,
    and the output is the plain stream."""
    params, model = periodic_pair
    V = JCFG.llama.vocab_size - 2
    (jd, jdc), (td, tdc) = _drafter(seed=13, vocab=V)
    ids = np.asarray([111, IM_START_TOKEN_ID, 222, IM_END_TOKEN_ID, 111, 222],
                     np.int32)
    je, te = _embeds(params, model, ids)
    kw = dict(max_new_tokens=10, max_images=2, spec_k=4)
    ref = jspec.greedy_decode_spec_draft_model(params, jd, JCFG, jdc, je,
                                               jnp.asarray(ids), **kw)
    out = spec_decode.greedy_decode_spec_draft_model(model, td, CFG, tdc, te,
                                                     ids, **kw)
    check_spec(out, ref, decode.greedy_decode(model, CFG, te,
                                              max_new_tokens=10,
                                              max_images=2))
    # what each package's lookup gives for the two ids past the table
    jrows = np.asarray(JL.embed_tokens(jd, jnp.asarray([5, V, V + 1])))
    trows = spec_decode._draft_embed(td, torch.tensor([5, V, V + 1])).detach(
    ).numpy()
    assert np.isnan(jrows[1:]).all() and np.isnan(trows[1:]).all()
    np.testing.assert_array_equal(trows[0], jrows[0])
    # the drafter is dead after the special: every chunk accepts nothing
    assert int(out["iters"]) == int(out["steps"]) - 1


# ---- ServeEngine(draft=...) -------------------------------------------------

ENGINE = dict(n_slots=2, max_cache_len=64, max_new_tokens_cap=16,
              max_images=2, prefill_buckets=(8, 16))


def _serve(jp, model, jdraft, tdraft, reqs, spec_k, steps_per_sync=3,
           desync=False):
    """The same requests through JAX's engine and the port's; with
    `desync`, both drafters lose their state (d_len back to 0) after the
    first tick."""
    out = []
    for eng in (JServeEngine(jp, JCFG, attn_impl="xla", spec_k=spec_k,
                             draft=jdraft, steps_per_sync=steps_per_sync,
                             **ENGINE),
                ServeEngine(model, CFG, spec_k=spec_k, draft=tdraft,
                            steps_per_sync=steps_per_sync, **ENGINE)):
        jax_side = isinstance(eng, JServeEngine)
        for r in reqs:
            eng.submit((JRequest if jax_side else Request)(**r))
        first, ticks = True, 0
        while eng.pending or any(u is not None for u in eng.slot_uid):
            eng.step()
            ticks += 1
            if desync and first:
                if jax_side:
                    eng.state = eng.state._replace(
                        d_len=jnp.zeros_like(eng.state.d_len))
                else:
                    eng.state.d_len.zero_()
                first = False
        done = {c.uid: c for c in eng.completed}
        out.append((done, eng.spec_accepted, ticks, eng._ticks_since_spec))
    return out


def _assert_same(a, b):
    assert sorted(map(str, a)) == sorted(map(str, b))
    for uid in a:
        np.testing.assert_array_equal(a[uid].ids, b[uid].ids)
        assert a[uid].steps == b[uid].steps
        np.testing.assert_allclose(a[uid].image_embeds, b[uid].image_embeds,
                                   **H_TOL)


@pytest.mark.parametrize("drafter", ["random", "self", "small_vocab"])
def test_draft_engine_matches_jax_and_plain(periodic_pair, drafter):
    """Continuous batching with a drafter: ids equal to JAX's draft engine
    and to the plain engine, the same accepted-draft count and ticks. The
    small-vocabulary drafter (2 rows short) meets <image_start> and
    <image_end> in one prompt, as in the single-request test below."""
    params, model = periodic_pair
    if drafter == "self":
        (jd, jdc), (td, tdc) = ((params["llama"], JCFG.llama),
                                (model.llama, CFG.llama))
    else:
        (jd, jdc), (td, tdc) = _drafter(
            vocab=JCFG.llama.vocab_size - 2 * (drafter == "small_vocab"))
    c_ids = _ids(31, 7)
    if drafter == "small_vocab":
        c_ids[2], c_ids[5] = IM_START_TOKEN_ID, IM_END_TOKEN_ID
    reqs = [dict(prompt_ids=np.asarray([111, 222, 111, 222], np.int32),
                 max_new_tokens=14, uid="a"),
            dict(prompt_ids=np.asarray([222, 111, 222], np.int32),
                 max_new_tokens=12, uid="b"),
            dict(prompt_ids=c_ids, max_new_tokens=9, uid="c")]
    (jdone, jacc, jticks, _), (done, acc, ticks, _) = _serve(
        params, model, (jd, jdc), (td, tdc), reqs, spec_k=6)
    _assert_same(done, jdone)
    assert (acc, ticks) == (jacc, jticks)
    plain = ServeEngine(model, CFG, steps_per_sync=3, **ENGINE)
    for r in reqs:
        plain.submit(Request(**r))
    _assert_same(done, {c.uid: c for c in plain.run()})
    if drafter == "self":
        assert acc > 0


def test_draft_engine_resyncs_after_losing_drafter_state(periodic_pair):
    """JAX's resync case: both drafters lose their state after the first
    tick; catch-up ticks are no evidence against speculation, the drafter
    resyncs, and the output stays exact."""
    params, model = periodic_pair
    reqs = [dict(prompt_ids=np.asarray([111, 222, 111, 222], np.int32),
                 max_new_tokens=14, uid="r")]
    (jdone, jacc, _, jsince), (done, acc, _, since) = _serve(
        params, model, (params["llama"], JCFG.llama),
        (model.llama, CFG.llama), reqs, spec_k=6, steps_per_sync=1,
        desync=True)
    _assert_same(done, jdone)
    assert (acc, since) == (jacc, jsince) and since == 0
