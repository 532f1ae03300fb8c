"""PyTorch port, the whole serving slice: the same greedy requests through
the JAX package's ServeEngine (CPU, XLA attention) and the port's
ServeEngine (CPU tensors, so the plain attention versions) with the same
fp32 weights must give EQUAL token ids, and image embeddings within 1e-5
(fp32 on both sides; the vision head and projector feed back K continuous
tokens, so per-step differences of ~1e-7 stay well under 1e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metamorph_tpu.config import LlamaConfig as JLlamaConfig
from metamorph_tpu.config import MetaMorphConfig as JConfig
from metamorph_tpu.config import MultimodalConfig as JMM
from metamorph_tpu.config import SiglipConfig as JSiglipConfig
from metamorph_tpu.config import TrainConfig
from metamorph_tpu.inference.serve import Request as JRequest
from metamorph_tpu.inference.serve import ServeEngine as JServeEngine
from metamorph_tpu.models import metamorph as JM
from metamorph_tpu_torch.config import (LlamaConfig, MetaMorphConfig,
                                        MultimodalConfig, SiglipConfig)
from metamorph_tpu_torch.constants import IM_START_TOKEN_ID, LLAMA3_EOS_IDS
from metamorph_tpu_torch.convert import from_jax_params
from metamorph_tpu_torch.inference.serve import Request, ServeEngine

K = 3
JCFG = JConfig(llama=JLlamaConfig.tiny(), siglip=JSiglipConfig.tiny(),
               mm=JMM(num_image_tokens=K), train=TrainConfig(max_seq_len=64))
CFG = MetaMorphConfig(llama=LlamaConfig.tiny(), siglip=SiglipConfig.tiny(),
                      mm=MultimodalConfig(num_image_tokens=K))
ENGINE = dict(n_slots=2, max_cache_len=64, max_new_tokens_cap=16,
              max_images=2, prefill_buckets=(8, 16), steps_per_sync=3)


@pytest.fixture(scope="module")
def jax_params():
    return JM.init_metamorph_params(jax.random.PRNGKey(7), JCFG,
                                    dtype=jnp.float32)


def _requests():
    rng = np.random.default_rng(0)
    D = JCFG.llama.hidden_size
    reqs = [dict(prompt_ids=rng.integers(10, 1000, (t0,)).astype(np.int32),
                 max_new_tokens=b, uid=i)
            for i, (t0, b) in enumerate([(6, 10), (9, 7), (4, 12)])]
    reqs.append(dict(prompt_ids=rng.integers(10, 1000, (11,)).astype(np.int32),
                     image_embeds=rng.normal(size=(1, K, D)).astype(
                         np.float32) * 0.02,
                     image_positions=np.asarray([3]), max_new_tokens=9,
                     uid="img"))
    return reqs


def _serve_both(params):
    reqs = _requests()
    jeng = JServeEngine(params, JCFG, attn_impl="xla", **ENGINE)
    for r in reqs:
        jeng.submit(JRequest(**r))
    ref = {c.uid: c for c in jeng.run()}
    model = from_jax_params(jax.tree.map(np.asarray, params), CFG,
                            device="cpu")
    eng = ServeEngine(model, CFG, **ENGINE)
    for r in reqs:
        eng.submit(Request(**r))
    out = {c.uid: c for c in eng.run()}
    assert sorted(map(str, out)) == sorted(map(str, ref)) \
        == ["0", "1", "2", "img"]
    return ref, out


def _forcing_image_start(params):
    """lm head that picks <image_start> (or eos), so rows enter image mode
    and feed back K continuous tokens through vision head + projector."""
    p = jax.tree.map(lambda x: x, params)
    D, V = JCFG.llama.hidden_size, JCFG.llama.vocab_size
    kernel = np.zeros((D, V), np.float32)
    kernel[:, IM_START_TOKEN_ID] = 10.0
    kernel[:, LLAMA3_EOS_IDS[0]] = -10.0
    p["llama"]["lm_head"]["kernel"] = jnp.asarray(kernel)
    return p


@pytest.mark.parametrize("variant", ["text", "image_generation"])
def test_port_engine_matches_jax_engine(jax_params, variant):
    params = (jax_params if variant == "text"
              else _forcing_image_start(jax_params))
    ref, out = _serve_both(params)
    n_img = 0
    for uid, c in ref.items():
        np.testing.assert_array_equal(out[uid].ids, c.ids, err_msg=str(uid))
        assert out[uid].steps == c.steps
        assert out[uid].image_embeds.shape == c.image_embeds.shape
        np.testing.assert_allclose(out[uid].image_embeds, c.image_embeds,
                                   rtol=1e-5, atol=1e-5)
        n_img += c.image_embeds.shape[0]
    if variant == "image_generation":
        assert n_img > 0


def test_port_engine_rejects_unported_options(jax_params):
    model = from_jax_params(jax.tree.map(np.asarray, jax_params), CFG,
                            device="cpu")
    # the shared prefix is ported (tests/test_torch_prefix.py); as in JAX
    # it refuses chunked fill, and its requests must carry ids
    with pytest.raises(ValueError, match="fill_chunk"):
        ServeEngine(model, CFG, **ENGINE, fill_chunk=8,
                    shared_prefix_ids=[1, 2, 3])
    pref = ServeEngine(model, CFG, **ENGINE, kv_int8=True,
                       shared_prefix_ids=[1, 2, 3])
    with pytest.raises(ValueError, match="prompt_ids"):
        pref.submit(Request(prompt_embeds=np.zeros((4, 64), np.float32),
                            max_new_tokens=4))
    # draft models are ported (tests/test_torch_spec.py); as in JAX, a
    # drafter needs speculation on
    with pytest.raises(ValueError, match="spec_k"):
        ServeEngine(model, CFG, **ENGINE, draft=(model.llama, CFG.llama))
    eng = ServeEngine(model, CFG, **ENGINE)
    with pytest.raises(ValueError):       # prompt + budget > cache
        eng.submit(Request(prompt_ids=np.zeros(60, np.int32),
                           max_new_tokens=8))
    with pytest.raises(ValueError):       # image without splice positions
        eng.submit(Request(prompt_ids=np.zeros(8, np.int32),
                           image_embeds=np.zeros((1, K, 64), np.float32)))


def test_port_engine_sampling_is_seeded(jax_params):
    """Sampling rows draw from the engine's torch.Generator: the same seed
    gives the same stream; temperature 0 rows stay greedy."""
    model = from_jax_params(jax.tree.map(np.asarray, jax_params), CFG,
                            device="cpu")

    def run(seed):
        eng = ServeEngine(model, CFG, seed=seed, **ENGINE)
        rng = np.random.default_rng(1)
        for i in range(3):
            eng.submit(Request(prompt_ids=rng.integers(10, 1000, (5,)).astype(
                np.int32), max_new_tokens=8, temperature=1.0 if i else 0.0,
                top_p=0.9, uid=i))
        return {c.uid: c.ids for c in eng.run()}

    a, b = run(5), run(5)
    for uid in a:
        np.testing.assert_array_equal(a[uid], b[uid])
    greedy = ServeEngine(model, CFG, **ENGINE)
    rng = np.random.default_rng(1)
    greedy.submit(Request(prompt_ids=rng.integers(10, 1000, (5,)).astype(
        np.int32), max_new_tokens=8, uid=0))
    np.testing.assert_array_equal(greedy.run()[0].ids, a[0])


def test_port_embeds_admission_and_streaming_match_ids_path(jax_params):
    """Pre-fused prompt embeddings (`_prefill_admit`) decode exactly like
    the same prompts admitted as ids, and on_token streams every id."""
    model = from_jax_params(jax.tree.map(np.asarray, jax_params), CFG,
                            device="cpu")
    reqs = [r for r in _requests() if r["uid"] != "img"]
    streamed = {}

    def on_token(uid, ids):
        streamed.setdefault(uid, []).extend(ids.tolist())

    def run(as_ids):
        eng = ServeEngine(model, CFG, on_token=on_token if as_ids else None,
                          **ENGINE)
        for r in reqs:
            if as_ids:
                eng.submit(Request(**r))
            else:
                with torch.no_grad():
                    pe = model.llama.embed[torch.from_numpy(
                        r["prompt_ids"]).long()].numpy()
                eng.submit(Request(prompt_embeds=pe,
                                   max_new_tokens=r["max_new_tokens"],
                                   uid=r["uid"]))
        return {c.uid: c for c in eng.run()}

    a, b = run(True), run(False)
    assert sorted(a) == sorted(b) == [0, 1, 2]
    for uid in a:
        np.testing.assert_array_equal(a[uid].ids, b[uid].ids)
        assert streamed[uid] == a[uid].ids.tolist()


def _rerun_capture(eng):
    """CPU stand-in for `serve._cuda_graph`: the "graph" re-runs the
    captured closure at each replay, after checking that the state holds
    the static buffers it was captured on (what a real replay reads and
    writes), and checks that the closure leaves the state on them."""
    from metamorph_tpu_torch.inference import serve as S

    def capture(fn):
        bufs = {f: getattr(eng.state, f) for f in S._PLAIN_TICK_FIELDS}

        def on_buffers():
            return all(getattr(eng.state, f) is b for f, b in bufs.items())

        class Rerun:
            def replay(self):
                assert on_buffers()
                fn()
                assert on_buffers()

        return Rerun()

    return capture


def _drive(eng, reqs, plan):
    """Submit reqs[i] before tick `plan[i]`, changing steps_per_sync to 4
    after tick 6; record the state after each tick; run to the end."""
    seen = []
    for t in range(200):
        for r, at in zip(reqs, plan):
            if at == t:
                eng.submit(Request(**r))
        if t == 6:
            eng.steps_per_sync = 4
        if not (eng.pending or any(u is not None for u in eng.slot_uid)) \
                and t > max(plan):
            break
        eng.step()
        st = eng.state
        seen.append([x.clone() for x in (st.ids, st.n_ids, st.steps,
                                         st.cache_lens, st.next_embed,
                                         st.img_embeds)])
    return {c.uid: c for c in eng.completed}, seen


@pytest.mark.parametrize("variant", ["text", "image_generation"])
def test_graphed_plain_ticks_match_eager_ticks(jax_params, variant):
    """Plain ticks replayed through the capture seam (the CPU stand-in,
    which re-runs the closure on the static buffers) give the eager
    engine's ids, steps, image embeddings and state after every tick:
    across admissions between replays (which rebind state fields), rows
    that finish mid-tick (budgets off the tick), and a key change (a
    second steps_per_sync: one more eager tick, one more capture)."""
    params = (jax_params if variant == "text"
              else _forcing_image_start(jax_params))
    model = from_jax_params(jax.tree.map(np.asarray, params), CFG,
                            device="cpu")
    reqs = _requests()
    plan = [0, 0, 3, 5]
    runs = []
    for graphed in (False, True):
        eng = ServeEngine(model, CFG, **dict(ENGINE, n_slots=3))
        if graphed:
            eng._capture = _rerun_capture(eng)
        runs.append((eng,) + _drive(eng, reqs, plan))
    (eager, ref, ref_seen), (eng, out, seen) = runs
    assert eager.tick_counts["plain_graphed"] == 0
    assert eng.tick_counts["captures"] == 2
    assert 0 < eng.tick_counts["plain_graphed"] < eng.tick_counts["plain"]
    assert eng.tick_counts["plain"] == eager.tick_counts["plain"]
    assert sorted(map(str, out)) == ["0", "1", "2", "img"]
    for uid, c in ref.items():
        np.testing.assert_array_equal(out[uid].ids, c.ids)
        assert out[uid].steps == c.steps
        np.testing.assert_array_equal(out[uid].image_embeds, c.image_embeds)
    if variant == "image_generation":
        assert sum(c.image_embeds.shape[0] for c in ref.values()) > 0
    assert len(seen) == len(ref_seen)
    for a, b in zip(seen, ref_seen):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


@pytest.mark.parametrize("variant", ["sampling", "spec"])
def test_sampling_and_spec_ticks_stay_eager(jax_params, variant):
    """An engine that samples, and a speculative engine's spec ticks, run
    eagerly even where the engine can capture: nothing is replayed."""
    model = from_jax_params(jax.tree.map(np.asarray, jax_params), CFG,
                            device="cpu")
    eng = ServeEngine(model, CFG, **ENGINE,
                      **({"spec_k": 4} if variant == "spec" else {}))
    eng._capture = _rerun_capture(eng)
    eng.spec_overhead_frac = 0.0     # every decode tick runs the spec program
    for r in _requests():
        eng.submit(Request(**r, temperature=0.8 if variant == "sampling"
                           else 0.0))
    assert len(eng.run()) == 4
    program = "plain" if variant == "sampling" else "spec"
    assert eng.tick_counts[program] > 0
    assert eng.tick_counts["plain_graphed"] == eng.tick_counts["captures"] \
        == 0
