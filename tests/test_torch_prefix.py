"""PyTorch port, the shared prefix (`ServeEngine(shared_prefix_ids=...)`,
`_prefill_admit_prefixed`), on the CPU with fp32 weights (tiny LLaMA +
SigLIP, K=3), mirroring tests/test_serve_spec.py's prefix tests: the
prefix engine given suffixes gives EQUAL greedy ids to the port's plain
engine given prefix + suffix, and to JAX's prefix engine; image embeds
within 1e-5. Also the HTTP server's `--system-prompt` with a stub
tokenizer."""

import json
import sys
import urllib.request

import jax
import numpy as np
import pytest
import torch

from metamorph_tpu.inference.serve import Request as JRequest
from metamorph_tpu.inference.serve import ServeEngine as JServeEngine
from metamorph_tpu_torch.convert import from_jax_params
from metamorph_tpu_torch.inference import loader, serve_http
from metamorph_tpu_torch.inference.serve import Request, ServeEngine
from tests.test_torch_frontends import files, jax_params  # noqa: F401
from tests.test_torch_serve import CFG, JCFG
from tests.test_torch_serve import jax_params as serve_params  # noqa: F401
from tests.test_torch_spec import _drafter

K = CFG.mm.num_image_tokens
D = CFG.llama.hidden_size
SMALL = dict(n_slots=2, max_cache_len=64, max_new_tokens_cap=16,
             max_images=2, steps_per_sync=3)


@pytest.fixture(scope="module")
def pair(serve_params):
    return serve_params, from_jax_params(jax.tree.map(np.asarray,
                                                      serve_params),
                                         CFG, device="cpu")


def _by_uid(done):
    return {c.uid: c for c in done}


def _assert_same(a, b):
    assert sorted(map(str, a)) == sorted(map(str, b))
    for uid in a:
        np.testing.assert_array_equal(a[uid].ids, b[uid].ids,
                                      err_msg=str(uid))
        assert a[uid].image_embeds.shape == b[uid].image_embeds.shape
        if a[uid].image_embeds.size:
            np.testing.assert_allclose(a[uid].image_embeds,
                                       b[uid].image_embeds, rtol=1e-5,
                                       atol=1e-5)


def _wave(seed, P, lens, image_at=None):
    """A prefix of P ids, suffixes of `lens`, budgets; the request at
    index `image_at` carries an image at suffix position 1."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(10, 1000, (P,)).astype(np.int32)
    img = rng.normal(size=(1, K, D)).astype(np.float32) * 0.02
    reqs = []
    for i, n in enumerate(lens):
        r = dict(prompt_ids=rng.integers(10, 1000, (n,)).astype(np.int32),
                 max_new_tokens=int(6 + (3 * i) % 4), uid=i)
        if i == image_at:
            r.update(image_embeds=img.copy(), image_positions=np.asarray([1]))
        reqs.append(r)
    return prefix, reqs


def _whole(prefix, r):
    """The same request as one prompt: prefix + suffix, the image moved to
    its full-prompt position."""
    w = dict(r, prompt_ids=np.concatenate([prefix, r["prompt_ids"]]))
    if "image_positions" in r:
        w["image_positions"] = r["image_positions"] + len(prefix)
    return w


def _serve(engine, reqs, req_cls=Request):
    for r in reqs:
        engine.submit(req_cls(**r))
    return _by_uid(engine.run())


@pytest.mark.parametrize("reference", ["port_plain", "jax_prefix"])
def test_prefix_engine_matches_plain_and_jax(pair, reference):
    """Four requests on two slots (a second wave of admissions reuses the
    freed slots), an image inside one suffix."""
    params, model = pair
    prefix, reqs = _wave(41, 11, (5, 9, 3, 6), image_at=1)
    kw = dict(SMALL, prefill_buckets=(8, 16, 32))
    pref = ServeEngine(model, CFG, shared_prefix_ids=prefix, **kw)
    out = _serve(pref, reqs)
    assert pref.tick_counts["prefill"] >= 2
    if reference == "port_plain":
        ref = _serve(ServeEngine(model, CFG, **kw),
                     [_whole(prefix, r) for r in reqs])
    else:
        ref = _serve(JServeEngine(params, JCFG, attn_impl="xla",
                                  shared_prefix_ids=prefix, **kw), reqs,
                     JRequest)
    _assert_same(ref, out)


@pytest.mark.parametrize("variant", ["spec", "draft", "kv_int8"])
def test_prefix_composes_with_spec_draft_and_int8_cache(pair, variant):
    """Prefix reuse under prompt-lookup speculation and a drafter (ids
    equal to the prefix engine without speculation, and to JAX's prefix
    engine with the same options), and with the int8 cache (ids equal to
    JAX's prefix engine on its int8 cache)."""
    params, model = pair
    prefix, reqs = _wave(42, 7, (5, 4, 7))
    kw = dict(SMALL, prefill_buckets=(8, 16), shared_prefix_ids=prefix)
    (jd, jdc), (td, tdc) = _drafter()
    opts = {"spec": (dict(spec_k=4), dict(spec_k=4)),
            "draft": (dict(spec_k=4, draft=(td, tdc)),
                      dict(spec_k=4, draft=(jd, jdc))),
            "kv_int8": (dict(kv_int8=True), dict(kv_int8=True))}[variant]
    eng = ServeEngine(model, CFG, **kw, **opts[0])
    out = _serve(eng, reqs)
    jref = _serve(JServeEngine(params, JCFG, attn_impl="xla", **kw,
                               **opts[1]), reqs, JRequest)
    _assert_same(jref, out)
    if variant == "kv_int8":
        assert eng.state.cache["k"].dtype == torch.int8
    else:
        assert eng.tick_counts["spec"] > 0
        _assert_same(_serve(ServeEngine(model, CFG, **kw), reqs), out)


def test_prefix_odd_room_top_bucket(pair):
    """room = 256 - 37 = 219: the appended top bucket rounds down to 192,
    so the admission chunks still tile it; a suffix in that bucket decodes
    as the plain engine does on prefix + suffix."""
    _, model = pair
    prefix, reqs = _wave(44, 37, (150,))
    kw = dict(n_slots=1, max_cache_len=256, max_new_tokens_cap=8,
              max_images=2, prefill_buckets=(64, 128), steps_per_sync=2)
    pref = ServeEngine(model, CFG, shared_prefix_ids=prefix, **kw)
    assert pref.prefill_buckets == (64, 128, 192)
    out = _serve(pref, reqs)
    ref = _serve(ServeEngine(model, CFG, **kw),
                 [_whole(prefix, r) for r in reqs])
    _assert_same(ref, out)


def test_prefix_rejections(pair):
    _, model = pair
    prefix = np.asarray([5, 6, 7, 8], np.int32)
    eng = ServeEngine(model, CFG, n_slots=1, max_cache_len=64,
                      max_new_tokens_cap=64, max_images=2,
                      prefill_buckets=(8,), shared_prefix_ids=prefix)
    with pytest.raises(ValueError, match="prompt_ids"):
        eng.submit(Request(prompt_embeds=np.zeros((4, D), np.float32),
                           max_new_tokens=4, uid="x"))
    with pytest.raises(ValueError, match="max_cache_len"):   # P counts
        eng.submit(Request(prompt_ids=np.ones(8, np.int32),
                           max_new_tokens=53))
    with pytest.raises(ValueError, match="fill_chunk"):
        ServeEngine(model, CFG, n_slots=1, max_cache_len=64,
                    max_new_tokens_cap=8, prefill_buckets=(8,),
                    fill_chunk=8, shared_prefix_ids=prefix)
    with pytest.raises(ValueError, match="no room"):
        ServeEngine(model, CFG, n_slots=1, max_cache_len=64,
                    max_new_tokens_cap=8, prefill_buckets=(8,),
                    shared_prefix_ids=np.arange(63, dtype=np.int32))


class _PrefixTokenizer:
    """A word tokenizer that honours `add_special_tokens` (a BOS first)."""
    bos_token_id = 128000

    def __call__(self, s, add_special_tokens=True):
        class R:
            pass

        r = R()
        words = [1000 + sum(map(ord, w)) % 1000 for w in s.split()]
        r.input_ids = [self.bos_token_id] * add_special_tokens + words
        return r

    def decode(self, ids, **kw):
        return " ".join(map(str, ids))

    def add_tokens(self, toks, special_tokens=True):
        return len(toks)


class _Transformers:
    class AutoTokenizer:
        @staticmethod
        def from_pretrained(path):
            return _PrefixTokenizer()


def test_http_system_prompt_serves_the_whole_prompts_ids(files, monkeypatch):
    """`serve_http.main --system-prompt` (with `--int8`): the prefix is
    encoded with the BOS, each request without it, and the ids served equal
    the plain engine's on the int8 model given BOS + system words + request
    words."""
    from metamorph_tpu_torch.inference.serve_cli import load_model

    tload = loader.load_pretrained_model
    monkeypatch.setattr(loader, "load_pretrained_model",
                        lambda p, dtype=None, **kw: tload(
                            p, dtype=torch.float32, **kw))
    monkeypatch.setitem(sys.modules, "transformers", _Transformers())
    argv = ["--model-path", str(files / "model"), "--tokenizer", "stub",
            "--port", "0", "--max-cache-len", "128", "--max-new-tokens",
            "8", "--n-slots", "2", "--device", "cpu", "--int8"]
    system = "You answer in one short sentence ."
    srv = serve_http.main(argv + ["--system-prompt", system], block=False)
    prompts = ["what is the weather", "name a colour please"]
    try:
        got = []
        for p in prompts:
            req = urllib.request.Request(
                f"http://127.0.0.1:{srv.port}/v1/completions",
                data=json.dumps({"prompt": p, "max_new_tokens": 6}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=300) as r:
                got.append(json.loads(r.read())["ids"])
    finally:
        srv.stop()
    tok = _PrefixTokenizer()
    args = serve_http.parse_args(argv)
    model, cfg = load_model(args)
    eng = ServeEngine(model, cfg, n_slots=2, max_cache_len=128,
                      max_new_tokens_cap=8)
    done = _serve(eng, [dict(prompt_ids=np.asarray(
        tok(system).input_ids + tok(p, add_special_tokens=False).input_ids,
        np.int32), max_new_tokens=6, uid=i) for i, p in enumerate(prompts)])
    assert got == [done[i].ids.tolist() for i in range(len(prompts))]
    assert all(len(g) == 6 for g in got)
