"""PyTorch port, the decode entry points (`inference/decode.py`) held to the
JAX package on the CPU with the same fp32 weights (tiny LLaMA + SigLIP,
K=3): `greedy_decode` (stop ids, the int8 cache, `max_cache_len`,
`start_in_image`), `batched_greedy_decode` on LEFT-padded prompts of three
lengths (the port re-lays them as right-aligned ragged rows),
`generate` / `generate_batched` with pixels (at K=4: the tower's
interpolation reduction needs a square K), and the sampler.

Greedy ids and step counts must be EQUAL, image embeddings within 1e-5
(fp32 on both sides; the K fed-back continuous tokens move by ~1e-7).
Sampling: `jax.random.categorical` draws cannot be matched, so the
nucleus-masked logits are held exactly to the ones JAX's `_sample_token`
hands its draw, seeded repeats bitwise, and temperature 1e-6 to greedy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metamorph_tpu.config import MetaMorphConfig as JConfig
from metamorph_tpu.config import MultimodalConfig as JMM
from metamorph_tpu.inference import decode as jdecode
from metamorph_tpu.models import llama as JL
from metamorph_tpu.models import metamorph as JM
from metamorph_tpu.multimodal.packing import batch_to_arrays as jbatch
from metamorph_tpu.multimodal.packing import pack_sequences as jpack
from metamorph_tpu_torch.config import MetaMorphConfig, MultimodalConfig
from metamorph_tpu_torch.constants import IMAGE_TOKEN_INDEX
from metamorph_tpu_torch.convert import from_jax_params
from metamorph_tpu_torch.inference import decode
from metamorph_tpu_torch.models import llama as L
from tests.test_torch_serve import CFG, JCFG, _forcing_image_start

K = CFG.mm.num_image_tokens
# the tower's interpolation reduction needs a square K: pixels run at K=4
JCFG4 = JConfig(llama=JCFG.llama, siglip=JCFG.siglip,
                mm=JMM(num_image_tokens=4), train=JCFG.train)
CFG4 = MetaMorphConfig(llama=CFG.llama, siglip=CFG.siglip,
                       mm=MultimodalConfig(num_image_tokens=4))
EMB_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def jax_params():
    return JM.init_metamorph_params(jax.random.PRNGKey(7), JCFG,
                                    dtype=jnp.float32)


def _port(params, cfg=CFG):
    return from_jax_params(jax.tree.map(np.asarray, params), cfg,
                           device="cpu")


@pytest.fixture(scope="module")
def pair(jax_params):
    return jax_params, _port(jax_params)


@pytest.fixture(scope="module")
def pair4():
    params = JM.init_metamorph_params(jax.random.PRNGKey(5), JCFG4,
                                      dtype=jnp.float32)
    return params, _port(params, CFG4)


@pytest.fixture(scope="module")
def forced_pair(jax_params):
    p = _forcing_image_start(jax_params)
    return p, _port(p)


def _ids(seed, n):
    return np.random.default_rng(seed).integers(10, 1000, (n,)).astype(
        np.int32)


def _embeds(params, model, ids):
    je = JL.embed_tokens(params["llama"], jnp.asarray(ids)[None])
    te = L.embed_tokens(model.llama, torch.from_numpy(ids)[None])
    return je, te


def check_same(out, ref, batched=False):
    """Equal ids / counts / steps, image embeddings within 1e-5."""
    rows = range(len(np.asarray(ref["n_ids"]))) if batched else [None]
    for b in rows:
        def g(d, k):
            x = np.asarray(d[k])
            return x if b is None else x[b]
        n, k = int(g(ref, "n_ids")), int(g(ref, "n_image_tokens"))
        assert int(g(out, "n_ids")) == n, (b, int(g(out, "n_ids")), n)
        np.testing.assert_array_equal(g(out, "ids"), g(ref, "ids"))
        assert int(g(out, "n_image_tokens")) == k
        np.testing.assert_allclose(g(out, "image_embeds")[:k],
                                   g(ref, "image_embeds")[:k], **EMB_TOL)
    np.testing.assert_array_equal(np.asarray(out["steps"]),
                                  np.asarray(ref["steps"]))


GREEDY_CASES = {
    "plain": dict(),
    "stop_ids": dict(stop_ids=(None,)),      # filled with a generated id
    "kv_int8": dict(kv_int8=True),
    "max_cache_len": dict(max_cache_len=40),
}


@pytest.mark.parametrize("case", sorted(GREEDY_CASES))
def test_greedy_decode_matches_jax(pair, case):
    params, model = pair
    kw = dict(GREEDY_CASES[case])
    ids = _ids(0, 9)
    je, te = _embeds(params, model, ids)
    if "stop_ids" in kw:
        # stop at the plain run's 4th generated id
        plain = jdecode.greedy_decode(params, JCFG, je, max_new_tokens=12,
                                      max_images=2)
        kw["stop_ids"] = (int(plain["ids"][3]),)
    ref = jdecode.greedy_decode(params, JCFG, je, max_new_tokens=12,
                                max_images=2, **kw)
    out = decode.greedy_decode(model, CFG, te, max_new_tokens=12,
                               max_images=2, **kw)
    check_same(out, ref)
    if case == "stop_ids":
        assert int(ref["n_ids"]) == 4


@pytest.mark.parametrize("start_in_image", [False, True])
def test_greedy_decode_image_feedback_matches_jax(forced_pair,
                                                  start_in_image):
    """The K-step continuous feedback loop: a head that prefers
    <image_start> (or a prompt that starts in image mode) runs image
    emissions through the vision head and projector."""
    params, model = forced_pair
    je, te = _embeds(params, model, _ids(3, 5))
    kw = dict(max_new_tokens=11, max_images=2, start_in_image=start_in_image)
    ref = jdecode.greedy_decode(params, JCFG, je, **kw)
    out = decode.greedy_decode(model, CFG, te, **kw)
    check_same(out, ref)
    assert int(ref["n_image_tokens"]) >= K


def _left_padded(params, model, rows, T0):
    B, D = len(rows), JCFG.llama.hidden_size
    je = np.zeros((B, T0, D), np.float32)
    mask = np.zeros((B, T0), np.int32)
    ids = np.zeros((B, T0), np.int32)
    for b, r in enumerate(rows):
        n = len(r)
        je[b, T0 - n:] = np.asarray(JL.embed_tokens(params["llama"],
                                                    jnp.asarray(r)))
        mask[b, T0 - n:] = 1
        ids[b, T0 - n:] = r
    te = torch.from_numpy(je.copy())
    return jnp.asarray(je), te, mask, ids


@pytest.mark.parametrize("head", ["text", "image_mode"])
def test_batched_greedy_decode_matches_jax(pair, forced_pair, head):
    """Three left-padded rows of unequal length; with the forcing head
    every row runs image emissions."""
    params, model = pair if head == "text" else forced_pair
    rows = [_ids(5, 3), _ids(6, 8), _ids(7, 5)]
    je, te, mask, _ = _left_padded(params, model, rows, 8)
    ref = jdecode.batched_greedy_decode(params, JCFG, je, jnp.asarray(mask),
                                        max_new_tokens=10, max_images=2)
    out = decode.batched_greedy_decode(model, CFG, te, mask,
                                       max_new_tokens=10, max_images=2)
    check_same(out, ref, batched=True)


def _image_batch(seed, padding_side="right", lens=(6,)):
    """Prompts with one image sentinel each, packed by the JAX packer (the
    port's is a copy), and pixels."""
    rng = np.random.default_rng(seed)
    K4 = CFG4.mm.num_image_tokens
    seqs = []
    for n in lens:
        ids = [128000] + rng.integers(10, 1000, (n,)).tolist()
        ids.insert(2, IMAGE_TOKEN_INDEX)
        seqs.append(ids)
    T = max(lens) + 1 + K4 + 3
    batch = jbatch(jpack(seqs, None, K4, T, len(lens),
                         padding_side=padding_side))
    s = JCFG.siglip.image_size
    px = rng.normal(size=(len(lens), s, s, 3)).astype(np.float32)
    return batch, px


def test_generate_with_pixels_matches_jax(pair4):
    params, model = pair4
    batch, px = _image_batch(11)
    ref = jdecode.generate(params, JCFG4,
                           {k: jnp.asarray(v) for k, v in batch.items()},
                           jnp.asarray(px), max_new_tokens=8, max_images=2)
    out = decode.generate(model, CFG4, batch, px, max_new_tokens=8,
                          max_images=2)
    check_same(out, ref)


def test_generate_batched_matches_jax(pair4):
    params, model = pair4
    batch, px = _image_batch(12, padding_side="left", lens=(4, 7))
    ref = jdecode.generate_batched(
        params, JCFG4, {k: jnp.asarray(v) for k, v in batch.items()},
        jnp.asarray(px), max_new_tokens=6, max_images=1)
    out = decode.generate_batched(model, CFG4, batch, px, max_new_tokens=6,
                                  max_images=1)
    check_same(out, ref, batched=True)


def _jax_masked_logits(monkeypatch, logits, temperature, top_p):
    """The logits JAX's `_sample_token` hands `jax.random.categorical`."""
    seen = {}

    def capture(key, lg, axis=-1):
        seen["logits"] = np.asarray(lg)
        return jnp.zeros(lg.shape[:-1], jnp.int32)

    monkeypatch.setattr(jax.random, "categorical", capture)
    jdecode._sample_token(jax.random.PRNGKey(0), jnp.asarray(logits),
                          temperature, top_p)
    return seen["logits"]


@pytest.mark.parametrize("temperature,top_p", [(1.0, 1.0), (0.7, 0.9),
                                               (2.0, 0.5), (1e-3, 0.95),
                                               (1.3, 0.999)])
def test_nucleus_logits_match_jax(monkeypatch, temperature, top_p):
    logits = np.random.default_rng(4).normal(size=(3, 1000)).astype(
        np.float32) * 3
    ref = _jax_masked_logits(monkeypatch, logits, temperature, top_p)
    out = decode.nucleus_logits(torch.from_numpy(logits), temperature, top_p)
    np.testing.assert_array_equal(out.numpy(), ref)
    if top_p < 1.0:
        assert (ref <= -1e29).any() and (ref > -1e29).any()


def test_sampling_seeded_repeats_and_cold_is_greedy(pair):
    params, model = pair
    _, te = _embeds(params, model, _ids(8, 6))

    def run(seed, **kw):
        g = torch.Generator()
        g.manual_seed(seed)
        return decode.greedy_decode(model, CFG, te, max_new_tokens=8,
                                    max_images=1, sample_rng=g, **kw)

    greedy = decode.greedy_decode(model, CFG, te, max_new_tokens=8,
                                  max_images=1)
    cold = run(0, do_sample=True, temperature=1e-6, top_p=0.9)
    np.testing.assert_array_equal(cold["ids"].numpy(), greedy["ids"].numpy())
    hot = [run(s, do_sample=True, temperature=2.0, top_p=0.95)
           for s in (1, 1, 2)]
    np.testing.assert_array_equal(hot[0]["ids"].numpy(),
                                  hot[1]["ids"].numpy())
    assert not np.array_equal(hot[0]["ids"].numpy(), hot[2]["ids"].numpy())
    batched = decode.batched_greedy_decode(
        model, CFG, te.repeat(2, 1, 1), np.ones((2, 6), np.int32),
        max_new_tokens=8, max_images=1, do_sample=True, temperature=1e-6,
        sample_rng=torch.Generator().manual_seed(3))
    for b in range(2):
        np.testing.assert_array_equal(batched["ids"][b].numpy(),
                                      greedy["ids"].numpy())


def test_truncate_at_keywords():
    assert decode.truncate_at_keywords("a cat.</s> more", ["</s>", "###"]) \
        == jdecode.truncate_at_keywords("a cat.</s> more", ["</s>", "###"]) \
        == "a cat."
    assert decode.truncate_at_keywords("plain", ["</s>"]) == "plain"
