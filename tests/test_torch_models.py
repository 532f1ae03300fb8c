"""PyTorch port, models: weights carried across with `convert.from_jax_params`
give the JAX package's outputs — LLaMA forward + lm head, prefill and a
ragged decode step, the SigLIP tower, image encoding, the token reduction
at SO400M geometry, the vision head, and the embedding fusion.

Both sides run the same fp32 weights on the CPU. Tolerances: 1e-4 absolute
for the LLaMA hidden states and logits (two layers of fp32 matmuls summed
in a different order; logits are sums over D=64 products) and 1e-5 for the
vision side (shallower)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metamorph_tpu.config import LlamaConfig as JLlamaConfig
from metamorph_tpu.config import MetaMorphConfig as JConfig
from metamorph_tpu.config import MultimodalConfig as JMM
from metamorph_tpu.config import SiglipConfig as JSiglipConfig
from metamorph_tpu.models import llama as JL
from metamorph_tpu.models import metamorph as JM
from metamorph_tpu.models import siglip as JS
from metamorph_tpu.multimodal.packing import batch_to_arrays, pack_sequences
from metamorph_tpu_torch.config import (_LATENT_AND_EXPERT_KEYS,
                                        LlamaConfig, MetaMorphConfig,
                                        MultimodalConfig, SiglipConfig,
                                        resolve_dtype)
from metamorph_tpu_torch.constants import IMAGE_TOKEN_INDEX
from metamorph_tpu_torch.convert import from_jax_params, init_params
from metamorph_tpu_torch.models import llama as L
from metamorph_tpu_torch.models import metamorph as M
from metamorph_tpu_torch.models import siglip as S

K = 4
JCFG = JConfig(llama=JLlamaConfig.tiny(), siglip=JSiglipConfig.tiny(),
               mm=JMM(num_image_tokens=K))
CFG = MetaMorphConfig(llama=LlamaConfig.tiny(), siglip=SiglipConfig.tiny(),
                      mm=MultimodalConfig(num_image_tokens=K))
LLM_TOL = dict(rtol=1e-4, atol=1e-4)
VIS_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def pair():
    jp = JM.init_metamorph_params(jax.random.PRNGKey(3), JCFG,
                                  dtype=jnp.float32)
    model = from_jax_params(jax.tree.map(np.asarray, jp), CFG, device="cpu")
    return jp, model


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_config_copy_matches_jax_package():
    """Same fields and defaults, so a config JSON round-trips across; the
    dtype names map to torch dtypes. The port's decoder config has the
    latent-attention and expert fields besides (a block the JAX package
    lacks), which a grouped-query config leaves out of its JSON."""
    assert resolve_dtype("bfloat16") is torch.bfloat16
    assert resolve_dtype("float32") is torch.float32
    d = JConfig().to_dict()
    assert MetaMorphConfig.from_dict(d) == MetaMorphConfig()
    assert MetaMorphConfig.from_json(CFG.to_json()) == CFG
    assert JConfig.from_json(MetaMorphConfig().to_json()) == JConfig()
    for mine, theirs in ((LlamaConfig(), JLlamaConfig()),
                         (SiglipConfig(), JSiglipConfig()),
                         (MultimodalConfig(), JMM())):
        extra = set(mine.__dict__) - set(theirs.__dict__)
        assert extra == (set(_LATENT_AND_EXPERT_KEYS)
                         if isinstance(mine, LlamaConfig) else set())
        assert {k: v for k, v in mine.__dict__.items()
                if k not in extra} == theirs.__dict__


def test_llama_forward_and_lm_head_match_jax(pair):
    jp, model = pair
    rng = np.random.default_rng(0)
    B, T = 2, 24
    ids = rng.integers(10, 1000, (B, T)).astype(np.int32)
    mask = np.ones((B, T), np.int32)
    mask[1, 17:] = 0
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T))
    emb = JL.embed_tokens(jp["llama"], jnp.asarray(ids))
    h_ref = JL.llama_forward(jp["llama"], JCFG.llama, emb, jnp.asarray(pos),
                             jnp.asarray(mask), attn_impl="xla")
    logits_ref = np.asarray(JL.lm_head(jp["llama"], JCFG.llama, h_ref))
    with torch.no_grad():
        h = L.llama_forward(model.llama, CFG.llama,
                            L.embed_tokens(model.llama, _t(ids)), _t(pos),
                            _t(mask))
        logits = L.lm_head(model.llama, CFG.llama, h).numpy()
    valid = mask.astype(bool)
    np.testing.assert_allclose(h.numpy()[valid], np.asarray(h_ref)[valid],
                               **LLM_TOL)
    np.testing.assert_allclose(logits[valid], logits_ref[valid], **LLM_TOL)


def test_prefill_and_ragged_decode_step_match_jax(pair):
    """prefill fills the cache rows; decode_step writes each row at its own
    position and attends over its own length (ragged cache_idx)."""
    jp, model = pair
    rng = np.random.default_rng(1)
    B, T, Smax = 2, 8, 32
    ids = rng.integers(10, 1000, (B, T)).astype(np.int32)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T))
    mask = np.ones((B, T), np.int32)
    jcache = JL.init_kv_cache(JCFG.llama, B, Smax, dtype=jnp.float32)
    _, jcache = JL.prefill(jp["llama"], JCFG.llama,
                           JL.embed_tokens(jp["llama"], jnp.asarray(ids)),
                           jnp.asarray(pos), jnp.asarray(mask), jcache)
    cache = L.init_kv_cache(CFG.llama, B, Smax, dtype=torch.float32)
    with torch.no_grad():
        L.prefill(model.llama, CFG.llama, L.embed_tokens(model.llama, _t(ids)),
                  _t(pos), _t(mask), cache)
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jcache["k"]),
                               **LLM_TOL)
    idx = np.asarray([T, T - 3], np.int32)      # ragged: row 1 rewinds
    x_ids = rng.integers(10, 1000, (B,)).astype(np.int32)
    jx = JL.embed_tokens(jp["llama"], jnp.asarray(x_ids))[:, None]
    jh, jcache = JL.decode_step(jp["llama"], JCFG.llama, jx,
                                jnp.asarray(idx)[:, None], jcache,
                                jnp.asarray(idx))
    with torch.no_grad():
        x = L.embed_tokens(model.llama, _t(x_ids))[:, None]
        h, cache = L.decode_step(model.llama, CFG.llama, x, _t(idx)[:, None],
                                 cache, _t(idx))
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **LLM_TOL)
    np.testing.assert_allclose(cache["v"].numpy(), np.asarray(jcache["v"]),
                               **LLM_TOL)


def test_siglip_and_encode_images_match_jax(pair):
    jp, model = pair
    s = JCFG.siglip.image_size
    pixels = np.random.default_rng(2).normal(size=(2, s, s, 3)).astype(
        np.float32)
    feats_ref = np.asarray(JS.siglip_encode(jp["siglip"], JCFG.siglip,
                                            jnp.asarray(pixels)))
    proj_ref, tgt_ref = JM.encode_images(jp, JCFG, jnp.asarray(pixels))
    with torch.no_grad():
        feats = S.siglip_encode(model.siglip, CFG.siglip, _t(pixels))
        proj, tgt = M.encode_images(model, CFG, _t(pixels))
    np.testing.assert_allclose(feats.numpy(), feats_ref, **VIS_TOL)
    np.testing.assert_allclose(proj.numpy(), np.asarray(proj_ref), **VIS_TOL)
    np.testing.assert_allclose(tgt.numpy(), np.asarray(tgt_ref), **VIS_TOL)


def test_reduce_tokens_interpolation_at_so400m_geometry():
    """729 patches -> 64 tokens: torch bilinear (align_corners=False, no
    antialias) is the same sampling as jax.image.resize 'linear'."""
    feats = np.random.default_rng(4).normal(size=(2, 729, 16)).astype(
        np.float32)
    ref = np.asarray(JS.reduce_tokens(jnp.asarray(feats),
                                      JMM(num_image_tokens=64)))
    out = S.reduce_tokens(_t(feats), MultimodalConfig(num_image_tokens=64))
    np.testing.assert_allclose(out.numpy(), ref, **VIS_TOL)


def test_vision_head_and_fusion_match_jax(pair):
    jp, model = pair
    D = JCFG.llama.hidden_size
    h = np.random.default_rng(5).normal(size=(3, D)).astype(np.float32)
    ref = np.asarray(JM.apply_vision_head(jp, JCFG, jnp.asarray(h)))
    with torch.no_grad():
        out = M.apply_vision_head(model, CFG, _t(h)).numpy()
    np.testing.assert_allclose(out, ref, **VIS_TOL)

    ids = [[1, 2, IMAGE_TOKEN_INDEX, 7, 8], [4, IMAGE_TOKEN_INDEX, 6]]
    batch = batch_to_arrays(pack_sequences(ids, None, K, 16, 2))
    proj = np.random.default_rng(6).normal(size=(2, K, D)).astype(np.float32)
    fused_ref = np.asarray(JM.fuse_embeddings(
        jp, JCFG, {k: jnp.asarray(v) for k, v in batch.items()},
        jnp.asarray(proj)))
    with torch.no_grad():
        fused = M.fuse_embeddings(model, CFG,
                                  {k: _t(v) for k, v in batch.items()},
                                  _t(proj)).numpy()
    np.testing.assert_allclose(fused, fused_ref, **VIS_TOL)


def test_init_params_scales_and_determinism():
    """init_params follows the JAX init scales and is a function of the
    seed."""
    a = init_params(CFG, seed=0, device="cpu", dtype=torch.float32)
    b = init_params(CFG, seed=0, device="cpu", dtype=torch.float32)
    c = init_params(CFG, seed=1, device="cpu", dtype=torch.float32)
    assert torch.equal(a.llama.layers[0].wq, b.llama.layers[0].wq)
    assert not torch.equal(a.llama.layers[0].wq, c.llama.layers[0].wq)
    D = CFG.llama.hidden_size
    std = a.llama.embed.std().item()
    assert abs(std - D ** -0.5) < 0.1 * D ** -0.5
    assert torch.all(a.llama.final_norm == 1)
    bound = CFG.siglip.hidden_size ** -0.5
    w0 = a.projector.layers[0].kernel
    assert w0.abs().max().item() <= bound
    assert all(torch.isfinite(p).all() for p in a.parameters())
