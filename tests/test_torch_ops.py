"""PyTorch port, attention ops: the plain versions behind the kernel
wrappers (what CPU tensors run) against the JAX package's Pallas kernels in
interpret mode — forward (flash, decode with bf16-valued and int8 caches,
the fill and verify chunk kernels), and the backward through the port's
autograd Function against `jax.grad` through the JAX custom VJP — plus
`quantize_kv`, the wrappers' routing and the package's JAX-free imports.

Tolerances: both sides compute in fp32 on the CPU; they differ only in the
order of the fp32 sums (the Pallas kernels stream key blocks with an online
softmax, the port's plain versions take one softmax over all keys), so
2e-5 absolute/relative, the JAX package's own kernel-vs-XLA tolerance, on
flash outputs and 1e-5 on the decode and chunk outputs (fewer, shorter
sums); gradients are sums over up to 512 keys of such terms, so 1e-4
(the JAX package holds its backward to 2e-4 against XLA). The plain
backward against autograd through the plain forward: 1e-5 (the same fp32
products, another association)."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metamorph_tpu.ops import quant as jquant
from metamorph_tpu.ops.decode_attention import chunk_attention as jax_chunk
from metamorph_tpu.ops.decode_attention import \
    chunk_attention_batched as jax_chunk_batched
from metamorph_tpu.ops.decode_attention import decode_attention as jax_decode
from metamorph_tpu.ops.flash_attention import flash_attention as jax_flash
from metamorph_tpu.ops.flash_attention import \
    flash_attention_with_lse as jax_flash_lse
from metamorph_tpu_torch.ops import decode_attention as da
from metamorph_tpu_torch.ops import flash_attention as fa
from metamorph_tpu_torch.ops.quant import quantize_kv

TOL = dict(rtol=2e-5, atol=2e-5)
ATT_TOL = dict(rtol=1e-5, atol=1e-5)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's side on one CPU thread. With torch's default thread count
    the plain flash forward on a loaded machine (several test workers at
    once) now and then gives an output up to ~1e-4 away from its usual
    bits, past TOL, where one thread never has: the multithreaded CPU
    path is not reproducible under load, so these comparisons pin it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _mask(B, T, lens):
    m = np.zeros((B, T), np.int32)
    for b, n in enumerate(lens):
        m[b, :n] = 1
    return m


@pytest.mark.parametrize("B,T,H,KV,Dh,lens,causal", [
    (2, 256, 4, 4, 64, None, True),           # MHA
    (2, 256, 4, 2, 64, None, True),           # GQA x2
    (1, 384, 8, 2, 64, None, True),           # GQA x4, 3 blocks
    (2, 256, 4, 2, 64, (100, 256), True),     # ragged attn_mask
    (2, 256, 4, 2, 64, (200, 256), False),    # non-causal with padding
], ids=["mha", "gqa2", "gqa4", "ragged", "noncausal"])
def test_flash_plain_matches_jax_kernel(B, T, H, KV, Dh, lens, causal):
    q, k, v = (_np((B, T, H, Dh), 0), _np((B, T, KV, Dh), 1),
               _np((B, T, KV, Dh), 2))
    mask = None if lens is None else _mask(B, T, lens)
    ref = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               attn_mask=None if mask is None
                               else jnp.asarray(mask),
                               causal=causal, block_q=128, block_k=128))
    out = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v),
                             attn_mask=None if mask is None
                             else torch.from_numpy(mask),
                             causal=causal).numpy()
    assert np.isfinite(out).all()
    if mask is None:
        np.testing.assert_allclose(out, ref, **TOL)
    else:
        valid = mask.astype(bool)
        np.testing.assert_allclose(out[valid], ref[valid], **TOL)
        # padded query rows attend to the valid keys in both (not zeros)
        np.testing.assert_allclose(out[~valid], ref[~valid], **TOL)


def test_flash_plain_matches_jax_triangle_kernel(monkeypatch):
    """T=256 with FLASH_TRI_BLOCK=128 takes the JAX package's triangle-grid
    kernel (`_fwd_kernel_tri`, log2-domain softmax), here with a padded
    row crossing a block boundary."""
    monkeypatch.setenv("FLASH_TRI_BLOCK", "128")
    monkeypatch.setenv("FLASH_TRI_BLOCK_K", "128")
    B, T, H, KV, Dh = 2, 256, 4, 2, 64
    q, k, v = (_np((B, T, H, Dh), 3), _np((B, T, KV, Dh), 4),
               _np((B, T, KV, Dh), 5))
    mask = _mask(B, T, (150, 256))
    ref = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               attn_mask=jnp.asarray(mask), causal=True))
    out = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v),
                             attn_mask=torch.from_numpy(mask)).numpy()
    valid = mask.astype(bool)
    np.testing.assert_allclose(out[valid], ref[valid], **TOL)
    assert np.isfinite(out[~valid]).all()


@pytest.mark.parametrize("causal", [True, False])
def test_flash_with_lse_matches_jax(causal):
    """Kernel layout [B,H,T,Dh] with per-row lengths: o and the logsumexp."""
    B, H, KV, T, Dh = 2, 4, 2, 128, 64
    q, k, v = (_np((B, H, T, Dh), 6), _np((B, KV, T, Dh), 7),
               _np((B, KV, T, Dh), 8))
    lengths = np.asarray([77, 128], np.int32)
    o_ref, lse_ref = jax_flash_lse(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), jnp.asarray(lengths),
                                   causal=causal, block_q=64, block_k=64)
    o, lse = fa.flash_attention_with_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lengths), causal=causal)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), **TOL)


def test_plain_attention_helpers_match_jax():
    """make_causal_mask, repeat_kv and dot_product_attention (the plain
    path SigLIP uses) against the JAX package's."""
    from metamorph_tpu.ops import attention as jatt
    from metamorph_tpu_torch.ops import attention as att

    mask = _mask(2, 12, (7, 12))
    np.testing.assert_array_equal(
        att.make_causal_mask(torch.from_numpy(mask)).numpy(),
        np.asarray(jatt.make_causal_mask(jnp.asarray(mask))))
    q, k = _np((2, 12, 4, 16), 16), _np((2, 12, 2, 16), 17)
    np.testing.assert_array_equal(att.repeat_kv(torch.from_numpy(k), 2).numpy(),
                                  np.asarray(jatt.repeat_kv(jnp.asarray(k), 2)))
    m = jatt.make_causal_mask(jnp.asarray(mask))
    ref = jatt.dot_product_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(k), mask=m)
    out = att.dot_product_attention(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(k),
                                    mask=torch.from_numpy(np.array(m)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_flash_empty_row_is_zero_with_neg_inf_lse():
    """A row with no visible key (length 0): o = 0, lse = -1e30, as the
    JAX kernels' `_finish` writes it."""
    q = torch.randn(1, 2, 8, 64)
    k = torch.randn(1, 1, 8, 64)
    o, lse = fa.flash_attention_with_lse(q, k, k.clone(),
                                         torch.tensor([0], dtype=torch.int32))
    assert torch.all(o == 0) and torch.all(lse == fa.NEG_INF)


@pytest.mark.parametrize("layer,with_starts", [(0, False), (1, False),
                                               (1, True)])
def test_decode_plain_matches_jax_kernel(layer, with_starts):
    """Stacked cache [L,B,KV,S,Dh] with a layer index, ragged lengths and
    (optionally) per-row starts, against the Pallas decode kernel."""
    L, B, H, KV, S, Dh = 2, 3, 8, 2, 256, 64
    q = _np((B, H, Dh), 10)
    k, v = _np((L, B, KV, S, Dh), 11), _np((L, B, KV, S, Dh), 12)
    lengths = np.asarray([17, 256, 130], np.int32)
    starts = np.asarray([3, 0, 100], np.int32) if with_starts else None
    ref = np.asarray(jax_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
        starts=None if starts is None else jnp.asarray(starts),
        block_s=64, layer=layer))
    out = da.decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lengths),
        starts=None if starts is None else torch.from_numpy(starts),
        layer=layer).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


def test_decode_unstacked_cache_and_empty_window():
    """[B,KV,S,Dh] cache without a layer; an empty window gives 0, as the
    Pallas kernel gives it."""
    B, H, KV, S, Dh = 2, 4, 2, 64, 64
    q, k, v = _np((B, H, Dh), 13), _np((B, KV, S, Dh), 14), _np((B, KV, S, Dh), 15)
    lengths = np.asarray([40, 5], np.int32)
    starts = np.asarray([0, 5], np.int32)      # row 1: [5, 5) is empty
    ref = np.asarray(jax_decode(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(lengths),
                                starts=jnp.asarray(starts), block_s=64))
    out = da.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), torch.from_numpy(lengths),
                              starts=torch.from_numpy(starts)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)
    assert np.all(out[1] == 0)
    with pytest.raises(ValueError):
        da.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), torch.from_numpy(lengths),
                            layer=0)


def _bf16_valued(x):
    """fp32 values that a bf16 cache holds."""
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _int8_cache(k, v):
    """(k int8, v int8, k_scale, v_scale) as numpy, quantized by the JAX
    package's quantize_kv."""
    kq, ks = jquant.quantize_kv(jnp.asarray(k))
    vq, vs = jquant.quantize_kv(jnp.asarray(v))
    return tuple(np.array(a) for a in (kq, vq, ks, vs))


def test_quantize_kv_matches_jax():
    """Same int8 entries (a +-1 step allowed on <= 0.1 % of them, where an
    fp32 quotient lands on a half) and scales within 1e-6."""
    x = _np((3, 2, 4, 50, 64), 40) * 3.0
    x[0, 0, 0, 0] = 0.0                      # an all-zero vector: scale 1e-8/127
    q_ref, s_ref = (np.asarray(a) for a in jquant.quantize_kv(jnp.asarray(x)))
    q, s = quantize_kv(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_allclose(s.numpy(), s_ref, rtol=1e-6, atol=0)
    diff = np.abs(q.numpy().astype(np.int32) - q_ref.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    assert np.abs(q.numpy()).max() == 127


@pytest.mark.parametrize("layer,with_starts", [(0, False), (1, True)])
def test_decode_int8_plain_matches_jax_kernel(layer, with_starts):
    """int8 cache with per-(token, kv head) scales, stacked with a layer:
    the plain version against the Pallas decode kernel's int8 branch."""
    L, B, H, KV, S, Dh = 2, 3, 8, 2, 256, 64
    q = _np((B, H, Dh), 41)
    kq, vq, ks, vs = _int8_cache(_np((L, B, KV, S, Dh), 42),
                                 _np((L, B, KV, S, Dh), 43))
    lengths = np.asarray([17, 256, 130], np.int32)
    starts = np.asarray([3, 0, 100], np.int32) if with_starts else None
    ref = np.asarray(jax_decode(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq),
        jnp.asarray(lengths),
        starts=None if starts is None else jnp.asarray(starts), block_s=64,
        layer=layer, k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs)))
    t = torch.from_numpy
    out = da.decode_attention(
        t(q), t(kq), t(vq), t(lengths),
        starts=None if starts is None else t(starts), layer=layer,
        k_scale=t(ks), v_scale=t(vs)).numpy()
    np.testing.assert_allclose(out, ref, **ATT_TOL)


def _split_windows(split, S):
    """(start, length) rows around one split length: shorter than a split,
    starting mid-split, ending at a split boundary and one either side,
    spanning boundaries, the whole cache, and an empty window."""
    return [(3, 10), (split // 2 + 1, split + 5), (0, split),
            (0, split + 1), (1, split - 1), (split - 1, 2 * split + 1),
            (0, S), (7, 7)]


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("split", [16, 64, 256])
def test_decode_split_merge_matches_plain_and_jax(split, quant):
    """`merge_partials`, kernel B's split-and-merge arithmetic in fp32,
    against the plain version and the Pallas decode kernel: each window
    cut into fixed splits, an (m, l, o) per split, merged in split order.
    The empty window gives 0."""
    L, H, KV, S, Dh = 2, 8, 2, 576, 64
    rows = _split_windows(split, S)
    B = len(rows)
    starts = np.asarray([r[0] for r in rows], np.int32)
    lengths = np.asarray([r[1] for r in rows], np.int32)
    q = _np((B, H, Dh), 50 + split)
    k, v = _np((L, B, KV, S, Dh), 51), _np((L, B, KV, S, Dh), 52)
    scales = {}
    if quant:
        k, v, ks, vs = _int8_cache(k, v)
        scales = dict(k_scale=ks, v_scale=vs)
    ref = np.asarray(jax_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
        starts=jnp.asarray(starts), block_s=64, layer=1,
        **{n: jnp.asarray(x) for n, x in scales.items()}))
    t = torch.from_numpy
    lay = {n: t(x[1]) for n, x in scales.items()}
    merged = da.merge_partials(t(q), t(k[1]), t(v[1]), t(lengths), t(starts),
                               split, **lay).numpy()
    plain = da.decode_attention_plain(t(q), t(k[1]), t(v[1]), t(lengths),
                                      t(starts), **lay).numpy()
    np.testing.assert_allclose(merged, plain, **ATT_TOL)
    np.testing.assert_allclose(merged, ref, **ATT_TOL)
    assert np.all(merged[-1] == 0)               # [7, 7) is empty


def test_split_counts_read_only_host_sizes():
    """Kernel B's, the fill kernel's and the verify kernel's split counts
    are functions of host-known sizes (S, batch, heads, SM count), never
    of the rows' lengths or offsets, which live on the device. Kernel B's
    grid holds about four CTAs per SM at the decode step's shape (B = 8,
    KV = 8, S = 4096) and spreads a single 4,096-key row over 256 CTAs;
    the fill form at C = 256 fills about one wave; the verify form at the
    spec step's shape (NB = 8, KV = 8, S = 4108) holds VERIFY_CTAS_PER_SM
    CTAs per SM, and each of its splits starts inside S."""
    import inspect

    assert list(inspect.signature(da.decode_splits).parameters) == [
        "S", "B", "KV", "sm_count"]
    assert list(inspect.signature(da.fill_splits).parameters) == [
        "S", "NB", "C", "G", "KV", "sm_count"]
    assert list(inspect.signature(da.verify_splits).parameters) == [
        "S", "NB", "KV", "sm_count"]
    for S, NB, KV in ((4108, 8, 8), (4108, 1, 8), (600, 5, 2), (64, 2, 1),
                      (33, 1, 1), (70000, 1, 1)):
        n = da.verify_splits(S, NB, KV, 132)
        split = da.verify_split_len(S, n)
        assert 1 <= n <= da.MAX_SPLITS and split % da.SPLIT_QUANTUM == 0
        assert split * (n - 1) < S <= split * n
    assert da.VERIFY_CTAS_PER_SM == 4
    assert da.verify_splits(4108, 8, 8, 132) == 9           # 576 CTAs
    assert da.verify_split_len(4108, 9) == 512
    for S, B, KV in ((4096, 8, 8), (4096, 1, 8), (700, 4, 2), (4108, 8, 8),
                     (33, 2, 1)):
        split, n = da.decode_splits(S, B, KV, 132)
        assert split % da.SPLIT_QUANTUM == 0
        assert split * (n - 1) < S <= split * n
    assert da.decode_splits(4096, 8, 8, 132) == (512, 8)    # 512 CTAs
    assert da.decode_splits(4096, 1, 8, 132) == (128, 32)   # 256 CTAs
    n = da.fill_splits(4096, 1, 256, 4, 8, 132)
    assert n == 2 and 64 * n <= 132
    assert da.fill_splits(4096, 8, 256, 4, 8, 132) == 1
    assert da.fill_splits(300, 1, 64, 2, 2, 132) == 1


def _verify_offsets(split, S, C):
    """Chunk offsets around one split length: the visible range [0,
    off + C) cut inside by a split boundary, ending exactly at a boundary
    (off + C - 1 is a split's last key), ending one key either side of it,
    in the first split only (the rest lie wholly past it), and at S - C."""
    return [split + 5, 2 * split - C, 2 * split - C + 1, 2 * split - C - 1,
            0, S - C]


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("split", [16, 64, 128])
def test_verify_split_merge_matches_plain_and_jax(split, quant):
    """`verify_merge_partials`, kernel E verify form's split-and-merge
    arithmetic in fp32, against the plain version and the Pallas
    `_chunk_kernel_batched`: each chunk's row cut into fixed splits, an
    (m, l, o) per split, merged in split order, with large stale entries
    past each chunk that only the mask keeps out."""
    S, C, H, KV, Dh = 320, 4, 8, 2, 32
    offs = np.asarray(_verify_offsets(split, S, C), np.int32)
    B = len(offs)
    k, v, ks, vs = _chunk_cache(quant, 48 + split, B=B, KV=KV, S=S, Dh=Dh,
                                junk_from={b: int(o) + C
                                           for b, o in enumerate(offs)})
    q = _np((B, C, H, Dh), 49 + split)
    layer = 1
    jkw = {} if ks is None else dict(k_scale=jnp.asarray(ks),
                                     v_scale=jnp.asarray(vs))
    ref = np.asarray(jax_chunk_batched(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(offs),
        layer=layer, block_s=16, **jkw))
    t = torch.from_numpy
    lay = {} if ks is None else dict(k_scale=t(ks[layer]),
                                     v_scale=t(vs[layer]))
    merged = da.verify_merge_partials(t(q), t(k[layer]), t(v[layer]),
                                      t(offs), split, **lay).numpy()
    plain = da.chunk_attention_plain(t(q), t(k[layer]), t(v[layer]),
                                     t(offs), **lay).numpy()
    np.testing.assert_allclose(merged, plain, **ATT_TOL)
    np.testing.assert_allclose(merged, ref, **ATT_TOL)


def _chunk_cache(quant, seed, L=2, B=3, KV=2, S=64, Dh=32, junk_from=None):
    """Stacked cache as numpy (bf16-valued fp32, or int8 + scales). Rows
    listed in `junk_from` {row: position} get large stale values from that
    position on: only the mask keeps them out."""
    k, v = _np((L, B, KV, S, Dh), seed), _np((L, B, KV, S, Dh), seed + 1)
    for row, p in (junk_from or {}).items():
        k[:, row, :, p:] = 40.0
        v[:, row, :, p:] = -60.0
    if quant:
        return _int8_cache(k, v)
    return _bf16_valued(k), _bf16_valued(v), None, None


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_chunk_plain_matches_jax_fill_kernel(quant):
    """`chunk_attention` (kernel E's K6 form) against the Pallas
    `_chunk_kernel`: several slots and offsets, offset 0 and S - C, stale
    junk past the chunk."""
    S, C, H, Dh = 64, 8, 4, 32
    for slot, off in ((0, 0), (2, 24), (1, S - C)):
        k, v, ks, vs = _chunk_cache(quant, 44 + off, S=S, Dh=Dh,
                                    junk_from={slot: off + C})
        q = _np((C, H, Dh), 45 + slot)
        for layer in (0, 1):
            jkw = {} if ks is None else dict(k_scale=jnp.asarray(ks),
                                             v_scale=jnp.asarray(vs))
            ref = np.asarray(jax_chunk(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), jnp.int32(slot),
                                       jnp.int32(off), layer=layer,
                                       block_s=16, **jkw))
            tkw = {} if ks is None else dict(k_scale=torch.from_numpy(ks),
                                             v_scale=torch.from_numpy(vs))
            out = da.chunk_attention(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), slot, off,
                                     layer=layer, **tkw).numpy()
            np.testing.assert_allclose(out, ref, **ATT_TOL,
                                       err_msg=f"slot {slot} off {off}")


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_chunk_batched_plain_matches_jax_verify_kernel(quant):
    """`chunk_attention_batched` (kernel E's K7 form) against the Pallas
    `_chunk_kernel_batched`: ragged offsets including 0 and S - C, stale
    junk past each row's chunk."""
    B, S, C, H, Dh = 3, 64, 4, 8, 32
    offs = np.asarray([0, 37, S - C], np.int32)
    k, v, ks, vs = _chunk_cache(quant, 46, B=B, S=S, Dh=Dh,
                                junk_from={b: int(o) + C
                                           for b, o in enumerate(offs)})
    q = _np((B, C, H, Dh), 47)
    for layer in (0, 1):
        jkw = {} if ks is None else dict(k_scale=jnp.asarray(ks),
                                         v_scale=jnp.asarray(vs))
        ref = np.asarray(jax_chunk_batched(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(offs),
            layer=layer, block_s=16, **jkw))
        tkw = {} if ks is None else dict(k_scale=torch.from_numpy(ks),
                                         v_scale=torch.from_numpy(vs))
        out = da.chunk_attention_batched(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(offs), layer=layer, **tkw).numpy()
        np.testing.assert_allclose(out, ref, **ATT_TOL)


def _grads_port(q, k, v, loss):
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    loss(qt, kt, vt).backward()
    return qt.grad.numpy(), kt.grad.numpy(), vt.grad.numpy()


def _masked_sq(o, mask):
    return (o * o * mask[:, :, None, None]).sum()


@pytest.mark.parametrize("grid,T,lens,bwd_blocks,wide", [
    ("rect", 256, (200,), None, None),       # T=256 ragged: K4 (`_bwd`)
    ("tri", 512, (300, 512), (128, 128), None),   # K3 square (`_bwd_tri`)
    ("tri_rect", 512, (300, 512), (64, 64), "256"),
], ids=["K4", "K3", "K3-wide"])
def test_flash_backward_matches_jax_kernels(monkeypatch, grid, T, lens,
                                            bwd_blocks, wide):
    """jax.grad through the JAX flash custom VJP (Pallas backward kernels in
    interpret mode) against autograd through the port's Function, on the
    three grids and losses of tests/test_flash_attention.py:77-151."""
    if wide:
        monkeypatch.setenv("FLASH_TRI_BLOCK_BWD_WIDE", wide)
    B, H, KV, Dh = len(lens), 4, 2, 64
    seed = {"rect": 6, "tri": 9, "tri_rect": 20}[grid]
    q, k, v = (_np((B, T, H, Dh), seed), _np((B, T, KV, Dh), seed + 1),
               _np((B, T, KV, Dh), seed + 2))
    mask = _mask(B, T, lens)
    kw = {} if bwd_blocks is None else dict(block_q_bwd=bwd_blocks[0],
                                            block_k_bwd=bwd_blocks[1])
    jm = jnp.asarray(mask)

    def jloss(q, k, v):
        o = jax_flash(q, k, v, attn_mask=jm, causal=True, **kw)
        return jnp.sum(o * o * jm[:, :, None, None])

    ref = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tm = torch.from_numpy(mask).float()
    got = _grads_port(q, k, v, lambda q, k, v: _masked_sq(
        fa.flash_attention(q, k, v, attn_mask=torch.from_numpy(mask)), tm))
    for a, b, name in zip(got, ref, "qkv"):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("H,KV,lens", [
    (4, 2, (192, 100)),            # GQA x2
    (8, 2, (192, 0)),              # GQA x4, a row with no visible key
], ids=["gqa2", "gqa4-empty-row"])
def test_flash_with_lse_backward_matches_jax(H, KV, lens):
    """Non-causal, T != S, with a loss on the logsumexp too: the lse
    cotangent (K4's dlse term) through both packages."""
    B, T, S, Dh = 2, 128, 192, 64
    q, k, v = (_np((B, H, T, Dh), 30), _np((B, KV, S, Dh), 31),
               _np((B, KV, S, Dh), 32))
    w = _np((B, H, T), 33)
    lengths = np.asarray(lens, np.int32)

    def jloss(q, k, v):
        o, lse = jax_flash_lse(q, k, v, jnp.asarray(lengths), causal=False,
                               block_q=64, block_k=64, block_q_bwd=64,
                               block_k_bwd=64)
        # an empty row's lse is -1e30: weight only the finite ones
        return jnp.sum(o * o) + jnp.sum(jnp.where(lse > -1e29, lse, 0) * w)

    ref = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tw = torch.from_numpy(w)

    def tloss(q, k, v):
        o, lse = fa.flash_attention_with_lse(q, k, v,
                                             torch.from_numpy(lengths),
                                             causal=False)
        return (o * o).sum() + (torch.where(lse > -1e29, lse, 0) * tw).sum()

    got = _grads_port(q, k, v, tloss)
    for a, b, name in zip(got, ref, "qkv"):
        assert np.isfinite(a).all(), name
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-4,
                                   err_msg=name)
    if lens[1] == 0:
        assert np.all(got[0][1] == 0) and np.all(got[1][1] == 0)


@pytest.mark.parametrize("B,H,KV,T,S,lens,causal", [
    (2, 4, 2, 70, 70, (70, 33), True),
    (2, 8, 2, 40, 90, (90, 0), False),
    (1, 4, 4, 64, 64, (64,), True),
])
def test_flash_bwd_plain_matches_autograd(B, H, KV, T, S, lens, causal):
    """`flash_attention_bwd_plain` (the backward the CPU path and the
    kernels' checks use) against torch.autograd through
    `flash_attention_plain`, with an lse cotangent."""
    g = torch.Generator().manual_seed(B * T + S)
    q = torch.randn(B, H, T, 32, generator=g, requires_grad=True)
    k = torch.randn(B, KV, S, 32, generator=g, requires_grad=True)
    v = torch.randn(B, KV, S, 32, generator=g, requires_grad=True)
    do = torch.randn(B, H, T, 32, generator=g)
    lengths = torch.tensor(lens, dtype=torch.int32)
    o, lse = fa.flash_attention_plain(q, k, v, lengths, causal)
    dlse = torch.randn(B, H, T, generator=g) * (lse > -1e29)
    ref = torch.autograd.grad((o * do).sum() + (lse * dlse).sum(), (q, k, v))
    got = fa.flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(),
                                       o.detach(), lse.detach(), do, dlse,
                                       lengths, causal)
    for a, b, name in zip(got, ref, "qkv"):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def test_cpu_tensors_take_plain_path_and_count_no_launch():
    """CPU tensors run the plain versions and leave every launch counter
    at 0; a tensor on another device (meta) goes to the kernel route and is
    refused there with no launch."""
    kernels = (fa.FLASH_FWD, fa.FLASH_BWD_DQ, fa.FLASH_BWD_DKV,
               da.DECODE_ATTN, da.DECODE_ATTN_INT8, da.CHUNK_ATTN,
               da.CHUNK_ATTN_INT8)
    q = torch.randn(1, 16, 4, 64, requires_grad=True)
    k = torch.randn(1, 16, 2, 64)
    fa.flash_attention(q, k, k).sum().backward()     # plain fwd + bwd
    fa.flash_attention_with_lse(q.transpose(1, 2), k.transpose(1, 2),
                                k.transpose(1, 2))
    cache = torch.randn(2, 1, 2, 16, 64)
    qd = q.detach()
    da.decode_attention(qd[:, 0], cache, cache,
                        torch.tensor([9], dtype=torch.int32), layer=1)
    c8, sc = quantize_kv(cache)
    da.decode_attention(qd[:, 0], c8, c8, torch.tensor([9], dtype=torch.int32),
                        layer=1, k_scale=sc, v_scale=sc)
    da.chunk_attention(qd[0, :4], c8, c8, 0, 3, layer=0, k_scale=sc,
                       v_scale=sc)
    da.chunk_attention_batched(qd[:, :4], cache, cache,
                               torch.tensor([2], dtype=torch.int32), layer=1)
    meta = torch.empty(1, 16, 4, 64, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        fa.flash_attention(meta, meta[:, :, :2], meta[:, :, :2])
    with pytest.raises(ValueError):
        da.chunk_attention_batched(meta[:, :4], cache.to("meta"),
                                   cache.to("meta"),
                                   torch.zeros(1, dtype=torch.int32,
                                               device="meta"), layer=0)
    assert [kern.launches for kern in kernels] == [0] * len(kernels)
    assert all(not kern.sites and not kern.forms for kern in kernels)


def test_package_imports_without_jax():
    """Every module of metamorph_tpu_torch imports in a process where
    neither JAX nor the JAX package can be imported, and none of them pulls
    either in. The decode entry points, the front ends and the visualizer
    are named, so that they stay among the modules walked."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['metamorph_tpu'] = None\n"
        "import metamorph_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m == 'metamorph_tpu' or "
        "m.startswith('metamorph_tpu.') or m.startswith('jax')]\n"
        "assert not [m for m in bad if sys.modules[m] is not None], bad\n"
        "print(' '.join(names))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    names = set(res.stdout.split())
    assert len(names) >= 31
    assert {f"metamorph_tpu_torch.inference.{m}" for m in (
        "decode", "spec_decode", "demo", "serve_cli", "serve_http")} <= names
    assert {f"metamorph_tpu_torch.visualizer.{m}" for m in (
        "scheduler", "adapter", "unet", "vae", "pipeline", "hf_import",
        "params")} <= names
