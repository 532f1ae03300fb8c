"""PyTorch port, CUDA kernels on the card: each kernel against its plain
PyTorch version (fp32 math and fp32 output from the same bf16 inputs), the
launch counters,
and the wrappers' input checks; kernel G (Triton) and the routed experts'
grouped products against their plain forms and the reference; the serving
engine's plain ticks replayed from CUDA graphs against its eager ticks
(dense and on the DeepSeek-V3 block); the visualizer's render on the card
against the CPU, and its loader's device rule; the offloaded AdamW
(pinned moments, bitwise the on-card update, a failed pin raising).
Skips where there is no CUDA device.

On a machine with an NVIDIA GPU (and no JAX, which tests/conftest.py
imports):  python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: 2e-2 on bf16 outputs (a bf16 rounding of |o| up to ~4 plus
the bf16 probability tile the flash and chunk kernels feed their PV
products; for the int8 caches the plain version reads the same int8
entries and scales, so quantization adds nothing), 2e-3 on the fp32
logsumexp (only the order of fp32 sums differs). The backward
kernels are held to 3e-2 of max|ref| for each of dq, dk, dv: P and dS
enter their tensor-core products rounded to bf16 (relative 2**-9 each),
and the outputs are bf16."""

import ctypes

import pytest
import torch

from metamorph_tpu_torch.kernels._build import Kernel
from metamorph_tpu_torch.ops import decode_attention as da
from metamorph_tpu_torch.ops import flash_attention as fa
from metamorph_tpu_torch.ops.quant import quantize_kv

pytestmark = pytest.mark.cuda

O_TOL, LSE_TOL = 2e-2, 2e-3
BWD_TOL = 3e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _randn(gen, dev, *shape):
    return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)


@pytest.mark.parametrize("Dh", [64, 128])
@pytest.mark.parametrize("B,T,S,H,KV,lens,causal", [
    (2, 300, 300, 8, 2, [300, 131], True),
    (1, 64, 64, 4, 4, [64], True),
    (2, 100, 257, 8, 1, [257, 1], False),
    (1, 70, 70, 2, 1, [0], True),                # no visible key
])
def test_flash_kernel_matches_plain(dev, B, T, S, H, KV, lens, causal, Dh):
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (_randn(gen, dev, B, H, T, Dh), _randn(gen, dev, B, KV, S, Dh),
               _randn(gen, dev, B, KV, S, Dh))
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    n0 = fa.FLASH_FWD.launches
    o, lse = fa.flash_attention_with_lse(q, k, v, lengths, causal=causal)
    torch.cuda.synchronize()
    assert fa.FLASH_FWD.launches == n0 + 1
    ro, rlse = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                        lengths, causal)
    assert (o.float() - ro).abs().max().item() <= O_TOL
    assert (lse - rlse).abs().max().item() <= LSE_TOL
    # model layout, read through strides
    mask = torch.arange(S, device=dev)[None] < lengths[:, None]
    om = fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), attn_mask=mask, causal=causal)
    assert torch.equal(om.transpose(1, 2), o)


@pytest.mark.parametrize("Dh", [64, 128])
@pytest.mark.parametrize("G", [1, 2, 4, 8])
def test_decode_kernel_matches_plain(dev, G, Dh):
    gen = torch.Generator(device=dev).manual_seed(1)
    L, B, KV, S = 3, 4, 2, 700
    q = _randn(gen, dev, B, KV * G, Dh)
    ck, cv = _randn(gen, dev, L, B, KV, S, Dh), _randn(gen, dev, L, B, KV, S, Dh)
    lengths = torch.tensor([1, 700, 257, 33], dtype=torch.int32, device=dev)
    starts = torch.tensor([0, 300, 256, 33], dtype=torch.int32, device=dev)
    for st in (None, starts):
        n0 = da.DECODE_ATTN.launches
        o = da.decode_attention(q, ck, cv, lengths, starts=st, layer=2)
        torch.cuda.synchronize()
        assert da.DECODE_ATTN.launches == n0 + 1
        ref = da.decode_attention_plain(q.float(), ck[2].float(),
                                        cv[2].float(), lengths, st)
        assert (o.float() - ref).abs().max().item() <= O_TOL
    assert torch.all(o[3] == 0)             # empty window [33, 33)


@pytest.mark.parametrize("Dh", [64, 128])
@pytest.mark.parametrize("G", [1, 2, 4, 8])
def test_decode_int8_kernel_matches_plain(dev, G, Dh):
    """Kernel B's int8 branch: int8 entries and per-(token, kv head)
    scales of a stacked cache, against the plain version on the same int8
    cache."""
    gen = torch.Generator(device=dev).manual_seed(4)
    L, B, KV, S = 3, 4, 2, 700
    q = _randn(gen, dev, B, KV * G, Dh)
    ck, ks = quantize_kv(torch.randn(L, B, KV, S, Dh, generator=gen,
                                     device=dev) * 2)
    cv, vs = quantize_kv(torch.randn(L, B, KV, S, Dh, generator=gen,
                                     device=dev))
    lengths = torch.tensor([1, 700, 257, 33], dtype=torch.int32, device=dev)
    starts = torch.tensor([0, 300, 256, 33], dtype=torch.int32, device=dev)
    for st in (None, starts):
        n0 = da.DECODE_ATTN_INT8.launches
        o = da.decode_attention(q, ck, cv, lengths, starts=st, layer=2,
                                k_scale=ks, v_scale=vs)
        torch.cuda.synchronize()
        assert da.DECODE_ATTN_INT8.launches == n0 + 1
        ref = da.decode_attention_plain(q.float(), ck[2], cv[2], lengths, st,
                                        k_scale=ks[2], v_scale=vs[2])
        assert (o.float() - ref).abs().max().item() <= O_TOL
    assert torch.all(o[3] == 0)             # empty window [33, 33)


def _decode_cache(gen, dev, quant, L, B, KV, S, Dh):
    k = torch.randn(L, B, KV, S, Dh, generator=gen, device=dev)
    v = torch.randn(L, B, KV, S, Dh, generator=gen, device=dev)
    if quant:
        (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
        return k, v, dict(k_scale=ks, v_scale=vs)
    return k.to(torch.bfloat16), v.to(torch.bfloat16), {}


def _check_decode(q, k, v, lengths, starts, layer, sc):
    """Kernel B on the stacked cache at `layer` against the plain version;
    a second launch must give the same bits."""
    kern = da.DECODE_ATTN_INT8 if sc else da.DECODE_ATTN
    n0 = kern.launches
    o = da.decode_attention(q, k, v, lengths, starts=starts, layer=layer, **sc)
    again = da.decode_attention(q, k, v, lengths, starts=starts, layer=layer,
                                **sc)
    torch.cuda.synchronize()
    assert kern.launches == n0 + 2
    ref = da.decode_attention_plain(q.float(), k[layer], v[layer], lengths,
                                    starts,
                                    **{n: x[layer] for n, x in sc.items()})
    assert torch.equal(o, again), "not bitwise repeatable"
    assert torch.isfinite(o).all()
    assert (o.float() - ref).abs().max().item() <= O_TOL
    return o


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_decode_split_kernel_one_long_row(dev, quant):
    """A batch of one 4,096-key row at the 8B shape spreads over many key
    splits (`decode_splits`), and their in-launch merge matches the plain
    version, at the first and the last layer of the stacked cache."""
    gen = torch.Generator(device=dev).manual_seed(20)
    L, B, H, KV, S, Dh = 3, 1, 32, 8, 4096, 128
    _, n_split = da.decode_splits(S, B, KV, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    assert n_split * KV >= 128
    q = _randn(gen, dev, B, H, Dh)
    k, v, sc = _decode_cache(gen, dev, quant, L, B, KV, S, Dh)
    lengths = torch.tensor([S], dtype=torch.int32, device=dev)
    for layer in (0, L - 1):
        _check_decode(q, k, v, lengths, None, layer, sc)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("Dh", [64, 128])
@pytest.mark.parametrize("G", [1, 4, 8])
def test_decode_split_kernel_at_split_edges(dev, quant, Dh, G):
    """Windows that start and end at a split boundary and one key either
    side of it, S not a multiple of the split, a row with an empty window
    next to full rows, the stacked cache at layers 0 and L - 1; repeats
    bitwise equal."""
    gen = torch.Generator(device=dev).manual_seed(21 + G)
    L, KV, S = 2, 2, 1000
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    B = 8
    split, n_split = da.decode_splits(S, B, KV, sms)
    assert S % split and n_split > 1
    rows = [(0, S), (split - 1, 2 * split + 1), (split, 2 * split),
            (split + 1, 2 * split - 1), (500, 500), (0, S),
            (3, split + 1), (S - 1, S)]
    q = _randn(gen, dev, B, KV * G, Dh)
    k, v, sc = _decode_cache(gen, dev, quant, L, B, KV, S, Dh)
    starts = torch.tensor([r[0] for r in rows], dtype=torch.int32, device=dev)
    lengths = torch.tensor([r[1] for r in rows], dtype=torch.int32,
                           device=dev)
    for layer in (0, L - 1):
        o = _check_decode(q, k, v, lengths, starts, layer, sc)
        assert torch.all(o[4] == 0)          # [500, 500) is empty


def _fill_cache(gen, dev, quant, L, B, KV, S, Dh, row, off, C):
    """A stacked cache whose row `row` holds large stale values past the
    chunk [off, off + C) (only the mask keeps them out)."""
    k = torch.randn(L, B, KV, S, Dh, generator=gen, device=dev)
    v = torch.randn(L, B, KV, S, Dh, generator=gen, device=dev)
    k[:, row, :, off + C:] = 30.0
    v[:, row, :, off + C:] = -50.0
    if quant:
        (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
        return k, v, ks, vs
    return k.to(torch.bfloat16), v.to(torch.bfloat16), None, None


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("Dh", [64, 128])
@pytest.mark.parametrize("C,G,S", [
    (256, 4, 1300),     # the fill form's shape class; S not a tile multiple
    (256, 1, 1300),
    (256, 2, 1300),
    (256, 8, 1300),
    (64, 4, 1300),
    (64, 1, 500),       # one key split: the CTA writes its output directly
])
def test_fill_kernel_at_offsets(dev, quant, Dh, C, G, S):
    """Kernel E's fill form (the wgmma + TMA kernel, `chunk_fill.cu`) at
    offsets 0, 64k +- 1, 1024 and S - C, with stale entries past the chunk,
    against the plain version; repeats bitwise equal."""
    gen = torch.Generator(device=dev).manual_seed(30 + G + C)
    L, B, KV, row = 2, 3, 2, 1
    H = KV * G
    kern = da.CHUNK_ATTN_INT8 if quant else da.CHUNK_ATTN
    q = _randn(gen, dev, C, H, Dh)
    r_t = torch.tensor([row], dtype=torch.int32, device=dev)
    offsets = {0, 63, 65, 127, 129, 1024, S - C}
    for off in sorted(o for o in offsets if o <= S - C):
        k, v, ks, vs = _fill_cache(gen, dev, quant, L, B, KV, S, Dh, row, off,
                                   C)
        off_t = torch.tensor([off], dtype=torch.int32, device=dev)
        layer = (off // 64) % L
        n0 = kern.launches
        o = da.chunk_attention(q, k, v, r_t, off_t, layer=layer, k_scale=ks,
                               v_scale=vs)
        again = da.chunk_attention(q, k, v, r_t, off_t, layer=layer,
                                   k_scale=ks, v_scale=vs)
        torch.cuda.synchronize()
        assert kern.launches == n0 + 2
        ref = da.chunk_attention_plain(
            q[None].float(), k[layer][r_t], v[layer][r_t], off_t,
            k_scale=None if ks is None else ks[layer][r_t],
            v_scale=None if vs is None else vs[layer][r_t])[0]
        assert torch.equal(o, again), f"offset {off}: not bitwise repeatable"
        assert torch.isfinite(o).all()
        err = (o.float() - ref).abs().max().item()
        assert err <= O_TOL, (off, err)


def _chunk_case(dev, quant, NB, C, H, KV, Dh, offs, seed):
    """q [NB, C, H, Dh] and a stacked cache whose entries past each chunk
    are large stale values (only the mask keeps them out)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    L, B, S = 2, 5, 600
    q = _randn(gen, dev, NB, C, H, Dh)
    k = torch.randn(L, B, KV, S, Dh, generator=gen, device=dev)
    v = torch.randn(L, B, KV, S, Dh, generator=gen, device=dev)
    rows = list(range(NB)) if NB > 1 else [3]
    for r, off in zip(rows, offs):
        k[:, r, :, off + C:] = 30.0
        v[:, r, :, off + C:] = -50.0
    if quant:
        (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
    else:
        k, v, ks, vs = k.to(torch.bfloat16), v.to(torch.bfloat16), None, None
    return q, k, v, ks, vs, rows


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("Dh", [64, 128])
@pytest.mark.parametrize("form,C,H,KV,offs", [
    ("verify", 4, 32, 8, [0, 1, 77, 300, 592]),     # G*C = 16: 16-row CTAs
    ("verify", 3, 8, 1, [5, 0, 64, 597, 128]),      # G*C = 24
    ("fill", 256, 32, 8, [255]),                     # G*C = 1024
    ("fill", 100, 4, 4, [0]),                        # MHA, ragged last tile
    ("fill", 37, 16, 2, [600 - 37]),                 # G = 8, offset S - C
])
def test_chunk_kernel_matches_plain(dev, quant, Dh, form, C, H, KV, offs):
    """Kernel E in its K7 form (`chunk_attention_batched`, every row at its
    own offset) and its K6 form (`chunk_attention`, one chunk of one row)
    against `chunk_attention_plain` on the same cache."""
    NB = len(offs)
    q, k, v, ks, vs, rows = _chunk_case(dev, quant, NB, C, H, KV, Dh, offs,
                                        seed=5 + C)
    kern = da.CHUNK_ATTN_INT8 if quant else da.CHUNK_ATTN
    n0 = kern.launches
    offs_t = torch.tensor(offs, dtype=torch.int32, device=dev)
    for layer in (0, 1):
        if form == "verify":
            o = da.chunk_attention_batched(q, k, v, offs_t, layer=layer,
                                           k_scale=ks, v_scale=vs)
        else:
            o = da.chunk_attention(q[0], k, v, rows[0], offs[0], layer=layer,
                                   k_scale=ks, v_scale=vs)[None]
        torch.cuda.synchronize()
        r = torch.tensor(rows, device=dev)
        ref = da.chunk_attention_plain(
            q.float(), k[layer][r], v[layer][r], offs_t,
            k_scale=None if ks is None else ks[layer][r],
            v_scale=None if vs is None else vs[layer][r])
        assert o.dtype == torch.bfloat16 and torch.isfinite(o).all()
        assert (o.float() - ref).abs().max().item() <= O_TOL
    site = ("chunk_attention_batched" if form == "verify"
            else "chunk_attention")
    assert kern.launches == n0 + 2 and kern.sites[site] >= 2


def _verify_counters_zero() -> bool:
    return all(bool((ctr == 0).all()) for key, (_, ctr) in da._SCRATCH.items()
               if key[0] == "verify")


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("Dh", [64, 128])
@pytest.mark.parametrize("G,C", [(4, 4), (2, 4), (1, 4)],
                         ids=["GC16", "GC8", "GC4"])
def test_verify_kernel_at_split_edges(dev, quant, Dh, G, C):
    """Kernel E's verify form (key splits merged in the launch) at the spec
    step's cache length: one 4,096-key row among short rows, offset 0,
    chunks whose last key ends a split or misses it by one either way, a
    chunk that starts on a split boundary, stale entries past each chunk;
    each (token, head) row within 2e-2 of its own max|ref|, repeats
    bitwise equal, the arrival counters back at zero."""
    gen = torch.Generator(device=dev).manual_seed(40 + G + Dh)
    L, NB, KV, S = 2, 8, 8, 4108
    H = KV * G
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    split = da.verify_split_len(S, da.verify_splits(S, NB, KV, sms))
    offs = [S - 16, 0, split - C, split - C + 1, split - C - 1,
            2 * split, 17, 3 * split - 2]
    q = _randn(gen, dev, NB, C, H, Dh)
    k = torch.randn(L, NB, KV, S, Dh, generator=gen, device=dev)
    v = torch.randn(L, NB, KV, S, Dh, generator=gen, device=dev)
    for r, off in enumerate(offs):
        k[:, r, :, off + C:] = 30.0
        v[:, r, :, off + C:] = -50.0
    if quant:
        (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
    else:
        k, v, ks, vs = k.to(torch.bfloat16), v.to(torch.bfloat16), None, None
    kern = da.CHUNK_ATTN_INT8 if quant else da.CHUNK_ATTN
    offs_t = torch.tensor(offs, dtype=torch.int32, device=dev)
    for layer in (0, L - 1):
        n0 = kern.launches
        o, again = (da.chunk_attention_batched(q, k, v, offs_t, layer=layer,
                                               k_scale=ks, v_scale=vs)
                    for _ in range(2))
        torch.cuda.synchronize()
        assert kern.launches == n0 + 2
        assert _verify_counters_zero()
        ref = da.chunk_attention_plain(
            q.float(), k[layer], v[layer], offs_t,
            k_scale=None if ks is None else ks[layer],
            v_scale=None if vs is None else vs[layer])
        assert torch.equal(o, again), "not bitwise repeatable"
        assert torch.isfinite(o).all()
        rel = ((o.float() - ref).abs().amax(-1)
               / ref.abs().amax(-1).clamp_min(1e-3))
        assert rel.max().item() <= O_TOL, rel.amax((1, 2)).tolist()


def test_int8_and_chunk_wrappers_refuse_what_the_kernels_do_not_take(dev):
    """Wrong dtypes, missing or mis-shaped scales, offsets of the wrong
    length and non-contiguous inputs raise before any launch."""
    q = torch.randn(2, 4, 8, 128, device=dev, dtype=torch.bfloat16)
    c8, sc = quantize_kv(torch.randn(2, 2, 2, 64, 128, device=dev))
    cb = c8.to(torch.bfloat16)
    offs = torch.tensor([3, 9], dtype=torch.int32, device=dev)
    n = torch.tensor([3, 9], dtype=torch.int32, device=dev)
    counts = (da.CHUNK_ATTN.launches, da.CHUNK_ATTN_INT8.launches,
              da.DECODE_ATTN_INT8.launches)
    bad = [
        lambda: da.chunk_attention_batched(q, c8, c8, offs, layer=0),
        lambda: da.chunk_attention_batched(q, cb, cb, offs, layer=0,
                                           k_scale=sc, v_scale=sc),
        lambda: da.chunk_attention_batched(q.float(), cb, cb, offs,
                                           layer=0),
        lambda: da.chunk_attention_batched(q, cb, cb, offs[:1], layer=0),
        lambda: da.chunk_attention_batched(q, cb, cb, offs.long(), layer=0),
        lambda: da.chunk_attention_batched(q.transpose(1, 2), cb, cb, offs,
                                           layer=0),
        lambda: da.chunk_attention_batched(q, c8, c8, offs, layer=0,
                                           k_scale=sc.transpose(2, 3),
                                           v_scale=sc),
        lambda: da.chunk_attention(q[0], c8, c8, 0, 2, layer=2, k_scale=sc,
                                   v_scale=sc),
        lambda: da.decode_attention(q[:, 0], c8, c8, n, layer=0,
                                    k_scale=sc),
        lambda: da.decode_attention(q[:, 0], c8, c8, n, layer=0,
                                    k_scale=sc[..., :32].contiguous(),
                                    v_scale=sc),
    ]
    for call in bad:
        with pytest.raises(ValueError):
            call()
    assert counts == (da.CHUNK_ATTN.launches, da.CHUNK_ATTN_INT8.launches,
                      da.DECODE_ATTN_INT8.launches)


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    q = torch.randn(1, 4, 16, 128, device=dev)
    with pytest.raises(ValueError):          # fp32
        fa.flash_attention_with_lse(q, q[:, :2], q[:, :2])
    qb = q.to(torch.bfloat16)
    with pytest.raises(ValueError):          # head dim 32
        fa.flash_attention_with_lse(qb[..., :32].contiguous(),
                                    qb[:, :2, :, :32].contiguous(),
                                    qb[:, :2, :, :32].contiguous())
    cache = torch.zeros(2, 1, 2, 16, 128, device=dev, dtype=torch.bfloat16)
    n = torch.tensor([3], dtype=torch.int32, device=dev)
    qd = qb[:, :, 0].contiguous()
    da.decode_attention(qd, cache, cache, n, layer=1)     # accepted
    with pytest.raises(ValueError):          # non-contiguous cache
        da.decode_attention(qd, cache.transpose(3, 4), cache, n, layer=0)
    with pytest.raises(ValueError):          # layer out of range
        da.decode_attention(qd, cache, cache, n, layer=2)
    with pytest.raises(ValueError):          # int64 lengths
        da.decode_attention(qd, cache, cache, n.long(), layer=0)


def _rel_err(x, ref):
    return ((x.float() - ref).abs().max() / ref.abs().max().clamp_min(1e-30)
            ).item()


@pytest.mark.parametrize("Dh", [64, 128])
@pytest.mark.parametrize("B,T,S,H,KV,lens,causal,with_dlse", [
    (2, 300, 300, 8, 2, [300, 131], True, False),   # ragged, T % 64 != 0
    (1, 256, 256, 4, 1, [256], True, True),         # GQA x4, lse cotangent
    (2, 100, 257, 8, 4, [257, 70], False, True),    # non-causal, T != S
    (2, 70, 70, 2, 1, [0, 70], True, False),        # a row with no key
    (1, 200, 200, 8, 2, [200], True, False),        # T % 128 = 72
    (2, 192, 333, 4, 1, [333, 65], False, True),    # T % 128 = 64, S % 64
    (2, 130, 130, 8, 8, [130, 0], True, True),      # 2 rows past a tile
])
def test_flash_bwd_kernels_match_plain(dev, B, T, S, H, KV, lens, causal,
                                       with_dlse, Dh):
    """Kernels C (dq) and D (dk, dv) against the plain backward in fp32
    from the same bf16 inputs; bitwise equal on a second launch."""
    gen = torch.Generator(device=dev).manual_seed(2)
    q, k, v = (_randn(gen, dev, B, H, T, Dh), _randn(gen, dev, B, KV, S, Dh),
               _randn(gen, dev, B, KV, S, Dh))
    do = _randn(gen, dev, B, H, T, Dh)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    o, lse = fa.flash_attention_with_lse(q, k, v, lengths, causal=causal)
    dlse = (torch.randn(B, H, T, generator=gen, device=dev) if with_dlse
            else None)
    scale = Dh ** -0.5
    n_dq, n_dkv = fa.FLASH_BWD_DQ.launches, fa.FLASH_BWD_DKV.launches
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, dlse, lengths, causal,
                                 scale)
    again = fa.flash_attention_bwd(q, k, v, o, lse, do, dlse, lengths,
                                   causal, scale)
    torch.cuda.synchronize()
    assert fa.FLASH_BWD_DQ.launches == n_dq + 2
    assert fa.FLASH_BWD_DKV.launches == n_dkv + 2
    ref = fa.flash_attention_bwd_plain(q.float(), k.float(), v.float(),
                                       o.float(), lse, do.float(), dlse,
                                       lengths, causal, scale)
    for name, x, y, r in zip(("dq", "dk", "dv"), got, again, ref):
        assert x.dtype == torch.bfloat16 and x.shape == r.shape
        assert torch.isfinite(x).all(), name
        assert torch.equal(x, y), f"{name} not bitwise repeatable"
        assert _rel_err(x, r) <= BWD_TOL, (name, _rel_err(x, r))
    if lens[0] == 0:
        assert torch.all(got[0][0] == 0)     # no visible key: dq = 0
        assert torch.all(got[1][0] == 0) and torch.all(got[2][0] == 0)


@pytest.mark.parametrize("Dh", [64, 128])
def test_flash_autograd_on_card_matches_plain(dev, Dh):
    """flash_attention (model layout) under autograd on the card runs
    kernels A, C and D; its grads agree with autograd through the plain
    forward."""
    gen = torch.Generator(device=dev).manual_seed(3)
    B, T, H, KV = 2, 200, 8, 2
    q, k, v = (_randn(gen, dev, B, T, H, Dh), _randn(gen, dev, B, T, KV, Dh),
               _randn(gen, dev, B, T, KV, Dh))
    w = torch.randn(B, T, H, Dh, generator=gen, device=dev)
    mask = torch.ones(B, T, dtype=torch.int32, device=dev)
    mask[1, 150:] = 0
    qa, ka, va = (x.clone().requires_grad_() for x in (q, k, v))
    n = (fa.FLASH_FWD.launches, fa.FLASH_BWD_DQ.launches,
         fa.FLASH_BWD_DKV.launches)
    (fa.flash_attention(qa, ka, va, attn_mask=mask).float() * w).sum(
        ).backward()
    torch.cuda.synchronize()
    assert (fa.FLASH_FWD.launches, fa.FLASH_BWD_DQ.launches,
            fa.FLASH_BWD_DKV.launches) == (n[0] + 1, n[1] + 1, n[2] + 1)
    qr, kr, vr = (x.float().requires_grad_() for x in (q, k, v))
    o, _ = fa.flash_attention_plain(qr.transpose(1, 2), kr.transpose(1, 2),
                                    vr.transpose(1, 2), mask.sum(-1).int())
    (o.transpose(1, 2) * w).sum().backward()
    for name, a, r in (("dq", qa.grad, qr.grad), ("dk", ka.grad, kr.grad),
                       ("dv", va.grad, vr.grad)):
        assert _rel_err(a, r) <= BWD_TOL, (name, _rel_err(a, r))


def test_bwd_wrapper_refuses_what_the_kernels_do_not_take(dev):
    q = torch.randn(1, 4, 16, 128, device=dev, dtype=torch.bfloat16)
    k = q[:, :2].contiguous()
    n = torch.tensor([16], dtype=torch.int32, device=dev)
    o, lse = fa.flash_attention_with_lse(q, k, k, n)
    dq_n = fa.FLASH_BWD_DQ.launches
    with pytest.raises(ValueError):          # fp32 operands
        fa.flash_attention_bwd(q.float(), k.float(), k.float(), o.float(),
                               lse, o.float(), None, n, True, 0.1)
    with pytest.raises(ValueError):          # int64 lengths
        fa.flash_attention_bwd(q, k, k, o, lse, o, None, n.long(), True, 0.1)
    with pytest.raises(ValueError):          # lse of the wrong shape
        fa.flash_attention_bwd(q, k, k, o, lse[:, :, :8], o, None, n, True,
                               0.1)
    assert fa.FLASH_BWD_DQ.launches == dq_n


def _check_fwd(q, k, v, lengths, causal):
    o, lse = fa.flash_attention_with_lse(q, k, v, lengths, causal=causal)
    torch.cuda.synchronize()
    ro, rlse = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                        lengths, causal)
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    assert (o.float() - ro).abs().max().item() <= O_TOL
    assert (lse - rlse).abs().max().item() <= LSE_TOL
    return o, lse


def _check_bwd(q, k, v, o, lse, do, lengths, causal):
    scale = q.shape[-1] ** -0.5
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, None, lengths, causal,
                                 scale)
    again = fa.flash_attention_bwd(q, k, v, o, lse, do, None, lengths, causal,
                                   scale)
    torch.cuda.synchronize()
    ref = fa.flash_attention_bwd_plain(q.float(), k.float(), v.float(),
                                       o.float(), lse, do.float(), None,
                                       lengths, causal, scale)
    for name, x, y, r in zip(("dq", "dk", "dv"), got, again, ref):
        assert torch.isfinite(x).all(), name
        assert torch.equal(x, y), f"{name} not bitwise repeatable"
        assert _rel_err(x, r) <= BWD_TOL, (name, _rel_err(x, r))
    return got


@pytest.mark.parametrize("Dh", [64, 128])
@pytest.mark.parametrize("B,T,S,H,KV,lens,causal", [
    (1, 1, 17, 4, 1, [17], False),               # one q row
    (2, 17, 17, 4, 2, [17, 9], True),            # shorter than any tile
    (1, 129, 129, 4, 1, [129], True),            # one row past a 128-row tile
    (1, 129, 129, 4, 1, [129], False),
    (1, 64, 64, 4, 2, [64], True),               # half a 128-row q tile
    (2, 191, 191, 8, 2, [191, 127], True),       # T, length % 64 = 63
    (1, 257, 257, 4, 1, [257], True),
    (2, 100, 300, 8, 2, [257, 300], False),      # S = 300, length 257
    (2, 150, 150, 16, 2, [150, 100], True),      # GQA G = 8
    (1, 4096, 4096, 32, 8, [4096], True),        # the 8B train step's shape
])
def test_flash_kernels_at_tile_edges(dev, B, T, S, H, KV, lens, causal, Dh):
    """Kernels A, C and D where a TMA box runs past T or S (the map
    zero-fills it), past the length (masked), at GQA G = 8, and at the
    train step's causal T = 4096."""
    gen = torch.Generator(device=dev).manual_seed(7)
    q, k, v = (_randn(gen, dev, B, H, T, Dh), _randn(gen, dev, B, KV, S, Dh),
               _randn(gen, dev, B, KV, S, Dh))
    do = _randn(gen, dev, B, H, T, Dh)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    o, lse = _check_fwd(q, k, v, lengths, causal)
    _check_bwd(q, k, v, o, lse, do, lengths, causal)


@pytest.mark.parametrize("Dh", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernels_read_strided_views(dev, Dh, causal):
    """q, k and v as views into larger buffers (k and v sliced from one
    [B, S, 2, KV, Dh] tensor, q from a buffer with spare heads), T and S
    not multiples of a tile: a map that ran past T or past a head would
    read a neighbour's values. Results equal those of contiguous copies
    bit for bit."""
    gen = torch.Generator(device=dev).manual_seed(9)
    B, T, H, KV = 2, 200, 8, 2
    qbuf = _randn(gen, dev, B, T, H + 2, Dh)
    kv = _randn(gen, dev, B, T, 2, KV, Dh)
    q = qbuf[:, :, 1:H + 1].transpose(1, 2)
    k, v = kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2)
    do = _randn(gen, dev, B, H, T, Dh)
    lengths = torch.tensor([T, 131], dtype=torch.int32, device=dev)
    o, lse = _check_fwd(q, k, v, lengths, causal)
    qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
    oc, lsec = fa.flash_attention_with_lse(qc, kc, vc, lengths, causal=causal)
    assert torch.equal(o, oc) and torch.equal(lse, lsec)
    got = _check_bwd(q, k, v, o, lse, do, lengths, causal)
    ref = fa.flash_attention_bwd(qc, kc, vc, oc, lsec, do, None, lengths,
                                 causal, Dh ** -0.5)
    for x, y in zip(got, ref):
        assert torch.equal(x, y)


def test_kernels_run_on_a_second_card():
    """Kernels A-E on cuda:1 after cuda:0 in one process: each launch finds
    its shared-memory opt-in made for its own device (the attribute is per
    device) and agrees with its plain version there."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    for index in (0, 1):
        dev = torch.device("cuda", index)
        gen = torch.Generator(device=dev).manual_seed(50)
        B, T, H, KV, Dh = 2, 300, 8, 2, 128
        q, k, v, do = (_randn(gen, dev, B, H, T, Dh),
                       _randn(gen, dev, B, KV, T, Dh),
                       _randn(gen, dev, B, KV, T, Dh),
                       _randn(gen, dev, B, H, T, Dh))
        lengths = torch.tensor([T, 200], dtype=torch.int32, device=dev)
        o, lse = _check_fwd(q, k, v, lengths, True)             # A
        _check_bwd(q, k, v, o, lse, do, lengths, True)          # C, D
        L, S = 2, 700
        cache = [_randn(gen, dev, L, B, KV, S, Dh) for _ in range(2)]
        n = torch.tensor([700, 33], dtype=torch.int32, device=dev)
        od = da.decode_attention(q[:, :, 0].contiguous(), *cache, n,
                                 layer=1)                       # B
        ref = da.decode_attention_plain(q[:, :, 0].float(), cache[0][1],
                                        cache[1][1], n)
        assert (od.float() - ref).abs().max().item() <= O_TOL
        offs = torch.tensor([600, 5], dtype=torch.int32, device=dev)
        qc = _randn(gen, dev, B, 4, H, Dh)
        ov = da.chunk_attention_batched(qc, *cache, offs, layer=0)  # E
        ref = da.chunk_attention_plain(qc.float(), cache[0][0], cache[1][0],
                                       offs)
        assert (ov.float() - ref).abs().max().item() <= O_TOL
        qf = _randn(gen, dev, 256, H, Dh)
        of = da.chunk_attention(qf, *cache, 1, 300, layer=0)    # E fill
        ref = da.chunk_attention_plain(qf[None].float(), cache[0][0][1:2],
                                       cache[1][0][1:2],
                                       offs.new_tensor([300]))[0]
        assert (of.float() - ref).abs().max().item() <= O_TOL
        torch.cuda.synchronize(dev)


DESC_CHECK = Kernel("mm_sm90_desc_check",
                    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                    + [ctypes.c_void_p])


@pytest.mark.parametrize("N", [64, 128])
@pytest.mark.parametrize("mode", [0, 1, 2, 3],
                         ids=["ss_kmajor", "ss_mnmajor", "rs_kmajor",
                              "rs_mnmajor"])
def test_sm90_descriptors_match_matmul(dev, N, mode):
    """`csrc/sm90_check.cu`: TMA boxes with the 128-byte swizzle, the wgmma
    descriptors (K-major and MN-major B, 64 or 128 output columns, two
    swizzle chunks of depth) and the accumulator layout that kernels A and
    D use, through one 64 x N x 128 product, against torch.matmul in fp32
    on the same bf16 values (only the order of fp32 sums differs)."""
    gen = torch.Generator(device=dev).manual_seed(10 + mode)
    a = _randn(gen, dev, 64, 128)
    b = _randn(gen, dev, 128, N) if mode & 1 else _randn(gen, dev, N, 128)
    c = torch.full((64, N), float("nan"), device=dev)
    DESC_CHECK.launch(a.data_ptr(), b.data_ptr(), c.data_ptr(), N, mode,
                      torch.cuda.current_stream(dev).cuda_stream)
    torch.cuda.synchronize()
    ref = a.float() @ (b.float() if mode & 1 else b.float().t())
    assert (c - ref).abs().max().item() <= 1e-3


# ---------------------------------------------------------------------------
# the host-data slice on the card's machine
# ---------------------------------------------------------------------------

def test_native_packer_builds_and_matches_python(dev):
    """The packer compiles on this machine into metamorph_tpu_torch/build/
    and gives the Python packer's batches, field for field."""
    import dataclasses
    import random

    import numpy as np

    from metamorph_tpu_torch.multimodal import native
    from metamorph_tpu_torch.multimodal.packing import (PackedBatch,
                                                        pack_sequences)

    assert native.native_available(), native.NATIVE.error
    assert native.library_path().parent == native.BUILD_DIR
    assert native.library_path().exists()
    rng = random.Random(0)
    for _ in range(20):
        ids, labs, n_img = [], [], 0
        for _ in range(rng.randint(1, 4)):
            row = [128000] + [rng.randint(10, 999) for _ in range(5)]
            for _ in range(rng.randint(0, 2)):
                row += [128256, -200, 128257] if rng.random() < 0.5 else [-200]
                n_img += 1
            n_img += row.count(-200) == 0
            ids.append(row)
            labs.append([t if t != -200 else -100 for t in row])
        args = (ids, labs, 3, rng.choice([12, 40]), n_img + 1)
        a = native.pack_sequences_native(*args)
        b = pack_sequences(*args)
        for f in dataclasses.fields(PackedBatch):
            x, y = getattr(a, f.name), getattr(b, f.name)
            assert (x is None and y is None) or np.array_equal(x, y), f.name


def test_fused_resize_normalize_on_card_matches_cpu(dev):
    """The two interpolation products and the normalization on the card
    against the same function on the CPU: 1e-5 absolute, fp32 both ways
    (TF32 off) with only the order of the sums differing."""
    from metamorph_tpu_torch.ops.preprocess import fused_resize_normalize

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        gen = torch.Generator().manual_seed(0)
        frames = torch.randint(0, 256, (3, 250, 370, 3), generator=gen,
                               dtype=torch.uint8)
        cpu = fused_resize_normalize(frames, 384)
        gpu = fused_resize_normalize(frames.to(dev), 384)
        assert gpu.device.type == "cuda" and gpu.dtype == torch.float32
        assert (gpu.cpu() - cpu).abs().max().item() <= 1e-5
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def test_anyres_train_step_on_card_matches_cpu(dev, tmp_path):
    """One anyres train_step (view_map gather with the learned newline,
    spatial_unpad) through the port's dataset and collator: bf16 with the
    kernels on the card against fp32 with the plain versions on the CPU,
    on the same weights; losses within 2e-2 relative."""
    import copy
    import json

    import numpy as np
    from PIL import Image

    from chip_smoke import word_tokenize
    from metamorph_tpu_torch.config import (LlamaConfig, MetaMorphConfig,
                                            MultimodalConfig, SiglipConfig,
                                            TrainConfig)
    from metamorph_tpu_torch.convert import init_params
    from metamorph_tpu_torch.multimodal.packing import batch_to_arrays
    from metamorph_tpu_torch.train import train_step as TS
    from metamorph_tpu_torch.train.data import (DataConfig, DataIterator,
                                                LazySupervisedDataset,
                                                PackedCollator)
    from metamorph_tpu_torch.train.optimizer import make_optimizer

    pins = ((28, 56), (56, 28), (56, 56))
    cfg = MetaMorphConfig(
        llama=LlamaConfig(hidden_size=256, intermediate_size=512,
                          num_layers=2, num_heads=2, num_kv_heads=1,
                          head_dim=128),
        siglip=SiglipConfig.tiny(),
        mm=MultimodalConfig(num_image_tokens=4, image_token_reduction="none",
                            image_aspect_ratio="anyres",
                            mm_patch_merge_type="spatial_unpad",
                            image_grid_pinpoints=pins),
        train=TrainConfig(batch_size=2, max_seq_len=128,
                          max_images_per_batch=2, learning_rate=1e-3))
    rows = []
    for i, hw in enumerate([(30, 60), (45, 20)]):
        path = tmp_path / f"{i}.png"
        Image.fromarray(np.random.default_rng(i).integers(
            0, 256, (*hw, 3)).astype(np.uint8)).save(path)
        rows.append({"id": str(i), "image": str(path), "conversations": [
            {"from": "human", "value": f"<image>\nwhat is {i}"},
            {"from": "gpt", "value": f"it is thing {i}"}]})
    data = tmp_path / "d.jsonl"
    data.write_text("".join(json.dumps(r) + "\n" for r in rows))
    ds = LazySupervisedDataset(
        str(data), word_tokenize,
        DataConfig(image_aspect_ratio="anyres", image_size=28,
                   grid_pinpoints=pins))
    col = PackedCollator(num_image_tokens=4, max_seq_len=128,
                         num_image_slots=2, image_size=28,
                         image_aspect_ratio="anyres", grid_pinpoints=pins)
    packed, pixels = next(iter(DataIterator(ds, col, batch_size=2)))
    arrays = batch_to_arrays(packed)
    assert "view_map" in arrays and (arrays["view_map"] == -1).any()

    cpu = init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    gpu = copy.deepcopy(cpu).to(device=dev, dtype=torch.bfloat16)
    losses = {}
    for name, model, d in (("cpu", cpu, torch.device("cpu")),
                           ("gpu", gpu, dev)):
        state = TS.init_train_state(model, cfg)
        tx = make_optimizer(cfg.train, model)
        batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(d)
                 for k, v in arrays.items()}
        _, m = TS.train_step(state, batch, torch.from_numpy(pixels).to(d),
                             cfg, tx)
        losses[name] = float(m["loss"])
        assert float(m["n_image_ar_tokens"]) == 0.0
        assert float(m["n_text_tokens"]) > 1
    assert np.isfinite(losses["gpu"])
    assert abs(losses["gpu"] - losses["cpu"]) <= 2e-2 * abs(losses["cpu"])


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_single_row_chunk_step_on_card_matches_cpu(dev, quant):
    """`llama.decode_chunk_step` (one cache row) on the card, bf16 weights,
    against the same step on the CPU in fp32, after a 10-token prefill:
    a 4-token chunk at G=4 takes kernel E's verify form (16 packed rows),
    an 8-token one its fill form; hidden states at cosine >= 0.999 (0.995
    with the int8 cache, whose entries round to neighbouring steps from
    bf16 and fp32 K/V)."""
    from metamorph_tpu_torch.config import LlamaConfig
    from metamorph_tpu_torch.convert import init_llama
    from metamorph_tpu_torch.models import llama as L

    cfg = LlamaConfig(vocab_size=1000, hidden_size=256,
                      intermediate_size=512, num_layers=2, num_heads=8,
                      num_kv_heads=2, head_dim=64)
    cpu = init_llama(cfg, seed=3, device="cpu", dtype=torch.float32)
    gpu = init_llama(cfg, seed=3, device="cpu", dtype=torch.float32).to(
        device=dev, dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(4)
    ids = torch.randint(0, 1000, (1, 10), generator=gen)
    kern = da.CHUNK_ATTN_INT8 if quant else da.CHUNK_ATTN
    kern.reset()
    h = {}
    with torch.no_grad():
        for name, model, d in (("cpu", cpu, torch.device("cpu")),
                               ("gpu", gpu, dev)):
            cache = L.init_kv_cache(cfg, 1, 40, dtype=model.embed.dtype,
                                    device=d, quantized=quant)
            L.prefill(model, cfg, L.embed_tokens(model, ids.to(d)),
                      torch.arange(10, device=d)[None], None, cache)
            for C in (4, 8):
                xc = L.embed_tokens(model, torch.arange(C, device=d) + 7)
                h[name, C], _ = L.decode_chunk_step(
                    model, cfg, xc, torch.arange(10, 10 + C, device=d), cache)
    for C in (4, 8):
        a, b = h["gpu", C].float().cpu(), h["cpu", C]
        cos = torch.nn.functional.cosine_similarity(a, b, dim=-1).min()
        assert torch.isfinite(a).all() and cos >= (0.995 if quant else 0.999)
    assert kern.forms == {"verify": 2, "fill": 2} and kern.launches == 4


# ---- kernel F: the weight-only int8 product ---------------------------------

W8_TOL = 4e-3   # max|err| / max|ref| of a bf16 output against fp32 sums of
                # the same bf16 x and int8 weights: one bf16 rounding of the
                # output (2**-9 relative) plus fp32 sums in another order


def _check_w8(Q, x, wq, form):
    """Kernel F on x against its plain version at W8_TOL, bitwise on a
    repeat, launched twice in `form`, the gemv counters left at zero."""
    Q.W8_MATMUL.reset()
    out = Q.quantized_matmul(x, wq)
    again = Q.quantized_matmul(x, wq)
    torch.cuda.synchronize()
    assert Q.W8_MATMUL.launches == 2 and Q.W8_MATMUL.forms == {form: 2}
    assert out.dtype == torch.bfloat16 and out.shape == (x.shape[0],
                                                         wq.q.shape[0])
    ref = Q.quantized_matmul_plain(x.float(), wq)
    err = ((out.float() - ref).abs().max() / ref.abs().max()).item()
    assert err <= W8_TOL
    assert torch.equal(out, again)
    assert all(int(c.abs().sum()) == 0 for _, c in Q._SCRATCH.values())


@pytest.mark.parametrize("M", [1, 8, 13, 17, 32, 33, 48, 64, 65, 264, 4096])
@pytest.mark.parametrize("K,N", [(4096, 1024), (4144, 1000), (4096, 14344)])
def test_w8_matmul_kernel_matches_plain(dev, M, K, N):
    """Both forms (gemv up to GEMV_MAX_M rows, with shared tiles merged in
    the launch; tiled beyond), around the form boundary, ragged K (4,144:
    not a multiple of the 64- or 128-deep step) and N (not a multiple of
    the 128- or 256-channel tile): against the plain version in fp32, and
    bitwise on a repeat."""
    from metamorph_tpu_torch.ops import quant as Q

    gen = torch.Generator(device=dev).manual_seed(5)
    wq = Q.quantize_weight(torch.randn((K, N), generator=gen, device=dev)
                           * K ** -0.5)
    x = _randn(gen, dev, M, K)
    _check_w8(Q, x, wq, "gemv" if M <= Q.GEMV_MAX_M else "tiled")


@pytest.mark.parametrize("form,max_m", [("gemv", 64), ("tiled", 0)])
@pytest.mark.parametrize("M", [1, 32, 33, 48, 64])
def test_w8_both_forms_at_the_boundary(dev, monkeypatch, form, max_m, M):
    """Each form at the row counts where the boundary is measured (the
    gemv kernel takes up to 64 rows, the tiled one any), whichever side
    GEMV_MAX_M puts them on."""
    from metamorph_tpu_torch.ops import quant as Q

    monkeypatch.setattr(Q, "GEMV_MAX_M", max_m)
    gen = torch.Generator(device=dev).manual_seed(7)
    wq = Q.quantize_weight(torch.randn((4144, 1000), generator=gen,
                                       device=dev) * 0.02)
    _check_w8(Q, _randn(gen, dev, M, 4144), wq, form)


def test_w8_tiles_straddle_the_last_wave(dev):
    """The tiled form with a few more column-tile pairs than its persistent
    grid holds clusters (so some clusters take a second pair) and an odd
    number of column tiles (one CTA of the last pair has no tile of its
    own); and the gemv form on a weight whose units do not divide evenly
    over its grid."""
    from metamorph_tpu_torch.ops import quant as Q

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(9)
    rows = -(-264 // Q.TILED_BM)            # row tiles at M = 264
    cols = -(-(sms // 2 + 3) // rows)       # column-tile pairs
    N = Q.TILED_BN * (2 * cols - 2) + Q.TILED_BN // 2   # 2 cols - 1 tiles
    wq = Q.quantize_weight(torch.randn((1024, N), generator=gen,
                                       device=dev) * 0.03)
    _check_w8(Q, _randn(gen, dev, 264, 1024), wq, "tiled")
    (_, shape, _, _), = wq.plans.values()
    assert rows * cols > shape[4] // 2
    K, N = 1408, 4360                  # 11 x 35 units of 128 x 128
    wq = Q.quantize_weight(torch.randn((K, N), generator=gen, device=dev)
                           * 0.03)
    _check_w8(Q, _randn(gen, dev, 8, K), wq, "gemv")
    (_, shape, _, _), = wq.plans.values()
    assert (11 * 35) % shape[4] != 0


def test_w8_convert_is_exact_for_every_byte(dev):
    """Every int8 value, -128 included, through both forms' convert: one-hot
    rows of x pick single weights, so out is q^T exactly (scale 1)."""
    from metamorph_tpu_torch.ops import quant as Q

    K = N = 256
    q = ((torch.arange(N)[:, None] + torch.arange(K)[None]) % 256 - 128
         ).to(torch.int8)
    w = Q.QuantizedWeight(q.to(dev), torch.ones(N, device=dev))
    for M, form in ((8, "gemv"), (K, "tiled")):
        x = torch.eye(K, device=dev)[:M].to(torch.bfloat16)
        Q.W8_MATMUL.reset()
        out = Q.quantized_matmul(x, w)
        torch.cuda.synchronize()
        assert Q.W8_MATMUL.forms == {form: 1}
        assert torch.equal(out.float().cpu(), q[:, :M].t().float())


def test_w8_matmul_takes_leading_dims(dev):
    from metamorph_tpu_torch.ops import quant as Q

    gen = torch.Generator(device=dev).manual_seed(6)
    wq = Q.quantize_weight(torch.randn((256, 384), generator=gen,
                                       device=dev))
    x = _randn(gen, dev, 2, 3, 256)
    out = Q.quantized_matmul(x, wq)
    assert out.shape == (2, 3, 384)
    assert torch.equal(out.reshape(6, 384),
                       Q.quantized_matmul(x.reshape(6, 256), wq))


def test_w8_plans_follow_rows_and_storage(dev):
    """Kernel F's launch arguments are worked out once per (rows, depth,
    device, storage) of a weight: a second row count gets its own plan,
    and a weight whose buffers are replaced is planned again against the
    new storage (never launched on the old pointers)."""
    from metamorph_tpu_torch.ops import quant as Q

    gen = torch.Generator(device=dev).manual_seed(8)
    wq = Q.quantize_weight(torch.randn((512, 320), generator=gen,
                                       device=dev))
    x8, x300 = _randn(gen, dev, 8, 512), _randn(gen, dev, 300, 512)
    for x in (x8, x300, x8):
        ref = Q.quantized_matmul_plain(x.float(), wq)
        err = ((Q.quantized_matmul(x, wq).float() - ref).abs().max()
               / ref.abs().max()).item()
        assert err <= W8_TOL
    assert len(wq.plans) == 2
    wq.q = wq.q.clone()
    wq.scale = wq.scale * 2
    ref = Q.quantized_matmul_plain(x8.float(), wq)
    out = Q.quantized_matmul(x8, wq)
    assert len(wq.plans) == 3
    assert ((out.float() - ref).abs().max() / ref.abs().max()).item() \
        <= W8_TOL


def test_quantize_consume_keeps_the_peak_near_the_bf16_model(dev):
    """`quantize_llama_decode(consume=True)` drops each bf16 weight once it
    is quantized: the peak stays within one weight's fp32 temporaries of
    the bf16 model, where keeping the source adds the whole int8 model."""
    from metamorph_tpu_torch.config import LlamaConfig
    from metamorph_tpu_torch.convert import init_llama
    from metamorph_tpu_torch.ops import quant as Q

    cfg = LlamaConfig(vocab_size=1000, hidden_size=256,
                      intermediate_size=1024, num_layers=16, num_heads=4,
                      num_kv_heads=2, head_dim=64, tie_word_embeddings=False)
    peaks = {}
    for consume in (False, True):
        src = init_llama(cfg, seed=3, device=dev, dtype=torch.bfloat16)
        n_max = max(p.numel() for p in src.parameters())
        torch.cuda.synchronize()
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = Q.quantize_llama_decode(src, consume=consume)
        torch.cuda.synchronize()
        peaks[consume] = torch.cuda.max_memory_allocated() - start
        int8 = sum(m.q.numel() for m in out.modules()
                   if isinstance(m, Q.QuantizedWeight))
        assert (src.layers[3].w_up is None) == consume
        assert (src.lm_head is None) == consume
        del src, out
    assert peaks[False] >= int8
    assert peaks[True] <= 16 * n_max < int8


def test_w8_wrapper_refuses_what_the_kernel_does_not_take(dev):
    from metamorph_tpu_torch.ops import quant as Q

    wq = Q.quantize_weight(torch.randn(64, 48, device=dev))
    Q.W8_MATMUL.reset()
    with pytest.raises(ValueError, match="bf16"):
        Q.quantized_matmul(torch.randn(2, 64, device=dev), wq)
    with pytest.raises(ValueError, match="does not match"):
        Q.quantized_matmul(torch.randn(2, 32, device=dev).bfloat16(), wq)
    with pytest.raises(ValueError, match="multiple of 16"):
        Q.quantized_matmul(torch.randn(2, 40, device=dev).bfloat16(),
                           Q.quantize_weight(torch.randn(40, 48,
                                                         device=dev)))
    assert Q.W8_MATMUL.launches == 0


def test_int8_model_on_card_matches_cpu(dev):
    """A small LLaMA quantized for serving: prefill and a decode step on
    the card (every dense product on kernel F) against the same model
    quantized on the CPU in fp32 (plain products). The card quantizes its
    bf16 weights, the CPU its fp32 ones, so a few int8 steps differ."""
    from metamorph_tpu_torch.config import LlamaConfig
    from metamorph_tpu_torch.convert import init_llama
    from metamorph_tpu_torch.models import llama as L
    from metamorph_tpu_torch.ops import quant as Q

    cfg = LlamaConfig(vocab_size=1000, hidden_size=256,
                      intermediate_size=512, num_layers=2, num_heads=8,
                      num_kv_heads=2, head_dim=64, tie_word_embeddings=False)
    cpu = Q.quantize_llama_decode(init_llama(cfg, seed=3, device="cpu",
                                             dtype=torch.float32))
    gpu = Q.quantize_llama_decode(init_llama(
        cfg, seed=3, device="cpu", dtype=torch.float32).to(
        device=dev, dtype=torch.bfloat16))
    ids = torch.randint(0, 1000, (2, 12),
                        generator=torch.Generator().manual_seed(4))
    logits = {}
    Q.W8_MATMUL.reset()
    with torch.no_grad():
        for name, model, d in (("cpu", cpu, torch.device("cpu")),
                               ("gpu", gpu, dev)):
            cache = L.init_kv_cache(cfg, 2, 32, dtype=model.embed.dtype,
                                    device=d)
            L.prefill(model, cfg, L.embed_tokens(model, ids.to(d)),
                      torch.arange(12, device=d)[None].expand(2, 12), None,
                      cache)
            idx = torch.full((2,), 12, dtype=torch.int32, device=d)
            h, _ = L.decode_step(model, cfg, L.embed_tokens(
                model, torch.tensor([[5], [9]], device=d)), idx[:, None],
                cache, idx)
            logits[name] = L.lm_head(model, cfg, h[:, 0]).float().cpu()
    cos = torch.nn.functional.cosine_similarity(logits["gpu"],
                                                logits["cpu"], dim=-1)
    assert torch.isfinite(logits["gpu"]).all() and cos.min() >= 0.99
    # 7 products per layer in the prefill and in the step, and the head
    assert Q.W8_MATMUL.launches == 2 * 7 * 2 + 1



@pytest.mark.parametrize("case", ["bf16", "bf16_image", "kv_int8", "w8"])
def test_graphed_plain_ticks_equal_eager_ticks_on_card(dev, case):
    """A small MetaMorph served twice on the card through the same
    admissions between ticks: an engine that replays its plain ticks from
    CUDA graphs and one that runs `_decode_all` eagerly (no capture) hold
    equal ids, lengths, next_embed and img_embeds after every tick, and
    finish with equal requests. Over a bf16 cache (text, and rows forced
    into image generation), the int8 KV cache, and kernel F weights."""
    import numpy as np

    from metamorph_tpu_torch.config import (LlamaConfig, MetaMorphConfig,
                                            MultimodalConfig, SiglipConfig)
    from metamorph_tpu_torch.constants import IM_START_TOKEN_ID
    from metamorph_tpu_torch.convert import init_params
    from metamorph_tpu_torch.inference.serve import Request, ServeEngine
    from metamorph_tpu_torch.ops.quant import quantize_llama_decode

    cfg = MetaMorphConfig(
        llama=LlamaConfig(vocab_size=128258, hidden_size=256,
                          intermediate_size=512, num_layers=2, num_heads=8,
                          num_kv_heads=2, head_dim=64, rope_scaling=False,
                          tie_word_embeddings=False),
        siglip=SiglipConfig.tiny(), mm=MultimodalConfig(num_image_tokens=4))
    model = init_params(cfg, seed=5, device=dev)
    model.requires_grad_(False)
    if case == "bf16_image":
        with torch.no_grad():
            model.llama.lm_head[:, IM_START_TOKEN_ID] = 4.0
    if case == "w8":
        model.llama = quantize_llama_decode(model.llama)
    rng = np.random.default_rng(2)
    reqs = [dict(prompt_ids=rng.integers(10, 128000, (t,)).astype(np.int32),
                 max_new_tokens=b, uid=i)
            for i, (t, b) in enumerate([(12, 21), (40, 14), (7, 30),
                                        (60, 11), (25, 17)])]
    plan = [0, 0, 2, 3, 6]
    runs = []
    for graphed in (False, True):
        eng = ServeEngine(model, cfg, n_slots=4, max_cache_len=256,
                          max_new_tokens_cap=32, max_images=4,
                          prefill_buckets=(16, 32, 64), steps_per_sync=4,
                          kv_int8=case == "kv_int8")
        if not graphed:
            eng._capture = None
        seen = []
        with torch.no_grad():
            for t in range(100):
                for r, at in zip(reqs, plan):
                    if at == t:
                        eng.submit(Request(**r))
                if t > max(plan) and not (eng.pending or any(
                        u is not None for u in eng.slot_uid)):
                    break
                eng.step()
                st = eng.state
                seen.append([x.clone() for x in (
                    st.ids, st.cache_lens, st.next_embed, st.img_embeds)])
        runs.append((eng, {c.uid: c for c in eng.completed}, seen))
    (eager, ref, ref_seen), (eng, out, seen) = runs
    assert eager.tick_counts["plain_graphed"] == 0
    assert eng.tick_counts["captures"] == 1
    assert eng.tick_counts["plain_graphed"] == eng.tick_counts["plain"] - 1
    kern = "mm_decode_attn_int8" if case == "kv_int8" else "mm_decode_attn_bf16"
    captured, replayed = eng.graph_launches()[kern]
    assert captured == 4 * 2 and replayed == captured * eng.tick_counts[
        "plain_graphed"]
    if case == "w8":
        assert eng.graph_launches()["mm_w8_matmul"][0] == 4 * (2 * 7 + 1)
    assert sorted(out) == sorted(ref) == list(range(5))
    for uid, c in ref.items():
        assert np.array_equal(out[uid].ids, c.ids), uid
        assert out[uid].steps == c.steps
        assert np.array_equal(out[uid].image_embeds, c.image_embeds)
    if case == "bf16_image":
        assert sum(c.image_embeds.shape[0] for c in ref.values()) > 0
    assert len(seen) == len(ref_seen)
    for k, (a, b) in enumerate(zip(seen, ref_seen)):
        for x, y in zip(a, b):
            assert torch.equal(x, y), k

def _tiny_visualizer(device):
    from metamorph_tpu_torch.visualizer import adapter, unet, vae

    ucfg, vcfg = unet.UNetConfig.tiny(), vae.VAEConfig.tiny()
    return (adapter.init_adapter(input_dim=12, hidden_dim=16,
                                 output_dim=16, num_layers=2, seed=1,
                                 device=device),
            unet.init_unet_params(ucfg, seed=2, device=device),
            vae.init_vae_params(vcfg, seed=3, device=device), ucfg, vcfg)


def test_visualizer_render_on_card_matches_cpu(dev, tmp_path, monkeypatch):
    """The visualizer written on the CPU, loaded on the card (the loader's
    default device), renders what the CPU renders from the same noise: fp32
    with TF32 off to 1e-3 on the images; bf16 finite and in [0, 1]."""
    from metamorph_tpu_torch.inference import loader
    from metamorph_tpu_torch.visualizer import pipeline

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    *cpu, ucfg, vcfg = _tiny_visualizer("cpu")
    loader.save_visualizer(str(tmp_path), *cpu, ucfg, vcfg)
    card = loader.load_visualization(str(tmp_path))
    assert {p.device.type for t in card[:3] for p in t.parameters()} == {
        "cuda"}
    embeds = torch.randn(1, 4, 12, generator=torch.Generator().manual_seed(0))
    kw = dict(num_inference_steps=4, latent_size=8, scheduler="pndm")
    ref = pipeline.render(*cpu, ucfg, vcfg, embeds,
                          torch.Generator().manual_seed(5), **kw)
    out = pipeline.render(*card[:3], ucfg, vcfg, embeds,
                          torch.Generator().manual_seed(5), **kw)
    assert out.device.type == "cuda" and out.shape == (1, 16, 16, 3)
    assert (out.cpu() - ref).abs().max().item() <= 1e-3
    half = loader.load_visualization(str(tmp_path), dtype=torch.bfloat16)
    img = pipeline.render(*half[:3], ucfg, vcfg, embeds,
                          torch.Generator().manual_seed(5), **kw)
    assert torch.isfinite(img).all() and 0 <= img.min() and img.max() <= 1


def test_visualizer_entry_points_default_to_the_card(dev, tmp_path):
    from metamorph_tpu_torch.inference import loader

    *card, ucfg, vcfg = _tiny_visualizer("cuda")
    assert all(p.device.type == "cuda" for t in card for p in t.parameters())
    loader.save_visualizer(str(tmp_path), *card, ucfg, vcfg)
    back = loader.load_visualization(str(tmp_path), device="cpu")
    for a, b in zip(card, back[:3]):
        want = dict(a.named_parameters())
        for n, p in b.named_parameters():
            assert p.device.type == "cpu" and torch.equal(p, want[n].cpu())


# ---- offload_optimizer -----------------------------------------------------------

def _offload_run(dev, offload, steps=2):
    """chip_smoke.py's small train config (head dim 128, so kernels A, C
    and D run) in bf16 on the card, `steps` train steps on one packed
    1024-token row; the moments offloaded or not. Returns (model, state,
    losses, peak bytes above the weights)."""
    import dataclasses

    import numpy as np

    from chip_smoke import small_train_cfg
    from metamorph_tpu_torch.convert import init_params
    from metamorph_tpu_torch.multimodal.packing import batch_to_arrays
    from metamorph_tpu_torch.train import train_step as TS
    from metamorph_tpu_torch.train.optimizer import make_optimizer
    from metamorph_tpu_torch.train.profile_train import packed_row

    cfg = small_train_cfg()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, learning_rate=1e-3, offload_optimizer=offload))
    model = init_params(cfg, seed=0, device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    state = TS.init_train_state(model, cfg)
    tx = make_optimizer(cfg.train, model)
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v
             in batch_to_arrays(packed_row(1024, 4, 2, seed=3)).items()}
    gen = torch.Generator(device=dev).manual_seed(1)
    pixels = torch.randn((2, 28, 28, 3), generator=gen, device=dev)
    losses = []
    for _ in range(steps):
        state, m = TS.train_step(state, batch, pixels, cfg, tx)
        losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    return model, state, losses, torch.cuda.max_memory_allocated() - base


def test_offloaded_step_on_card_is_bitwise_and_pinned(dev, monkeypatch):
    """Two bf16 steps with the moments in pinned host memory against the
    moments on the card: losses, parameters and moments bitwise; the peak
    above the weights lower by about the moments (CHUNK cut to 2**16
    elements, so the staging slots stay small)."""
    from metamorph_tpu_torch.train import optimizer as opt_lib

    monkeypatch.setattr(opt_lib, "CHUNK", 1 << 16)
    ref_model, ref, ref_losses, ref_peak = _offload_run(dev, False)
    model, state, losses, peak = _offload_run(dev, True)
    assert losses == ref_losses
    for (n, p), (_, q) in zip(model.named_parameters(),
                              ref_model.named_parameters()):
        assert torch.equal(p, q), n
    moments = [t for k in ("mu", "nu") for t in state["opt_state"][k].values()]
    assert moments and all(t.is_pinned() and t.device.type == "cpu"
                           for t in moments)
    for k in ("mu", "nu"):
        for n, t in state["opt_state"][k].items():
            assert torch.equal(t.to(dev), ref["opt_state"][k][n]), (k, n)
    moment_bytes = sum(t.numel() * t.element_size() for t in moments)
    assert peak <= ref_peak - 0.9 * moment_bytes, (peak, ref_peak,
                                                   moment_bytes)


def test_a_failed_pin_raises(dev):
    """No fallback to pageable memory: a pin the host cannot give (16 TiB)
    raises, naming the offload."""
    from metamorph_tpu_torch.train.optimizer import pinned_zeros

    with pytest.raises(RuntimeError, match="offload_optimizer: could not pin"):
        pinned_zeros(1 << 44, torch.uint8)


def test_offload_loads_wait_for_kernels_queued_on_the_main_stream(
        dev, monkeypatch):
    """The staging slots come from the main stream's pool, which hands out
    memory that kernels still queued there will write. The main stream is
    held busy (`torch.cuda._sleep`), then queued to fill freed blocks of
    the slots' size with NaN; the offloaded update must load its moments
    only after those fills, and stay bitwise the on-card update."""
    from torch import nn

    from metamorph_tpu_torch.config import TrainConfig
    from metamorph_tpu_torch.train import optimizer as opt_lib

    chunk = 1 << 20
    monkeypatch.setattr(opt_lib, "CHUNK", chunk)
    gen = torch.Generator(device=dev).manual_seed(4)
    p0 = torch.randn(3 * chunk, generator=gen, device=dev).bfloat16()
    g0 = torch.randn(3 * chunk, generator=gen, device=dev).bfloat16()
    out = {}
    for offload in (False, True):
        model = nn.Module()
        model.w = nn.Parameter(p0.clone())
        model.w.grad = g0.clone()
        tx = opt_lib.AdamW(TrainConfig(offload_optimizer=offload,
                                       grad_clip_norm=1e9), model)
        state = tx.init(model)
        state["count"] = 100            # past the warmup: lr > 0
        torch.cuda.synchronize()
        if offload:
            torch.cuda._sleep(1 << 30)  # ~0.5 s of the main stream
            bait = [torch.empty(chunk, dtype=torch.bfloat16, device=dev)
                    for _ in range(8)]
            for t in bait:
                t.fill_(float("nan"))
            del bait
        tx.update(model, state)
        torch.cuda.synchronize()
        out[offload] = (model.w.detach().clone(),
                        [state[k]["w"].to(dev) for k in ("mu", "nu")])
    assert torch.isfinite(out[True][0].float()).all()
    assert torch.equal(out[True][0], out[False][0])
    for a, b in zip(out[True][1], out[False][1]):
        assert torch.equal(a, b)


def test_ring_positions_on_card_match_the_plain_ring(dev):
    """Every position of a 4-rank ring in turn (`_ring_body` fed from a
    list of chunks, as chip_smoke.py 14b runs it) on kernels A, C and D
    against the same ring on the plain versions (fp32 from the same bf16
    inputs): o within 2e-2 of each row's max |ref| (O_TOL), the q/k/v
    gradients within BWD_TOL of the tensor's max |ref|, as the backward
    kernels' tests hold them (a causal row's dq is near zero where it sees
    few keys, so a row's own max is no scale for it); each kernel launched
    once per unskipped chunk (4 diagonals, 6 full chunks)."""
    from metamorph_tpu_torch.parallel import ring_attention as R

    gen = torch.Generator(device=dev).manual_seed(14)
    B, H, KV, Dh, n, C = 2, 8, 2, 128, 4, 192
    q, k, v, do = (_randn(gen, dev, B, H, n * C, Dh),
                   _randn(gen, dev, B, KV, n * C, Dh),
                   _randn(gen, dev, B, KV, n * C, Dh),
                   _randn(gen, dev, B, H, n * C, Dh))

    def ring(q, k, v, do, dtype):
        ks = [k[:, :, j * C:(j + 1) * C].float().requires_grad_()
              for j in range(n)]
        vs = [v[:, :, j * C:(j + 1) * C].float().requires_grad_()
              for j in range(n)]
        outs, dqs = [], []
        for idx in range(n):
            sl = slice(idx * C, (idx + 1) * C)
            qi = q[:, :, sl].clone().requires_grad_()
            o, _ = R._ring_body(qi, idx, n, R.chunks_source(ks, vs, idx,
                                                            dtype))
            o.to(dtype).backward(do[:, :, sl])
            outs.append(o.detach())
            dqs.append(qi.grad)
        return (torch.cat(outs, 2), torch.cat(dqs, 2),
                torch.cat([x.grad for x in ks], 2),
                torch.cat([x.grad for x in vs], 2))

    kernels = (fa.FLASH_FWD, fa.FLASH_BWD_DQ, fa.FLASH_BWD_DKV)
    before = [kern.launches for kern in kernels]
    got = ring(q, k, v, do, torch.bfloat16)
    torch.cuda.synchronize()
    assert [kern.launches - b for kern, b in zip(kernels, before)] == \
        [n + n * (n - 1) // 2] * 3
    cpu = [x.cpu().float() for x in (q, k, v, do)]
    ref = ring(*cpu, torch.float32)
    diff = (got[0].float().cpu() - ref[0]).abs().amax(-1)
    rel = (diff / ref[0].abs().amax(-1).clamp_min(1e-3)).max().item()
    assert rel <= O_TOL, rel
    for name, a, r in zip(("dq", "dk", "dv"), got[1:], ref[1:]):
        err = (a.float().cpu() - r).abs().max().item()
        assert err <= BWD_TOL * r.abs().max().item(), (name, err)


def test_one_rank_nccl_sharded_step_matches_the_one_card_step(dev, tmp_path):
    """`make_sharded_train_step` over a one-rank NCCL group, the 4b width
    (chip_smoke.small_train_cfg), two bf16 steps: the losses, grad norms and
    every parameter bitwise those of the one-card step; the group is
    NCCL."""
    import dataclasses

    import numpy as np
    import torch.distributed as dist

    from chip_smoke import small_train_cfg
    from metamorph_tpu_torch.config import MeshConfig
    from metamorph_tpu_torch.convert import init_params
    from metamorph_tpu_torch.multimodal.packing import batch_to_arrays
    from metamorph_tpu_torch.parallel import context
    from metamorph_tpu_torch.parallel import mesh as M
    from metamorph_tpu_torch.train import train_step as TS
    from metamorph_tpu_torch.train.optimizer import local, make_optimizer
    from metamorph_tpu_torch.train.profile_train import packed_row

    cfg = small_train_cfg()
    cfg = dataclasses.replace(cfg, mesh=MeshConfig(1, -1, 1),
                              train=dataclasses.replace(cfg.train,
                                                        learning_rate=1e-3))
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v
             in batch_to_arrays(packed_row(1024, 4, 2, seed=3)).items()}
    gen = torch.Generator(device=dev).manual_seed(1)
    pixels = torch.randn((2, 28, 28, 3), generator=gen, device=dev)

    model = init_params(cfg, seed=0, device=dev, dtype=torch.bfloat16)
    state = TS.init_train_state(model, cfg)
    tx = make_optimizer(cfg.train, model)
    ref = [TS.train_step(state, batch, pixels, cfg, tx)[1] for _ in range(2)]

    M.init_distributed("cuda", store=dist.FileStore(str(tmp_path / "s"), 1),
                       rank=0, world_size=1, device=dev)
    try:
        assert dist.get_backend() == "nccl"
        mesh = M.build_mesh(cfg.mesh, "cuda")
        sharded = init_params(cfg, seed=0, device=dev, dtype=torch.bfloat16)
        step, _, sstate = TS.make_sharded_train_step(cfg, mesh, sharded)
        got = [step(sstate, batch, pixels)[1] for _ in range(2)]
        for a, b in zip(got, ref):
            for key in ("loss", "grad_norm", "n_text_tokens"):
                assert float(a[key]) == float(b[key]), key
        for (n, p), (_, r) in zip(sstate["params"].named_parameters(),
                                  model.named_parameters()):
            assert torch.equal(local(p), r), n
    finally:
        context.set_current_mesh(None)
        context.set_sequence_axis(None)
        dist.destroy_process_group()


def test_rank_device_names_the_card(dev, monkeypatch):
    """`train()`'s device rule: "cuda" becomes the current card with its
    index (set_device needs one), LOCAL_RANK picks the card under
    torchrun."""
    from metamorph_tpu_torch.train.trainer import rank_device

    monkeypatch.delenv("LOCAL_RANK", raising=False)
    assert rank_device("cuda") == torch.device("cuda",
                                                torch.cuda.current_device())
    monkeypatch.setenv("LOCAL_RANK", "0")
    assert rank_device("cuda") == torch.device("cuda", 0)
    assert rank_device("cpu") == torch.device("cpu")


# -- kernel G and the routed experts (the DeepSeek-V3 block) --------------

@pytest.mark.parametrize("B,lens", [(3, [1, 17, 4096]), (64, None)],
                         ids=["ragged", "many_rows"])
def test_mla_decode_kernel_matches_plain(dev, B, lens):
    """Kernel G at the published widths (16 heads, latent 512 + rope 64)
    on ragged rows, layer 1 of a two-layer cache: its splits, their merge
    and a row of one key; bitwise the same on a second launch (the
    arrival counters are left at zero). 2e-2 on the bf16 output: its
    rounding plus the bf16 probability tile of the PV product."""
    from metamorph_tpu_torch.ops import mla_decode as mg

    gen = torch.Generator(device=dev).manual_seed(7)
    S, H = 4096, 16
    cache = _randn(gen, dev, 2, B, S, 576)
    q = _randn(gen, dev, B, H, 576)
    if lens is None:
        lens = torch.randint(1, S + 1, (B,), generator=gen,
                             device=dev).tolist()
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    scale = 192 ** -0.5
    n0 = mg.MLA_DECODE.launches
    o = mg.mla_decode_attention(q, cache, lengths, 1, 512, scale)
    again = mg.mla_decode_attention(q, cache, lengths, 1, 512, scale)
    torch.cuda.synchronize()
    assert mg.MLA_DECODE.launches == n0 + 2
    want = mg.mla_decode_plain(q.float(), cache[1].float(), lengths, 512,
                               scale)
    assert (o.float() - want).abs().max().item() <= O_TOL
    assert torch.equal(o, again)


def _mla_moe_cfg(**over):
    llama = dict(vocab_size=128258, hidden_size=256, intermediate_size=512,
                 num_layers=3, num_heads=4, num_kv_heads=4, head_dim=96,
                 rope_theta=800000.0, rms_norm_eps=1e-5,
                 max_position_embeddings=4096, rope_scaling=False,
                 tie_word_embeddings=False, kv_lora_rank=128,
                 qk_nope_head_dim=32, qk_rope_head_dim=64, v_head_dim=32,
                 n_routed_experts=8, num_experts_per_tok=2,
                 moe_intermediate_size=64, n_shared_experts=1,
                 first_k_dense_replace=1, routed_scaling_factor=2.446,
                 norm_topk_prob=True)
    llama.update(over)
    return {"llama": llama,
            "siglip": dict(image_size=28, patch_size=14, hidden_size=32,
                           intermediate_size=64, num_layers=2, num_heads=4,
                           layer_norm_eps=1e-6, select_layer=-1),
            "mm": dict(projector_type="mlp2x_gelu", vision_head_type="mlp",
                       num_image_tokens=4)}


def test_graphed_mla_moe_ticks_equal_eager_ticks_on_card(dev):
    """A small MetaMorph on the DeepSeek-V3 block served twice on the card
    through the same admissions: plain ticks replayed from CUDA graphs
    (kernel G, the grouped products, the routing counters) against eager
    ones hold equal ids, lengths and next_embed after every tick, equal
    expert counts, and finish with equal requests."""
    import numpy as np

    from benchmark.weights_mla_moe import fill_model_
    from metamorph_tpu_torch.config import MetaMorphConfig
    from metamorph_tpu_torch.inference.serve import Request, ServeEngine
    from metamorph_tpu_torch.models.metamorph import MetaMorph

    cfg_d = _mla_moe_cfg()
    cfg = MetaMorphConfig.from_dict(cfg_d)
    with torch.no_grad():
        model = MetaMorph(cfg, dtype=torch.bfloat16, device=dev)
        fill_model_(model, cfg_d, 5)
    model.requires_grad_(False)
    rng = np.random.default_rng(2)
    reqs = [dict(prompt_ids=rng.integers(10, 128000, (t,)).astype(np.int32),
                 max_new_tokens=b, uid=i)
            for i, (t, b) in enumerate([(12, 21), (40, 14), (7, 30),
                                        (60, 11), (25, 17)])]
    plan = [0, 0, 2, 3, 6]
    runs = []
    for graphed in (False, True):
        eng = ServeEngine(model, cfg, n_slots=4, max_cache_len=256,
                          max_new_tokens_cap=32, max_images=4,
                          prefill_buckets=(16, 32, 64), steps_per_sync=4)
        eng.log_routes()
        if not graphed:
            eng._capture = None
        seen, routes = [], []
        with torch.no_grad():
            for t in range(100):
                for r, at in zip(reqs, plan):
                    if at == t:
                        eng.submit(Request(**r))
                if t > max(plan) and not (eng.pending or any(
                        u is not None for u in eng.slot_uid)):
                    break
                eng.step()
                st = eng.state
                seen.append([x.clone() for x in (
                    st.ids, st.cache_lens, st.next_embed)])
                routes.append(eng.routes)
        runs.append((eng, {c.uid: c for c in eng.completed}, seen, routes))
    (eager, ref, ref_seen, ref_routes), (eng, out, seen, routes) = runs
    assert eager.tick_counts["plain_graphed"] == 0
    assert eng.tick_counts["captures"] == 1
    assert eng.tick_counts["plain_graphed"] == eng.tick_counts["plain"] - 1
    for uid, c in ref.items():
        np.testing.assert_array_equal(out[uid].ids, c.ids)
        np.testing.assert_array_equal(out[uid].routes, c.routes)
    for a, b in zip(seen, ref_seen):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    assert any(r is not None for r in routes)
    for a, b in zip(routes, ref_routes):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    launches = dict(eng.graph_launches())
    assert launches["mla_decode_attn_kernel"][1] > 0
    assert launches["grouped_mm"][1] > 0


def test_routed_layer_on_card_matches_reference(dev):
    """The routed layer at Kimi-VL-A3B's widths (D 2,048, 64 experts of
    1,408, top 6, a shared expert of 2,816) in bf16 on the card against
    the reference's float32 loop over experts on the same weights and
    inputs. The router sees the same float32 logits on both sides, so the
    picks agree; 3e-2 of the output's largest entry covers the bf16
    products (three roundings of relative 2**-9 through a SwiGLU)."""
    from benchmark.reference import mla_moe as ref
    from benchmark.reference.precision import fp32_only
    from benchmark.weights_mla_moe import weights
    from metamorph_tpu_torch.config import LlamaConfig
    from metamorph_tpu_torch.models import mla_moe
    from metamorph_tpu_torch.ops import moe

    fp32_only()
    over = dict(hidden_size=2048, n_routed_experts=64, num_experts_per_tok=6,
                moe_intermediate_size=1408, n_shared_experts=2,
                num_layers=2, first_k_dense_replace=1)
    cfg_d = _mla_moe_cfg(**over)
    lc = LlamaConfig(**cfg_d["llama"])
    with torch.no_grad():
        layer = mla_moe.MlaMoeLayer(lc, 1, torch.bfloat16, dev)
    W = {k[len("llama.layers.1."):]: v for k, v in
         weights(cfg_d, 3, dev, torch.bfloat16).items()
         if k.startswith("llama.layers.1.")}
    with torch.no_grad():
        for k, v in W.items():
            getattr(layer, k).copy_(v)
    gen = torch.Generator(device=dev).manual_seed(8)
    h = _randn(gen, dev, 4, 16, 2048)
    n0 = moe.GROUPED_MM.launches
    with torch.no_grad():
        got = mla_moe._ffn(layer, lc, h).float()
    torch.cuda.synchronize()
    assert moe.GROUPED_MM.launches == n0 + 3
    want = ref.moe(h.float().reshape(-1, 2048),
                   {k: v.float() for k, v in W.items()},
                   cfg_d["llama"]).view(4, 16, 2048)
    err = (got - want).abs().max() / want.abs().max()
    assert err.item() <= 3e-2
