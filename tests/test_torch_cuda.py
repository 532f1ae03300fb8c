"""PyTorch port, CUDA kernels on the card: each kernel against its plain
PyTorch version (fp32 math and fp32 output from the same bf16 inputs), the
launch counters,
and the wrappers' input checks. Skips where there is no CUDA device.

On a machine with an NVIDIA GPU (and no JAX, which tests/conftest.py
imports):  python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: 2e-2 on bf16 outputs (a bf16 rounding of |o| up to ~4 plus
the bf16 probability tile the flash kernel feeds its PV product), 2e-3 on
the fp32 logsumexp (only the order of fp32 sums differs). The backward
kernels are held to 3e-2 of max|ref| for each of dq, dk, dv: P and dS
enter their tensor-core products rounded to bf16 (relative 2**-9 each),
and the outputs are bf16."""

import pytest
import torch

from metamorph_tpu_torch.ops import decode_attention as da
from metamorph_tpu_torch.ops import flash_attention as fa

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
