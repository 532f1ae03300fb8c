"""Flash attention, forward and backward (counterpart of
`metamorph_tpu/ops/flash_attention.py`).

Three CUDA kernels of the port:
  * kernel A, `csrc/flash_fwd.cu`, replaces the Pallas forward kernels
    `_fwd_kernel_tri` and `_fwd_kernel`;
  * kernel C, `csrc/flash_bwd.cu` `mm_flash_bwd_dq_bf16`, replaces the
    Pallas dq kernels `_bwd_dq_kernel_tri` and `_bwd_dq_kernel`;
  * kernel D, `csrc/flash_bwd.cu` `mm_flash_bwd_dkv_bf16`, replaces the
    Pallas dk/dv kernels `_bwd_dkv_kernel_tri` and `_bwd_dkv_kernel`.
`_FlashFn` (a `torch.autograd.Function`) joins them: its forward is kernel
A and saves (q, k, v, o, lse); its backward forms delta = rowsum(do * o) in
fp32 and runs kernels C and D. The wrappers pick the route by where the
tensors live: CPU tensors take the plain PyTorch versions
(`flash_attention_plain`, `flash_attention_bwd_plain`), CUDA tensors launch
the kernels or raise; there is no fallback from the card to the plain path.

Semantics (those of the JAX kernels):
  * key j is visible to query i iff j < length[b] and, when causal, j <= i;
  * right padding arrives as per-row `lengths` (or an `attn_mask` whose
    row sums give them); rows at or past the length still attend to the
    valid keys, and a row with no visible key gets o = 0, lse = -1e30 and
    no gradient;
  * GQA: q head h reads kv head h // (H // KV); K/V are never repeated;
  * fp32 softmax; the kernels take bf16 inputs with fp32 accumulation;
  * `flash_attention_with_lse` is differentiable in both outputs: the lse
    cotangent enters the backward as ds = p * (dp - delta + dlse) * scale.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from metamorph_tpu_torch.kernels._build import Kernel

NEG_INF = -1e30

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
FLASH_FWD = Kernel("mm_flash_fwd_bf16",
                   [_P, _P, _P, _P, _P, _P] + [_I] * 6 + [_L] * 12
                   + [ctypes.c_float, _I, _P])
FLASH_BWD_DQ = Kernel("mm_flash_bwd_dq_bf16",
                      [_P] * 8 + [_I] * 6 + [_L] * 15
                      + [ctypes.c_float, _I, _P])
FLASH_BWD_DKV = Kernel("mm_flash_bwd_dkv_bf16",
                       [_P] * 9 + [_I] * 6 + [_L] * 18
                       + [ctypes.c_float, _I, _P])


def _visible(lengths: torch.Tensor, T: int, S: int, causal: bool, device
             ) -> torch.Tensor:
    """[B,1,1,T,S] bool: key j visible to query i."""
    B = lengths.shape[0]
    col = torch.arange(S, device=device)
    mask = (col[None, None, :] < lengths.to(device)[:, None, None]
            ).expand(B, T, S)
    if causal:
        row = torch.arange(T, device=device)
        mask = mask & (col[None, :] <= row[:, None])[None]
    return mask[:, None, None]


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          lengths: torch.Tensor, causal: bool = True,
                          scale: Optional[float] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version, kernel layout: q [B,H,T,Dh], k/v [B,KV,S,Dh],
    lengths [B]. Computes in fp32; returns (o [B,H,T,Dh] in q.dtype,
    lse [B,H,T] fp32)."""
    B, H, T, Dh = q.shape
    KV, S = k.shape[1], k.shape[2]
    G = H // KV
    scale = scale if scale is not None else Dh ** -0.5
    qg = q.float().reshape(B, KV, G, T, Dh)
    s = torch.einsum("bkgtd,bksd->bkgts", qg, k.float()) * scale
    mask = _visible(lengths, T, S, causal, q.device)
    s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * mask
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    o = torch.einsum("bkgts,bksd->bkgtd", p, v.float()) / l_safe
    lse = torch.where(l == 0, torch.full_like(l, NEG_INF), m + torch.log(l_safe))
    return (o.reshape(B, H, T, Dh).to(q.dtype), lse.reshape(B, H, T))


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              lse: torch.Tensor, do: torch.Tensor,
                              dlse: Optional[torch.Tensor],
                              lengths: torch.Tensor, causal: bool = True,
                              scale: Optional[float] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Plain PyTorch backward, kernel layout (q/o/do [B,H,T,Dh], k/v
    [B,KV,S,Dh], lse/dlse [B,H,T]), in fp32 with einsums, following the
    JAX `_bwd`: P is recomputed from the forward's lse, delta =
    rowsum(do * o), ds = p * (dp - delta + dlse) * scale, and dk/dv sum
    over each kv head's group of q heads. Returns (dq, dk, dv) in the
    dtypes of q, k, v."""
    B, H, T, Dh = q.shape
    KV, S = k.shape[1], k.shape[2]
    G = H // KV
    scale = scale if scale is not None else Dh ** -0.5
    qg = q.float().reshape(B, KV, G, T, Dh)
    dog = do.float().reshape(B, KV, G, T, Dh)
    kf, vf = k.float(), v.float()
    lse_g = lse.float().reshape(B, KV, G, T, 1)
    delta = (dog * o.float().reshape(B, KV, G, T, Dh)).sum(-1, keepdim=True)
    if dlse is not None:
        delta = delta - dlse.float().reshape(B, KV, G, T, 1)
    s = torch.einsum("bkgtd,bksd->bkgts", qg, kf) * scale
    mask = _visible(lengths, T, S, causal, q.device)
    # the mask goes in before the exp: an empty row's lse is -1e30
    p = torch.exp(torch.where(mask, s - lse_g, NEG_INF))
    del s
    dv = torch.einsum("bkgts,bkgtd->bksd", p, dog)
    dp = torch.einsum("bkgtd,bksd->bkgts", dog, vf)
    ds = p * (dp - delta) * scale
    del p, dp
    dq = torch.einsum("bkgts,bksd->bkgtd", ds, kf).reshape(B, H, T, Dh)
    dk = torch.einsum("bkgts,bkgtd->bksd", ds, qg)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_operand(name: str, x: torch.Tensor, device) -> None:
    if not x.is_cuda or x.device != device:
        raise ValueError(f"{name} must be a CUDA tensor on {device}, got "
                         f"{x.device}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"{name} must be bfloat16, got {x.dtype}")
    if x.stride(-1) != 1 or any(s % 8 for s in x.stride()[:-1]):
        raise ValueError(f"{name}: head dim must be contiguous and the other "
                         f"strides multiples of 8, got {x.stride()}")
    if x.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _check_shapes(q, k, v, lengths) -> None:
    B, H, T, Dh = q.shape
    KV = k.shape[1]
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != Dh:
        raise ValueError(f"k/v shape {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if H % KV:
        raise ValueError(f"q heads {H} not a multiple of kv heads {KV}")
    if Dh not in (64, 128):
        raise ValueError(f"head dim {Dh} unsupported by the kernel (64, 128)")
    if (lengths.device != q.device or lengths.dtype != torch.int32
            or lengths.shape != (B,) or not lengths.is_contiguous()):
        raise ValueError("lengths must be a contiguous int32 [B] tensor on "
                         "the same device")


def _check_rows(name: str, x: torch.Tensor, shape) -> None:
    if x.dtype != torch.float32 or x.shape != shape or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous fp32 {list(shape)} "
                         f"tensor")


def _strides(x: torch.Tensor):
    return x.stride(0), x.stride(1), x.stride(2)


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _launch(q, k, v, o, lse, lengths, causal: bool, scale: float) -> None:
    """Kernel A. Kernel-layout views: q/o [B,H,T,Dh], k/v [B,KV,S,Dh] (any
    strides with a contiguous head dim), lse [B,H,T] contiguous fp32."""
    B, H, T, Dh = q.shape
    KV, S = k.shape[1], k.shape[2]
    dev = q.device
    for name, x in (("q", q), ("k", k), ("v", v), ("o", o)):
        _check_operand(name, x, dev)
    _check_shapes(q, k, v, lengths)
    _check_rows("lse", lse, (B, H, T))
    with torch.cuda.device(dev):
        FLASH_FWD.launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), lengths.data_ptr(), B, H, KV, T, S, Dh,
            *_strides(q), *_strides(k), *_strides(v), *_strides(o),
            float(scale), int(bool(causal)), _stream(dev))


def _check_bwd(q, k, v, do, lse, dd, lengths, outs) -> None:
    B, H, T, _ = q.shape
    for name, x in (("q", q), ("k", k), ("v", v), ("do", do), *outs):
        _check_operand(name, x, q.device)
    _check_shapes(q, k, v, lengths)
    if do.shape != q.shape:
        raise ValueError("do must have q's shape")
    _check_rows("lse", lse, (B, H, T))
    _check_rows("delta", dd, (B, H, T))


def _launch_dq(q, k, v, do, lse, dd, dq, lengths, causal: bool,
               scale: float) -> None:
    """Kernel C. Kernel-layout views: q/do/dq [B,H,T,Dh], k/v [B,KV,S,Dh];
    lse and dd = delta - dlse contiguous fp32 [B,H,T]."""
    B, H, T, Dh = q.shape
    KV, S = k.shape[1], k.shape[2]
    _check_bwd(q, k, v, do, lse, dd, lengths, [("dq", dq)])
    if dq.shape != q.shape:
        raise ValueError("dq must have q's shape")
    with torch.cuda.device(q.device):
        FLASH_BWD_DQ.launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), dd.data_ptr(), dq.data_ptr(), lengths.data_ptr(),
            B, H, KV, T, S, Dh,
            *_strides(q), *_strides(k), *_strides(v), *_strides(do),
            *_strides(dq), float(scale), int(bool(causal)),
            _stream(q.device))


def _launch_dkv(q, k, v, do, lse, dd, dk, dv, lengths, causal: bool,
                scale: float) -> None:
    """Kernel D. As `_launch_dq`, with dk/dv [B,KV,S,Dh] views."""
    B, H, T, Dh = q.shape
    KV, S = k.shape[1], k.shape[2]
    _check_bwd(q, k, v, do, lse, dd, lengths, [("dk", dk), ("dv", dv)])
    if dk.shape != k.shape or dv.shape != v.shape:
        raise ValueError("dk/dv must have k's shape")
    with torch.cuda.device(q.device):
        FLASH_BWD_DKV.launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), dd.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            lengths.data_ptr(), B, H, KV, T, S, Dh,
            *_strides(q), *_strides(k), *_strides(v), *_strides(do),
            *_strides(dk), *_strides(dv), float(scale), int(bool(causal)),
            _stream(q.device))


def _fwd(q, k, v, lengths, causal: bool, scale: float):
    """Kernel-layout forward on either device. On the card, o takes q's
    memory layout (a transposed view of model-layout q gives a
    model-layout o)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, lengths, causal, scale)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    _launch(q, k, v, o, lse, lengths, causal, scale)
    return o, lse


def _kernel_ready(x: torch.Tensor) -> torch.Tensor:
    """x itself if kernels C/D can read it through its strides, else a
    contiguous copy (a cotangent may arrive expanded or permuted)."""
    if x.stride(-1) == 1 and not any(s % 8 for s in x.stride()[:-1]) \
            and x.data_ptr() % 16 == 0:
        return x
    return x.contiguous()


def flash_attention_bwd(q, k, v, o, lse, do, dlse, lengths, causal: bool,
                        scale: float):
    """Kernel-layout backward on either device: (dq, dk, dv) with the
    memory layouts of q, k, v."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, dlse, lengths,
                                         causal, scale)
    do = _kernel_ready(do.to(q.dtype))
    delta = (do.float() * o.float()).sum(-1)
    if dlse is not None:
        delta = delta - dlse.float()
    dd = delta.contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    _launch_dq(q, k, v, do, lse, dd, dq, lengths, causal, scale)
    _launch_dkv(q, k, v, do, lse, dd, dk, dv, lengths, causal, scale)
    return dq, dk, dv


class _FlashFn(torch.autograd.Function):
    """(o, lse) = attention(q, k, v) in kernel layout, both outputs
    differentiable. Saves the flash call's residuals, the post-rope q/k/v
    and (o, lse), so a remat policy that keeps them never re-runs the
    forward for the backward."""

    @staticmethod
    def forward(ctx, q, k, v, lengths, causal, scale):
        o, lse = _fwd(q, k, v, lengths, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse, lengths)
        ctx.causal, ctx.scale = causal, scale
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse, lengths = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, dlse, lengths,
                                         ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None


def _attend(q, k, v, lengths, causal: bool, scale: float):
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashFn.apply(q, k, v, lengths, causal, scale)
    return _fwd(q, k, v, lengths, causal, scale)


def _lengths(attn_mask, B: int, S: int, device) -> torch.Tensor:
    if attn_mask is None:
        return torch.full((B,), S, dtype=torch.int32, device=device)
    return attn_mask.to(torch.int32).sum(dim=-1, dtype=torch.int32)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    attn_mask: Optional[torch.Tensor] = None,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Model layout: q [B,T,H,Dh], k/v [B,S,KV,Dh], attn_mask [B,S]
    right-padded validity. Returns [B,T,H,Dh] in q.dtype. On the card the
    kernels read and write the model layout through strides (no transpose
    copies). Differentiable when an input requires grad."""
    B, T, H, Dh = q.shape
    S = k.shape[1]
    lengths = _lengths(attn_mask, B, S, q.device)
    scale = scale if scale is not None else Dh ** -0.5
    o, _ = _attend(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                   lengths, causal, scale)
    return o.transpose(1, 2)


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor,
                             lengths: Optional[torch.Tensor] = None,
                             causal: bool = True,
                             scale: Optional[float] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel layout: q [B,H,T,Dh], k/v [B,KV,S,Dh]. Returns
    (o [B,H,T,Dh], lse [B,H,T] fp32), both differentiable — the building
    block ring attention combines chunks with."""
    B, H, T, Dh = q.shape
    S = k.shape[2]
    if lengths is None:
        lengths = torch.full((B,), S, dtype=torch.int32, device=q.device)
    scale = scale if scale is not None else Dh ** -0.5
    return _attend(q, k, v, lengths, causal, scale)
