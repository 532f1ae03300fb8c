"""Kernel G: decode attention of multi-head latent attention in its
absorbed form, a Triton kernel on the card and a plain PyTorch version on
the CPU.

Replaces no TPU kernel: the JAX package has no latent attention. It was
added because kernel B reads separate per-head K and V slabs of head dim
64 or 128, while the latent cache holds one row per token: the normed
latent c (kv_lora_rank, 512 published) beside the roped shared key
(qk_rope_head_dim, 64), 576 bf16 values. With the key up-projection
folded into the query (q_nope . W_UK per head) and the value
up-projection applied after the kernel, every head attends to the same
rows: multi-query attention with keys the whole row and values its first
kv_lora_rank columns.

    q   [B, H, 576]  (the absorbed nope part, then the roped part)
    row [B, S, 576] of the cache [L, B, S, 576] at `layer`
    out [B, H, 512] = softmax(scale * q . row[0:len]) @ row[0:len, :512]

Bound: bytes. A row's keys are read once for all H heads (1,152 bytes a
key against 2 * H * (576 + 512) = 34,816 FLOPs, some 30 FLOPs a byte:
below the card's 295 in bf16, far above its 18 without tensor cores), so
both products run on the tensor cores (`tl.dot`, the H = 16 heads as the
M of an m16 tile) and the kernel is as fast as it streams the rows. One
program per (row, split): each row's keys [0, len) are cut into splits of
`split_len` keys, sized from S and the SM count (never from the lengths,
which stay on the device), and a program whose split starts past its
row's length exits at once, so a row reads only its own keys. Splits
write float32 partials (the normalised output and its log-sum-exp) to a
workspace and count their arrival on an int32 counter per row; the last
to arrive merges them in the same launch and sets the counter back to
zero, as kernel B does. A row with one live split writes its output
directly. Nothing is allocated or read to the host in a launch, so a
decode tick that runs it captures into a CUDA graph.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Tuple

import torch

from metamorph_tpu_torch.ops.moe import Launches

NEG_INF = -1e30
BLOCK_N = 32            # keys a loop iteration loads
SPLIT_QUANTUM = 64      # split lengths are multiples of this
MAX_SPLITS = 16         # partials per row, at most
MLA_DECODE = Launches("mla_decode_attn_kernel")


def mla_decode_splits(S: int, B: int, sm_count: int) -> Tuple[int, int]:
    """(split_len, n_split): about four programs per SM over the (B,
    n_split) grid, split_len a multiple of SPLIT_QUANTUM with split_len *
    n_split >= S. Host-known sizes only."""
    want = min(MAX_SPLITS, max(1, math.ceil(4 * sm_count / B)))
    split = math.ceil(math.ceil(S / want) / SPLIT_QUANTUM) * SPLIT_QUANTUM
    return split, math.ceil(S / split)


def mla_decode_plain(q: torch.Tensor, rows: torch.Tensor,
                     lengths: torch.Tensor, d_v: int, scale: float
                     ) -> torch.Tensor:
    """q [B, H, Dl]; rows [B, S, Dl] (one layer); lengths [B]. float32
    math; returns [B, H, d_v] in q's dtype. A row with no keys gives 0."""
    S = rows.shape[1]
    r = rows.float()
    s = torch.einsum("bhd,bsd->bhs", q.float(), r) * scale
    mask = (torch.arange(S, device=q.device)[None, :]
            < lengths.to(q.device)[:, None])[:, None, :]
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * mask
    l = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(l == 0, torch.ones_like(l), l)
    return torch.einsum("bhs,bsd->bhd", p, r[..., :d_v]).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _kernel():
    """The Triton kernel, built at first use (`triton` is imported here,
    never when the module is imported)."""
    import triton
    import triton.language as tl

    @triton.jit
    def mla_decode_attn_kernel(
            Q, KV, O, Lens, WS, LSE, Ctr,
            stride_qb, stride_qh, stride_kb, stride_ks, stride_ob,
            stride_oh, scale, split_len,
            H: tl.constexpr, BLOCK_H: tl.constexpr, DV: tl.constexpr,
            DR: tl.constexpr, BLOCK_N: tl.constexpr,
            MAX_SPLIT: tl.constexpr):
        b = tl.program_id(0)
        sp = tl.program_id(1)
        length = tl.load(Lens + b)
        n_live = tl.cdiv(length, split_len)
        offs_h = tl.arange(0, BLOCK_H)
        offs_v = tl.arange(0, DV)
        offs_r = tl.arange(0, DR)
        mask_h = offs_h < H
        o_ptrs = (O + b * stride_ob + offs_h[:, None] * stride_oh
                  + offs_v[None, :])
        if n_live == 0:
            if sp == 0:
                tl.store(o_ptrs, tl.zeros([BLOCK_H, DV], tl.float32).to(
                    O.dtype.element_ty), mask=mask_h[:, None])
            return
        if sp >= n_live:
            return
        q_base = Q + b * stride_qb + offs_h[:, None] * stride_qh
        q_c = tl.load(q_base + offs_v[None, :], mask=mask_h[:, None],
                      other=0.0)
        q_r = tl.load(q_base + DV + offs_r[None, :], mask=mask_h[:, None],
                      other=0.0)
        start = sp * split_len
        end = tl.minimum(start + split_len, length)
        m = tl.full([BLOCK_H], -float("inf"), tl.float32)
        l = tl.zeros([BLOCK_H], tl.float32)
        acc = tl.zeros([BLOCK_H, DV], tl.float32)
        k_base = KV + b * stride_kb
        for n0 in range(start, end, BLOCK_N):
            offs_n = n0 + tl.arange(0, BLOCK_N)
            mask_n = offs_n < end
            rows = k_base + offs_n[:, None] * stride_ks
            kc = tl.load(rows + offs_v[None, :], mask=mask_n[:, None],
                         other=0.0)
            kr = tl.load(rows + DV + offs_r[None, :], mask=mask_n[:, None],
                         other=0.0)
            s = tl.dot(q_c, tl.trans(kc)) + tl.dot(q_r, tl.trans(kr))
            s = tl.where(mask_n[None, :], s * scale, -float("inf"))
            m_new = tl.maximum(m, tl.max(s, axis=1))
            alpha = tl.exp(m - m_new)
            p = tl.exp(s - m_new[:, None])
            l = l * alpha + tl.sum(p, axis=1)
            acc = acc * alpha[:, None] + tl.dot(p.to(kc.dtype), kc)
            m = m_new
        out = acc / l[:, None]
        if n_live == 1:
            tl.store(o_ptrs, out.to(O.dtype.element_ty), mask=mask_h[:, None])
            return
        # this split's partial, then its arrival; the last to arrive merges
        part = (b * MAX_SPLIT + sp) * BLOCK_H
        tl.store(WS + (part + offs_h[:, None]) * DV + offs_v[None, :], out)
        tl.store(LSE + part + offs_h, m + tl.log(l))
        tl.debug_barrier()
        seen = tl.atomic_add(Ctr + b, 1, sem="acq_rel")
        if seen == n_live - 1:
            big = tl.full([BLOCK_H], -float("inf"), tl.float32)
            for j in range(0, n_live):
                lse = tl.load(LSE + (b * MAX_SPLIT + j) * BLOCK_H + offs_h,
                              cache_modifier=".cg")
                big = tl.maximum(big, lse)
            tot = tl.zeros([BLOCK_H], tl.float32)
            merged = tl.zeros([BLOCK_H, DV], tl.float32)
            for j in range(0, n_live):
                base = (b * MAX_SPLIT + j) * BLOCK_H
                lse = tl.load(LSE + base + offs_h, cache_modifier=".cg")
                w = tl.exp(lse - big)
                o_j = tl.load(WS + (base + offs_h[:, None]) * DV
                              + offs_v[None, :], cache_modifier=".cg")
                merged += w[:, None] * o_j
                tot += w
            tl.store(o_ptrs, (merged / tot[:, None]).to(O.dtype.element_ty),
                     mask=mask_h[:, None])
            tl.store(Ctr + b, 0)

    return mla_decode_attn_kernel


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_SCRATCH: Dict[tuple, Tuple[torch.Tensor, ...]] = {}


def _scratch(dev, B: int, block_h: int, d_v: int):
    """Partials [B, MAX_SPLITS, block_h, d_v], their log-sum-exps and the
    zeroed arrival counters [B], made once per (device, shape) and reused:
    each launch leaves the counters at zero."""
    key = (dev, B, block_h, d_v)
    if key not in _SCRATCH:
        _SCRATCH[key] = (
            torch.empty(B * MAX_SPLITS * block_h * d_v, dtype=torch.float32,
                        device=dev),
            torch.empty(B * MAX_SPLITS * block_h, dtype=torch.float32,
                        device=dev),
            torch.zeros(B, dtype=torch.int32, device=dev))
    return _SCRATCH[key]


def _launch(q, rows, lengths, d_v: int, scale: float) -> torch.Tensor:
    B, H, Dl = q.shape
    S = rows.shape[1]
    dev = q.device
    if q.dtype != torch.bfloat16 or rows.dtype != torch.bfloat16:
        raise ValueError("kernel G takes bf16 queries and cache")
    if not (q.is_cuda and rows.device == dev and lengths.device == dev):
        raise ValueError(f"q, the cache and lengths must be on {dev}")
    if q.stride(-1) != 1 or rows.stride(-1) != 1:
        raise ValueError("q and the cache rows must be contiguous in the "
                         "last dim")
    if rows.shape[0] != B or rows.shape[2] != Dl:
        raise ValueError(f"cache rows {tuple(rows.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if lengths.dtype != torch.int32 or lengths.shape != (B,):
        raise ValueError(f"lengths must be an int32 [{B}] tensor")
    d_r = Dl - d_v
    if d_v & (d_v - 1) or d_r & (d_r - 1) or H > 64:
        raise ValueError(f"kernel G takes power-of-two latent and rope "
                         f"widths and at most 64 heads, got {d_v} + {d_r}, "
                         f"H={H}")
    block_h = max(16, 1 << (H - 1).bit_length())
    split_len, n_split = mla_decode_splits(S, B, _sm_count(dev.index))
    ws, lse, ctr = _scratch(dev, B, block_h, d_v)
    o = torch.empty((B, H, d_v), dtype=q.dtype, device=dev)
    with torch.cuda.device(dev):
        _kernel()[(B, n_split)](
            q, rows, o, lengths, ws, lse, ctr,
            q.stride(0), q.stride(1), rows.stride(0), rows.stride(1),
            o.stride(0), o.stride(1), float(scale), split_len,
            H=H, BLOCK_H=block_h, DV=d_v, DR=d_r, BLOCK_N=BLOCK_N,
            MAX_SPLIT=MAX_SPLITS, num_warps=4, num_stages=2)
    MLA_DECODE.launches += 1
    return o


def mla_decode_attention(q: torch.Tensor, cache: torch.Tensor,
                         lengths: torch.Tensor, layer: int, d_v: int,
                         scale: float) -> torch.Tensor:
    """q [B, H, Dl] (absorbed); cache [L, B, S, Dl]; lengths [B] int32,
    the keys [0, len) each row attends to; the values are each row's
    first d_v columns. Returns [B, H, d_v] in q's dtype: kernel G for CUDA
    tensors, the plain version for CPU ones."""
    rows = cache[layer]
    if q.device.type == "cpu":
        return mla_decode_plain(q, rows, lengths, d_v, scale)
    return _launch(q, rows, lengths, d_v, scale)
