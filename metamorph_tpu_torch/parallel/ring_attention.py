"""Ring attention: sequence-parallel causal attention over a process group
(counterpart of `metamorph_tpu/parallel/ring_attention.py`).

Each of the n ranks of the sequence group holds T_loc = T / n positions of
every row. It runs flash attention of its queries against each K/V chunk
in turn, and merges the partial results by their logsumexp. At step i
rank r holds the chunk of rank src = (r - i) mod n, as in JAX's
`_ring_body`:
  * src < r: full attention (no mask): kernel A non-causal with lse;
  * src == r: the diagonal, causal: kernel A causal;
  * src > r: every key is in the future; skipped, and nothing launches
    (merging o = 0, lse = -1e30 changes nothing, bit for bit).
The backward runs kernels C and D per chunk, with the lse cotangent that
the merge hands each chunk.

The chunks come straight from their owners: `_Exchange` sends this
rank's (k, v) to every other rank of the group and receives theirs, in the
chunks' own dtype (bf16 on the card, as JAX's ring rotates them), in one
`batch_isend_irecv`; step i then takes the chunk of rank - i, the one
JAX's one-hop rotation brings at that step. Its backward sends each
chunk's gradient back to its owner, the counterpart of JAX's autodiff of
`lax.ppermute`, and the owner sums them in fp32, as the merge sums: each
step takes its q as a copy (in q's dtype) of one fp32 q, and the local
chunk likewise, so autograd adds the steps' dq, dk and dv in fp32 and
rounds each once. (Summed in bf16 hop by hop, as JAX's ring sums them,
the 8-chunk ring's rows came 1.5-1.8 % of their max from one call's, on
the CPU's plain versions.) Each rank sends and receives n - 1 chunks each
way, the bytes of JAX's ring. A rank whose received chunks are all
skipped (rank 0) still has to take part in the backward exchange, so the
output is tied to every received chunk (`_Tie`, the identity on o with a
zero gradient for the chunks).

`_ring_body` takes the source of each step's chunk as a function, so one
process can also run every position of a ring in turn from a list of
chunks (`chunks_source`), with the same code.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import torch
import torch.distributed as dist

from metamorph_tpu_torch.ops.flash_attention import flash_attention_with_lse
from metamorph_tpu_torch.parallel.mesh import check_backend


def _merge(o1, l1, o2, l2):
    """Combine two partial attention results by their logsumexp, in fp32.
    o: [B,H,T,Dh]; l: [B,H,T]."""
    m = torch.maximum(l1, l2)
    e1 = torch.exp(l1 - m)
    e2 = torch.exp(l2 - m)
    denom = torch.clamp_min(e1 + e2, 1e-38)
    o = (o1 * e1[..., None] + o2 * e2[..., None]) / denom[..., None]
    return o, m + torch.log(denom)


def _permute(sends, group) -> List[torch.Tensor]:
    """For each (tensor, step): send it to rank + step of `group` and
    receive its like from rank - step, all in one batch."""
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    ops, out = [], []
    for t, step in sends:
        t = t.contiguous()
        out.append(torch.empty_like(t))
        ops.append(dist.P2POp(dist.isend, t, dist.get_global_rank(
            group, (me + step) % n), group))
        ops.append(dist.P2POp(dist.irecv, out[-1], dist.get_global_rank(
            group, (me - step) % n), group))
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return out


class _Exchange(torch.autograd.Function):
    """From fp32 k, v: the (k, v) of rank - i of `group` in `dtype`, for
    i = 1 .. n-1 (k1, v1, k2, v2, ...); the backward sends each chunk's
    gradient back to its owner and returns their fp32 sums."""

    @staticmethod
    def forward(ctx, k32, v32, group, dtype):
        ctx.group = group
        n = dist.get_world_size(group)
        k, v = k32.to(dtype), v32.to(dtype)
        return tuple(_permute([(t, i) for i in range(1, n) for t in (k, v)],
                              group))

    @staticmethod
    def backward(ctx, *grads):
        back = _permute([(g, -(j // 2 + 1)) for j, g in enumerate(grads)],
                        ctx.group)
        dk = torch.stack([g.float() for g in back[0::2]]).sum(0)
        dv = torch.stack([g.float() for g in back[1::2]]).sum(0)
        return dk, dv, None, None


class _Tie(torch.autograd.Function):
    """The identity on o; the received chunks get a zero gradient, which
    puts their permutes into this rank's backward."""

    @staticmethod
    def forward(ctx, o, *chunks):
        ctx.n = len(chunks)
        return o.view_as(o)

    @staticmethod
    def backward(ctx, do):
        return (do,) + (None,) * ctx.n


def _ring_body(q: torch.Tensor, idx: int, n: int,
               kv_at: Callable[[int], Tuple[torch.Tensor, torch.Tensor]]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal attention of this rank's queries over the ring. q in kernel
    layout [B,H,T_loc,Dh]; kv_at(i) gives the kernel-layout (k, v)
    [B,KV,T_loc,Dh] that the rank holds at step i (the chunk of rank
    (idx - i) mod n); it is asked for i = 0 .. n-1 in order. Returns
    (o [B,H,T_loc,Dh] fp32, lse [B,H,T_loc] fp32)."""
    q32 = q.float()
    k, v = kv_at(0)
    o, lse = flash_attention_with_lse(q32.to(q.dtype), k, v, causal=True)
    o = o.float()
    for i in range(1, n):
        k, v = kv_at(i)
        if (idx - i) % n < idx:
            o_c, l_c = flash_attention_with_lse(q32.to(q.dtype), k, v,
                                                causal=False)
            o, lse = _merge(o, lse, o_c.float(), l_c)
    return o, lse


def group_source(k: torch.Tensor, v: torch.Tensor, group
                 ) -> Tuple[Callable, List[torch.Tensor]]:
    """kv_at for a process group: step i's chunk is rank - i's, in k's
    dtype, received from it (`_Exchange`). k/v in model layout
    [B,T_loc,KV,Dh]; the chunks come back in kernel layout. Also returns
    the received chunks (for `_Tie`)."""
    k32, v32 = k.float(), v.float()
    n = dist.get_world_size(group)
    held = list(_Exchange.apply(k32, v32, group, k.dtype)) if n > 1 else []

    def kv_at(i: int):
        kt, vt = ((k32.to(k.dtype), v32.to(v.dtype)) if i == 0
                  else held[2 * i - 2:2 * i])
        return kt.transpose(1, 2), vt.transpose(1, 2)

    return kv_at, held


def chunks_source(ks: List[torch.Tensor], vs: List[torch.Tensor], idx: int,
                  dtype: torch.dtype) -> Callable:
    """kv_at for one process that plays position idx of a ring whose
    chunks it holds itself (kernel layout, fp32, as each owner sums its
    chunk's gradients), cast to `dtype`: the chunk of rank (idx - i) mod n
    at step i."""
    n = len(ks)
    return lambda i: (ks[(idx - i) % n].to(dtype), vs[(idx - i) % n].to(dtype))


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group) -> torch.Tensor:
    """Causal attention over a sequence split into equal chunks over the
    ranks of `group` (`ops/attention.attention` passes the
    registered sequence axis), rank r holding positions [r*T_loc,
    (r+1)*T_loc). Model layout: q [B,T_loc,H,Dh], k/v [B,T_loc,KV,Dh].
    Returns [B,T_loc,H,Dh] in q's dtype. Causal only, which is exact for
    right-padded rows."""
    check_backend(q.device, group)
    n = dist.get_world_size(group)
    idx = dist.get_rank(group)
    kv_at, held = group_source(k, v, group)
    o, _ = _ring_body(q.transpose(1, 2), idx, n, kv_at)
    return _Tie.apply(o, *held).transpose(1, 2).to(q.dtype)
