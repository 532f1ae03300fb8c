"""Attention ops (counterpart of `metamorph_tpu/ops/attention.py`).

The materialized-scores path: fp32 scores and softmax, probabilities cast
back to the input dtype for the PV product. The SigLIP tower uses it as the
JAX package does; the LLaMA decoder goes through the flash and decode
kernels instead (`ops/flash_attention.py`, `ops/decode_attention.py`), and
under sequence parallelism through ring attention (`attention` while a
sequence axis is registered, `parallel/ring_attention.py`).
Layouts are the JAX package's: q [B, T, H, Dh], k/v [B, S, KV, Dh].
"""

from __future__ import annotations

from typing import Optional

import torch

from metamorph_tpu_torch.ops.flash_attention import flash_attention
from metamorph_tpu_torch.parallel.context import sequence_group
from metamorph_tpu_torch.parallel.ring_attention import ring_attention

NEG_INF = -1e30


def make_causal_mask(attn_mask: torch.Tensor) -> torch.Tensor:
    """[B,T] validity mask -> [B,1,T,T] boolean attend-allowed mask
    (causal + key padding)."""
    B, T = attn_mask.shape
    causal = torch.ones((T, T), dtype=torch.bool,
                        device=attn_mask.device).tril()
    pad = attn_mask.bool()[:, None, None, :]
    return causal[None, None] & pad


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B,T,KV,Dh] -> [B,T,KV*n_rep,Dh] (GQA head replication)."""
    if n_rep == 1:
        return x
    B, T, KV, Dh = x.shape
    return x[:, :, :, None, :].expand(B, T, KV, n_rep, Dh).reshape(
        B, T, KV * n_rep, Dh)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: Optional[torch.Tensor] = None,
                          scale: Optional[float] = None) -> torch.Tensor:
    """GQA attention with fp32 softmax. Returns [B, T, H, Dh] in q.dtype."""
    H, KV = q.shape[2], k.shape[2]
    k = repeat_kv(k, H // KV)
    v = repeat_kv(v, H // KV)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    if mask is not None:
        scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhts,bshd->bthd", probs, v)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: Optional[torch.Tensor] = None,
              attn_mask: Optional[torch.Tensor] = None,
              causal: bool = True, impl: str = "xla") -> torch.Tensor:
    """The models' entry point, as JAX's `attention`:
    impl="xla": the materialized-scores path;
    impl="flash": flash attention (kernels A, C, D on the card);
    impl="ring": flash attention here; the ring below.
    While a sequence axis of more than one rank is registered
    (`parallel/context.py`), each rank holds a slice of the sequence and
    every impl is ring attention over that axis, the exact form there:
    causal only, which is exact for right-padded rows (`attn_mask` is
    not read). JAX's flash and xla paths gather the sequence instead,
    with the same result."""
    if impl not in ("xla", "flash", "ring"):
        raise ValueError(f"unknown attention impl {impl!r}")
    group = sequence_group()
    if group is not None:
        if not causal:
            raise ValueError("a sequence split over ranks takes causal "
                             "attention only")
        return ring_attention(q, k, v, group)
    if impl in ("flash", "ring"):
        return flash_attention(q, k, v, attn_mask=attn_mask, causal=causal)
    if impl == "flash":
        return flash_attention(q, k, v, attn_mask=attn_mask, causal=causal)
    if mask is None and attn_mask is not None and causal:
        mask = make_causal_mask(attn_mask)
    return dot_product_attention(q, k, v, mask=mask)
