"""Prompt-lookup drafting (counterpart of `make_ngram_draft` in
`metamorph_tpu/inference/spec_decode.py`), vectorised over the B rows of
the serving engine. The rest of the JAX module (single-request and batched
speculative greedy decode, draft models) is not ported yet.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


def make_ngram_draft(n_draft: int, max_ngram: int = 3,
                     recent_len_threshold: Optional[int] = None
                     ) -> Callable[[torch.Tensor, torch.Tensor],
                                   torch.Tensor]:
    """Returns draft(ids_all [B, cap] int32, n_all [B] int) -> [B, n_draft]
    int32: per row, find the most recent earlier occurrence of the LONGEST
    matching suffix n-gram (n = max_ngram down to 2) in ids_all[:n_all] and
    propose the n_draft tokens that followed it (-1 where no draft). Among
    same-length matches the most recent wins when its continuation covers
    >= recent_len_threshold tokens (default 3/4 of n_draft), else the latest
    with a full continuation, else the latest partial one — the JAX rule.

    Like `jax.lax.dynamic_slice`, the suffix read clamps its index into
    [0, cap - 1], so a history shorter than n reads index 0 there."""
    if recent_len_threshold is None:
        recent_len_threshold = max(1, (3 * n_draft) // 4)

    def draft(ids_all: torch.Tensor, n_all: torch.Tensor) -> torch.Tensor:
        B, cap = ids_all.shape
        dev = ids_all.device
        n_all = n_all.long()
        start = torch.full((B,), -1, dtype=torch.long, device=dev)
        for n in range(2, max_ngram + 1):
            p = torch.arange(cap - n, device=dev)[None]           # [1, P]
            m = torch.ones((B, cap - n), dtype=torch.bool, device=dev)
            for k in range(n):
                idx = (n_all - n + k).clamp(0, cap - 1)[:, None]
                m = m & (ids_all[:, k:cap - n + k] == ids_all.gather(1, idx))
            # strictly earlier occurrence with >= 1 real token after it
            m = m & (p < (n_all - n)[:, None])
            j_any = torch.where(m, p, -1).amax(dim=1)
            full = m & (p <= (n_all - n - n_draft)[:, None])
            j_full = torch.where(full, p, -1).amax(dim=1)
            recent_ok = (j_any >= 0) & (n_all - n - j_any
                                        >= recent_len_threshold)
            j = torch.where(recent_ok, j_any,
                            torch.where(j_full >= 0, j_full, j_any))
            j = torch.where(n_all >= n + 1, j, -1)
            # longer n overrides: the loop ends on the longest match found
            start = torch.where(j >= 0, j + n, start)
        idx = start[:, None] + torch.arange(n_draft, device=dev)[None]
        d = ids_all.gather(1, idx.clamp(0, cap - 1))
        ok = (start[:, None] >= 0) & (idx < n_all[:, None])
        return torch.where(ok, d, -1).to(torch.int32)

    return draft
