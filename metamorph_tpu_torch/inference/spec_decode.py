"""Speculative greedy decode (counterpart of
`metamorph_tpu/inference/spec_decode.py`): prompt-lookup or draft-model
proposals, verified exactly in one chunk step of the main model.

Each loop step feeds [next input + spec_k - 1 drafts] through one verify
chunk (`llama.decode_chunk_step_batched`, kernel E on the card), applies
the full state machine to the chunk's first hidden state, then accepts the
drafts whose predecessor's argmax they equal. Only plain-text tokens ride the accept chain: it stops
AT the first special token (<image_start>, <image_end>, eos, a stop id),
and while a row emits image tokens the chunk degenerates to one accepted
token. The output ids, image embeddings and step counts equal
`decode.greedy_decode`'s; "iters" counts the chunk steps.

As in `decode.py`, the rows sit unpadded at the start of their cache rows
(the JAX batched functions left-pad), so RoPE positions equal cache slots
and the chunk attention needs no `starts`. The single-request functions
are the B=1 case of the batched machinery, and a `draft_fn` takes and
gives [B]-leading tensors: (ids_all [B, cap], n_all [B]) -> [B, spec_k - 1]
int32, -1 where there is no draft (`make_ngram_draft` is one).

Draft models (`greedy_decode_spec_draft_model`, batched too, and the
serving engine's draft ticks): a small LLaMA sharing the vocabulary keeps
its own KV cache over each row's id stream. Per step it catches up on the
ids accepted since its last sync in one chunk step (junk tail positions are
never read by a valid query and the next catch-up overwrites them), then
rolls spec_k - 1 single-token steps to propose. It embeds ids as JAX's
`jnp.take` does (`_draft_embed`): an id past its vocabulary gives a NaN row,
so a LLaMA-3.2-1B drafter (128256 rows) that meets <image_start> or
<image_end> (128256/128257) proposes token 0 from then on; exact
verification keeps the output the plain stream.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from metamorph_tpu_torch.config import MetaMorphConfig
from metamorph_tpu_torch.constants import IM_END_TOKEN_ID, IM_START_TOKEN_ID
from metamorph_tpu_torch.inference.decode import (DecodeState, _advance,
                                                  _eos_ids, _new_state,
                                                  _prefill_rows, _put_rows,
                                                  _result, _right_align)
from metamorph_tpu_torch.models import llama as llama_lib

# the speculative decode's state: the decode state with its drafting source
# (`ids_all`, `n_all`) and chunk-step count (`iters`) in use
SpecState = DecodeState


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


def _special_ids(eos_ids: torch.Tensor) -> torch.Tensor:
    return torch.cat([eos_ids, torch.tensor(
        (IM_START_TOKEN_ID, IM_END_TOKEN_ID), dtype=torch.int32,
        device=eos_ids.device)])


def _accept_chain(model, cfg: MetaMorphConfig, s1: SpecState,
                  tok1: torch.Tensor, emit1: torch.Tensor,
                  drafts: torch.Tensor, h: torch.Tensor, max_new: int,
                  special_ids: torch.Tensor,
                  eos_ids: torch.Tensor) -> SpecState:
    """Extra acceptances after the chunk's first (always applied)
    transition: per row, the plain-text prefix chain through the drafted
    positions (drafts [B, Km1], chunk hiddens h [B, spec_k, D]). Updates
    `s1` in place."""
    B, Km1 = drafts.shape
    dev = drafts.device
    b_idx = torch.arange(B, device=dev)
    preds = llama_lib.lm_head(model.llama, cfg.llama,
                              h[:, 1:].reshape(B * Km1, -1)).argmax(
        dim=-1).to(torch.int32).reshape(B, Km1)
    base_ok = (~emit1 & ~s1.done & ~torch.isin(tok1, special_ids)
               & ~s1.in_image)
    zeros = torch.zeros((B,), dtype=torch.bool, device=dev)
    n_extra = torch.zeros((B,), dtype=torch.int32, device=dev)
    last_tok = tok1
    eos_acc, start_acc, end_acc = zeros, zeros, zeros
    ok_chain, prev = base_ok, tok1
    for i in range(Km1):
        acc_i = ok_chain & (drafts[:, i] == prev) & (s1.steps + i < max_new)
        cand = preds[:, i]
        # the chain is a prefix: accepted draft i lands at n_ids + i
        _put_rows(s1.ids, b_idx, s1.n_ids + i, acc_i, cand)
        _put_rows(s1.ids_all, b_idx, s1.n_all + i, acc_i, cand)
        n_extra = n_extra + acc_i.to(torch.int32)
        last_tok = torch.where(acc_i, cand, last_tok)
        eos_acc = eos_acc | (acc_i & torch.isin(cand, eos_ids))
        start_acc = start_acc | (acc_i & (cand == IM_START_TOKEN_ID))
        end_acc = end_acc | (acc_i & (cand == IM_END_TOKEN_ID))
        ok_chain = acc_i & ~torch.isin(cand, special_ids)
        prev = cand

    tok_embed = llama_lib.embed_tokens(model.llama, last_tok).to(
        s1.next_embed.dtype)
    s1.next_embed = torch.where((n_extra > 0)[:, None, None],
                                tok_embed[:, None], s1.next_embed)
    s1.n_ids = s1.n_ids + n_extra
    s1.n_all = s1.n_all + n_extra
    s1.cache_len = s1.cache_len + n_extra
    s1.in_image = s1.in_image | start_acc
    s1.img_count = torch.where(end_acc, torch.zeros_like(s1.img_count),
                               s1.img_count)
    s1.steps = s1.steps + n_extra
    s1.done = s1.done | eos_acc | (s1.steps >= max_new)
    return s1


def _verify_step(model, cfg: MetaMorphConfig, s: SpecState,
                 drafts: torch.Tensor, max_new: int, eos_ids: torch.Tensor,
                 special_ids: torch.Tensor) -> SpecState:
    """One chunk step: embed [next input + drafts], verify them in one
    chunk of the main model, run the first transition through the full
    state machine, then the accept chain. Updates `s` in place."""
    K = cfg.mm.num_image_tokens
    B, Km1 = drafts.shape
    spec_k = Km1 + 1
    D = s.next_embed.shape[-1]
    d_emb = llama_lib.embed_tokens(model.llama,
                                   drafts.clamp_min(0).reshape(-1)).to(
        s.next_embed.dtype)
    chunk = torch.cat([s.next_embed, d_emb.reshape(B, Km1, D)], dim=1)
    pos = s.cache_len[:, None] + torch.arange(spec_k, device=drafts.device)
    h, _ = llama_lib.decode_chunk_step_batched(
        model.llama, cfg.llama, chunk, pos, s.cache_len, s.cache)
    s.cache_len = s.cache_len + 1
    s.iters += 1
    _, tok1, emit1 = _advance(model, cfg, s, h[:, 0], K, max_new, eos_ids)
    if Km1:
        _accept_chain(model, cfg, s, tok1, emit1, drafts, h, max_new,
                      special_ids, eos_ids)
    return s


def _spec_result(s: SpecState, single: bool) -> Dict[str, torch.Tensor]:
    out = _result(s, single)
    if not single:
        out["steps"] = s.steps          # per-row transitions, as JAX's
    out["iters"] = torch.tensor(s.iters)
    return out


def _start(model, cfg: MetaMorphConfig, embeds: torch.Tensor,
           ids: torch.Tensor, lens: torch.Tensor, padded: bool,
           max_new_tokens: int, max_images: int, max_cache_len: int,
           stop_ids: tuple, kv_int8: bool, spec_k: int, cap_extra: int):
    """Prefill right-aligned rows, seed each row's drafting source with its
    prompt ids, and apply the first transition. Returns (state, eos_ids,
    special_ids)."""
    K = cfg.mm.num_image_tokens
    B, T0 = embeds.shape[:2]
    dev, dtype = embeds.device, embeds.dtype
    S = max_cache_len or (T0 + max_new_tokens + spec_k + 8)
    cache = llama_lib.init_kv_cache(cfg.llama, B, S, dtype=dtype, device=dev,
                                    quantized=kv_int8)
    h_last = _prefill_rows(model.llama, cfg.llama, embeds, lens, cache,
                           padded)
    cap = T0 + max_new_tokens + cap_extra
    ids_all = torch.full((B, cap), -1, dtype=torch.int32, device=dev)
    valid = torch.arange(T0, device=dev)[None] < lens[:, None]
    ids_all[:, :T0] = torch.where(valid, ids.to(torch.int32),
                                  torch.full_like(ids_all[:, :T0], -1))
    state = _new_state(cfg, cache, lens, max_new_tokens, max_images, dtype,
                       ids_all=ids_all, n_all=lens.to(torch.int32))
    eos_ids = _eos_ids(stop_ids, dev)
    _advance(model, cfg, state, h_last, K, max_new_tokens, eos_ids)
    return state, eos_ids, _special_ids(eos_ids)


def _single_inputs(prompt_embeds, prompt_ids):
    dev = prompt_embeds.device
    T0 = prompt_embeds.shape[1]
    lens = torch.full((1,), T0, dtype=torch.int32, device=dev)
    return torch.as_tensor(prompt_ids, device=dev).reshape(1, T0), lens


def _batched_inputs(prompt_embeds, prompt_mask, prompt_ids):
    dev = prompt_embeds.device
    lens = torch.as_tensor(prompt_mask, device=dev).sum(dim=1).to(
        torch.int32)
    return (_right_align(prompt_embeds, lens),
            _right_align(torch.as_tensor(prompt_ids, device=dev), lens), lens)


def _spec_loop(model, cfg, state, draft_fn, spec_k, max_new, eos_ids,
               special_ids):
    while not bool(state.done.all()):
        drafts = draft_fn(state.ids_all, state.n_all)           # [B, Km1]
        _verify_step(model, cfg, state,
                     drafts.reshape(state.n_all.shape[0], spec_k - 1),
                     max_new, eos_ids, special_ids)
    return state


@torch.no_grad()
def greedy_decode_spec(model, cfg: MetaMorphConfig,
                       prompt_embeds: torch.Tensor,  # [1, T0, D] fused prompt
                       prompt_ids,                   # [T0] int — drafting
                                                     # source (image-slot
                                                     # placeholders are fine)
                       max_new_tokens: int = 256, max_images: int = 4,
                       max_cache_len: int = 0, stop_ids: tuple = (),
                       kv_int8: bool = False,
                       spec_k: int = 8,   # chunk width: 1 input + spec_k - 1
                                          # drafts
                       draft_fn=None) -> Dict[str, torch.Tensor]:
    """Greedy decode with speculative verification of one request. Output
    equal to `decode.greedy_decode`'s (ids, image embeds, steps), plus
    "iters", the number of chunk steps (iters == steps: no draft was ever
    accepted)."""
    ids, lens = _single_inputs(prompt_embeds, prompt_ids)
    state, eos_ids, special_ids = _start(
        model, cfg, prompt_embeds, ids, lens, False, max_new_tokens,
        max_images, max_cache_len, tuple(stop_ids), kv_int8, spec_k, 4)
    draft_fn = draft_fn or make_ngram_draft(spec_k - 1)
    _spec_loop(model, cfg, state, draft_fn, spec_k, max_new_tokens, eos_ids,
               special_ids)
    return _spec_result(state, single=True)


@torch.no_grad()
def batched_greedy_decode_spec(model, cfg: MetaMorphConfig,
                               prompt_embeds: torch.Tensor,  # [B, T0, D]
                                                             # LEFT-padded
                               prompt_mask,                  # [B, T0]
                               prompt_ids,                   # [B, T0], aligned
                                                             # with the embeds
                               max_new_tokens: int = 256,
                               max_images: int = 4, max_cache_len: int = 0,
                               stop_ids: tuple = (), kv_int8: bool = False,
                               spec_k: int = 8,
                               draft_fn=None) -> Dict[str, torch.Tensor]:
    """Batched speculative greedy decode; per row equal to
    `decode.batched_greedy_decode` (greedy). Returns per-row "steps" [B]
    and the chunk-step count "iters" (B * iters against sum(steps) is the
    saving)."""
    embeds, ids, lens = _batched_inputs(prompt_embeds, prompt_mask,
                                        prompt_ids)
    state, eos_ids, special_ids = _start(
        model, cfg, embeds, ids, lens, True, max_new_tokens, max_images,
        max_cache_len, tuple(stop_ids), kv_int8, spec_k, 4)
    draft_fn = draft_fn or make_ngram_draft(spec_k - 1)
    _spec_loop(model, cfg, state, draft_fn, spec_k, max_new_tokens, eos_ids,
               special_ids)
    return _spec_result(state, single=False)


# ---------------------------------------------------------------------------
# draft models
# ---------------------------------------------------------------------------

def _draft_embed(llama: llama_lib.Llama, ids: torch.Tensor) -> torch.Tensor:
    """The drafter's embedding lookup with JAX's `jnp.take` semantics: an
    id at or past the drafter's vocabulary gives a row of NaN (never an
    index error or a device-side assert)."""
    V = llama.embed.shape[0]
    ok = (ids >= 0) & (ids < V)
    rows = llama_lib.embed_tokens(llama, ids.clamp(0, V - 1))
    return torch.where(ok[..., None], rows,
                       torch.full_like(rows, float("nan")))


def _argmax_ids(llama, lcfg, h: torch.Tensor) -> torch.Tensor:
    return llama_lib.lm_head(llama, lcfg, h).argmax(dim=-1).to(torch.int32)


def draft_propose(draft, draft_cfg, d_cache: Dict[str, torch.Tensor],
                  d_len: torch.Tensor, ids_all: torch.Tensor,
                  n_all: torch.Tensor, spec_k: int):
    """One drafter round for B rows: catch up on ids_all[d_len : n_all]
    (at most spec_k ids per row) in one chunk step, then roll spec_k - 1
    single-token steps from the last caught-up hidden state. Updates the
    drafter cache in place; returns (drafts [B, spec_k - 1], new d_len)."""
    B, A = ids_all.shape
    dev, dtype = ids_all.device, draft.embed.dtype
    valid = (n_all - d_len).clamp(max=spec_k)
    cu_idx = d_len[:, None] + torch.arange(spec_k, device=dev)[None]
    cu_ids = ids_all.gather(1, cu_idx.clamp(0, A - 1).long())
    cu_emb = _draft_embed(draft, cu_ids.clamp_min(0))
    hd, _ = llama_lib.decode_chunk_step_batched(draft, draft_cfg, cu_emb,
                                                cu_idx, d_len, d_cache)
    d_len = (d_len + valid).to(torch.int32)
    h_last = hd[torch.arange(B, device=dev), (valid - 1).clamp_min(0).long()]
    d_tok = _argmax_ids(draft, draft_cfg, h_last)
    drafts = [d_tok]
    for j in range(spec_k - 2):
        d_emb = _draft_embed(draft, d_tok)[:, None]
        hj, _ = llama_lib.decode_step(draft, draft_cfg, d_emb,
                                      (d_len + j)[:, None], d_cache,
                                      d_len + j)
        d_tok = _argmax_ids(draft, draft_cfg, hj[:, 0])
        drafts.append(d_tok)
    return torch.stack(drafts, dim=1), d_len


def _draft_prefill(draft, draft_cfg, ids: torch.Tensor, lens: torch.Tensor,
                   S: int, padded: bool) -> Dict[str, torch.Tensor]:
    """The drafter's cache (in its weights' dtype) over each row's prompt
    ids, rows from slot 0."""
    B = ids.shape[0]
    d_cache = llama_lib.init_kv_cache(draft_cfg, B, S,
                                      dtype=draft.embed.dtype,
                                      device=ids.device)
    d_emb = _draft_embed(draft, ids.clamp_min(0))
    _prefill_rows(draft, draft_cfg, d_emb, lens, d_cache, padded)
    return d_cache


def _draft_model_run(model, draft, cfg, draft_cfg, embeds, ids, lens,
                     padded, max_new_tokens, max_images, max_cache_len,
                     stop_ids, kv_int8, spec_k) -> SpecState:
    if spec_k < 2:
        raise ValueError("spec_k must be >= 2 for draft-model speculation")
    T0 = embeds.shape[1]
    state, eos_ids, special_ids = _start(
        model, cfg, embeds, ids, lens, padded, max_new_tokens, max_images,
        max_cache_len, tuple(stop_ids), kv_int8, spec_k, spec_k + 4)
    S = max_cache_len or (T0 + max_new_tokens + spec_k + 8)
    d_cache = _draft_prefill(draft, draft_cfg, ids, lens, S, padded)
    d_len = lens.clone()
    while not bool(state.done.all()):
        drafts, d_len = draft_propose(draft, draft_cfg, d_cache, d_len,
                                      state.ids_all, state.n_all, spec_k)
        _verify_step(model, cfg, state, drafts, max_new_tokens, eos_ids,
                     special_ids)
    return state


@torch.no_grad()
def greedy_decode_spec_draft_model(model, draft, cfg: MetaMorphConfig,
                                   draft_cfg,
                                   prompt_embeds: torch.Tensor,  # [1, T0, D]
                                   prompt_ids,   # [T0] — the drafter's view
                                                 # of the prompt (it is blind
                                                 # to image content)
                                   max_new_tokens: int = 256,
                                   max_images: int = 4,
                                   max_cache_len: int = 0,
                                   stop_ids: tuple = (),
                                   kv_int8: bool = False,
                                   spec_k: int = 8
                                   ) -> Dict[str, torch.Tensor]:
    """Draft-MODEL speculative decoding of one request: `draft` (a
    `Llama` module, config `draft_cfg`) proposes spec_k - 1 tokens per step
    and the main model verifies them in one chunk step. Output equal to
    `decode.greedy_decode`'s, plus "iters"."""
    ids, lens = _single_inputs(prompt_embeds, prompt_ids)
    state = _draft_model_run(model, draft, cfg, draft_cfg, prompt_embeds,
                             ids, lens, False, max_new_tokens, max_images,
                             max_cache_len, stop_ids, kv_int8, spec_k)
    return _spec_result(state, single=True)


@torch.no_grad()
def batched_greedy_decode_spec_draft_model(model, draft,
                                           cfg: MetaMorphConfig, draft_cfg,
                                           prompt_embeds: torch.Tensor,
                                           prompt_mask, prompt_ids,
                                           max_new_tokens: int = 256,
                                           max_images: int = 4,
                                           max_cache_len: int = 0,
                                           stop_ids: tuple = (),
                                           kv_int8: bool = False,
                                           spec_k: int = 8
                                           ) -> Dict[str, torch.Tensor]:
    """Batched draft-model speculation over LEFT-padded prompts: the
    drafter keeps one cache row per prompt row and proposes per-row
    chains; one batched chunk step verifies them all. Per row equal to
    `decode.batched_greedy_decode`'s; "steps" per row, "iters" shared."""
    embeds, ids, lens = _batched_inputs(prompt_embeds, prompt_mask,
                                        prompt_ids)
    state = _draft_model_run(model, draft, cfg, draft_cfg, embeds, ids, lens,
                             True, max_new_tokens, max_images, max_cache_len,
                             stop_ids, kv_int8, spec_k)
    return _spec_result(state, single=False)
