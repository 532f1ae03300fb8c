"""Continuous-batching multimodal serving engine (counterpart of
`metamorph_tpu/inference/serve.py`).

Each of B cache slots runs its own request; a request is admitted into a
free slot as soon as one frees. Device state is a set of [B]-leading
tensors (`ServeState`) over one KV cache [L, B, KV, S, Dh]; per-slot write
positions (`cache_lens`) make the rows ragged in time. The pieces:

  * `_prefill_admit` / `_prefill_admit_ids`: one batched prefill per run of
    same-bucket requests, writing each row's K/V into its slot and running
    the first state-machine transition from the last prompt position; the
    ids form embeds and splices image tokens on the device;
  * `_decode_all`: `steps_per_sync` single-token steps over every slot;
    on CUDA, a greedy engine replays it from a captured graph
    (`_TickGraph`, `ServeEngine._plain_tick`);
  * `_decode_all_spec` / `_spec_verify_tick` (`spec_k > 1`): each step runs
    one batched verify chunk of [next token + spec_k - 1 prompt-lookup
    drafts] per row and accepts the matching prefix for greedy rows, so
    their ids equal the plain engine's;
  * `_decode_all_spec_draft` (`draft=(draft_llama, draft_cfg)`): the same
    verify tick with proposals from a small LLaMA that keeps a KV cache
    per slot (`d_cache`) and its own count of ingested ids (`d_len`);
  * `_decode_fill_all*` / `_fill_core` (`fill_chunk > 0`): decode steps
    that each carry one `fill_chunk`-token piece of a long pending prompt
    into its slot, admitting the row on its last chunk;
  * `_prefill_admit_prefixed` (`shared_prefix_ids`): the prefix's KV,
    computed once when the engine is built, is copied into each admitted
    row, and only the request's suffix runs, as batched chunk steps
    (`decode_chunk_step_batched`) against the growing row;
  * `_advance_rows`: the per-row <image_start> / K continuous tokens /
    <image_end> state machine, shared by all of them;
  * `_snapshot`: one packed int32 array per tick, copied to the host
    asynchronously and read by the scheduler a tick later.

`kv_int8=True` keeps the cache in int8 with per-(token, kv head) scales.
On CUDA tensors the prefill attention always runs kernel A (the flash
forward), decode attention kernel B (bf16 or int8) and the verify and fill
chunks kernel E (the shared prefix's suffix chunks too); a model from
`ops/quant.quantize_llama_decode` runs every dense product on kernel F. On
CPU tensors all take their plain versions. Unlike the JAX engine there is
no size rule that sends small shapes to a plain path on the device.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from metamorph_tpu_torch.config import MetaMorphConfig
from metamorph_tpu_torch.constants import (IM_END_TOKEN_ID, IM_START_TOKEN_ID,
                                           LLAMA3_EOS_IDS)
from metamorph_tpu_torch.inference.decode import _project_pred, _put_rows
from metamorph_tpu_torch.inference.spec_decode import (_draft_embed,
                                                       draft_propose,
                                                       make_ngram_draft)
from metamorph_tpu_torch.models import llama as llama_lib
from metamorph_tpu_torch.models import metamorph as mm_lib
from metamorph_tpu_torch.ops.decode_attention import (DECODE_ATTN,
                                                      DECODE_ATTN_INT8)
from metamorph_tpu_torch.ops.mla_decode import MLA_DECODE
from metamorph_tpu_torch.ops.moe import GROUPED_MM
from metamorph_tpu_torch.ops.quant import W8_MATMUL
from metamorph_tpu_torch.utils import trace


@dataclass
class ServeState:
    """Per-slot device state; every tensor is [B]-leading and keeps its
    shape for the engine's life (updated in place or replaced)."""
    cache: Dict[str, torch.Tensor]   # [L, B, KV, S, Dh]
    cache_lens: torch.Tensor         # [B] int32 — tokens in each slot's cache
    next_embed: torch.Tensor         # [B, 1, D] — input for each row's next step
    in_image: torch.Tensor           # [B] bool
    img_count: torch.Tensor          # [B] int32
    ids: torch.Tensor                # [B, max_new] int32 (pad = -1)
    n_ids: torch.Tensor              # [B] int32
    img_embeds: torch.Tensor         # [B, C, Dv] fp32
    n_img: torch.Tensor              # [B] int32
    steps: torch.Tensor              # [B] int32 — tokens generated by this row
    max_new: torch.Tensor            # [B] int32 — per-request budget
    active: torch.Tensor             # [B] bool — slot occupied and generating
    temp: torch.Tensor               # [B] f32 — sampling temperature (0=greedy)
    top_p: torch.Tensor              # [B] f32 — nucleus mass (1 = off)
    ids_all: torch.Tensor            # [B, A] int32 — prompt + generated ids
                                     #   (the drafting source; embeds-path
                                     #   rows hold generated ids only)
    n_all: torch.Tensor              # [B] int32 — valid ids_all entries
    spec_extra: torch.Tensor         # [B] int32 — draft tokens accepted per
                                     #   row (never reset; the scheduler
                                     #   reads per-row deltas)
    d_cache: Optional[Dict[str, torch.Tensor]]  # drafter KV cache
                                     #   [L, B, KV, S, Dh] (None: no drafter)
    d_len: torch.Tensor              # [B] int32 — ids the drafter ingested
    route_counts: Optional[torch.Tensor] = None  # [n, L_moe, E] int32 —
                                     #   expert picks of the active rows
                                     #   per step of the last plain tick
                                     #   (routed-expert models only)
    route_log: Optional[torch.Tensor] = None  # [B, S, L_moe, k] uint8 —
                                     #   each position's expert picks
                                     #   (`ServeEngine.log_routes`)


# Sampling looks at the top-K logits per row before the nucleus filter, as
# the JAX engine does.
_SAMPLE_TOP_K = 64


def _sample_rows(generator: torch.Generator, logits: torch.Tensor,
                 temp: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """Per-row temperature + nucleus sampling over [B, V] fp32 logits
    within the top-K window. Rows with temp == 0 are ignored by the caller
    (it takes their argmax). Draws from `generator`."""
    topv, topi = torch.topk(logits, _SAMPLE_TOP_K, dim=-1)
    scaled = topv / temp.clamp_min(1e-6)[:, None]
    probs = torch.softmax(scaled, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # keep token i iff the mass BEFORE it is < top_p (always keeps the top-1)
    keep = (cum - probs) < top_p[:, None]
    masked = torch.where(keep, scaled, torch.full_like(scaled, -1e30))
    idx = torch.multinomial(torch.softmax(masked, dim=-1), 1,
                            generator=generator)
    return topi.gather(1, idx)[:, 0].to(torch.int32)


def _advance_rows(model, cfg: MetaMorphConfig, state: ServeState,
                  h_last: torch.Tensor, fresh: torch.Tensor, K: int,
                  eos_ids: torch.Tensor, sampling: bool = False,
                  generator: Optional[torch.Generator] = None):
    """Per-row state machine (the transitions of the JAX `_advance_rows`).
    `fresh[B]` marks rows whose h_last is a real new hidden state; others
    are frozen. `eos_ids` holds the eos ids plus the engine's stop ids.
    Updates `state` in place; returns (state, tok, emit_image)."""
    B = h_last.shape[0]
    b_idx = torch.arange(B, device=h_last.device)
    logits = llama_lib.lm_head(model.llama, cfg.llama, h_last)     # [B, V]
    tok = logits.argmax(dim=-1).to(torch.int32)
    if sampling:
        sampled = _sample_rows(generator, logits, state.temp, state.top_p)
        tok = torch.where(state.temp > 0, sampled, tok)

    pred_z = mm_lib.apply_vision_head(model, cfg, h_last)           # [B, Dv]
    prediction = _project_pred(model, cfg, pred_z)                  # [B, D]
    tok_embed = llama_lib.embed_tokens(model.llama, tok)            # [B, D]

    act = fresh & state.active
    is_start = act & ~state.in_image & (tok == IM_START_TOKEN_ID)
    emit_image = act & state.in_image & (state.img_count < K)
    is_end = act & ~emit_image & ~is_start & (tok == IM_END_TOKEN_ID)

    record = act & ~emit_image
    _put_rows(state.ids, b_idx, state.n_ids, record, tok)
    state.n_ids = state.n_ids + record.to(torch.int32)
    _put_rows(state.ids_all, b_idx, state.n_all, record, tok)
    state.n_all = state.n_all + record.to(torch.int32)

    _put_rows(state.img_embeds, b_idx, state.n_img, emit_image, pred_z)
    state.n_img = state.n_img + emit_image.to(torch.int32)
    img_count = torch.where(emit_image, state.img_count + 1, state.img_count)

    in_image = state.in_image | is_start
    in_image = in_image & ~(emit_image & (img_count >= K))
    in_image = in_image & ~is_end
    state.in_image = in_image
    state.img_count = torch.where(is_end, torch.zeros_like(img_count),
                                  img_count)  # reference counter quirk

    nxt = torch.where(emit_image[:, None], prediction, tok_embed)
    state.next_embed = torch.where(act[:, None, None], nxt[:, None],
                                   state.next_embed)

    state.steps = state.steps + act.to(torch.int32)
    is_eos = torch.isin(tok, eos_ids) & act
    buffer_full = state.n_img >= state.img_embeds.shape[1]
    ids_full = state.n_ids >= state.ids.shape[1]
    finished = is_eos | (state.steps >= state.max_new) | buffer_full | ids_full
    state.active = state.active & ~(act & finished)
    return state, tok, emit_image


def _decode_all(model, state: ServeState, cfg: MetaMorphConfig,
                eos_ids: torch.Tensor, n_steps: int = 1,
                sampling: bool = False,
                generator: Optional[torch.Generator] = None) -> ServeState:
    """Advance every active slot by `n_steps` tokens (all B rows compute;
    inactive rows are frozen by the state machine)."""
    K = cfg.mm.num_image_tokens
    for j in range(n_steps):
        pos = state.cache_lens[:, None]                      # [B,1] RoPE pos
        # a routed-expert model counts its active rows' picks (and logs
        # every row's, when asked to)
        routing = (() if state.route_counts is None
                   else (state.active, state.route_counts[j],
                         state.route_log))
        h, _ = llama_lib.decode_step(model.llama, cfg.llama, state.next_embed,
                                     pos, state.cache, state.cache_lens,
                                     *routing)
        state.cache_lens = state.cache_lens + state.active.to(torch.int32)
        _advance_rows(model, cfg, state, h[:, 0], state.active, K, eos_ids,
                      sampling, generator)
    return state


# The ServeState tensors a plain tick that does not sample reads or writes:
# a captured tick's static buffers. The cache is written in place and keys
# the graph instead.
_PLAIN_TICK_FIELDS = ("cache_lens", "next_embed", "in_image", "img_count",
                      "ids", "n_ids", "img_embeds", "n_img", "steps",
                      "max_new", "active", "ids_all", "n_all")

# the kernels a plain tick launches, whose host calls a capture records
_TICK_KERNELS = (DECODE_ATTN, DECODE_ATTN_INT8, W8_MATMUL, MLA_DECODE,
                 GROUPED_MM)


def _cuda_graph(fn):
    """Capture the kernels `fn` launches as a CUDA graph, on
    `torch.cuda.graph`'s side stream: `fn`'s Python runs once and its
    launches are recorded, not run. Only this thread's calls are held to
    the capture's rules (`thread_local`). `replay()` launches the graph on
    the current stream."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        fn()
    return graph


class _TickGraph:
    """One plain tick captured for replay: `tick` (`_decode_all`'s steps)
    then `bind`. Its static buffers are the state's tensors when it was
    captured. Eager code between replays (admissions) may rebind fields to
    new tensors: `bind` copies each such field into its buffer and points
    the state back at it, inside the capture after the steps and before
    each replay. `launches` holds each kernel's host calls during the
    capture, which ran nothing: each replay runs them once."""

    def __init__(self, capture, state: ServeState, tick):
        self.bufs = {f: getattr(state, f) for f in _PLAIN_TICK_FIELDS}
        before = [k.launches for k in _TICK_KERNELS]

        def run():
            tick()
            self.bind(state)

        self.graph = capture(run)
        self.launches = {k.symbol: k.launches - n
                         for k, n in zip(_TICK_KERNELS, before)}
        self.replays = 0

    def bind(self, state: ServeState) -> None:
        for f, buf in self.bufs.items():
            t = getattr(state, f)
            if t is not buf:
                buf.copy_(t)
                setattr(state, f, buf)

    def replay(self, state: ServeState) -> None:
        self.bind(state)
        self.graph.replay()
        self.replays += 1


def _spec_verify_tick(model, state: ServeState, cfg: MetaMorphConfig,
                      drafts: torch.Tensor, K: int, spec_k: int,
                      eos_ids: torch.Tensor, special_ids: torch.Tensor,
                      sampling: bool = False,
                      generator: Optional[torch.Generator] = None
                      ) -> ServeState:
    """One speculative chunk step: embed [next token + drafts], run the
    batched verify chunk, apply the first transition through the full state
    machine, then the greedy rows' accept chain (exact per row). Updates
    `state` in place."""
    B = state.cache_lens.shape[0]
    D = state.next_embed.shape[-1]
    Km1 = spec_k - 1
    dtype = state.next_embed.dtype
    dev = state.cache_lens.device
    b_idx = torch.arange(B, device=dev)

    fresh = state.active.clone()
    d_emb = llama_lib.embed_tokens(model.llama,
                                   drafts.clamp_min(0).reshape(-1)).to(dtype)
    chunk = torch.cat([state.next_embed, d_emb.reshape(B, Km1, D)], dim=1)
    rope_pos = state.cache_lens[:, None] + torch.arange(spec_k, device=dev)
    h, _ = llama_lib.decode_chunk_step_batched(
        model.llama, cfg.llama, chunk, rope_pos, state.cache_lens,
        state.cache)
    state.cache_lens = state.cache_lens + fresh.to(torch.int32)
    _, tok1, emit1 = _advance_rows(model, cfg, state, h[:, 0], fresh, K,
                                   eos_ids, sampling, generator)
    if Km1 == 0:
        return state

    preds = llama_lib.lm_head(model.llama, cfg.llama,
                              h[:, 1:].reshape(B * Km1, -1)).argmax(
        dim=-1).to(torch.int32).reshape(B, Km1)
    base_ok = (fresh & state.active & ~emit1 & ~torch.isin(tok1, special_ids)
               & ~state.in_image & (state.temp <= 0))   # greedy rows only
    zeros = torch.zeros((B,), dtype=torch.bool, device=dev)
    n_extra = torch.zeros((B,), dtype=torch.int32, device=dev)
    last_tok = tok1
    eos_acc, start_acc, end_acc = zeros, zeros, zeros
    ok_chain, prev = base_ok, tok1
    for i in range(Km1):
        acc_i = (ok_chain & (drafts[:, i] == prev)
                 & (state.steps + i < state.max_new))
        cand = preds[:, i]
        _put_rows(state.ids, b_idx, state.n_ids + i, acc_i, cand)
        _put_rows(state.ids_all, b_idx, state.n_all + i, acc_i, cand)
        n_extra = n_extra + acc_i.to(torch.int32)
        last_tok = torch.where(acc_i, cand, last_tok)
        eos_acc = eos_acc | (acc_i & torch.isin(cand, eos_ids))
        start_acc = start_acc | (acc_i & (cand == IM_START_TOKEN_ID))
        end_acc = end_acc | (acc_i & (cand == IM_END_TOKEN_ID))
        ok_chain = acc_i & ~torch.isin(cand, special_ids)
        prev = cand

    tok_embed = llama_lib.embed_tokens(model.llama, last_tok).to(dtype)
    state.next_embed = torch.where((n_extra > 0)[:, None, None],
                                   tok_embed[:, None], state.next_embed)
    state.n_ids = state.n_ids + n_extra
    state.n_all = state.n_all + n_extra
    state.cache_lens = state.cache_lens + n_extra
    state.in_image = state.in_image | start_acc
    state.img_count = torch.where(end_acc, torch.zeros_like(state.img_count),
                                  state.img_count)
    state.steps = state.steps + n_extra
    state.spec_extra = state.spec_extra + n_extra
    state.active = state.active & ~(eos_acc | (state.steps >= state.max_new))
    return state


def _decode_all_spec(model, state: ServeState, cfg: MetaMorphConfig,
                     eos_ids: torch.Tensor, special_ids: torch.Tensor,
                     n_steps: int = 1, spec_k: int = 4,
                     sampling: bool = False,
                     generator: Optional[torch.Generator] = None
                     ) -> ServeState:
    """Speculative decode tick: each of the `n_steps` chunk steps advances
    every active slot by >= 1 token; greedy (temp == 0) rows also verify
    spec_k - 1 prompt-lookup drafts and accept the matching prefix, so
    their streams equal the plain engine's. Serving rows are unpadded, so
    physical positions equal RoPE positions. Sampling rows take one token
    per chunk."""
    K = cfg.mm.num_image_tokens
    draft = make_ngram_draft(spec_k - 1)
    for _ in range(n_steps):
        drafts = draft(state.ids_all, state.n_all)             # [B, Km1]
        _spec_verify_tick(model, state, cfg, drafts, K, spec_k, eos_ids,
                          special_ids, sampling, generator)
    return state


def _decode_all_spec_draft(model, draft, draft_cfg, state: ServeState,
                           cfg: MetaMorphConfig, eos_ids: torch.Tensor,
                           special_ids: torch.Tensor, n_steps: int = 1,
                           spec_k: int = 4, sampling: bool = False,
                           generator: Optional[torch.Generator] = None
                           ) -> ServeState:
    """Draft-MODEL speculative tick: like `_decode_all_spec`, but the
    proposals come from `draft` (a small LLaMA) over per-slot caches
    (`state.d_cache`). Per chunk step the drafter catches up on the ids
    accepted since its last sync, at most spec_k per step (so a row
    admitted through chunked fill, whose drafter starts at 0, converges
    over a few ticks), then rolls spec_k - 1 single-token steps. Greedy
    rows' streams stay exactly the plain engine's."""
    K = cfg.mm.num_image_tokens
    for _ in range(n_steps):
        drafts, state.d_len = draft_propose(
            draft, draft_cfg, state.d_cache, state.d_len, state.ids_all,
            state.n_all, spec_k)
        _spec_verify_tick(model, state, cfg, drafts, K, spec_k, eos_ids,
                          special_ids, sampling, generator)
    return state


def _chunks_from_ids(model, cfg: MetaMorphConfig, ids: torch.Tensor,
                     offs: torch.Tensor, img: Optional[torch.Tensor],
                     img_pos: Optional[torch.Tensor], dtype,
                     img_on: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[n, C, D] prompt chunks on the device from [n, C] token ids, with the
    fill request's image tokens img [MI, K, D] spliced by absolute position
    (chunk token c of chunk i sits at offs[i] + c). `img_on` [n] gates the
    splice per step: with several fills in one tick only ONE may carry
    images, and its splice must not leak into the other fills' chunks."""
    emb = llama_lib.embed_tokens(model.llama, ids).to(dtype)
    if img is None:
        return emb
    MI, K = img.shape[0], img.shape[1]
    C = ids.shape[1]
    t = torch.arange(C, device=ids.device)
    for j in range(MI):
        pos = img_pos[j]
        rel = offs.long()[:, None] + t[None] - pos                # [n, C]
        m = (rel >= 0) & (rel < K) & (pos >= 0)
        if img_on is not None:
            m = m & img_on[:, None]
        rows = img[j].to(dtype)[rel.clamp(0, K - 1)]             # [n, C, D]
        emb = torch.where(m[..., None], rows, emb)
    return emb


def _fill_core(model, state: ServeState, cfg: MetaMorphConfig,
               chunks: torch.Tensor,      # [n, C, D] prompt chunks
               chunk_ids: torch.Tensor,   # [n, C] int32 (-1 for embeds)
               fill_n_all: torch.Tensor,  # [n] drafting-source length at
                                          #   admission (0 for embeds)
               chunk_offs: torch.Tensor,  # [n] region starts
               chunk_lens: torch.Tensor,  # [n] valid tokens (0 = no chunk)
               is_last: torch.Tensor,     # [n] bool — admit after this one
               fill_slot: torch.Tensor,   # [n] target row of each step
               prompt_len: torch.Tensor, fill_max_new: torch.Tensor,
               fill_temp: torch.Tensor, fill_top_p: torch.Tensor,
               eos_ids: torch.Tensor, sampling: bool = False,
               generator: Optional[torch.Generator] = None) -> ServeState:
    """n decode steps, each carrying one chunk of a pending prompt into row
    `fill_slot[i]` (chunked prefill fused with the decode stream). Steps of
    one tick may feed different rows. On the chunk marked is_last its row
    is reset and admitted, and runs its first transition in the same step.
    Updates `state` in place; every per-step value stays on the device."""
    K = cfg.mm.num_image_tokens
    n, C = chunks.shape[:2]
    B = state.cache_lens.shape[0]
    dev = chunks.device
    b_all = torch.arange(B, device=dev)
    t = torch.arange(C, device=dev)
    A = state.ids_all.shape[1]
    for i in range(n):
        slot, off, clen = fill_slot[i], chunk_offs[i], chunk_lens[i]
        one_hot = b_all == slot                                  # [B]
        valid = clen > 0
        # record this chunk's ids as drafting source (row fill_slot)
        cols = off.long().clamp(0, A - C) + t
        cur = state.ids_all[slot.long(), cols]
        state.ids_all[slot.long(), cols] = torch.where(
            (t < clen) & valid, chunk_ids[i], cur)
        # park the fill row's decode-side junk write at the end of this
        # chunk's region (overwritten by the next chunk / first real token)
        parked = torch.where(valid, off + clen,
                             state.cache_lens[slot.long()])
        state.cache_lens = torch.where(one_hot & valid, parked.to(torch.int32),
                                       state.cache_lens)
        h_dec, h_chunk, _ = llama_lib.decode_step_with_chunk(
            model.llama, cfg.llama, state.next_embed,
            state.cache_lens[:, None], state.cache, state.cache_lens,
            chunks[i], off + t, (t < clen) & valid, slot)
        state.cache_lens = state.cache_lens + state.active.to(torch.int32)

        # admission: reset the fill row's lanes and activate it, then the
        # shared state machine runs its first transition this same step
        row = one_hot & is_last[i] & valid                       # [B]

        def put(arr, val):
            cond = row.reshape((B,) + (1,) * (arr.dim() - 1))
            return torch.where(cond, torch.as_tensor(val, dtype=arr.dtype,
                                                     device=dev), arr)

        state.cache_lens = put(state.cache_lens, prompt_len[i])
        state.in_image = put(state.in_image, False)
        state.img_count = put(state.img_count, 0)
        state.ids = put(state.ids, -1)
        state.n_ids = put(state.n_ids, 0)
        state.img_embeds = put(state.img_embeds, 0.0)
        state.n_img = put(state.n_img, 0)
        state.steps = put(state.steps, 0)
        state.max_new = put(state.max_new, fill_max_new[i])
        state.active = state.active | row
        state.temp = put(state.temp, fill_temp[i])
        state.top_p = put(state.top_p, fill_top_p[i])
        state.n_all = put(state.n_all, fill_n_all[i])
        # the drafter (if any) lags a fill-admitted row by its whole prompt;
        # the draft tick's catch-up ingests spec_k ids a step until synced
        # (the row's drafts are dead until then; exactness is unaffected)
        state.d_len = put(state.d_len, 0)
        h_last = h_chunk[(clen.long() - 1).clamp_min(0)]         # [D]
        h = torch.where(row[:, None], h_last[None], h_dec[:, 0])
        _advance_rows(model, cfg, state, h, state.active, K, eos_ids,
                      sampling, generator)
    return state


def _decode_fill_all(model, state, cfg, chunks, chunk_offs, chunk_lens,
                     is_last, fill_slot, prompt_len, fill_max_new, fill_temp,
                     fill_top_p, eos_ids, sampling=False,
                     generator=None) -> ServeState:
    """Pre-fused-embeddings fill: [n, C, D] float chunks; the admitted row
    drafts from generated tokens only (fill_n_all = 0)."""
    no_ids = torch.full(chunks.shape[:2], -1, dtype=torch.int32,
                        device=chunks.device)
    return _fill_core(model, state, cfg, chunks, no_ids,
                      torch.zeros_like(prompt_len), chunk_offs, chunk_lens,
                      is_last, fill_slot, prompt_len, fill_max_new,
                      fill_temp, fill_top_p, eos_ids, sampling, generator)


def _decode_fill_all_ids(model, state, cfg, chunk_ids, img, img_pos, img_on,
                         chunk_offs, chunk_lens, is_last, fill_slot,
                         prompt_len, fill_max_new, fill_temp, fill_top_p,
                         eos_ids, sampling=False,
                         generator=None) -> ServeState:
    """Token-ids fill: embeddings (and the image-carrying fill's splice,
    gated per step) are computed on the device; the prompt ids seed the
    row's drafting source."""
    chunks = _chunks_from_ids(model, cfg, chunk_ids, chunk_offs, img,
                              img_pos, state.next_embed.dtype, img_on)
    return _fill_core(model, state, cfg, chunks, chunk_ids, prompt_len,
                      chunk_offs, chunk_lens, is_last, fill_slot, prompt_len,
                      fill_max_new, fill_temp, fill_top_p, eos_ids, sampling,
                      generator)


# columns of the packed snapshot ahead of the ids
_SNAP_HEAD = 6


def _snapshot(state: ServeState) -> torch.Tensor:
    """Everything the scheduler reads to harvest, packed into ONE int32
    array [B, 6 + ids_cap]: active / n_ids / n_img / steps / spec_extra /
    the drafter's lag (max over rows of n_all - d_len; meaningful for draft
    engines only), then each row's generated ids."""
    lag = (state.n_all - state.d_len).max().expand_as(state.n_ids)
    head = torch.stack([state.active.to(torch.int32), state.n_ids,
                        state.n_img, state.steps, state.spec_extra, lag],
                       dim=1)
    return torch.cat([head, state.ids], dim=1)


def _embed_splice(model, cfg: MetaMorphConfig, ids: torch.Tensor,
                  img: Optional[torch.Tensor], img_pos: Optional[torch.Tensor],
                  dtype) -> torch.Tensor:
    """On-device prompt construction: token embedding lookup + image-token
    splice. ids [n, T]; img [n, MI, K, D] projected image tokens (None for
    text-only); img_pos [n, MI] splice starts (-1 = unused). Each image
    occupies K consecutive positions."""
    emb = llama_lib.embed_tokens(model.llama, ids).to(dtype)
    if img is None:
        return emb
    n, T = ids.shape
    MI, K, D = img.shape[1], img.shape[2], img.shape[3]
    t = torch.arange(T, device=ids.device)
    for j in range(MI):
        pos = img_pos[:, j][:, None]                             # [n, 1]
        rel = t[None] - pos                                      # [n, T]
        m = (rel >= 0) & (rel < K) & (pos >= 0)
        idx = rel.clamp(0, K - 1).long()[..., None].expand(n, T, D)
        rows = torch.gather(img[:, j].to(dtype), 1, idx)         # [n, T, D]
        emb = torch.where(m[..., None], rows, emb)
    return emb


def _admit_reset_slots(state: ServeState, slots: torch.Tensor,
                       prompt_lens: torch.Tensor, max_new: torch.Tensor,
                       temps: torch.Tensor, top_ps: torch.Tensor,
                       n_all: torch.Tensor, d_len: torch.Tensor
                       ) -> ServeState:
    """Reset every per-slot state-machine lane of the freshly admitted
    `slots` (in place)."""
    state.n_all[slots] = n_all.to(torch.int32)
    state.d_len[slots] = d_len.to(torch.int32)
    state.cache_lens[slots] = prompt_lens.to(torch.int32)
    state.in_image[slots] = False
    state.img_count[slots] = 0
    state.ids[slots] = -1
    state.n_ids[slots] = 0
    state.img_embeds[slots] = 0.0
    state.n_img[slots] = 0
    state.steps[slots] = 0
    state.max_new[slots] = max_new.to(torch.int32)
    state.active[slots] = True
    state.temp[slots] = temps
    state.top_p[slots] = top_ps
    return state


def _first_transition(model, state: ServeState, cfg: MetaMorphConfig,
                      slots: torch.Tensor, h_last_rows: torch.Tensor,
                      eos_ids: torch.Tensor, sampling: bool = False,
                      generator: Optional[torch.Generator] = None) -> None:
    """The admitted rows' first state-machine transition, from each
    prompt's last hidden state h_last_rows [n, D] (in place)."""
    B = state.cache_lens.shape[0]
    h = h_last_rows.new_zeros((B, h_last_rows.shape[-1]))
    h[slots] = h_last_rows
    fresh = torch.zeros((B,), dtype=torch.bool, device=h.device)
    fresh[slots] = True
    _advance_rows(model, cfg, state, h, fresh, cfg.mm.num_image_tokens,
                  eos_ids, sampling, generator)


def _prefill_core(model, state: ServeState, cfg: MetaMorphConfig,
                  prompt_embeds: torch.Tensor,   # [n, T0b, D] right-padded
                  prompt_lens: torch.Tensor,     # [n] int32 (real lengths)
                  slots: torch.Tensor,           # [n] int64 (distinct)
                  max_new: torch.Tensor, temps: torch.Tensor,
                  top_ps: torch.Tensor, eos_ids: torch.Tensor,
                  sampling: bool = False,
                  generator: Optional[torch.Generator] = None,
                  prompt_token_ids: Optional[torch.Tensor] = None,
                  draft=None) -> ServeState:
    """Prefill n same-bucket requests in ONE batched forward and admit each
    into its slot: write the KV regions, reset the rows' lanes, and run the
    first transition from each prompt's last real hidden state. With a
    drafter (`draft=(draft_llama, draft_cfg)`) and token ids, the drafter
    prefills over the same ids into its slot rows; embeds-path rows start
    its count at 0 and let the draft tick's catch-up sync on generated
    ids."""
    n, T0b = prompt_embeds.shape[:2]
    dev = prompt_embeds.device
    pos = torch.arange(T0b, device=dev)[None].expand(n, T0b)
    # No key mask: prompts are right-padded, so causality alone keeps every
    # real position off the pad keys after it (the flash prefill contract).
    # Pad positions compute junk K/V that decode overwrites before reading.
    log = {} if state.route_log is None else {"route_log": state.route_log}
    h_all, _ = llama_lib.prefill(model.llama, cfg.llama, prompt_embeds, pos,
                                 None, state.cache, rows=slots, **log)
    if prompt_token_ids is not None:
        state.ids_all[slots, :T0b] = prompt_token_ids.to(torch.int32)
        n_all = prompt_lens
    else:
        n_all = torch.zeros_like(prompt_lens)
    d_len = torch.zeros_like(prompt_lens)
    if draft is not None and prompt_token_ids is not None:
        d_emb = _draft_embed(draft[0], prompt_token_ids.clamp_min(0))
        llama_lib.prefill(draft[0], draft[1], d_emb, pos, None,
                          state.d_cache, rows=slots)
        d_len = prompt_lens
    _admit_reset_slots(state, slots, prompt_lens, max_new, temps, top_ps,
                       n_all, d_len)

    h_last_rows = h_all[torch.arange(n, device=dev),
                        prompt_lens.long() - 1]                  # [n, D]
    _first_transition(model, state, cfg, slots, h_last_rows, eos_ids,
                      sampling, generator)
    return state


def _prefill_admit(model, state, cfg, prompt_embeds, prompt_lens, slots,
                   max_new, temps, top_ps, eos_ids, sampling=False,
                   generator=None) -> ServeState:
    """Pre-fused-embeddings admission: the caller ships [n, T0b, D]."""
    return _prefill_core(model, state, cfg, prompt_embeds, prompt_lens, slots,
                         max_new, temps, top_ps, eos_ids, sampling, generator)


def _prefill_admit_ids(model, state, cfg, ids, img, img_pos, prompt_lens,
                       slots, max_new, temps, top_ps, eos_ids,
                       sampling=False, generator=None,
                       draft=None) -> ServeState:
    """Token-ids admission: embedding lookup and image splice run on the
    device, and the prompt seeds the row's id history (and the drafter's
    cache, with a drafter)."""
    pe = _embed_splice(model, cfg, ids, img, img_pos, state.next_embed.dtype)
    return _prefill_core(model, state, cfg, pe, prompt_lens, slots, max_new,
                         temps, top_ps, eos_ids, sampling, generator,
                         prompt_token_ids=ids, draft=draft)


def _prefill_admit_prefixed(model, state: ServeState, cfg: MetaMorphConfig,
                            prefix_cache: Dict[str, torch.Tensor],
                            prefix_ids: torch.Tensor,  # [P] int32
                            suffix_ids: torch.Tensor,  # [n, T0b] int32
                            img, img_pos,              # | None
                            suffix_lens: torch.Tensor,  # [n] int32
                            slots: torch.Tensor,       # [n] int64
                            max_new, temps, top_ps, eos_ids,
                            sampling: bool = False, generator=None,
                            draft=None) -> ServeState:
    """Shared-prefix admission: the prefix's KV (`prefix_cache`, [L, 1, KV,
    P, Dh], computed once by the engine) is copied into each admitted row
    of the engine's cache, and only the suffixes run through the model, as
    batched chunk steps of C = min(128, T0b) tokens (halved until it
    divides T0b) at write_pos P + off, each attending to the prefix and the
    earlier suffix chunks (kernel E on the card). Image positions are
    suffix-relative. Junk K/V past a row's suffix end is overwritten by
    generated tokens before its length reaches it. With a drafter, the
    drafter prefills over the whole prompt. No host sync: the chunks'
    offsets are Python ints and each row's last hidden state is picked on
    the device."""
    n, T0b = suffix_ids.shape
    P = prefix_ids.shape[0]
    dev = suffix_ids.device
    full_lens = P + suffix_lens
    for name, pc in prefix_cache.items():
        state.cache[name][:, slots, :, :P] = pc
    pe = _embed_splice(model, cfg, suffix_ids, img, img_pos,
                       state.next_embed.dtype)
    C = min(128, T0b)
    while T0b % C:          # a top bucket that is not a power of two
        C //= 2
    ar = torch.arange(C, device=dev)
    rows_n = torch.arange(n, device=dev)
    h_last = pe.new_zeros((n, pe.shape[-1]))
    for off in range(0, T0b, C):
        write_pos = torch.full((n,), P + off, dtype=torch.int32, device=dev)
        h, _ = llama_lib.decode_chunk_step_batched(
            model.llama, cfg.llama, pe[:, off:off + C],
            (P + off + ar)[None].expand(n, C), write_pos, state.cache,
            rows=slots)
        li = suffix_lens.long() - 1 - off
        take = (li >= 0) & (li < C)
        picked = h[rows_n, li.clamp(0, C - 1)]
        h_last = torch.where(take[:, None], picked, h_last)

    # drafting source: prefix + suffix ids
    state.ids_all[slots, :P] = prefix_ids[None].to(torch.int32)
    state.ids_all[slots, P:P + T0b] = suffix_ids.to(torch.int32)
    d_len = torch.zeros_like(suffix_lens)
    if draft is not None:
        # the drafter is small: it prefills over the whole prompt (a prefix
        # cache of its own is not worth the plumbing)
        full_ids = torch.cat([prefix_ids[None].expand(n, P).to(torch.int32),
                              suffix_ids.to(torch.int32)], dim=1)
        pos = torch.arange(P + T0b, device=dev)[None].expand(n, P + T0b)
        llama_lib.prefill(draft[0], draft[1],
                          _draft_embed(draft[0], full_ids.clamp_min(0)), pos,
                          None, state.d_cache, rows=slots)
        d_len = full_lens
    _admit_reset_slots(state, slots, full_lens, max_new, temps, top_ps,
                       full_lens, d_len)
    _first_transition(model, state, cfg, slots, h_last, eos_ids, sampling,
                      generator)
    return state


@dataclass
class Request:
    """One serving request. Two admission forms:
      * `prompt_ids` (preferred): [T0] int32 token ids; images (if any) as
        `image_embeds` [n_img, K, D] (projected to LLM space) +
        `image_positions` [n_img] (splice starts; the ids there are
        placeholders). Embedding lookup + splice happen on the device.
      * `prompt_embeds`: [T0, D] pre-fused floats."""
    prompt_embeds: Optional[np.ndarray] = None   # [T0, D]
    prompt_ids: Optional[np.ndarray] = None      # [T0] int32
    image_embeds: Any = None                     # [n_img, K, D] np or tensor
    image_positions: Optional[np.ndarray] = None  # [n_img] int32
    max_new_tokens: int = 64
    temperature: float = 0.0         # 0 = greedy; >0 samples (per request)
    top_p: float = 1.0               # nucleus mass, applied when sampling
    uid: Any = None
    t_submit: float = 0.0            # stamped by submit()

    @property
    def prompt_len(self) -> int:
        src = self.prompt_ids if self.prompt_ids is not None \
            else self.prompt_embeds
        return len(src)


@dataclass
class Completed:
    uid: Any
    ids: np.ndarray                  # [n_ids] generated token ids
    image_embeds: np.ndarray         # [n_img, Dv] continuous visual tokens
    steps: int = 0
    queue_s: float = 0.0             # submit -> admitted into a slot
    serve_s: float = 0.0             # admitted -> harvested (incl. prefill)
    # [prompt + steps, L_moe, k] expert picks of each position, where the
    # engine logs them (`ServeEngine.log_routes`)
    routes: Optional[np.ndarray] = None


class ServeEngine:
    """Host-side continuous-batching scheduler over the slot state.

    Usage:
        eng = ServeEngine(model, cfg, n_slots=8, max_cache_len=4096)
        eng.submit(Request(prompt_ids=ids, max_new_tokens=128, uid="r1"))
        done = eng.run()             # or step() incrementally

    The engine runs where the model's weights live (`model`'s device).
    Options, as in the JAX engine: `spec_k > 1` prompt-lookup speculation
    (routed per tick by the rows' acceptance rates), or draft-model
    speculation with `draft=(draft_llama, draft_cfg)` (a small `Llama`
    module sharing the vocabulary, on the model's device), `fill_chunk > 0`
    chunked fill of long prompts while slots decode (up to `max_fills` at
    once; 0 when it does not divide `max_cache_len`), `kv_int8` the int8
    KV cache, `shared_prefix_ids` a prefix (a system prompt) whose KV is
    computed once here: requests then carry only their suffix ids (image
    positions relative to the suffix), and chunked fill and the embeds
    transport are refused.

    A latent-attention decoder with routed experts (`LlamaConfig.
    attention_kind` "mla") serves through the same admission, plain tick
    and image state over its latent cache; speculation, chunked fill, the
    int8 cache and the shared prefix are refused here. Its plain ticks
    count each step's expert picks of the active rows per expert layer;
    the harvest that reads a tick's snapshot leaves them in `routes`
    ([steps, L_moe, E] int32, None after a tick that decoded nothing)."""

    def __init__(self, model: mm_lib.MetaMorph, cfg: MetaMorphConfig,
                 n_slots: int = 8, max_cache_len: int = 2048,
                 max_new_tokens_cap: int = 512, max_images: int = 4,
                 stop_ids: tuple = (),
                 prefill_buckets: Tuple[int, ...] = (64, 128, 256, 512, 1024,
                                                     2048, 4096),
                 steps_per_sync: int = 8, max_prefill_images: int = 4,
                 seed: int = 0, on_token=None, fill_chunk: int = 0,
                 max_fills: int = 2, kv_int8: bool = False, spec_k: int = 0,
                 draft=None, shared_prefix_ids=None):
        self.model, self.cfg = model, cfg
        lcfg = cfg.llama
        for what, on in (("speculative decoding (spec_k, draft)",
                          spec_k > 1 or draft is not None),
                         ("chunked fill (fill_chunk)", fill_chunk > 0),
                         ("the int8 KV cache (kv_int8)", kv_int8),
                         ("the shared prefix (shared_prefix_ids)",
                          shared_prefix_ids is not None)):
            if on:
                lcfg.require_gqa(what)
        self.n_slots, self.S = n_slots, max_cache_len
        self.device = model.llama.embed.device
        dev = self.device
        dtype = model.llama.embed.dtype
        self.stop_ids = tuple(stop_ids)
        self._eos_ids = torch.tensor(tuple(LLAMA3_EOS_IDS) + self.stop_ids,
                                     dtype=torch.int32, device=dev)
        self._special_ids = torch.tensor(
            tuple(LLAMA3_EOS_IDS) + self.stop_ids
            + (IM_START_TOKEN_ID, IM_END_TOKEN_ID), dtype=torch.int32,
            device=dev)
        # buckets above the cache length are clamped, with the cache length
        # itself on top
        buckets = sorted(b for b in prefill_buckets if b <= max_cache_len)
        if not buckets or buckets[-1] < max_cache_len:
            buckets.append(max_cache_len)
        self.prefill_buckets = tuple(buckets)
        self.steps_per_sync = max(int(steps_per_sync), 1)
        D = cfg.llama.hidden_size
        Dv = cfg.siglip.hidden_size
        K = cfg.mm.num_image_tokens
        # speculation: spec_k slack slots so a chunk written at the budget
        # boundary never clamps onto live entries
        self.spec_k = spec_k if spec_k > 1 else 0
        if draft is not None and not self.spec_k:
            raise ValueError("draft model requires spec_k >= 2")
        self._draft = draft
        S_alloc = max_cache_len + (self.spec_k + 8 if self.spec_k else 0)

        def zeros(*shape, dt=torch.int32):
            return torch.zeros(shape, dtype=dt, device=dev)

        self.state = ServeState(
            cache=llama_lib.init_kv_cache(cfg.llama, n_slots, S_alloc,
                                          dtype=dtype, device=dev,
                                          quantized=kv_int8),
            cache_lens=zeros(n_slots),
            next_embed=zeros(n_slots, 1, D, dt=dtype),
            in_image=zeros(n_slots, dt=torch.bool),
            img_count=zeros(n_slots),
            ids=torch.full((n_slots, max_new_tokens_cap), -1,
                           dtype=torch.int32, device=dev),
            n_ids=zeros(n_slots),
            img_embeds=zeros(n_slots, max_images * K, Dv, dt=torch.float32),
            n_img=zeros(n_slots),
            steps=zeros(n_slots),
            max_new=zeros(n_slots),
            active=zeros(n_slots, dt=torch.bool),
            temp=zeros(n_slots, dt=torch.float32),
            top_p=torch.ones((n_slots,), dtype=torch.float32, device=dev),
            ids_all=torch.full((n_slots, max_cache_len + 8), -1,
                               dtype=torch.int32, device=dev),
            n_all=zeros(n_slots),
            spec_extra=zeros(n_slots),
            d_cache=(llama_lib.init_kv_cache(
                draft[1], n_slots, S_alloc, dtype=draft[0].embed.dtype,
                device=dev) if draft is not None else None),
            d_len=zeros(n_slots),
            route_counts=(zeros(1 << (self.steps_per_sync.bit_length() - 1),
                                sum(map(lcfg.is_moe_layer,
                                        range(lcfg.num_layers))),
                                lcfg.n_routed_experts)
                          if lcfg.n_routed_experts else None),
        )
        self.routes = None
        self._routes_n = 0
        self._prefix = None
        if shared_prefix_ids is not None:
            self._prefix = self._build_prefix(shared_prefix_ids, kv_int8,
                                              fill_chunk)
        self.generator = torch.Generator(device=dev)
        self.generator.manual_seed(seed)
        # flips True the first time a sampling request is admitted; greedy
        # engines never run the sampler
        self._sampling = False
        self.max_prefill_images = max_prefill_images
        # adaptive speculation, PER ROW: each slot keeps an EMA of accepted
        # drafts per chunk step for its current request (reset on
        # admission); a tick runs the spec program iff the occupied rows'
        # expected extra tokens beat `spec_overhead_frac` of the tick's
        # tokens. Rows stay on probation (always probed) for their first
        # few spec ticks: the first chunk after admission accepts nothing
        # while the drafting source warms up.
        self._spec_ticked = False
        self._spec_extras_seen = np.zeros((n_slots,), np.int64)
        self._row_rate = np.full((n_slots,), -1.0)   # -1 = unprobed
        self._row_obs = np.zeros((n_slots,), np.int32)
        self._spec_probation = 3
        self._spec_tick_n = 0
        self._spec_tick_rows = np.zeros((n_slots,), bool)
        self._ticks_since_spec = 0
        self.spec_overhead_frac = 0.1
        # chunked fill: chunk regions must tile the cache exactly; only
        # prompts of at least 2 chunks stream through it, and only while
        # other slots decode
        self.fill_chunk = (fill_chunk if fill_chunk > 0
                           and max_cache_len % fill_chunk == 0 else 0)
        self.fill_min_len = 2 * self.fill_chunk
        self._fills: list = []   # in-progress chunked fills (FIFO)
        self.max_fills = max(int(max_fills), 1)
        # ticks by the program they ran: "prefill" (blocking admissions),
        # "fill", "spec", "plain"; of the plain ones, "plain_graphed" were
        # replayed from a captured graph, and "captures" counts the graphs
        self.tick_counts = {"prefill": 0, "fill": 0, "spec": 0, "plain": 0,
                            "plain_graphed": 0, "captures": 0}
        # plain ticks that do not sample replay a CUDA graph per key
        # (`_plain_tick`); not on the CPU, and not for a model split by
        # tensor parallelism, whose collectives stay out of a capture
        split = any(layer.tp_group is not None
                    for layer in model.llama.layers)
        self._capture = (_cuda_graph if dev.type == "cuda" and not split
                         else None)
        self._graphs: Dict[tuple, Optional[_TickGraph]] = {}
        # the packed status travels to a reused pinned host buffer behind
        # the next tick's device work (CUDA), read one tick later
        snap_shape = (n_slots, _SNAP_HEAD + max_new_tokens_cap)
        self._snap_host = (torch.empty(snap_shape, dtype=torch.int32,
                                       pin_memory=True)
                           if dev.type == "cuda" else None)
        self._snap = None
        self._routes_host = None
        # streaming: on_token(uid, new_ids) whenever a tick's snapshot shows
        # a row recorded new tokens (one sync chunk behind generation)
        self.on_token = on_token
        self._streamed = np.zeros(n_slots, np.int64)
        self.pending: List[Request] = []
        self.slot_uid: List[Any] = [None] * n_slots
        self.slot_t_admit: List[float] = [0.0] * n_slots
        self.slot_queue_s: List[float] = [0.0] * n_slots
        self.slot_prompt_len: List[int] = [0] * n_slots
        self.completed: List[Completed] = []

    def log_routes(self) -> None:
        """Keep every position's expert picks (a routed-expert model):
        admissions and decode steps write them into a [slots, S, L_moe, k]
        uint8 log on the device, and each finished request carries its
        own (`Completed.routes`, read at harvest). Call before the first
        tick: a captured tick writes the log only if it existed then."""
        lc = self.cfg.llama
        if self.state.route_counts is None:
            raise ValueError("only a routed-expert model has picks to log")
        if self._graphs or any(u is not None for u in self.slot_uid):
            raise ValueError("log_routes() goes before the first request")
        self.state.route_log = torch.zeros(
            (self.n_slots, self.state.cache["latent"].shape[2],
             self.state.route_counts.shape[1], lc.num_experts_per_tok),
            dtype=torch.uint8, device=self.device)

    @torch.no_grad()
    def _build_prefix(self, shared_prefix_ids, kv_int8: bool,
                      fill_chunk: int):
        """The prefix's KV [L, 1, KV, P, Dh] (bf16, or int8 with scales
        under kv_int8), from one prefill (kernel A on the card); and the
        suffix buckets: the user's buckets that fit beside the prefix and
        tile the admission chunks (multiples of 64, or powers of two below
        128), topped by the room left, rounded down to a multiple of 64.
        Returns (prefix ids, prefix cache)."""
        if fill_chunk:
            raise ValueError("fill_chunk (chunked prefill) is not supported "
                             "on shared-prefix engines: the fill machinery "
                             "is not prefix-aware")
        dev = self.device
        pids = torch.as_tensor(np.asarray(shared_prefix_ids, np.int32),
                               device=dev)
        P = int(pids.shape[0])
        if P + 1 >= self.S:
            raise ValueError("shared prefix leaves no room in the cache")
        llama = self.model.llama
        pc = llama_lib.init_kv_cache(self.cfg.llama, 1, P,
                                     dtype=llama.embed.dtype, device=dev,
                                     quantized=kv_int8)
        llama_lib.prefill(llama, self.cfg.llama,
                          llama_lib.embed_tokens(llama, pids[None]),
                          torch.arange(P, device=dev)[None], None, pc)

        def tiles(b):
            return b % 64 == 0 or (b < 128 and b & (b - 1) == 0)

        room = self.S - P
        bks = [b for b in self.prefill_buckets if b <= room and tiles(b)]
        top = room if tiles(room) else (room // 64) * 64
        if top > 0 and (not bks or bks[-1] < top):
            bks.append(top)
        if not bks:
            raise ValueError("shared prefix leaves no usable suffix bucket "
                             "(cache too small)")
        self.prefill_buckets = tuple(bks)
        return pids, pc

    # -- scheduling ---------------------------------------------------------

    def submit(self, req: Request) -> None:
        """Queue a request, stamped on the host clock (`perf_counter`, the
        clock of the spans and of a device trace)."""
        with trace.span("serve.submit", uid=req.uid):
            self._check(req)
            if req.temperature > 0:
                self._sampling = True
            req.t_submit = time.perf_counter()
            self.pending.append(req)

    def _check(self, req: Request) -> None:
        """Validate at submit, so a bad request fails alone instead of
        inside step() with every in-flight request."""
        if (req.prompt_ids is None) == (req.prompt_embeds is None):
            raise ValueError(
                "exactly one of prompt_ids / prompt_embeds must be set")
        if req.max_new_tokens > self.state.ids.shape[1]:
            raise ValueError("max_new_tokens exceeds the engine's buffer cap")
        if req.image_embeds is not None:
            if req.prompt_ids is None:
                raise ValueError("image_embeds requires the prompt_ids path "
                                 "(pre-fused prompts already contain images)")
            ie = req.image_embeds
            n_img = ie.shape[0]
            if n_img > self.max_prefill_images:
                raise ValueError(
                    f"{n_img} images > max_prefill_images="
                    f"{self.max_prefill_images}")
            if len(ie.shape) != 3 or ie.shape[1] != self.cfg.mm.num_image_tokens \
                    or ie.shape[2] != self.cfg.llama.hidden_size:
                raise ValueError(
                    "image_embeds must be [n_img, num_image_tokens, D] "
                    "(projected to LLM space)")
            if req.image_positions is None \
                    or np.asarray(req.image_positions).shape[0] != n_img:
                raise ValueError("image_positions must give one splice start "
                                 "per image")
        t0 = req.prompt_len
        P = 0
        if self._prefix is not None:
            if req.prompt_ids is None:
                raise ValueError("shared-prefix engines require the "
                                 "prompt_ids transport (suffix ids)")
            P = self._prefix[0].shape[0]
        if t0 > self.prefill_buckets[-1]:
            raise ValueError(
                f"prompt length {t0} exceeds largest bucket "
                f"{self.prefill_buckets[-1]}")
        if P + t0 + req.max_new_tokens > self.S:
            raise ValueError("prompt + generation exceed max_cache_len")
        if req.temperature < 0:
            raise ValueError("temperature must be >= 0 (0 = greedy)")
        if not 0 < req.top_p <= 1:
            raise ValueError("top_p must be in (0, 1]")

    @property
    def spec_accepted(self) -> int:
        """Cumulative draft tokens accepted by speculative ticks (host
        mirror of the device counter; one sync chunk stale)."""
        return int(self._spec_extras_seen.sum())

    def _bucket(self, t0: int) -> int:
        for b in self.prefill_buckets:
            if t0 <= b:
                return b
        raise ValueError(f"prompt length {t0} exceeds largest bucket")

    @staticmethod
    def _kind(req: Request) -> str:
        if req.prompt_embeds is not None:
            return "embeds"
        return "ids_img" if req.image_embeds is not None else "ids"

    def _admit_many(self, slots: List[int], reqs: List[Request],
                    bucket: int) -> None:
        """One batched prefill admitting len(reqs) same-bucket, same-kind
        requests."""
        n = len(reqs)
        dev = self.device
        D = self.cfg.llama.hidden_size
        dtype = self.state.next_embed.dtype

        def tensor(vals, dt):
            return torch.as_tensor(np.asarray(vals), dtype=dt, device=dev)

        lens = tensor([r.prompt_len for r in reqs], torch.int32)
        slot_t = tensor(slots, torch.int64)
        max_new = tensor([r.max_new_tokens for r in reqs], torch.int32)
        temps = tensor([r.temperature for r in reqs], torch.float32)
        top_ps = tensor([r.top_p for r in reqs], torch.float32)
        common = (max_new, temps, top_ps, self._eos_ids, self._sampling,
                  self.generator)
        kind = self._kind(reqs[0])
        if kind == "embeds":
            padded = np.zeros((n, bucket, D), np.float32)
            for i, req in enumerate(reqs):
                pe = np.asarray(req.prompt_embeds, np.float32)
                padded[i, :pe.shape[0]] = pe
            _prefill_admit(self.model, self.state, self.cfg,
                           tensor(padded, dtype), lens, slot_t, *common)
        else:
            ids = np.zeros((n, bucket), np.int32)
            for i, req in enumerate(reqs):
                pi = np.asarray(req.prompt_ids, np.int32)
                ids[i, :pi.shape[0]] = pi
            img = img_pos = None
            if kind == "ids_img":
                MI, K = self.max_prefill_images, self.cfg.mm.num_image_tokens
                img = torch.zeros((n, MI, K, D), dtype=dtype, device=dev)
                pos_np = np.full((n, MI), -1, np.int32)
                for i, req in enumerate(reqs):
                    ie = torch.as_tensor(req.image_embeds)
                    img[i, :ie.shape[0]] = ie.to(device=dev, dtype=dtype)
                    pos_np[i, :ie.shape[0]] = np.asarray(req.image_positions,
                                                         np.int32)
                img_pos = tensor(pos_np, torch.int32)
            if self._prefix is not None:
                _prefill_admit_prefixed(
                    self.model, self.state, self.cfg, self._prefix[1],
                    self._prefix[0], tensor(ids, torch.int32), img, img_pos,
                    lens, slot_t, *common, draft=self._draft)
            else:
                _prefill_admit_ids(self.model, self.state, self.cfg,
                                   tensor(ids, torch.int32), img, img_pos,
                                   lens, slot_t, *common, draft=self._draft)
        now = time.perf_counter()
        for slot, req in zip(slots, reqs):
            self.slot_uid[slot] = req.uid
            self.slot_t_admit[slot] = now
            self.slot_queue_s[slot] = now - req.t_submit
            self.slot_prompt_len[slot] = req.prompt_len
            self._streamed[slot] = 0
            self._row_rate[slot] = -1.0  # new request: re-probe its spec rate
            self._row_obs[slot] = 0

    def _fetch_snapshot(self) -> None:
        snap = _snapshot(self.state)
        n, self._routes_n = self._routes_n, 0
        routes = self.state.route_counts[:n] if n else None
        if self._snap_host is None:
            self._snap = (snap.clone(), None,
                          None if routes is None else routes.clone())
            return
        self._snap_host.copy_(snap, non_blocking=True)
        if routes is not None:
            if self._routes_host is None:
                self._routes_host = torch.empty(
                    self.state.route_counts.shape, dtype=torch.int32,
                    pin_memory=True)
            self._routes_host[:n].copy_(routes, non_blocking=True)
            routes = self._routes_host[:n]
        ev = torch.cuda.Event()
        ev.record()
        self._snap = (self._snap_host, ev, routes)

    def _harvest(self) -> List[Any]:
        """Move finished rows (occupied but no longer active) to completed,
        using the PREVIOUS tick's packed snapshot, and update each row's
        speculation rate. Rows are final once inactive, so its ids are their
        final ids; only img_embeds need a live fetch, and only for rows that
        emitted images. Filling slots still hold the previous request's
        lanes until their admitting chunk and are skipped. Returns the
        finished requests' uids."""
        self.routes = None
        if self._snap is None:
            return []
        host, ev, routes = self._snap
        if ev is not None:
            with trace.span("serve.harvest.wait"):
                ev.synchronize()
        snap = host.numpy().copy()
        if routes is not None:
            self.routes = routes.numpy().copy()
        self._snap = None
        active, n_ids, n_img, steps = snap[:, 0], snap[:, 1], snap[:, 2], \
            snap[:, 3]
        # per-row accepted-drafts-per-chunk-step EMA from this tick's delta
        extras_row = snap[:, 4].astype(np.int64)
        # a draft engine whose drafter is still catching up (lag > spec_k
        # after a fill admission) produces dead drafts: those ticks are no
        # evidence against speculation
        syncing = self._draft is not None and int(snap[0, 5]) > self.spec_k
        if self._spec_ticked:
            self._spec_ticked = False
            if not syncing and self._spec_tick_n > 0:
                delta = (extras_row - self._spec_extras_seen) \
                    / float(self._spec_tick_n)
                for s in np.where(self._spec_tick_rows)[0]:
                    self._row_obs[s] += 1
                    if self._row_rate[s] < 0:
                        self._row_rate[s] = delta[s]
                    else:
                        self._row_rate[s] = (0.7 * self._row_rate[s]
                                             + 0.3 * delta[s])
        self._spec_extras_seen = extras_row
        ids_all = snap[:, _SNAP_HEAD:]
        filling = {f["slot"] for f in self._fills}
        if self.on_token is not None:
            for s in range(self.n_slots):
                if s in filling or self.slot_uid[s] is None:
                    continue
                lo, hi = int(self._streamed[s]), int(n_ids[s])
                if hi > lo:
                    self.on_token(self.slot_uid[s], ids_all[s, lo:hi].copy())
                    self._streamed[s] = hi
        fin = [s for s in range(self.n_slots)
               if s not in filling and self.slot_uid[s] is not None
               and not active[s]]
        if not fin:
            return []
        uids = [self.slot_uid[s] for s in fin]
        Dv = self.state.img_embeds.shape[-1]
        need_img = [s for s in fin if n_img[s]]
        img_rows = (self.state.img_embeds[need_img].cpu().numpy()
                    if need_img else None)
        # the finished rows' logged picks in one copy (the slots' next
        # requests overwrite the log)
        n_log = [self.slot_prompt_len[s] + int(steps[s]) for s in fin]
        logs = (None if self.state.route_log is None else
                self.state.route_log[fin, :max(n_log)].cpu().numpy())
        now = time.perf_counter()
        for i, s in enumerate(fin):
            emb = (img_rows[need_img.index(s)][:n_img[s]]
                   if n_img[s] else np.zeros((0, Dv), np.float32))
            routes = None if logs is None else logs[i, :n_log[i]]
            self.completed.append(Completed(
                uid=self.slot_uid[s], ids=ids_all[s][:n_ids[s]],
                image_embeds=emb, steps=int(steps[s]),
                queue_s=self.slot_queue_s[s],
                serve_s=now - self.slot_t_admit[s], routes=routes))
            self.slot_uid[s] = None
        return uids

    def _spec_worth_it(self, occ, n: int) -> bool:
        """Per-row spec/plain routing: run the speculative program iff the
        occupied rows' expected extra tokens beat the spec chunk's overhead
        (spec_overhead_frac of the plain tick's B*n tokens). Rows on
        probation always probe; after a fallback, stale rates re-probe
        every 64 plain ticks."""
        rates = self._row_rate[occ]
        if (self._row_obs[list(occ)] < self._spec_probation).any() \
                or self._ticks_since_spec >= 64:
            return True
        est_extras = float(np.clip(rates, 0.0, None).sum()) * n
        return est_extras >= self.spec_overhead_frac * len(occ) * n

    def _mark_spec_tick(self, occ, n: int) -> None:
        self._spec_ticked = True
        self._spec_tick_n = n
        self._spec_tick_rows[:] = False
        self._spec_tick_rows[list(occ)] = True
        self._ticks_since_spec = 0

    def _start_fill(self, slot: int, req: Request) -> None:
        self.slot_uid[slot] = req.uid  # reserve the slot
        self._row_rate[slot] = -1.0    # new request: re-probe its spec rate
        self._row_obs[slot] = 0
        self._fills.append({"slot": slot, "req": req, "kind": self._kind(req),
                            "chunk": 0,
                            "nchunks": -(-req.prompt_len // self.fill_chunk)})

    def _can_join_fills(self, req: Request) -> bool:
        """May `req` start filling beside the fills in flight? Several fills
        run on the ids program (embeds fills stay exclusive) and carry at
        most one image request per tick."""
        if len(self._fills) >= self.max_fills:
            return False
        if not self._fills:
            return True
        kind = self._kind(req)
        if kind == "embeds" or any(f["kind"] == "embeds"
                                   for f in self._fills):
            return False
        if kind == "ids_img" and any(f["kind"] == "ids_img"
                                     for f in self._fills):
            return False
        return True

    def _fill_tick(self, n: int) -> int:
        """Run fused decode + chunk steps feeding up to n prompt chunks of
        the fills in flight (FIFO: the head fill's remaining chunks first,
        then the next fill's). Each fill's row admits on its last chunk. The
        step count is the remaining chunks capped at n, snapped down to a
        power of two. Returns the number of steps run."""
        C, D = self.fill_chunk, self.cfg.llama.hidden_size
        dev = self.device
        dtype = self.state.next_embed.dtype
        remaining = sum(f["nchunks"] - f["chunk"] for f in self._fills)
        n = min(n, remaining)
        n = 1 << (n.bit_length() - 1)
        kind0 = self._fills[0]["kind"]
        plan = []                      # (fill, chunk index)
        fi = 0
        for _ in range(n):
            while self._fills[fi]["chunk"] >= self._fills[fi]["nchunks"]:
                fi += 1
            f = self._fills[fi]
            plan.append((f, f["chunk"]))
            f["chunk"] += 1
        # per step: off, len, last, slot, prompt_len, max_new, img_on
        ints = np.zeros((7, n), np.int32)
        floats = np.ones((2, n), np.float32)          # temp, top_p
        if kind0 == "embeds":
            chunks = np.zeros((n, C, D), np.float32)
        else:
            chunk_ids = np.zeros((n, C), np.int32)
        img_fill = None
        for i, (f, j) in enumerate(plan):
            req = f["req"]
            T0 = req.prompt_len
            lo, hi = j * C, min((j + 1) * C, T0)
            if kind0 == "embeds":
                chunks[i, :hi - lo] = np.asarray(req.prompt_embeds)[lo:hi]
            else:
                chunk_ids[i, :hi - lo] = np.asarray(req.prompt_ids,
                                                    np.int32)[lo:hi]
            ints[:6, i] = (lo, hi - lo, j == f["nchunks"] - 1, f["slot"], T0,
                           req.max_new_tokens)
            floats[:, i] = (req.temperature, req.top_p)
            if f["kind"] == "ids_img":
                img_fill = f
                ints[6, i] = 1
        it = torch.as_tensor(ints).to(dev)
        ft = torch.as_tensor(floats).to(dev)
        offs, lens, last, slots, plens, maxnews, img_on = it
        common = (offs, lens, last.bool(), slots, plens, maxnews, ft[0],
                  ft[1], self._eos_ids, self._sampling, self.generator)
        if kind0 == "embeds":
            _decode_fill_all(self.model, self.state, self.cfg,
                             torch.as_tensor(chunks).to(dev, dtype), *common)
        else:
            img = img_pos = on = None
            if img_fill is not None:
                MI, K = self.max_prefill_images, self.cfg.mm.num_image_tokens
                req = img_fill["req"]
                ie = torch.as_tensor(req.image_embeds)
                img = torch.zeros((MI, K, D), dtype=dtype, device=dev)
                img[:ie.shape[0]] = ie.to(device=dev, dtype=dtype)
                pos_np = np.full((MI,), -1, np.int32)
                pos_np[:ie.shape[0]] = np.asarray(req.image_positions,
                                                  np.int32)
                img_pos = torch.as_tensor(pos_np).to(dev)
                on = img_on.bool()
            _decode_fill_all_ids(self.model, self.state, self.cfg,
                                 torch.as_tensor(chunk_ids).to(dev), img,
                                 img_pos, on, *common)
        now = time.perf_counter()
        for f in [f for f in self._fills if f["chunk"] >= f["nchunks"]]:
            slot, req = f["slot"], f["req"]    # admitted during the tick
            self.slot_t_admit[slot] = now
            self.slot_queue_s[slot] = now - req.t_submit
            self._streamed[slot] = 0
            self._fills.remove(f)
        return n

    def _head_is_chunkable(self, decoding: bool) -> bool:
        """Chunked fill pays for LONG prompts while slots are decoding (a
        blocking long prefill stalls every decoding slot); short prompts are
        cheaper through the batched blocking prefill."""
        if not (self.fill_chunk and decoding and self.pending):
            return False
        return self.pending[0].prompt_len >= self.fill_min_len

    @torch.no_grad()
    def step(self) -> None:
        """One scheduler tick. Admission policy, as in the JAX engine:
          * short prompts (and a cold start) -> blocking batched prefill
            (runs of consecutive same-bucket, same-kind requests share one
            prefill, snapped to a power of two);
          * long prompts while slots decode -> chunked fill fused into the
            decode steps (`fill_chunk`-token pieces).
        Then one tick of 2**floor(log2(steps_per_sync)) steps: fill steps
        while fills are in flight, else spec steps (when speculation is on
        and the rows' rates say it pays) or plain decode steps. The tick
        starts by harvesting the previous tick's snapshot and ends by
        starting this tick's copy.

        Traced (`utils/trace`), the tick is a `serve.step` span holding
        one span per phase: `serve.harvest` (its wait on the snapshot's
        event as `serve.harvest.wait`), a `serve.admit` per batched
        prefill (its bucket, rows, and each row's prompt length, image
        or not and uid: bucket x rows less the lengths is its padding),
        then `serve.fill` or `serve.decode` (a plain one says whether it
        replayed a graph: `graph`), and `serve.snapshot`."""
        with trace.span("serve.step"):
            with trace.span("serve.harvest") as sp:
                sp.set(uids=self._harvest())
            self._admit_pending()
            self._tick()
            with trace.span("serve.snapshot"):
                self._fetch_snapshot()

    def _admit_pending(self) -> None:
        """The tick's admissions: blocking batched prefills while slots
        are free and the head of the queue is not for chunked fill, then
        chunked fills for the long prompts."""
        free = [s for s in range(self.n_slots) if self.slot_uid[s] is None]
        fill_slots = {f["slot"] for f in self._fills}
        decoding = any(self.slot_uid[s] is not None and s not in fill_slots
                       for s in range(self.n_slots))
        while (free and self.pending and not self._fills
               and not self._head_is_chunkable(decoding)):
            b0 = self._bucket(self.pending[0].prompt_len)
            k0 = self._kind(self.pending[0])
            k = 1
            while (k < len(free) and k < len(self.pending) and k < 8
                   and self._bucket(self.pending[k].prompt_len) == b0
                   and self._kind(self.pending[k]) == k0):
                k += 1
            k = 1 << (k.bit_length() - 1)
            reqs = [self.pending.pop(0) for _ in range(k)]
            slots = [free.pop(0) for _ in range(k)]
            with trace.span("serve.admit", bucket=b0, rows=k) as sp:
                if trace.enabled():
                    sp.set(lens=[r.prompt_len for r in reqs],
                           image=[r.image_embeds is not None for r in reqs],
                           uids=[r.uid for r in reqs])
                self._admit_many(slots, reqs, b0)
            self.tick_counts["prefill"] += 1
            decoding = True
        while (free and self._head_is_chunkable(decoding)
               and self._can_join_fills(self.pending[0])):
            self._start_fill(free.pop(0), self.pending.pop(0))

    def _tick(self) -> None:
        """The tick's device steps: fill steps while fills are in flight,
        else spec or plain decode steps over the occupied rows."""
        fill_slots = {f["slot"] for f in self._fills}
        occ = [s for s in range(self.n_slots)
               if self.slot_uid[s] is not None and s not in fill_slots]
        n = 1 << (self.steps_per_sync.bit_length() - 1)
        if self._fills:
            with trace.span("serve.fill", steps=n, rows=len(occ)):
                self._fill_tick(n)
            self.tick_counts["fill"] += 1
        elif occ:
            if self.spec_k and self._spec_worth_it(occ, n):
                program = "draft" if self._draft is not None else "spec"
                with trace.span("serve.decode", program=program, steps=n,
                                rows=len(occ)):
                    if self._draft is not None:
                        _decode_all_spec_draft(
                            self.model, *self._draft, self.state, self.cfg,
                            self._eos_ids, self._special_ids, n, self.spec_k,
                            self._sampling, self.generator)
                    else:
                        _decode_all_spec(self.model, self.state, self.cfg,
                                         self._eos_ids, self._special_ids, n,
                                         self.spec_k, self._sampling,
                                         self.generator)
                self._mark_spec_tick(occ, n)
                self.tick_counts["spec"] += 1
            else:
                self._ticks_since_spec += 1
                with trace.span("serve.decode", program="plain", steps=n,
                                rows=len(occ)) as sp:
                    sp.set(graph=self._plain_tick(n))
                self.tick_counts["plain"] += 1

    def _plain_tick(self, n: int) -> bool:
        """n plain decode steps, replayed from the CUDA graph of their key
        (n, the slots, the cache's storage) where the engine captures and
        does not sample, else run eagerly. A key's first tick runs eagerly,
        so that kernel B's workspace, kernel F's plans and the libraries'
        handles exist before a capture; its second captures, then replays.
        Returns whether the tick was replayed."""
        def tick():
            _decode_all(self.model, self.state, self.cfg, self._eos_ids, n,
                        self._sampling, self.generator)

        if self.state.route_counts is not None:
            self._routes_n = n

        if self._capture is None or self._sampling:
            tick()
            return False
        key = (n, self.n_slots) + tuple(
            (name, t.data_ptr(), t.dtype)
            for name, t in sorted(self.state.cache.items()))
        if key not in self._graphs:
            self._graphs[key] = None
            tick()
            return False
        graph = self._graphs[key]
        if graph is None:
            graph = _TickGraph(self._capture, self.state, tick)
            self._graphs[key] = graph
            self.tick_counts["captures"] += 1
        graph.replay(self.state)
        self.tick_counts["plain_graphed"] += 1
        return True

    def graph_launches(self) -> Dict[str, Tuple[int, int]]:
        """Per kernel of a plain tick: (host calls made while capturing,
        which ran nothing; launches its replays ran), over this engine's
        graphs. A kernel's `launches` less the first plus the second is
        what ran on the card."""
        out = {}
        for g in filter(None, self._graphs.values()):
            for sym, n in g.launches.items():
                c, r = out.get(sym, (0, 0))
                out[sym] = (c + n, r + n * g.replays)
        return out

    def run(self, max_ticks: int = 100_000) -> List[Completed]:
        """Drive until every submitted request completes."""
        ticks = 0
        while self.pending or any(u is not None for u in self.slot_uid):
            self.step()
            ticks += 1
            if ticks > max_ticks:
                raise RuntimeError("serve loop did not converge")
        out, self.completed = self.completed, []
        return out
