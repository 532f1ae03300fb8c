"""Multimodal greedy decode with a KV cache (counterpart of
`metamorph_tpu/inference/decode.py`).

The state machine of the reference decode (`metamorph_llama.py:502-597`),
one transition per generated token:
  * token 128256 <image_start> (while not in image mode) -> image mode;
  * in image mode, for K steps: the last hidden state goes through the
    vision head (the 1152-d prediction is recorded) and the projector, and
    the projected embedding is fed back as the next input; then out;
  * token 128257 <image_end> -> out of image mode (the counter resets only
    here, as in the reference);
  * anything else -> its text embedding is fed back and its id recorded;
  * stop on eos (128001/128009) or a `stop_ids` token, at the budget, or
    when the image buffer is full.

Every function keeps B rows of state ([B]-leading tensors, `DecodeState`);
the single-request `greedy_decode` is the B=1 case. Where the JAX batched
functions LEFT-pad and share one cache length, each row here sits at the
start of its own cache row, unpadded and ragged in time: the prefill runs
right-padded rows with per-row lengths (kernel A, the flash forward, on the
card), each decode step writes row b at its own `cache_len[b]` (kernel B),
and a row's first hidden state is the one at its prompt length - 1. JAX
gives a pad position RoPE position 0 and masks it as a key, so a real
token sees the same keys at the same positions either way; the left-padded
inputs are re-laid by `_right_align`.

`lax.while_loop` becomes a Python loop that reads `done` once per step (one
host sync per generated token). Finished rows stay frozen by the `done`
mask, as in JAX. Sampling (`_sample_token`) cuts the nucleus over the whole
vocabulary, JAX's rule, and draws with an explicit `torch.Generator`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from metamorph_tpu_torch.config import MetaMorphConfig
from metamorph_tpu_torch.constants import (IM_END_TOKEN_ID, IM_START_TOKEN_ID,
                                           LLAMA3_EOS_IDS)
from metamorph_tpu_torch.models import llama as llama_lib
from metamorph_tpu_torch.models import metamorph as mm_lib
from metamorph_tpu_torch.models import projector as proj_lib

NEG_INF = -1e30


def _project_pred(model: mm_lib.MetaMorph, cfg: MetaMorphConfig,
                  pred_z: torch.Tensor) -> torch.Tensor:
    """mm_projector(vision_head output) — the continuous token fed back."""
    dtype = model.llama.embed.dtype
    return proj_lib.apply_stack(model.projector, mm_lib._proj_acts(cfg),
                                pred_z.to(dtype))


def _put_rows(buf: torch.Tensor, b_idx: torch.Tensor, col: torch.Tensor,
              where: torch.Tensor, val: torch.Tensor) -> None:
    """buf[b, col[b]] = val[b] for rows where `where[b]`, in place. `col` is
    clamped into range; an unselected row writes its old value back."""
    col = col.clamp(max=buf.shape[1] - 1).long()
    old = buf[b_idx, col]
    cond = where.reshape(where.shape + (1,) * (old.dim() - 1))
    buf[b_idx, col] = torch.where(cond, val.to(buf.dtype), old)


@dataclass
class DecodeState:
    """Per-row decode state; every tensor is [B]-leading."""
    cache: Dict[str, torch.Tensor]   # [L, B, KV, S, Dh]
    cache_len: torch.Tensor          # [B] int32 — tokens in each row's cache:
                                     #   the next write slot and RoPE position
    next_embed: torch.Tensor         # [B, 1, D] — input for the next step
    in_image: torch.Tensor           # [B] bool
    img_count: torch.Tensor          # [B] int32 — tokens of the current image
    ids: torch.Tensor                # [B, max_new] int32 (pad = -1)
    n_ids: torch.Tensor              # [B] int32
    img_embeds: torch.Tensor         # [B, max_images * K, Dv] fp32
    n_img: torch.Tensor              # [B] int32
    steps: torch.Tensor              # [B] int32 — transitions applied
    done: torch.Tensor               # [B] bool
    ids_all: Optional[torch.Tensor] = None  # [B, cap] prompt + recorded ids
                                            #   (speculation's drafting source)
    n_all: Optional[torch.Tensor] = None    # [B] int32
    iters: int = 0                   # chunk steps taken (speculation)


def _new_state(cfg: MetaMorphConfig, cache, cache_len: torch.Tensor,
               max_new: int, max_images: int, dtype,
               in_image: bool = False, ids_all=None, n_all=None
               ) -> DecodeState:
    B, dev = cache_len.shape[0], cache_len.device
    K, D, Dv = (cfg.mm.num_image_tokens, cfg.llama.hidden_size,
                cfg.siglip.hidden_size)

    def zeros(*shape, dt=torch.int32):
        return torch.zeros(shape, dtype=dt, device=dev)

    return DecodeState(
        cache=cache, cache_len=cache_len.to(torch.int32),
        next_embed=zeros(B, 1, D, dt=dtype),
        in_image=torch.full((B,), bool(in_image), device=dev),
        img_count=zeros(B),
        ids=torch.full((B, max_new), -1, dtype=torch.int32, device=dev),
        n_ids=zeros(B), img_embeds=zeros(B, max_images * K, Dv,
                                         dt=torch.float32),
        n_img=zeros(B), steps=zeros(B), done=zeros(B, dt=torch.bool),
        ids_all=ids_all, n_all=n_all)


def nucleus_logits(logits: torch.Tensor, temperature: float,
                   top_p: float) -> torch.Tensor:
    """[B, V] fp32 logits over the temperature, with every token outside
    the nucleus set to -1e30: sorted descending, the cut falls at index
    sum(cumsum(softmax) < top_p), so at least one token stays (JAX's
    `_sample_token`, whose categorical draw this precedes)."""
    logits = logits / max(temperature, 1e-6)
    if top_p < 1.0:
        sorted_logits = logits.sort(dim=-1, descending=True).values
        cum = torch.softmax(sorted_logits, dim=-1).cumsum(dim=-1)
        cut_idx = (cum < top_p).sum(dim=-1).clamp(max=logits.shape[-1] - 1)
        cutoff = sorted_logits.gather(-1, cut_idx[:, None])
        logits = torch.where(logits < cutoff, torch.full_like(logits, NEG_INF),
                             logits)
    return logits


def _sample_token(generator: torch.Generator, logits: torch.Tensor,
                  temperature: float, top_p: float) -> torch.Tensor:
    """Temperature + nucleus sampling of one token per row ([B] int32),
    drawn from `generator` (the reference exposes sampling through its
    HF-generate fallback, `metamorph_llama.py:712-717`)."""
    probs = torch.softmax(nucleus_logits(logits, temperature, top_p), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


def _advance(model, cfg: MetaMorphConfig, state: DecodeState,
             h_last: torch.Tensor, K: int, max_new: int,
             eos_ids: torch.Tensor, do_sample: bool = False,
             temperature: float = 1.0, top_p: float = 1.0,
             generator: Optional[torch.Generator] = None
             ) -> Tuple[DecodeState, torch.Tensor, torch.Tensor]:
    """One state-machine transition per row from its newest hidden state
    h_last [B, D] (JAX's `_advance` / `_advance_batched`, and with
    `ids_all` set also spec decode's `_advance1`, which appends the
    recorded id to the drafting source). Finished rows are frozen. Updates
    `state` in place; returns (state, tok [B], emit_image [B])."""
    B = h_last.shape[0]
    b_idx = torch.arange(B, device=h_last.device)
    logits = llama_lib.lm_head(model.llama, cfg.llama, h_last)      # [B, V]
    if do_sample:
        tok = _sample_token(generator, logits, temperature, top_p)
    else:
        tok = logits.argmax(dim=-1).to(torch.int32)

    pred_z = mm_lib.apply_vision_head(model, cfg, h_last)            # [B, Dv]
    prediction = _project_pred(model, cfg, pred_z)                   # [B, D]
    tok_embed = llama_lib.embed_tokens(model.llama, tok)             # [B, D]

    act = ~state.done
    is_start = act & ~state.in_image & (tok == IM_START_TOKEN_ID)
    emit_image = act & state.in_image & (state.img_count < K)
    is_end = act & ~emit_image & ~is_start & (tok == IM_END_TOKEN_ID)

    # record the generated id for every branch except continuous emission
    record = act & ~emit_image
    _put_rows(state.ids, b_idx, state.n_ids, record, tok)
    state.n_ids = state.n_ids + record.to(torch.int32)
    if state.ids_all is not None:
        _put_rows(state.ids_all, b_idx, state.n_all, record, tok)
        state.n_all = state.n_all + record.to(torch.int32)

    _put_rows(state.img_embeds, b_idx, state.n_img, emit_image, pred_z)
    state.n_img = state.n_img + emit_image.to(torch.int32)
    img_count = torch.where(emit_image, state.img_count + 1, state.img_count)

    in_image = state.in_image | is_start
    in_image = in_image & ~(emit_image & (img_count >= K))
    state.in_image = in_image & ~is_end
    # like the reference, the counter resets ONLY on <image_end>
    # (`metamorph_llama.py:565-567`): a second <image_start> without an
    # <image_end> between emits no image tokens
    state.img_count = torch.where(is_end, torch.zeros_like(img_count),
                                  img_count)

    state.next_embed = torch.where(emit_image[:, None], prediction,
                                   tok_embed.to(prediction.dtype))[:, None]
    state.steps = state.steps + act.to(torch.int32)
    is_eos = torch.isin(tok, eos_ids) & act
    buffer_full = state.n_img >= state.img_embeds.shape[1]
    state.done = (state.done | is_eos | (state.steps >= max_new)
                  | buffer_full)
    return state, tok, emit_image


def _eos_ids(stop_ids: tuple, dev) -> torch.Tensor:
    return torch.tensor(tuple(LLAMA3_EOS_IDS) + tuple(stop_ids),
                        dtype=torch.int32, device=dev)


def _right_align(x: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """[B, T, ...] LEFT-padded rows (row b's real tokens in the last
    lens[b] slots) -> the same rows starting at slot 0 (pads after them)."""
    T = x.shape[1]
    idx = ((T - lens.long())[:, None]
           + torch.arange(T, device=x.device)[None]).clamp(max=T - 1)
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand_as(x)
    return x.gather(1, idx)


def _prefill_rows(llama, lcfg, embeds: torch.Tensor, lens: torch.Tensor,
                  cache: Dict[str, torch.Tensor], padded: bool
                  ) -> torch.Tensor:
    """Prefill right-padded rows [B, T0, D] into cache rows 0..B-1 (per-row
    lengths `lens` when `padded`). Returns each row's hidden state at its
    last prompt token, [B, D]."""
    B, T0 = embeds.shape[:2]
    dev = embeds.device
    pos = torch.arange(T0, device=dev)[None].expand(B, T0)
    mask = (pos < lens[:, None]).to(torch.int32) if padded else None
    h_all, _ = llama_lib.prefill(llama, lcfg, embeds, pos, mask, cache)
    return h_all[torch.arange(B, device=dev), lens.long() - 1]


def _result(state: DecodeState, single: bool) -> Dict[str, Any]:
    """JAX's output dict: ids padded with -1, the image buffer, counts; the
    single-request form drops the row axis. `steps` of the batched form is
    the loop's transition count (the longest row's)."""
    out = {"ids": state.ids, "n_ids": state.n_ids,
           "image_embeds": state.img_embeds, "n_image_tokens": state.n_img,
           "steps": state.steps}
    if single:
        out = {k: v[0] for k, v in out.items()}
    else:
        out["steps"] = state.steps.max()
    return out


def _run(model, cfg: MetaMorphConfig, embeds: torch.Tensor,
         lens: torch.Tensor, padded: bool, max_new_tokens: int,
         max_images: int, max_cache_len: int, stop_ids: tuple,
         do_sample: bool, temperature: float, top_p: float,
         sample_rng: Optional[torch.Generator], kv_int8: bool,
         start_in_image: bool = False) -> DecodeState:
    """Prefill right-aligned rows, apply the first transition from each
    row's last prompt hidden state, then one decode step per token until
    every row is done."""
    K = cfg.mm.num_image_tokens
    B, T0 = embeds.shape[:2]
    dev, dtype = embeds.device, embeds.dtype
    S = max_cache_len or (T0 + max_new_tokens + 8)
    cache = llama_lib.init_kv_cache(cfg.llama, B, S, dtype=dtype, device=dev,
                                    quantized=kv_int8)
    h_last = _prefill_rows(model.llama, cfg.llama, embeds, lens, cache,
                           padded)
    state = _new_state(cfg, cache, lens, max_new_tokens, max_images, dtype,
                       in_image=start_in_image)
    if do_sample and sample_rng is None:
        sample_rng = torch.Generator(device=dev)
        sample_rng.manual_seed(0)
    eos_ids = _eos_ids(stop_ids, dev)
    sample = (do_sample, temperature, top_p, sample_rng)
    _advance(model, cfg, state, h_last, K, max_new_tokens, eos_ids, *sample)
    while not bool(state.done.all()):
        h, _ = llama_lib.decode_step(model.llama, cfg.llama, state.next_embed,
                                     state.cache_len[:, None], state.cache,
                                     state.cache_len)
        state.cache_len = state.cache_len + 1
        _advance(model, cfg, state, h[:, 0], K, max_new_tokens, eos_ids,
                 *sample)
    return state


@torch.no_grad()
def greedy_decode(model, cfg: MetaMorphConfig,
                  prompt_embeds: torch.Tensor,  # [1, T0, D] fused prompt
                  max_new_tokens: int = 256, max_images: int = 4,
                  max_cache_len: int = 0,
                  stop_ids: tuple = (),         # extra stop ids (the token
                                                # half of the reference's
                                                # KeywordsStoppingCriteria)
                  do_sample: bool = False, temperature: float = 1.0,
                  top_p: float = 1.0,
                  sample_rng: Optional[torch.Generator] = None,
                  kv_int8: bool = False,        # int8 KV cache
                  start_in_image: bool = False  # treat the prompt's last
                                                # token as a consumed
                                                # <image_start> (the parity
                                                # harness's way into the
                                                # K-step feedback loop)
                  ) -> Dict[str, torch.Tensor]:
    """Single-request decode on the model's device. Returns {"ids"
    [max_new] (pad -1), "n_ids", "image_embeds" [max_images * K, Dv],
    "n_image_tokens", "steps"} as tensors."""
    T0 = prompt_embeds.shape[1]
    lens = torch.full((1,), T0, dtype=torch.int32,
                      device=prompt_embeds.device)
    state = _run(model, cfg, prompt_embeds, lens, False, max_new_tokens,
                 max_images, max_cache_len, tuple(stop_ids), do_sample,
                 temperature, top_p, sample_rng, kv_int8, start_in_image)
    return _result(state, single=True)


@torch.no_grad()
def batched_greedy_decode(model, cfg: MetaMorphConfig,
                          prompt_embeds: torch.Tensor,  # [B, T0, D], LEFT-
                                                        # padded
                          prompt_mask,                  # [B, T0] 1 = real
                          max_new_tokens: int = 256, max_images: int = 4,
                          max_cache_len: int = 0, stop_ids: tuple = (),
                          do_sample: bool = False, temperature: float = 1.0,
                          top_p: float = 1.0,
                          sample_rng: Optional[torch.Generator] = None,
                          kv_int8: bool = False) -> Dict[str, torch.Tensor]:
    """B>1 decode of LEFT-padded prompts (JAX's layout, `pack_sequences`
    padding_side='left'), run as right-aligned ragged rows (see the module
    docstring). Per-row state machine identical to `greedy_decode`.
    Returns {"ids" [B, max_new], "n_ids" [B], "image_embeds" [B, C, Dv],
    "n_image_tokens" [B], "steps" ()}."""
    dev = prompt_embeds.device
    lens = torch.as_tensor(prompt_mask, device=dev).sum(dim=1).to(
        torch.int32)
    embeds = _right_align(prompt_embeds, lens)
    state = _run(model, cfg, embeds, lens, True, max_new_tokens, max_images,
                 max_cache_len, tuple(stop_ids), do_sample, temperature,
                 top_p, sample_rng, kv_int8)
    return _result(state, single=False)


def _fused_embeds(model, cfg: MetaMorphConfig, batch: Dict[str, Any],
                  pixels) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The batch's prompt embeddings with the images spliced in (on the
    model's device), and the batch as tensors there."""
    dev = model.llama.embed.device
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    if pixels is None:
        return llama_lib.embed_tokens(model.llama, batch["tokens"]), batch
    projected, _ = mm_lib.encode_images(model, cfg,
                                        torch.as_tensor(pixels, device=dev))
    return mm_lib.fuse_embeddings(model, cfg, batch, projected), batch


@torch.no_grad()
def generate_batched(model, cfg: MetaMorphConfig, batch: Dict[str, Any],
                     pixels=None, max_new_tokens: int = 256,
                     max_images: int = 4, **kw) -> Dict[str, torch.Tensor]:
    """Batched generate: fuse LEFT-padded prompts (`pack_sequences`
    padding_side='left'), then `batched_greedy_decode`."""
    embeds, batch = _fused_embeds(model, cfg, batch, pixels)
    return batched_greedy_decode(model, cfg, embeds, batch["attn_mask"],
                                 max_new_tokens=max_new_tokens,
                                 max_images=max_images, **kw)


@torch.no_grad()
def generate(model, cfg: MetaMorphConfig, batch: Dict[str, Any], pixels=None,
             max_new_tokens: int = 256, max_images: int = 4, spec_k: int = 1,
             draft: Optional[tuple] = None) -> Dict[str, torch.Tensor]:
    """Fuse the prompt (images included), then decode — the reference
    `generate` override (`metamorph_llama.py:665-717`). The batch is one
    right-padded row (`pack_sequences` output, arrays or tensors).
    `spec_k > 1` switches to speculative verification with prompt-lookup
    drafts, or with draft-model proposals when `draft=(draft_llama,
    draft_cfg)` names a small LLaMA sharing the vocabulary; the output is
    the same either way."""
    embeds, batch = _fused_embeds(model, cfg, batch, pixels)
    n = int(batch["attn_mask"][0].sum())
    embeds = embeds[:, :n]
    if spec_k > 1:
        from metamorph_tpu_torch.inference import spec_decode

        ids = batch["tokens"][0, :n]
        if draft is not None:
            return spec_decode.greedy_decode_spec_draft_model(
                model, draft[0], cfg, draft[1], embeds, ids,
                max_new_tokens=max_new_tokens, max_images=max_images,
                spec_k=spec_k)
        return spec_decode.greedy_decode_spec(
            model, cfg, embeds, ids, max_new_tokens=max_new_tokens,
            max_images=max_images, spec_k=spec_k)
    return greedy_decode(model, cfg, embeds, max_new_tokens=max_new_tokens,
                         max_images=max_images)


def truncate_at_keywords(text: str, keywords) -> str:
    """Host-side keyword stopping for decoded text — the string half of the
    reference's KeywordsStoppingCriteria (`mm_utils.py:226-258`); the
    token-id half is `stop_ids`."""
    cut = len(text)
    for kw in keywords:
        i = text.find(kw)
        if i != -1:
            cut = min(cut, i)
    return text[:cut]
