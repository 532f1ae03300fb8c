"""LLaMA-3 decoder (counterpart of `metamorph_tpu/models/llama.py`).

The weights live in `nn.Module`s — one `LlamaLayer` per layer instead of the
JAX package's [L, ...]-stacked tree — and keep the JAX layout: dense weights
are [D_in, D_out] and apply as `x @ w`. The functions mirror the JAX ones
and take the module where those take the parameter tree.

Attention goes through flash attention (`ops/flash_attention.py`, a
differentiable `torch.autograd.Function` when the weights require grad) for
full sequences, through decode attention (`ops/decode_attention.py`) for
single-token steps and through chunk attention (the same module) for the
speculative verify chunks (`decode_chunk_step` of one cache row,
`decode_chunk_step_batched` of every row) and the fused
decode + prompt-chunk step of chunked fill (`decode_step_with_chunk`); each
runs its CUDA kernels on the card and its plain version on the CPU. A
decoder linear or the lm head may be a `QuantizedWeight` (int8, from
`ops/quant.quantize_llama_decode`, for serving): every path then runs its
products on kernel F. The
layer loop is a Python loop; training checkpoints each layer with
`torch.utils.checkpoint` under the JAX package's remat policies. The KV
cache [L, B, KV, S, Dh] (bf16, or int8 with fp32 scales [L, B, KV, S]) is
updated in place (`index_put_`), with no host sync. Every dense product
of every path goes through `_dense`, which adds a layer's LoRA factors
(`models/lora.py`) when the config's `lora_r` is positive.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from metamorph_tpu_torch.config import LlamaConfig
from metamorph_tpu_torch.ops.attention import attention
from metamorph_tpu_torch.ops.decode_attention import (chunk_attention,
                                                      chunk_attention_batched,
                                                      decode_attention)
from metamorph_tpu_torch.ops.quant import (QuantizedWeight, quantize_kv,
                                           quantized_matmul)
from metamorph_tpu_torch.parallel.tensor import copy_in, reduce_out


def _param(*shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


# the decoder linears, each of which may carry LoRA factors
DENSE_NAMES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
# the row products of tensor parallelism (cut on D_in); the rest are cut
# on D_out
ROW_NAMES = ("wo", "w_down")


class LlamaLayer(nn.Module):
    """One decoder layer's weights (dense weights [D_in, D_out]). Each
    dense weight `w` may carry LoRA factors `w_lora_a` [D_in, r] and
    `w_lora_b` [r, D_out] (None until `models/lora.add_lora` or
    `train/checkpoint.load_lora` sets them)."""

    def __init__(self, cfg: LlamaConfig, dtype=torch.bfloat16, device=None):
        super().__init__()
        D, Fd = cfg.hidden_size, cfg.intermediate_size
        H, KV, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        kw = dict(dtype=dtype, device=device)
        self.wq = _param(D, H * Dh, **kw)
        self.wk = _param(D, KV * Dh, **kw)
        self.wv = _param(D, KV * Dh, **kw)
        self.wo = _param(H * Dh, D, **kw)
        self.w_gate = _param(D, Fd, **kw)
        self.w_up = _param(D, Fd, **kw)
        self.w_down = _param(Fd, D, **kw)
        self.input_norm = _param(D, **kw)
        self.post_attn_norm = _param(D, **kw)
        for name in DENSE_NAMES:
            self.register_parameter(f"{name}_lora_a", None)
            self.register_parameter(f"{name}_lora_b", None)
        # the tensor-parallel group when the layer holds a cut of its
        # weights (`parallel/sharding.apply_tensor_parallel`), else None
        self.tp_group = None

    def forward(self, cfg: LlamaConfig, x, cos, sin, attn_mask,
                remat: bool = False, remat_policy: str = "dots_no_batch"):
        """One decoder layer of the training forward (`_layer`) under the
        caller's config (its LoRA settings among them). Called as a
        module, so that FSDP2 gathers the layer's weights around it."""
        return _layer(self, cfg, x, cos, sin, attn_mask, remat,
                      remat_policy)


class Llama(nn.Module):
    """Embedding table [V, D], layers, final norm, and the lm head [D, V]
    (absent with tied embeddings)."""

    def __init__(self, cfg: LlamaConfig, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(dtype=dtype, device=device)
        self.embed = _param(cfg.vocab_size, cfg.hidden_size, **kw)
        if cfg.attention_kind == "mla":
            # the DeepSeek-V3 block: latent attention, routed experts
            from metamorph_tpu_torch.models.mla_moe import MlaMoeLayer
            if cfg.lora_r > 0:
                cfg.require_gqa("LoRA (lora_r > 0)")
            self.layers = nn.ModuleList(MlaMoeLayer(cfg, l, dtype, device)
                                        for l in range(cfg.num_layers))
        elif cfg.n_routed_experts:
            raise ValueError("routed experts come with latent attention "
                             "(kv_lora_rank > 0) only")
        else:
            self.layers = nn.ModuleList(LlamaLayer(cfg, dtype, device)
                                        for _ in range(cfg.num_layers))
        self.final_norm = _param(cfg.hidden_size, **kw)
        self.lm_head = (None if cfg.tie_word_embeddings
                        else _param(cfg.hidden_size, cfg.vocab_size, **kw))


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    x = x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)
    return (x * scale.float()).to(dtype)


def _rope_scaled_freqs(cfg: LlamaConfig, device=None) -> torch.Tensor:
    """Inverse frequencies with the LLaMA-3.1 NTK-by-parts scaling (fp32)."""
    dim = cfg.head_dim
    inv_freq = 1.0 / (cfg.rope_theta ** (
        torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim))
    if not cfg.rope_scaling:
        return inv_freq
    low_wavelen = cfg.rope_original_max_position / cfg.rope_low_freq_factor
    high_wavelen = cfg.rope_original_max_position / cfg.rope_high_freq_factor
    wavelen = 2.0 * math.pi / inv_freq
    scaled = inv_freq / cfg.rope_scaling_factor
    smooth = (cfg.rope_original_max_position / wavelen
              - cfg.rope_low_freq_factor) / (
        cfg.rope_high_freq_factor - cfg.rope_low_freq_factor)
    mid = (1.0 - smooth) * scaled + smooth * inv_freq
    return torch.where(wavelen > low_wavelen, scaled,
                       torch.where(wavelen < high_wavelen, inv_freq, mid))


def rope_tables(cfg: LlamaConfig, positions: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [..., T, Dh/2] (fp32) for integer positions [..., T]."""
    inv_freq = _rope_scaled_freqs(cfg, positions.device)
    angles = positions.float()[..., None] * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x [B,T,H,Dh]; cos/sin [B,T,Dh/2]. HF half-rotate convention, the
    arithmetic in x's dtype (tables cast at the use site)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    cos = cos[:, :, None, :].to(x.dtype)
    sin = sin[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _dense(layer: LlamaLayer, name: str, x, cfg: LlamaConfig):
    """x @ w (kernel F's `quantized_matmul` when w is a `QuantizedWeight`,
    after `ops/quant.quantize_llama_decode`), plus the LoRA path
    ((x @ a) @ b) * alpha / r when the layer carries factors and the config
    enables them (lora_r > 0), as the JAX package's `_lora_dense` gates
    it."""
    w = getattr(layer, name)
    out = (quantized_matmul(x, w) if isinstance(w, QuantizedWeight)
           else x @ w)
    a = getattr(layer, f"{name}_lora_a")
    if a is not None and cfg.lora_r > 0:
        scale = cfg.lora_alpha / cfg.lora_r
        b = getattr(layer, f"{name}_lora_b")
        group = layer.tp_group
        # under tensor parallelism the factor that stays whole (b of a row
        # product, a of a column one) gets a partial gradient on each rank
        if name in ROW_NAMES:
            b = copy_in(b, group)
        else:
            a = copy_in(a, group)
        out = out + ((x @ a) @ b) * scale
    return out


def _qkv(layer: LlamaLayer, cfg: LlamaConfig, h, cos, sin):
    B, T, _ = h.shape
    Dh = cfg.head_dim
    # the layer's own heads: all of them, or its cut under tensor
    # parallelism (H / t query heads, KV / t key heads)
    q = apply_rope(_dense(layer, "wq", h, cfg).reshape(B, T, -1, Dh), cos,
                   sin)
    k = apply_rope(_dense(layer, "wk", h, cfg).reshape(B, T, -1, Dh), cos,
                   sin)
    v = _dense(layer, "wv", h, cfg).reshape(B, T, -1, Dh)
    return q, k, v


def _attn_block(layer: LlamaLayer, cfg: LlamaConfig, x, cos, sin, attn_mask):
    """Full-sequence self-attention for one layer (prefill). Returns
    (out, (k, v)); k/v [B,T,KV,Dh] feed the decode cache."""
    B, T, _ = x.shape
    group = layer.tp_group
    q, k, v = _qkv(layer, cfg, copy_in(x, group), cos, sin)
    out = attention(q, k, v, attn_mask=attn_mask, impl="flash")
    return reduce_out(_dense(layer, "wo", out.reshape(B, T, -1), cfg),
                      group), (k, v)


def _mlp_block(layer: LlamaLayer, x, cfg: LlamaConfig):
    # silu in the activation dtype, as HF LlamaMLP computes it
    group = layer.tp_group
    x = copy_in(x, group)
    gate = F.silu(_dense(layer, "w_gate", x, cfg))
    return reduce_out(
        _dense(layer, "w_down", gate * _dense(layer, "w_up", x, cfg), cfg),
        group)


def _decoder_layer(layer: LlamaLayer, cfg: LlamaConfig, x, cos, sin, attn_mask):
    h = rms_norm(x, layer.input_norm, cfg.rms_norm_eps)
    attn_out, kv = _attn_block(layer, cfg, h, cos, sin, attn_mask)
    x = x + attn_out
    h = rms_norm(x, layer.post_attn_norm, cfg.rms_norm_eps)
    return x + _mlp_block(layer, h, cfg), kv


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------

def embed_tokens(model: Llama, ids: torch.Tensor) -> torch.Tensor:
    """Token embedding lookup."""
    return F.embedding(ids.long(), model.embed)


def _pre_attn(layer: LlamaLayer, cfg: LlamaConfig, x, cos, sin):
    h = rms_norm(x, layer.input_norm, cfg.rms_norm_eps)
    return _qkv(layer, cfg, copy_in(h, layer.tp_group),
                cos, sin)


def _post_attn(layer: LlamaLayer, cfg: LlamaConfig, x, attn):
    B, T, _ = x.shape
    x = x + reduce_out(_dense(layer, "wo", attn.reshape(B, T, -1), cfg),
                       layer.tp_group)
    h = rms_norm(x, layer.post_attn_norm, cfg.rms_norm_eps)
    return x + _mlp_block(layer, h, cfg)


def _layer_save_attn(layer: LlamaLayer, cfg: LlamaConfig, x, cos, sin,
                     attn_mask):
    """One layer as two checkpointed segments around the flash call: the
    flash Function keeps its residuals (post-rope q/k/v and o, lse), so the
    backward recomputes the norms, projections and MLP but never attention."""
    q, k, v = checkpoint(_pre_attn, layer, cfg, x, cos, sin,
                         use_reentrant=False)
    attn = attention(q, k, v, attn_mask=attn_mask, impl="flash")
    return checkpoint(_post_attn, layer, cfg, x, attn, use_reentrant=False)


# remat_policy -> what a checkpointed layer keeps (the JAX package's
# jax.checkpoint_policies, `metamorph_tpu/models/llama.py:225-256`):
#   "nothing": nothing, the whole layer is recomputed;
#   "dots_no_batch" / "dots": the matmul outputs (aten.mm; "dots" also
#     batched ones), so the backward re-runs the elementwise ops and the
#     flash forward;
#   "save_attn_only" / "save_attn_qkv" / "dots_no_batch_save_attn": the
#     flash call's residuals (see `_layer_save_attn`). The flash Function
#     saves the post-rope q/k/v it needs for its backward in any case, so
#     these three keep the same tensors here.
# A policy changes memory and time, never the numbers.
_SAVE_OPS = {
    "nothing": [],
    "dots_no_batch": [torch.ops.aten.mm.default],
    "dots": [torch.ops.aten.mm.default, torch.ops.aten.bmm.default],
}
REMAT_POLICIES = (*_SAVE_OPS, "save_attn_only", "save_attn_qkv",
                  "dots_no_batch_save_attn")


def _layer(layer: LlamaLayer, cfg: LlamaConfig, x, cos, sin, attn_mask,
           remat: bool, remat_policy: str):
    if remat_policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {remat_policy!r}")
    if not remat:
        return _decoder_layer(layer, cfg, x, cos, sin, attn_mask)[0]
    if remat_policy in _SAVE_OPS:
        ctx = functools.partial(create_selective_checkpoint_contexts,
                                _SAVE_OPS[remat_policy])
        return checkpoint(lambda x: _decoder_layer(
            layer, cfg, x, cos, sin, attn_mask)[0], x,
            use_reentrant=False, context_fn=ctx)
    return _layer_save_attn(layer, cfg, x, cos, sin, attn_mask)


def _forward(model: Llama, cfg: LlamaConfig, inputs_embeds, positions,
             attn_mask, on_kv=None):
    cos, sin = rope_tables(cfg, positions)
    x = inputs_embeds
    for l, layer in enumerate(model.layers):
        x, (k, v) = _decoder_layer(layer, cfg, x, cos, sin, attn_mask)
        if on_kv is not None:
            on_kv(l, k, v)
    return rms_norm(x, model.final_norm, cfg.rms_norm_eps)


def llama_forward(model: Llama, cfg: LlamaConfig,
                  inputs_embeds: torch.Tensor,      # [B, T, D]
                  positions: torch.Tensor,          # [B, T] int
                  attn_mask: Optional[torch.Tensor],  # [B, T] 1 = valid
                  remat: bool = False,
                  remat_policy: str = "dots_no_batch") -> torch.Tensor:
    """Full-sequence forward. Returns final-norm hidden states [B, T, D].
    `attn_mask` must be right-padded (it becomes per-row lengths); None
    means every key is valid, which is what training passes (as the JAX
    flash path does: padding sits after every valid query, so causality
    alone keeps it out). With `remat`, each layer is checkpointed under
    `remat_policy` (see REMAT_POLICIES). While a sequence axis is
    registered (sequence parallelism) attention is the ring, and
    `positions` hold this rank's global positions. Each layer runs
    as a module call (`LlamaLayer.forward`), which FSDP2 hooks. `prefill`
    is the form that also fills a KV cache."""
    cos, sin = rope_tables(cfg, positions)
    x = inputs_embeds
    for layer in model.layers:
        x = layer(cfg, x, cos, sin, attn_mask, remat, remat_policy)
    return rms_norm(x, model.final_norm, cfg.rms_norm_eps)


def lm_head(model: Llama, cfg: LlamaConfig, hidden: torch.Tensor
            ) -> torch.Tensor:
    """fp32 logits. A quantized head (`quantize_llama_decode`) gives its
    product rounded to the activations' dtype first, as in JAX."""
    if cfg.tie_word_embeddings:
        return (hidden @ model.embed.T).float()
    if isinstance(model.lm_head, QuantizedWeight):
        return quantized_matmul(hidden, model.lm_head).float()
    return (hidden @ model.lm_head).float()


# ---------------------------------------------------------------------------
# KV-cache decode
# ---------------------------------------------------------------------------

def init_kv_cache(cfg: LlamaConfig, batch: int, max_len: int,
                  dtype=torch.bfloat16, device=None,
                  quantized: bool = False) -> Dict[str, torch.Tensor]:
    """Decode cache [L, B, KV, S, Dh]: each (row, kv head) owns a contiguous
    [S, Dh] slab — the layout the decode and chunk kernels stream.

    quantized=True stores int8 entries plus per-(token, kv head) fp32
    scales "k_scale"/"v_scale" [L, B, KV, S] (`ops/quant.quantize_kv` is
    the write-side transform); downstream code detects the mode by the
    presence of "k_scale"."""
    if cfg.attention_kind == "mla":
        if quantized:
            cfg.require_gqa("the int8 KV cache (kv_int8)")
        from metamorph_tpu_torch.models import mla_moe
        return mla_moe.init_latent_cache(cfg, batch, max_len, dtype, device)
    shape = (cfg.num_layers, batch, cfg.num_kv_heads, max_len, cfg.head_dim)
    if quantized:
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:-1], device=device),
                "v_scale": torch.zeros(shape[:-1], device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _cache_entries(cache: Dict[str, torch.Tensor], k: torch.Tensor,
                   v: torch.Tensor):
    """k/v [..., Dh] in the cache's form: (k, v, k_scale, v_scale), the
    scales None for a bf16 cache."""
    if "k_scale" in cache:
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        return kq, vq, ks, vs
    return k.to(cache["k"].dtype), v.to(cache["v"].dtype), None, None


def _scales(cache: Dict[str, torch.Tensor]):
    return cache.get("k_scale"), cache.get("v_scale")


def _put(cache: Dict[str, torch.Tensor], l: int, index, k, v, ks, vs) -> None:
    """Write entries at cache[name][l][index] in place (scales likewise,
    without the head dim)."""
    cache["k"][l].index_put_(index, k)
    cache["v"][l].index_put_(index, v)
    if ks is not None:
        cache["k_scale"][l].index_put_(index, ks)
        cache["v_scale"][l].index_put_(index, vs)


def prefill(model: Llama, cfg: LlamaConfig, inputs_embeds, positions,
            attn_mask, cache: Dict[str, torch.Tensor],
            rows: Optional[torch.Tensor] = None,
            route_log: Optional[torch.Tensor] = None):
    """Run the prompt through the model and write each layer's K/V into
    cache[l, rows, :, :T] IN PLACE as the layer finishes (no stacked copy of
    all layers; quantized entries for an int8 cache). `rows` [B] selects
    the cache rows (default 0..B-1). Returns (hidden [B,T,D], cache).
    A latent-attention decoder writes its latent cache instead, and its
    expert picks to `route_log` (`mla_moe.prefill`)."""
    if cfg.attention_kind == "mla":
        from metamorph_tpu_torch.models import mla_moe
        return mla_moe.prefill(model, cfg, inputs_embeds, positions,
                               attn_mask, cache, rows, route_log)
    T = inputs_embeds.shape[1]
    dev = cache["k"].device
    if rows is None:
        rows = torch.arange(inputs_embeds.shape[0], device=dev)
    index = (rows.long()[:, None, None],
             torch.arange(cfg.num_kv_heads, device=dev)[None, :, None],
             torch.arange(T, device=dev)[None, None, :])

    def write(l, k, v):
        _put(cache, l, index, *_cache_entries(cache, k.transpose(1, 2),
                                              v.transpose(1, 2)))

    hidden = _forward(model, cfg, inputs_embeds, positions, attn_mask, write)
    return hidden, cache


def decode_step(model: Llama, cfg: LlamaConfig, x: torch.Tensor,
                pos: torch.Tensor, cache: Dict[str, torch.Tensor],
                cache_idx: torch.Tensor, active: Optional[torch.Tensor] = None,
                counts: Optional[torch.Tensor] = None,
                route_log: Optional[torch.Tensor] = None):
    """One-token step with per-row (ragged) cache positions.
    x [B,1,D]; pos [B,1] RoPE positions; cache_idx [B] int — tokens already
    in each row's cache (this step writes there); each row attends to its
    keys [0, cache_idx + 1). Updates the cache in place and returns
    (hidden [B,1,D], cache). (The JAX function's `starts`, for left-padded
    batched decode, comes with that decode.) A latent-attention decoder
    runs `mla_moe.decode_step`, which with `counts` [L_moe, E] also
    counts the expert picks of the `active` [B] rows, and with
    `route_log` logs each row's picks."""
    if cfg.attention_kind == "mla":
        from metamorph_tpu_torch.models import mla_moe
        return mla_moe.decode_step(model, cfg, x, pos, cache, cache_idx,
                                   active, counts, route_log)
    if not (torch.is_tensor(cache_idx) and cache_idx.dim() == 1):
        raise TypeError("cache_idx must be a [B] tensor (ragged rows)")
    B = x.shape[0]
    H, KV, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    ck, cv = cache["k"], cache["v"]
    S = ck.shape[3]
    cos, sin = rope_tables(cfg, pos)
    lengths = (cache_idx + 1).to(torch.int32)
    # write index per row; clamped so a frozen row can never index past S
    widx = cache_idx.clamp(max=S - 1).long()[:, None]
    index = (torch.arange(B, device=ck.device)[:, None],
             torch.arange(KV, device=ck.device)[None, :], widx)
    ks_all, vs_all = _scales(cache)
    for l, layer in enumerate(model.layers):
        h = rms_norm(x, layer.input_norm, cfg.rms_norm_eps)
        q, k, v = _qkv(layer, cfg, h, cos, sin)
        _put(cache, l, index, *_cache_entries(cache, k[:, 0], v[:, 0]))
        out = decode_attention(q[:, 0], ck, cv, lengths, layer=l,
                               k_scale=ks_all, v_scale=vs_all)
        x = x + _dense(layer, "wo", out.reshape(B, 1, H * Dh), cfg)
        h2 = rms_norm(x, layer.post_attn_norm, cfg.rms_norm_eps)
        x = x + _mlp_block(layer, h2, cfg)
    return rms_norm(x, model.final_norm, cfg.rms_norm_eps), cache


def decode_chunk_step(model: Llama, cfg: LlamaConfig, xc: torch.Tensor,
                      chunk_pos: torch.Tensor,
                      cache: Dict[str, torch.Tensor]):
    """Speculative-verification step of cache row 0: run C token embeddings
    `xc [C, D]` at the contiguous positions `chunk_pos [C]`, writing their
    K/V at chunk_pos; chunk token c attends to keys j <= chunk_pos[0] + c.
    The B=1 case of `decode_chunk_step_batched` (kernel E on the card: its
    verify form while G * C <= 16, else its fill form).

    The caller accepts a verified prefix and rolls its cache length back to
    it; entries past the accepted point are stale but harmless: the mask
    stops every query short of them, and the next chunk (which starts at
    the rolled-back position and spans at least the overhang) overwrites
    them before a length can reach them. Returns (h [C, D], cache)."""
    h, cache = decode_chunk_step_batched(model, cfg, xc[None], chunk_pos[None],
                                         chunk_pos[:1], cache)
    return h[0], cache


def decode_chunk_step_batched(model: Llama, cfg: LlamaConfig,
                              xc: torch.Tensor, rope_pos: torch.Tensor,
                              write_pos: torch.Tensor,
                              cache: Dict[str, torch.Tensor],
                              rows: Optional[torch.Tensor] = None):
    """Batched speculative-verification step: run C token embeddings per
    row (`xc [B, C, D]`) at RoPE positions `rope_pos [B, C]`, writing each
    row's C K/V entries at the contiguous slots starting `write_pos [B]`
    (ragged rows); chunk token c of row b attends to row b's keys
    j <= write_pos[b] + c (`chunk_attention_batched`, kernel E on the
    card). Rows are unpadded (the JAX function's `starts` are 0, the
    serving layout). Row b lives in cache row `rows[b]` (default b: the
    cache has B rows; the shared-prefix admission passes the admitted
    slots of the engine's cache). Entries past a row's accepted point are
    stale but harmless: the mask excludes them and the next chunk
    overwrites them. Returns (h [B, C, D], cache)."""
    B, C, _ = xc.shape
    H, KV, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dev = cache["k"].device
    S = cache["k"].shape[3]
    cos, sin = rope_tables(cfg, rope_pos)              # [B, C, Dh/2]
    # as jax.lax.dynamic_update_slice: the start is clamped so the C
    # entries fit
    start = write_pos.long().clamp(0, S - C)
    rows = (torch.arange(B, device=dev) if rows is None
            else rows.to(device=dev, dtype=torch.long))
    index = (rows[:, None, None],
             torch.arange(KV, device=dev)[None, :, None],
             (start[:, None] + torch.arange(C, device=dev))[:, None, :])
    offs = write_pos.to(torch.int32)
    rows = rows.to(torch.int32)
    ks_all, vs_all = _scales(cache)
    x = xc
    for l, layer in enumerate(model.layers):
        h = rms_norm(x, layer.input_norm, cfg.rms_norm_eps)
        q, k, v = _qkv(layer, cfg, h, cos, sin)
        _put(cache, l, index, *_cache_entries(cache, k.transpose(1, 2),
                                              v.transpose(1, 2)))
        out = chunk_attention_batched(q, cache["k"], cache["v"], offs,
                                      layer=l, k_scale=ks_all,
                                      v_scale=vs_all, rows=rows)
        x = x + _dense(layer, "wo", out.reshape(B, C, H * Dh), cfg)
        h2 = rms_norm(x, layer.post_attn_norm, cfg.rms_norm_eps)
        x = x + _mlp_block(layer, h2, cfg)
    return rms_norm(x, model.final_norm, cfg.rms_norm_eps), cache


def decode_step_with_chunk(model: Llama, cfg: LlamaConfig, x: torch.Tensor,
                           pos: torch.Tensor, cache: Dict[str, torch.Tensor],
                           cache_idx: torch.Tensor, chunk: torch.Tensor,
                           chunk_pos: torch.Tensor, chunk_mask: torch.Tensor,
                           fill_slot: torch.Tensor):
    """One decode step for every row PLUS one prompt chunk for row
    `fill_slot`, fused so the chunk's projections and MLP share the decode
    step's matmuls (one [B + C]-row product per weight).

    x [B,1,D] decode inputs; pos [B,1] / cache_idx [B] per-row ragged
    positions; chunk [C,D] prompt-chunk embeddings for row fill_slot (an
    int or 0-d tensor); chunk_pos [C] absolute positions (contiguous from
    chunk_pos[0]); chunk_mask [C] bool: False tokens keep the cache's old
    entries and scales, and their hiddens are junk. The decode rows write
    first (the fill row's junk write lands where the scheduler parked its
    cache_idx), then the chunk. Returns (h_dec [B,1,D], h_chunk [C,D],
    cache)."""
    B = x.shape[0]
    C = chunk.shape[0]
    H, KV, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dev = cache["k"].device
    S = cache["k"].shape[3]
    lengths = (cache_idx + 1).to(torch.int32)
    all_pos = torch.cat([pos[:, 0], chunk_pos.to(pos.dtype)])[None]
    cos, sin = rope_tables(cfg, all_pos)               # [1, B + C, Dh/2]
    xc = chunk[None].to(x.dtype)                       # [1, C, D]
    kv_idx = torch.arange(KV, device=dev)
    dec_index = (torch.arange(B, device=dev)[:, None], kv_idx[None, :],
                 cache_idx.clamp(max=S - 1).long()[:, None])
    slot = torch.as_tensor(fill_slot, device=dev).long().reshape(1, 1)
    slot32, chunk_off = slot.reshape(1).to(torch.int32), \
        chunk_pos[:1].to(torch.int32)
    # as jax.lax.dynamic_slice / dynamic_update_slice: clamped start
    c0 = chunk_pos[:1].long().clamp(0, S - C)
    chunk_index = (slot, kv_idx[:, None],
                   (c0 + torch.arange(C, device=dev))[None, :])
    sel = chunk_mask.to(torch.bool)[None, :]           # [1, C] over [KV, C]
    ks_all, vs_all = _scales(cache)
    for l, layer in enumerate(model.layers):
        h_d = rms_norm(x, layer.input_norm, cfg.rms_norm_eps)
        h_c = rms_norm(xc, layer.input_norm, cfg.rms_norm_eps)
        hcat = torch.cat([h_d[:, 0][None], h_c], dim=1)      # [1, B + C, D]
        q, k, v = _qkv(layer, cfg, hcat, cos, sin)
        _put(cache, l, dec_index, *_cache_entries(cache, k[0, :B], v[0, :B]))
        new = _cache_entries(cache, k[0, B:].transpose(0, 1),
                             v[0, B:].transpose(0, 1))  # [KV, C, (Dh)]
        names = ("k", "v", "k_scale", "v_scale")
        kept = [None if n is None else torch.where(
            sel[..., None] if n.dim() == 3 else sel, n,
            cache[name][l][chunk_index])
            for name, n in zip(names, new)]
        _put(cache, l, chunk_index, *kept)
        out_d = decode_attention(q[0, :B], cache["k"], cache["v"], lengths,
                                 layer=l, k_scale=ks_all, v_scale=vs_all)
        out_c = chunk_attention(q[0, B:], cache["k"], cache["v"], slot32,
                                chunk_off, layer=l, k_scale=ks_all,
                                v_scale=vs_all)
        ocat = torch.cat([out_d.reshape(B, H * Dh),
                          out_c.reshape(C, H * Dh)])[None]
        proj = _dense(layer, "wo", ocat, cfg)           # [1, B + C, D]
        x = x + proj[0, :B][:, None]
        xc = xc + proj[:, B:]
        h2_d = rms_norm(x, layer.post_attn_norm, cfg.rms_norm_eps)
        h2_c = rms_norm(xc, layer.post_attn_norm, cfg.rms_norm_eps)
        mlp = _mlp_block(layer, torch.cat([h2_d[:, 0][None], h2_c], dim=1),
                         cfg)
        x = x + mlp[0, :B][:, None]
        xc = xc + mlp[:, B:]
    x = rms_norm(x, model.final_norm, cfg.rms_norm_eps)
    xc = rms_norm(xc, model.final_norm, cfg.rms_norm_eps)
    return x, xc[0], cache
