"""The DeepSeek-V3 decoder block as Kimi-VL-A3B's language model has it:
multi-head latent attention (MLA) over a latent cache, and routed experts
(DeepSeekMoE) with a shared expert after the leading dense layers
(`LlamaConfig` with `kv_lora_rank` and `n_routed_experts` set; `Llama`
builds these layers then, and `llama.prefill`, `llama.decode_step` and
`llama.init_kv_cache` hand over to the functions here).

Attention (DeepSeek-V3, arXiv 2412.19437, section 2.1; q_lora_rank null):
    q = h @ wq                      [T, H, nope + rope]
    c, k_rot = h @ wkv_a            [T, rank], [T, rope] (one key for all heads)
    c = rms_norm(c, kv_norm, 1e-6)  (the published RMSNorm's default eps)
    k_nope, v = c @ wkv_b           [T, H, nope], [T, H, v]
    rotary positions on interleaved pairs of q's and k_rot's rope parts,
    scores over the nope + rope width, scale (nope + rope) ** -0.5.
Prefill runs this expanded form (on `scaled_dot_product_attention`:
kernel A takes head dims 64 and 128 only). The cache keeps, per token and
layer, the normed c beside the roped k_rot (rank + rope values, 576 in
bf16), and no per-head K or V. Decode runs the absorbed form: each head's
q_nope folded through its key up-projection (q_nope . W_UK, rank wide),
kernel G (`ops/mla_decode.py`) over the latent rows, and the value
up-projection (W_UV) after it. The same scores and outputs, in another
order of products.

Feed-forward: layers below `first_k_dense_replace` keep the dense SwiGLU
(`llama._mlp_block` over `w_gate`/`w_up`/`w_down`); the others route each
token to `num_experts_per_tok` experts (`ops/moe.py`) and add the shared
expert, which is the same SwiGLU over that layer's `w_gate`/`w_up`/`w_down`
(width n_shared_experts * moe_intermediate_size).

Dense weights are [D_in, D_out] as in `llama.py`; the experts' are
[E, D_in, D_out]; the router [D, E]; its correction bias is a float32
buffer. Serving only: the training forward, LoRA, int8 weights and cache,
speculation, chunked fill, the shared prefix and tensor parallelism are
refused where they are set up (`LlamaConfig.require_gqa`).
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from metamorph_tpu_torch.config import LlamaConfig
from metamorph_tpu_torch.models.llama import (DENSE_NAMES, _mlp_block,
                                              _param, rms_norm)
from metamorph_tpu_torch.ops import moe
from metamorph_tpu_torch.ops.mla_decode import mla_decode_attention
from metamorph_tpu_torch.utils import trace

KV_NORM_EPS = 1e-6


class MlaMoeLayer(nn.Module):
    """One layer's weights: the latent attention's, then the dense FFN's
    (a leading dense layer) or the shared expert's beside the router and
    the routed experts (an expert layer)."""

    def __init__(self, cfg: LlamaConfig, index: int, dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        D, H, R = cfg.hidden_size, cfg.num_heads, cfg.kv_lora_rank
        qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        kw = dict(dtype=dtype, device=device)
        self.wq = _param(D, H * qk, **kw)
        self.wkv_a = _param(D, R + cfg.qk_rope_head_dim, **kw)
        self.kv_norm = _param(R, **kw)
        self.wkv_b = _param(R, H * (cfg.qk_nope_head_dim + cfg.v_head_dim),
                            **kw)
        self.wo = _param(H * cfg.v_head_dim, D, **kw)
        self.input_norm = _param(D, **kw)
        self.post_attn_norm = _param(D, **kw)
        self.moe = cfg.is_moe_layer(index)
        if self.moe:
            E, Fe = cfg.n_routed_experts, cfg.moe_intermediate_size
            Fd = cfg.n_shared_experts * Fe
            self.router = _param(D, E, **kw)
            self.register_buffer("e_score_bias", torch.zeros(
                E, dtype=torch.float32, device=device))
            self.experts_gate = _param(E, D, Fe, **kw)
            self.experts_up = _param(E, D, Fe, **kw)
            self.experts_down = _param(E, Fe, D, **kw)
        else:
            Fd = cfg.intermediate_size
        self.w_gate = _param(D, Fd, **kw)
        self.w_up = _param(D, Fd, **kw)
        self.w_down = _param(Fd, D, **kw)
        # `llama._mlp_block` reads a layer's LoRA factors and its
        # tensor-parallel group: this block has neither
        for name in DENSE_NAMES:
            self.register_parameter(f"{name}_lora_a", None)
            self.register_parameter(f"{name}_lora_b", None)
        self.tp_group = None

    def forward(self, *args, **kwargs):
        raise ValueError("the training forward is not ported to attention "
                         "kind 'mla' (multi-head latent attention with "
                         "routed experts); it serves only")


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

def rope_tables(cfg: LlamaConfig, positions: torch.Tensor):
    """cos/sin [..., T, rope/2] (fp32) of the rope part's frequencies."""
    d = cfg.qk_rope_head_dim
    inv = 1.0 / (cfg.rope_theta ** (torch.arange(
        0, d, 2, dtype=torch.float32, device=positions.device) / d))
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def rope_interleaved(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
                     ) -> torch.Tensor:
    """x [B, T, n, d] whose rotary pairs are interleaved (x0, x1), (x2,
    x3), ...: de-interleaved to (x0, x2, ..., x1, x3, ...) and rotated
    half against half, as the published `apply_rotary_pos_emb_interleave`
    does; the result stays in that order (queries and keys alike). cos/sin
    [B, T, d/2]; the arithmetic in x's dtype."""
    B, T, n, d = x.shape
    x = x.view(B, T, n, d // 2, 2).transpose(-1, -2).reshape(B, T, n, d)
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    cos = cos[:, :, None, :].to(x.dtype)
    sin = sin[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _latent(layer: MlaMoeLayer, cfg: LlamaConfig, h, cos, sin):
    """h [B, T, D] -> q [B, T, H, nope + rope] (rope part roped) and the
    cache rows [B, T, rank + rope] (normed latent, roped shared key)."""
    B, T, _ = h.shape
    R, nope = cfg.kv_lora_rank, cfg.qk_nope_head_dim
    q = (h @ layer.wq).view(B, T, cfg.num_heads, -1)
    q = torch.cat([q[..., :nope], rope_interleaved(q[..., nope:], cos, sin)],
                  dim=-1)
    kv = h @ layer.wkv_a
    c = rms_norm(kv[..., :R], layer.kv_norm, KV_NORM_EPS)
    k_rot = rope_interleaved(kv[..., None, R:], cos, sin)[:, :, 0]
    return q, torch.cat([c, k_rot], dim=-1)


def _up(layer: MlaMoeLayer, cfg: LlamaConfig) -> torch.Tensor:
    """wkv_b as [rank, H, nope + v]: W_UK = [..., :nope], W_UV = [...,
    nope:] (views)."""
    return layer.wkv_b.view(cfg.kv_lora_rank, cfg.num_heads, -1)


def _scale(cfg: LlamaConfig) -> float:
    return (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5


def _attn_expanded(layer: MlaMoeLayer, cfg: LlamaConfig, q, rows):
    """Causal attention of the full rows (prefill): k_nope and v from the
    latent, the shared roped key broadcast to every head. q [B, T, H, qk],
    rows [B, T, rank + rope] -> [B, T, H * v]."""
    B, T, H, qk = q.shape
    R, nope, dv = cfg.kv_lora_rank, cfg.qk_nope_head_dim, cfg.v_head_dim
    kv = (rows[..., :R] @ layer.wkv_b).view(B, T, H, nope + dv)
    k = torch.cat([kv[..., :nope],
                   rows[..., None, R:].expand(B, T, H, qk - nope)], dim=-1)
    # v padded to the q/k width so that a fused kernel of one head dim
    # takes it; the padding's outputs are dropped
    v = F.pad(kv[..., nope:], (0, qk - dv))
    out = F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=True, scale=_scale(cfg))
    return out.transpose(1, 2)[..., :dv].reshape(B, T, H * dv)


def _ffn(layer: MlaMoeLayer, cfg: LlamaConfig, h: torch.Tensor,
         on_picks: Optional[Callable[[torch.Tensor], None]] = None
         ) -> torch.Tensor:
    """The layer's feed-forward on h [B, T, D]. An expert layer routes
    every token, and hands its picks [B * T, k] to `on_picks`."""
    if not layer.moe:
        return _mlp_block(layer, h, cfg)
    B, T, D = h.shape
    x = h.reshape(B * T, D)
    idx, w = moe.route(x, layer.router, layer.e_score_bias,
                       cfg.num_experts_per_tok, cfg.routed_scaling_factor,
                       cfg.norm_topk_prob)
    if on_picks is not None:
        on_picks(idx)
    routed = moe.experts_forward(x, idx, w, layer.experts_gate,
                                 layer.experts_up, layer.experts_down)
    return routed.view(B, T, D) + _mlp_block(layer, h, cfg)


# ---------------------------------------------------------------------------
# cache, prefill, decode
# ---------------------------------------------------------------------------

def init_latent_cache(cfg: LlamaConfig, batch: int, max_len: int,
                      dtype=torch.bfloat16, device=None
                      ) -> Dict[str, torch.Tensor]:
    """The latent cache {"latent": [L, B, S, rank + rope]}: one row per
    token and layer (normed latent, then the roped shared key)."""
    return {"latent": torch.zeros(
        (cfg.num_layers, batch, max_len,
         cfg.kv_lora_rank + cfg.qk_rope_head_dim), dtype=dtype,
        device=device)}


def forward(model, cfg: LlamaConfig, inputs_embeds, positions, on_rows=None,
            on_picks=None):
    """Full-sequence causal forward of right-padded rows (serving's
    prefill; pads after every real position stay out of its keys).
    `on_rows(l, rows)` takes each layer's cache rows [B, T, rank + rope],
    `on_picks(m, idx)` the m-th expert layer's picks [B * T, k]. Returns
    final-norm hidden states [B, T, D]. Traced, each expert layer is a
    `model.moe` span with its layer, tokens and picks."""
    cos, sin = rope_tables(cfg, positions)
    x = inputs_embeds
    B, T, _ = x.shape
    m = 0
    for l, layer in enumerate(model.layers):
        h = rms_norm(x, layer.input_norm, cfg.rms_norm_eps)
        q, rows = _latent(layer, cfg, h, cos, sin)
        if on_rows is not None:
            on_rows(l, rows)
        x = x + _attn_expanded(layer, cfg, q, rows) @ layer.wo
        h = rms_norm(x, layer.post_attn_norm, cfg.rms_norm_eps)
        if not layer.moe:
            x = x + _ffn(layer, cfg, h)
            continue
        with trace.span("model.moe", layer=l, tokens=B * T,
                        picks=B * T * cfg.num_experts_per_tok):
            x = x + _ffn(layer, cfg, h, None if on_picks is None
                         else functools.partial(on_picks, m))
        m += 1
    return rms_norm(x, model.final_norm, cfg.rms_norm_eps)


def prefill(model, cfg: LlamaConfig, inputs_embeds, positions, attn_mask,
            cache: Dict[str, torch.Tensor],
            rows: Optional[torch.Tensor] = None,
            route_log: Optional[torch.Tensor] = None):
    """`llama.prefill` for this block: writes each layer's latent rows
    into cache["latent"][l, rows, :T] in place as the layer finishes, and
    with `route_log` ([B_cache, S, L_moe, k] uint8) each token's expert
    picks at [rows, :T] (one write after the last layer). Prompts are right-padded and attention is
    causal, so `attn_mask` must be None or all ones up to each row's
    length (pads compute junk rows that decode overwrites before reading
    them)."""
    n, T = inputs_embeds.shape[:2]
    lat = cache["latent"]
    dev = lat.device
    if rows is None:
        rows = torch.arange(n, device=dev)
    index = (rows.long()[:, None], torch.arange(T, device=dev)[None, :])

    def write(l, r):
        lat[l].index_put_(index, r.to(lat.dtype))

    picked = []
    h = forward(model, cfg, inputs_embeds, positions, write,
                None if route_log is None else (
                    lambda m, idx: picked.append(idx)))
    if picked:      # every expert layer's picks in one write
        route_log.index_put_(index, torch.stack(picked, 1).view(
            n, T, len(picked), -1).to(route_log.dtype))
    return h, cache


def decode_step(model, cfg: LlamaConfig, x: torch.Tensor, pos: torch.Tensor,
                cache: Dict[str, torch.Tensor], cache_idx: torch.Tensor,
                active: Optional[torch.Tensor] = None,
                counts: Optional[torch.Tensor] = None,
                route_log: Optional[torch.Tensor] = None):
    """`llama.decode_step` for this block: x [B, 1, D], pos [B, 1],
    cache_idx [B] (the step writes there; row b attends to [0, cache_idx +
    1)). The absorbed form: q_nope . W_UK, kernel G over the latent rows,
    then W_UV. With `counts` ([L_moe, E] int32) the step writes each
    expert layer's picks per expert over the rows where `active` [B] is
    set, and with `route_log` ([B, S, L_moe, k] uint8) each row's picks at
    its write position, in place, both once after the last layer. Returns
    (hidden [B, 1, D], cache)."""
    if not (torch.is_tensor(cache_idx) and cache_idx.dim() == 1):
        raise TypeError("cache_idx must be a [B] tensor (ragged rows)")
    B = x.shape[0]
    H, nope, R = cfg.num_heads, cfg.qk_nope_head_dim, cfg.kv_lora_rank
    lat = cache["latent"]
    S = lat.shape[2]
    cos, sin = rope_tables(cfg, pos)
    lengths = (cache_idx + 1).to(torch.int32)
    index = (torch.arange(B, device=lat.device),
             cache_idx.clamp(max=S - 1).long())

    picked = []
    m = 0
    for l, layer in enumerate(model.layers):
        h = rms_norm(x, layer.input_norm, cfg.rms_norm_eps)
        q, rows = _latent(layer, cfg, h, cos, sin)
        lat[l].index_put_(index, rows[:, 0].to(lat.dtype))
        up = _up(layer, cfg)
        q_abs = torch.einsum("bhn,rhn->bhr", q[:, 0, :, :nope],
                             up[..., :nope])
        o = mla_decode_attention(torch.cat([q_abs, q[:, 0, :, nope:]], -1),
                                 lat, lengths, l, R, _scale(cfg))
        o = torch.einsum("bhr,rhv->bhv", o, up[..., nope:])
        x = x + o.reshape(B, 1, -1) @ layer.wo
        h = rms_norm(x, layer.post_attn_norm, cfg.rms_norm_eps)
        picks = None
        if layer.moe:
            if counts is not None or route_log is not None:
                picks = picked.append
            m += 1
        x = x + _ffn(layer, cfg, h, picks)
    if picked:      # every expert layer's picks, counted and logged at once
        idx = torch.stack(picked, 1)                       # [B, L_moe, k]
        if counts is not None:
            E = cfg.n_routed_experts
            off = torch.arange(m, device=idx.device)[:, None] * E
            counts.view(-1).copy_(moe.expert_counts(
                (idx + off).reshape(B, -1), m * E, active))
        if route_log is not None:
            route_log.index_put_(index, idx.to(route_log.dtype))
    return rms_norm(x, model.final_norm, cfg.rms_norm_eps), cache
