"""Plain reference of the decoder: a Mistral-style pre-norm decoder with
grouped-query attention, rotary positions and a SwiGLU feed-forward, as
the published `MistralForCausalLM` computes it, in float32 (TF32 off).

No kernel, cache or batching: one sequence at a time, attention
materialised in blocks of query rows. Weights come as a name -> tensor
mapping in the layout of `benchmark/weights.py` (dense weights
[D_in, D_out], applied as x @ w), in whatever dtype they are stored; each
layer's weights are cast to float32 when the layer runs, so a 12B model
never exists in float32 at once. Departures from the published model:
none at these lengths (Ministral's windows of 32k and more cover every
4,096-token row, so its attention is full causal here).
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from benchmark.reference.precision import matmul

LAYER_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
              "input_norm", "post_attn_norm")
Q_BLOCK = 512


def layer_weights(W: Dict[str, torch.Tensor], l: int) -> Dict[str, torch.Tensor]:
    return {k: W[f"llama.layers.{l}.{k}"].detach().float()
            for k in LAYER_KEYS}


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x [T, heads, Dh]: rotate-half rotary embedding at positions pos [T]."""
    Dh = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, Dh, 2, dtype=torch.float64,
                                        device=x.device) / Dh))
    ang = (pos.double()[:, None] * inv[None]).float()
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :Dh // 2], x[..., Dh // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                     ) -> torch.Tensor:
    """q [T, H, Dh], k/v [T, KV, Dh] -> [T, H, Dh]; query i sees keys
    j <= i; query head h reads key head h // (H / KV)."""
    T, H, Dh = q.shape
    G = H // k.shape[1]
    k = k.repeat_interleave(G, dim=1).transpose(0, 1)       # [H, T, Dh]
    v = v.repeat_interleave(G, dim=1).transpose(0, 1)
    qh = q.transpose(0, 1) * Dh ** -0.5
    out = []
    for s in range(0, T, Q_BLOCK):
        e = min(s + Q_BLOCK, T)
        scores = qh[:, s:e] @ k[:, :e].transpose(1, 2)       # [H, b, e]
        i = torch.arange(s, e, device=q.device)[:, None]
        j = torch.arange(e, device=q.device)[None]
        scores = scores.masked_fill(j > i, float("-inf"))
        out.append(torch.softmax(scores, dim=-1) @ v[:, :e])
    return torch.cat(out, dim=1).transpose(0, 1)


def layer(x: torch.Tensor, w: Dict[str, torch.Tensor], lc: dict,
          pos: torch.Tensor, mode: str = "fp32") -> torch.Tensor:
    """One decoder layer on x [T, D] (float32)."""
    T = x.shape[0]
    H, KV, Dh = lc["num_heads"], lc["num_kv_heads"], lc["head_dim"]
    eps, theta = lc["rms_norm_eps"], lc["rope_theta"]
    h = rms_norm(x, w["input_norm"], eps)
    q = rope(matmul(h, w["wq"], mode).view(T, H, Dh), pos, theta)
    k = rope(matmul(h, w["wk"], mode).view(T, KV, Dh), pos, theta)
    v = matmul(h, w["wv"], mode).view(T, KV, Dh)
    x = x + matmul(causal_attention(q, k, v).reshape(T, H * Dh), w["wo"],
                   mode)
    h = rms_norm(x, w["post_attn_norm"], eps)
    ff = F.silu(matmul(h, w["w_gate"], mode)) * matmul(h, w["w_up"], mode)
    return x + matmul(ff, w["w_down"], mode)


def head_weight(W: Dict[str, torch.Tensor], lc: dict) -> torch.Tensor:
    """The output head [D, V] in float32."""
    if lc.get("tie_word_embeddings", False):
        return W["llama.embed"].float().T
    return W["llama.lm_head"].float()


@torch.no_grad()
def final_hidden(W: Dict[str, torch.Tensor], lc: dict,
                 seqs: List[torch.Tensor], mode: str = "fp32"
                 ) -> List[torch.Tensor]:
    """Final-norm hidden states of each sequence of input embeddings
    [T_i, D] (float32), at positions 0..T_i-1, layer by layer over all
    sequences."""
    xs = [s.float() for s in seqs]
    pos = [torch.arange(x.shape[0], device=x.device) for x in xs]
    for l in range(lc["num_layers"]):
        w = layer_weights(W, l)
        xs = [layer(x, w, lc, p, mode) for x, p in zip(xs, pos)]
        del w
    fn = W["llama.final_norm"].float()
    return [rms_norm(x, fn, lc["rms_norm_eps"]) for x in xs]


def embed(W: Dict[str, torch.Tensor], ids: torch.Tensor) -> torch.Tensor:
    return W["llama.embed"][ids.long()].float()
