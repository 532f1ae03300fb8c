"""Plain reference of the DeepSeek-V3 decoder block as Kimi-VL-A3B's
language model has it, and of served requests on a MetaMorph built on
it, in float32 (TF32 off).

Attention is multi-head latent attention in its expanded form
(DeepSeek-V3, arXiv 2412.19437, section 2.1, and transformers'
`DeepseekV3Attention`, q_lora_rank null): q = h wq; (c, k_rot) = h wkv_a;
c normed (RMSNorm, eps 1e-6, the published module's default, not
rms_norm_eps); (k_nope, v) = c wkv_b per head; rotary positions on
interleaved pairs of the rope parts (`apply_rotary_pos_emb_interleave`);
causal softmax over the (nope + rope)-wide heads at scale (nope + rope)
** -0.5, k_rot shared by the heads. The feed-forward is a SwiGLU in the
leading dense layers and, after them, routed experts plus a shared
SwiGLU (`DeepseekV3MoE`): router logits and sigmoid scores in float32,
the top k on the scores plus the correction bias (one group: n_group 1),
weights from the unbiased scores, normalised and scaled by
routed_scaling_factor, each token through its experts one expert at a
time.

A served request is read as the program served it: the reference runs
over the prompt and the served tokens (as `reference/serve.py` does) and
routes each position's tokens to the experts the program picked there,
where the program logged them (`ServeEngine.log_routes`); each pick is
then judged as each token is, by its gap under float32 (`route_gap`).
Random weights make a deep stack of routers chaotic: a near-tie that
bf16 and float32 break apart turns one pick, the residual moves, and
later picks turn in turn (at Kimi-VL-A3B's widths, a 600-token prompt's
residual ends 60 % away from float32's and 97 % of its tokens pick
another set in the last layer, on an H100), so a reference that routed
by itself would judge another computation than the one served.

No kernel, cache or batching: one sequence at a time, attention
materialised in blocks of query rows. Weights come as name -> tensor in
the layout of `benchmark/weights_mla_moe.py`, in whatever dtype they are
stored; each layer's are cast to float32 while it runs, so the 16B model
never exists in float32 at once. `mode` "fp8" is the control
(`precision.matmul`): every dense product but the router's, which the
published code computes in float32 whatever the model's precision.
Departures from the published model: none at these lengths (rope_scaling
is null, so no YaRN factor enters the scale). Imports nothing of the
program.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from benchmark.reference import vision as vis
from benchmark.reference.decoder import Q_BLOCK, embed, head_weight, rms_norm
from benchmark.reference.precision import matmul

KV_NORM_EPS = 1e-6


def layer_weights(W: Dict[str, torch.Tensor], l: int
                  ) -> Dict[str, torch.Tensor]:
    p = f"llama.layers.{l}."
    return {k[len(p):]: v.detach().float() for k, v in W.items()
            if k.startswith(p)}


def rope_interleaved(x: torch.Tensor, pos: torch.Tensor, theta: float
                     ) -> torch.Tensor:
    """x [T, n, d] with interleaved rotary pairs: de-interleaved, then
    rotated half against half (the published order of the result)."""
    T, n, d = x.shape
    x = x.view(T, n, d // 2, 2).transpose(-1, -2).reshape(T, n, d)
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float64,
                                        device=x.device) / d))
    ang = (pos.double()[:, None] * inv[None]).float()
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(x: torch.Tensor, w: Dict[str, torch.Tensor], lc: dict,
              pos: torch.Tensor, mode: str = "fp32") -> torch.Tensor:
    """The expanded latent attention of x [T, D] (input-normed) -> [T, D]."""
    T = x.shape[0]
    H, R = lc["num_heads"], lc["kv_lora_rank"]
    nope, rope, dv = (lc["qk_nope_head_dim"], lc["qk_rope_head_dim"],
                      lc["v_head_dim"])
    theta = lc["rope_theta"]
    q = matmul(x, w["wq"], mode).view(T, H, nope + rope)
    q = torch.cat([q[..., :nope], rope_interleaved(q[..., nope:], pos,
                                                   theta)], dim=-1)
    kv = matmul(x, w["wkv_a"], mode)
    c = rms_norm(kv[:, :R], w["kv_norm"], KV_NORM_EPS)
    k_rot = rope_interleaved(kv[:, None, R:], pos, theta)     # [T, 1, rope]
    kvb = matmul(c, w["wkv_b"], mode).view(T, H, nope + dv)
    k = torch.cat([kvb[..., :nope], k_rot.expand(T, H, rope)], dim=-1)
    v = kvb[..., nope:]
    qh = q.transpose(0, 1) * (nope + rope) ** -0.5             # [H, T, qk]
    kh, vh = k.transpose(0, 1), v.transpose(0, 1)
    out = []
    for s in range(0, T, Q_BLOCK):
        e = min(s + Q_BLOCK, T)
        scores = qh[:, s:e] @ kh[:, :e].transpose(1, 2)
        i = torch.arange(s, e, device=x.device)[:, None]
        j = torch.arange(e, device=x.device)[None]
        scores = scores.masked_fill(j > i, float("-inf"))
        out.append(torch.softmax(scores, dim=-1) @ vh[:, :e])
    o = torch.cat(out, dim=1).transpose(0, 1).reshape(T, H * dv)
    return matmul(o, w["wo"], mode)


def swiglu(x, g, u, d, mode):
    return matmul(F.silu(matmul(x, g, mode)) * matmul(x, u, mode), d, mode)


def route(x: torch.Tensor, w: Dict[str, torch.Tensor], lc: dict,
          picks: Optional[torch.Tensor] = None, seen: Optional[list] = None):
    """Per token: (experts [T, k], weights [T, k]), as
    `DeepseekV3TopkRouter`: its own top k of the biased scores, or the
    given `picks`, weighted from the unbiased scores. `seen` gets (biased
    scores [T, E], own top k [T, k])."""
    scores = torch.sigmoid(x.float() @ w["router"])
    choice = scores + w["e_score_bias"][None]
    own = torch.topk(choice, lc["num_experts_per_tok"], dim=-1).indices
    if seen is not None:
        seen.append((choice, own))
    idx = own if picks is None else picks.long()
    wt = scores.gather(1, idx)
    if lc.get("norm_topk_prob", True):
        wt = wt / (wt.sum(dim=-1, keepdim=True) + 1e-20)
    return idx, wt * lc["routed_scaling_factor"]


def route_gap(choice: torch.Tensor, picks: torch.Tensor) -> float:
    """The widest gap, over tokens, by which the least biased score among
    a token's picks lies below the k-th best biased score (0 where the
    picks are the top k)."""
    kth = torch.topk(choice, picks.shape[-1], dim=-1).values[:, -1]
    return float((kth - choice.gather(1, picks.long()).min(-1).values)
                 .max())


def moe(x: torch.Tensor, w: Dict[str, torch.Tensor], lc: dict,
        mode: str = "fp32", picks: Optional[torch.Tensor] = None,
        seen: Optional[list] = None) -> torch.Tensor:
    """Routed experts, one expert at a time, plus the shared expert
    (`route`'s picks and `seen`)."""
    idx, wt = route(x, w, lc, picks, seen)
    out = torch.zeros_like(x)
    for e in range(lc["n_routed_experts"]):
        tok, slot = torch.where(idx == e)
        if tok.numel() == 0:
            continue
        y = swiglu(x[tok], w["experts_gate"][e], w["experts_up"][e],
                   w["experts_down"][e], mode)
        out.index_add_(0, tok, y * wt[tok, slot][:, None])
    return out + swiglu(x, w["w_gate"], w["w_up"], w["w_down"], mode)


def layer(x: torch.Tensor, w: Dict[str, torch.Tensor], lc: dict, l: int,
          pos: torch.Tensor, mode: str = "fp32",
          picks: Optional[torch.Tensor] = None,
          seen: Optional[list] = None) -> torch.Tensor:
    """Decoder layer l on x [T, D] (float32); an expert layer routes by
    `route` (its `picks` and `seen`)."""
    eps = lc["rms_norm_eps"]
    x = x + attention(rms_norm(x, w["input_norm"], eps), w, lc, pos, mode)
    h = rms_norm(x, w["post_attn_norm"], eps)
    if l < lc["first_k_dense_replace"] or not lc["n_routed_experts"]:
        return x + swiglu(h, w["w_gate"], w["w_up"], w["w_down"], mode)
    return x + moe(h, w, lc, mode, picks, seen)


@torch.no_grad()
def final_hidden(W: Dict[str, torch.Tensor], lc: dict,
                 seqs: List[torch.Tensor], mode: str = "fp32",
                 picks: Optional[List] = None,
                 seen: Optional[List[list]] = None) -> List[torch.Tensor]:
    """Final-norm hidden states of each sequence of input embeddings
    [T_i, D], at positions 0..T_i-1, layer by layer over all sequences.
    `picks[i]` ([>= T_i, L_moe, k], or None) routes sequence i's tokens
    in each expert layer; `seen[i]` gets each expert layer's `route`
    record of sequence i."""
    xs = [s.float() for s in seqs]
    pos = [torch.arange(x.shape[0], device=x.device) for x in xs]
    picks = picks or [None] * len(xs)
    dense = lc["first_k_dense_replace"]
    for l in range(lc["num_layers"]):
        w = layer_weights(W, l)
        xs = [layer(x, w, lc, l, p, mode,
                    None if pk is None or l < dense
                    else pk[:x.shape[0], l - dense],
                    None if seen is None else seen[i])
              for i, (x, p, pk) in enumerate(zip(xs, pos, picks))]
        del w
    fn = W["llama.final_norm"].float()
    return [rms_norm(x, fn, lc["rms_norm_eps"]) for x in xs]


@torch.no_grad()
def logits(W: Dict[str, torch.Tensor], lc: dict, ids: torch.Tensor,
           mode: str = "fp32") -> torch.Tensor:
    """The text model's logits [T, V] over token ids [T]."""
    h = final_hidden(W, lc, [embed(W, ids)], mode)[0]
    return matmul(h, head_weight(W, lc), mode)


@torch.no_grad()
def served_logits(W: Dict[str, torch.Tensor], cfg: dict, reqs: List[dict],
                  mode: str = "fp32", seen: Optional[List[list]] = None
                  ) -> List[torch.Tensor]:
    """`reference/serve.served_logits` on this decoder: for each request
    {prompt_ids, image_at, pixels, served, and optionally routes, the
    program's picks [>= P + n - 1, L_moe, k]}, the logits [n, V] at the
    positions that chose the served tokens, its image through the plain
    tower and projector (`reference/vision.py`), its tokens routed as
    `routes` says (by the reference itself without them). `seen[i]` gets
    request i's `route` records."""
    lc = cfg["llama"]
    K = cfg["mm"]["num_image_tokens"]
    dev = W["llama.embed"].device
    picks = [None if r.get("routes") is None
             else torch.as_tensor(r["routes"], device=dev) for r in reqs]
    seqs = []
    for r in reqs:
        prompt = torch.as_tensor(r["prompt_ids"], device=dev).long()
        served = torch.as_tensor(r["served"], device=dev).long()
        x = embed(W, torch.cat([prompt, served[:-1]]))
        if r["image_at"] is not None:
            feats = vis.image_features(W, cfg, r["pixels"], mode)
            at = r["image_at"]
            x[at:at + K] = vis.project(W, cfg, feats, mode)[0]
        seqs.append(x)
    hidden = final_hidden(W, lc, seqs, mode, picks, seen)
    head = head_weight(W, lc)
    out = []
    for r, h in zip(reqs, hidden):
        P, n = len(r["prompt_ids"]), len(r["served"])
        out.append(matmul(h[P - 1:P - 1 + n], head, mode))
    return out
