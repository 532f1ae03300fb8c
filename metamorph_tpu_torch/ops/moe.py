"""Routed experts (DeepSeekMoE, as DeepSeek-V3 and Kimi-VL run them):
routing, dispatch, the three grouped products and the weighted combine,
all on the device and with no host sync, so that a decode tick that runs
them still captures into a CUDA graph.

  * `route`: router logits in float32 (the published code casts the
    hidden state and the router weight up), sigmoid scores, the top k
    chosen on the scores plus the correction bias, their weights gathered
    from the unbiased scores, normalised (`norm_topk_prob`) and scaled by
    `routed_scaling_factor`;
  * `dispatch`: the picks sorted by expert (a stable sort, so tokens keep
    their order within an expert) and the experts' end offsets, counted
    with a scatter on the device (`torch.bincount` would read the largest
    id to the host);
  * `grouped_mm`: one product per weight over every expert's rows at once,
    `torch._grouped_mm` (CUTLASS's grouped GEMM for bf16 on sm_90; a loop
    of per-group products on the CPU);
  * `combine`: each token's k expert outputs, put back in token order,
    weighted in float32 and summed, then cast to the hidden dtype.

No Python loop runs over the experts. Every row of `x` is routed; a caller
whose batch holds rows that do no work (a decode tick's idle slots) lets
them ride along at a fixed cost and leaves them out of what it counts
(`expert_counts`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


class Launches:
    """A plain launch count of a library product the port calls, with the
    name a capture's accounting (`serve._TickGraph`) files it under."""

    def __init__(self, symbol: str):
        self.symbol = symbol
        self.launches = 0

    def reset(self) -> None:
        self.launches = 0


GROUPED_MM = Launches("grouped_mm")


def route(x: torch.Tensor, router: torch.Tensor, bias: torch.Tensor,
          k: int, scaling: float, norm_topk_prob: bool = True
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [N, D]; router [D, E]; bias [E] (float32). Returns (idx [N, k]
    int64, weights [N, k] float32)."""
    scores = torch.sigmoid(x.float() @ router.float())
    idx = torch.topk(scores + bias.float()[None], k, dim=-1).indices
    w = scores.gather(1, idx)
    if norm_topk_prob:
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
    return idx, w * scaling


def expert_counts(idx: torch.Tensor, n_experts: int,
                  rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Picks per expert [E] int32, over the rows where `rows` [N] (bool)
    is set (all rows without it)."""
    flat = idx.reshape(-1)
    ones = (torch.ones_like(flat, dtype=torch.int32) if rows is None
            else rows.to(torch.int32).repeat_interleave(idx.shape[1]))
    return torch.zeros(n_experts, dtype=torch.int32,
                       device=idx.device).scatter_add_(0, flat, ones)


def dispatch(idx: torch.Tensor, n_experts: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The picks idx [N, k] sorted by expert: (order [N * k], the pick
    positions in token-major order taken in expert order; offs [E] int32,
    each expert's end offset in the sorted rows)."""
    flat = idx.reshape(-1)
    order = torch.sort(flat, stable=True).indices
    offs = torch.cumsum(expert_counts(idx, n_experts), 0, dtype=torch.int32)
    return order, offs


def grouped_mm(x: torch.Tensor, w: torch.Tensor, offs: torch.Tensor
               ) -> torch.Tensor:
    """x [M, K] rows sorted by group; w [G, K, N]; offs [G] int32 end
    offsets. Row i of group g gives x[i] @ w[g]."""
    GROUPED_MM.launches += 1
    return torch._grouped_mm(x, w, offs=offs)


def experts_forward(x: torch.Tensor, idx: torch.Tensor, weights: torch.Tensor,
                    w_gate: torch.Tensor, w_up: torch.Tensor,
                    w_down: torch.Tensor) -> torch.Tensor:
    """The routed experts' sum for x [N, D]: each token's k picks through
    their experts' SwiGLU (w_gate/w_up [E, D, F], w_down [E, F, D]; silu in
    the activation dtype, as the published MLP computes it), weighted in
    float32 and summed. Returns [N, D] in x's dtype."""
    N, k = idx.shape
    order, offs = dispatch(idx, w_gate.shape[0])
    xs = x[order // k]                                  # [N * k, D]
    h = F.silu(grouped_mm(xs, w_gate, offs)) * grouped_mm(xs, w_up, offs)
    y = grouped_mm(h, w_down, offs)                     # expert order
    back = torch.empty_like(y)
    back[order] = y                                     # token-major
    out = (back.view(N, k, -1).float() * weights[..., None]).sum(dim=1)
    return out.to(x.dtype)
