"""The reference reading of served requests: the plain model runs once
over each request's prompt (its image through the plain tower and
projector) followed by the tokens the program served, and each served
token is judged by how far its logit lies below the reference's best at
that position.

A greedy server that computes what the model states serves, at every
position, a token whose reference logit is the best or within the
rounding of the program's precision of it. A wrong token, a step that
reads the wrong cache entries, or a wrong image splice lies further down.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from benchmark.reference import decoder as dec
from benchmark.reference import vision as vis
from benchmark.reference.precision import matmul


@torch.no_grad()
def served_logits(W: Dict[str, torch.Tensor], cfg: dict, reqs: List[dict],
                  mode: str = "fp32") -> List[torch.Tensor]:
    """For each request {prompt_ids [P] (placeholders where the image
    goes), image_at (int or None), pixels ([1, S, S, 3] or None), served
    [n]}: the logits [n, V] (float32) at the positions that chose the
    served tokens (the prompt's last, then each served token but the
    last)."""
    lc = cfg["llama"]
    K = cfg["mm"]["num_image_tokens"]
    seqs = []
    for r in reqs:
        dev = W["llama.embed"].device
        prompt = torch.as_tensor(r["prompt_ids"], device=dev).long()
        served = torch.as_tensor(r["served"], device=dev).long()
        x = dec.embed(W, torch.cat([prompt, served[:-1]]))
        if r["image_at"] is not None:
            feats = vis.image_features(W, cfg, r["pixels"], mode)
            at = r["image_at"]
            x[at:at + K] = vis.project(W, cfg, feats, mode)[0]
        seqs.append(x)
    hidden = dec.final_hidden(W, lc, seqs, mode)
    head = dec.head_weight(W, lc)
    out = []
    for r, h in zip(reqs, hidden):
        P, n = len(r["prompt_ids"]), len(r["served"])
        rows = h[P - 1:P - 1 + n]
        out.append(matmul(rows, head, mode))
    return out


def gaps(logits: List[torch.Tensor], tokens: List) -> List[float]:
    """Per request, the widest gap between the best logit and the logit
    of the token taken at each position."""
    out = []
    for lg, toks in zip(logits, tokens):
        t = torch.as_tensor(toks, device=lg.device).long()
        best = lg.max(dim=-1).values
        out.append(float((best - lg.gather(-1, t[:, None])[:, 0]).max()))
    return out
