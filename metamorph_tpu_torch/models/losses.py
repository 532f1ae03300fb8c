"""Stand-alone loss functions (counterpart of `metamorph_tpu/models/losses.py`).

The production dual loss lives in `models/metamorph.py::metamorph_forward`;
this module carries the reference's loss-function surface, including
`infonce_loss`, which the reference defines but never calls. Every loss
computes in fp32.
"""

from __future__ import annotations

import torch


def _unit(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)


def l1_loss(z: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Mean absolute error."""
    return (z.float() - h.float()).abs().mean()


def smooth_l1_loss(z: torch.Tensor, h: torch.Tensor,
                   beta: float = 1.0) -> torch.Tensor:
    """Huber-style smooth L1."""
    d = (z.float() - h.float()).abs()
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta).mean()


def cosine_loss(target: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """-mean cosine similarity (the normalize_vision AR loss)."""
    return -(_unit(target) * _unit(pred)).sum(-1).mean()


def soft_ce_loss(target_prob: torch.Tensor, pred_prob: torch.Tensor,
                 eps: float = 1e-10) -> torch.Tensor:
    """Soft cross-entropy for the apply_softmax variant."""
    return -(target_prob.float()
             * torch.log(pred_prob.float() + eps)).sum(-1).mean()


def infonce_loss(targets: torch.Tensor, preds: torch.Tensor,
                 temperature: float = 0.03) -> torch.Tensor:
    """Batch-contrastive InfoNCE: row i of preds should match row i of
    targets."""
    sim = (_unit(preds) @ _unit(targets).T) / temperature
    logp = torch.log_softmax(sim, dim=-1)
    return -logp.diagonal().mean()
