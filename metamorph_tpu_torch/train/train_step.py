"""The train step (counterpart of `metamorph_tpu/train/train_step.py`) on
one device.

A train state is a dict {"params": MetaMorph, "opt_state": AdamW state,
"step": int}; a step updates it in place and returns it with the step's
metrics. Gradient accumulation loops over microbatches, summing the
gradients in `.grad` and averaging them before the update.

`metrics["grad_norm"]` is the global norm of the raw gradients of the
trainable parameters. The JAX step takes it over every gradient, frozen
ones included (`train_step.py:61`); the two agree whenever the frozen
parameters get no gradient (stage 2 with a frozen tower), and in stage 1
the port's is the one the clip sees.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from metamorph_tpu_torch.config import MetaMorphConfig
from metamorph_tpu_torch.models.metamorph import MetaMorph, metamorph_forward
from metamorph_tpu_torch.train.optimizer import AdamW, make_optimizer

TrainState = dict   # {"params", "opt_state", "step"}


def init_train_state(model: MetaMorph, cfg: MetaMorphConfig) -> TrainState:
    """Marks the trainable parameters (requires_grad from the trainable
    mask) and makes the optimizer state."""
    tx = make_optimizer(cfg.train, model)
    for name, p in model.named_parameters():
        p.requires_grad_(tx.mask[name])
    return {"params": model, "opt_state": tx.init(model), "step": 0}


def loss_fn(model: MetaMorph, cfg: MetaMorphConfig, batch, pixels):
    return metamorph_forward(model, cfg, batch, pixels, remat=cfg.train.remat,
                             remat_policy=cfg.train.remat_policy)


def _zero_grads(model: MetaMorph) -> None:
    for p in model.parameters():
        p.grad = None


def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
               pixels: torch.Tensor, cfg: MetaMorphConfig, tx: AdamW
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimizer step. The metrics are those of the forward before the
    update."""
    model = state["params"]
    _zero_grads(model)
    total, metrics = loss_fn(model, cfg, batch, pixels)
    total.backward()
    metrics = dict(metrics)
    metrics["grad_norm"] = tx.update(model, state["opt_state"])
    state["step"] += 1
    return state, metrics


def accum_train_step(state: TrainState, batches: Dict[str, torch.Tensor],
                     pixels: torch.Tensor, cfg: MetaMorphConfig, tx: AdamW
                     ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """Gradient accumulation: batches/pixels carry a leading microbatch
    axis; gradients and metrics are averaged over the microbatches."""
    model = state["params"]
    n = pixels.shape[0]
    _zero_grads(model)
    sums: Dict[str, torch.Tensor] = {}
    for i in range(n):
        total, metrics = loss_fn(model, cfg,
                                 {k: v[i] for k, v in batches.items()},
                                 pixels[i])
        total.backward()
        for k, v in metrics.items():
            sums[k] = sums[k] + v if k in sums else v
    for p in model.parameters():
        if p.grad is not None:
            p.grad.div_(n)
    metrics = {k: v / n for k, v in sums.items()}
    metrics["grad_norm"] = tx.update(model, state["opt_state"])
    state["step"] += 1
    return state, metrics
