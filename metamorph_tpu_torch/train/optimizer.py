"""Optimizer, LR schedules, per-group learning rates, trainable sets
(counterpart of `metamorph_tpu/train/optimizer.py`).

`AdamW` is the port's own, equal to the JAX package's optax chain
(`make_optimizer`):
  1. the gradients of frozen parameters are zero (here: never computed)
     before the global-norm clip, so they do not enter the norm;
  2. `clip_by_global_norm`: g, or g / norm * max_norm where norm >= max_norm;
  3. per group ("default", "projector", "vision_tower") Adam with the bias
     correction at count + 1 and eps outside the sqrt, then decoupled
     weight decay, then a step of -lr(count) from the group's
     warmup-cosine schedule (lr = 0 at step 0);
  4. frozen parameters get no moments.
The moments take the parameter dtype (bf16 on the card), as optax's do.
The update runs per tensor, in fp32 on flat chunks of at most 256 MB, so
the temporaries stay small next to 8B parameters.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterator

import torch
from torch import nn

from metamorph_tpu_torch.config import TrainConfig

CHUNK = 64 * 1024 * 1024      # elements per fp32 chunk (256 MB)


def sqrt_lr_scale(base_lr: float, batch_size: int, base_batch_size: int
                  ) -> float:
    return base_lr * math.sqrt(batch_size / base_batch_size)


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    if steps <= 0:
        return lambda count: init

    def f(count: int) -> float:
        frac = 1 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end
    return f


def _join(schedules, boundary: int) -> Callable[[int], float]:
    first, second = schedules
    return lambda count: (first(count) if count < boundary
                          else second(count - boundary))


def make_schedule(cfg: TrainConfig, lr: float) -> Callable[[int], float]:
    """lr as a function of the step count, as optax's schedules give it."""
    warmup = max(int(cfg.total_steps * cfg.warmup_ratio), 1)
    if cfg.lr_schedule == "cosine":
        # optax.warmup_cosine_decay_schedule(0, lr, warmup,
        #                                    max(total, warmup + 1), 0)
        decay = max(cfg.total_steps, warmup + 1) - warmup

        def cosine(count: int) -> float:
            count = min(count, decay)
            return lr * 0.5 * (1 + math.cos(math.pi * count / decay))
        return _join((_linear(0.0, lr, warmup), cosine), warmup)
    if cfg.lr_schedule == "linear":
        return _join((_linear(0.0, lr, warmup),
                      _linear(lr, 0.0, max(cfg.total_steps - warmup, 1))),
                     warmup)
    if cfg.lr_schedule == "constant":
        return _join((_linear(0.0, lr, warmup), lambda count: lr), warmup)
    raise ValueError(cfg.lr_schedule)


def _top_level_group(name: str) -> str:
    top = name.split(".")[0]
    if top == "projector":
        return "projector"
    if top == "siglip":
        return "vision_tower"
    return "default"


def param_group_labels(model: nn.Module) -> Dict[str, str]:
    """Parameter name -> 'projector' / 'vision_tower' / 'default', the
    reference's optimizer param groups."""
    return {n: _top_level_group(n) for n, _ in model.named_parameters()}


def trainable_mask(model: nn.Module, cfg: TrainConfig) -> Dict[str, bool]:
    """Parameter name -> True to update it: the stage-1/stage-2 freeze
    toggles."""

    def mask(name: str) -> bool:
        names = name.split(".")
        if cfg.tune_mm_mlp_adapter:
            # stage 1: projector (+ input embeddings for the new image tokens)
            return _top_level_group(name) == "projector" or "embed" in names
        if cfg.lora_enable and names[0] == "llama":
            return any("_lora_" in n for n in names)
        if cfg.freeze_backbone and names[0] == "llama":
            return False
        if names[0] == "siglip":
            # the tower trains only when given its own LR
            return cfg.vision_tower_lr is not None
        return True

    return {n: mask(n) for n, _ in model.named_parameters()}


def _chunks(t: torch.Tensor) -> Iterator[torch.Tensor]:
    flat = t.view(-1)
    for s in range(0, flat.numel(), CHUNK):
        yield flat[s:s + CHUNK]


class AdamW:
    """The optax chain of `metamorph_tpu/train/optimizer.py:make_optimizer`
    over a module's parameters. `init` makes the state ({"count", "mu",
    "nu"}, moments for trainable parameters only); `update` applies one
    step in place from the parameters' `.grad` and returns the global norm
    of the raw trainable gradients."""

    def __init__(self, cfg: TrainConfig, model: nn.Module):
        self.cfg = cfg
        self.mask = trainable_mask(model, cfg)
        self.labels = param_group_labels(model)
        self.schedules = {
            "default": make_schedule(cfg, cfg.learning_rate),
            "projector": make_schedule(
                cfg, cfg.mm_projector_lr or cfg.learning_rate),
            "vision_tower": make_schedule(
                cfg, cfg.vision_tower_lr or cfg.learning_rate),
        }

    def trainable(self, model: nn.Module):
        return [(n, p) for n, p in model.named_parameters() if self.mask[n]]

    def init(self, model: nn.Module) -> dict:
        return {"count": 0,
                "mu": {n: torch.zeros_like(p) for n, p in self.trainable(model)},
                "nu": {n: torch.zeros_like(p) for n, p in self.trainable(model)}}

    @torch.no_grad()
    def global_norm(self, model: nn.Module) -> torch.Tensor:
        """sqrt of the sum of squares of the trainable gradients (fp32)."""
        params = self.trainable(model)
        total = torch.zeros((), dtype=torch.float32,
                            device=params[0][1].device if params else None)
        for _, p in params:
            if p.grad is not None:
                for c in _chunks(p.grad.contiguous()):
                    total += c.float().square().sum()
        return total.sqrt()

    @torch.no_grad()
    def update(self, model: nn.Module, state: dict) -> torch.Tensor:
        cfg = self.cfg
        norm = self.global_norm(model)
        count = state["count"]
        b1, b2, eps, wd = cfg.adam_b1, cfg.adam_b2, cfg.adam_eps, \
            cfg.weight_decay
        bc1 = 1 - b1 ** (count + 1)
        bc2 = 1 - b2 ** (count + 1)
        max_norm = cfg.grad_clip_norm
        clip = norm >= max_norm
        for name, p in self.trainable(model):
            lr = self.schedules[self.labels[name]](count)
            mu, nu = state["mu"][name], state["nu"][name]
            if p.grad is None:
                # a trainable parameter the loss does not reach (the tower
                # under freeze_vision): Adam sees g = 0 and weight decay
                # still applies, as with optax's zero gradients
                p.grad = torch.zeros_like(p)
            g = p.grad.contiguous()
            for pc, mc, nc, gc in zip(_chunks(p), _chunks(mu), _chunks(nu),
                                      _chunks(g)):
                g32 = gc.float()
                g32 = torch.where(clip, g32 / norm * max_norm, g32)
                m32 = (1 - b1) * g32 + b1 * mc.float()
                v32 = (1 - b2) * g32 * g32 + b2 * nc.float()
                u = (m32 / bc1) / ((v32 / bc2).sqrt() + eps)
                p32 = pc.float()
                if wd:
                    u = u + wd * p32
                pc.copy_(p32 - lr * u)
                mc.copy_(m32)
                nc.copy_(v32)
        state["count"] = count + 1
        return norm


def make_optimizer(cfg: TrainConfig, model: nn.Module) -> AdamW:
    return AdamW(cfg, model)
