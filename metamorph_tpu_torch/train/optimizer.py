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
the temporaries stay small next to 8B parameters; `adamw_chunk_` is that
update, shared with `PlainAdamW` (optax's plain `adamw`, which the
visualizer trains with).

With `offload_optimizer` (the JAX package's `pinned_host` moments,
`metamorph_tpu/train/train_step.py:126`) the moments live in pinned host
memory and each step streams them through the card one chunk at a time
(`_Offload`): the same arithmetic on the same bits, so the result is
bitwise that of the moments kept on the card. JAX fetches the whole
moment tree into the step; the port overlaps chunk i + 1's copy with
chunk i's update instead. On the CPU the moments are plain host tensors
and the same streaming code runs without streams.

Sharded (`make_sharded_train_step`: FSDP2, and tensor parallelism) the
update runs on each rank's local shards (`local`): the moments are made
from them, offloaded ones included, and the clip's global norm is the sum
of squares of the local gradient shards, all-reduced over the ranks that
hold different shards of each parameter (`norm_groups`: the fsdp group,
or fsdp x tensor for a parameter cut over tensor), so that a shard held by
several data replicas counts once.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Iterator, List, Tuple

import torch
import torch.distributed as dist
from torch import nn

from metamorph_tpu_torch.config import TrainConfig
from metamorph_tpu_torch.utils import trace

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


def local(t: torch.Tensor) -> torch.Tensor:
    """The rank's own part of a sharded (DTensor) parameter or gradient;
    a plain tensor as it is."""
    to_local = getattr(t, "to_local", None)
    return t if to_local is None else to_local()


def _chunks(t: torch.Tensor) -> Iterator[torch.Tensor]:
    flat = t.view(-1)
    for s in range(0, flat.numel(), CHUNK):
        yield flat[s:s + CHUNK]


@torch.no_grad()
def adamw_chunk_(p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor,
                 nu: torch.Tensor, lr: float, count: int, b1: float,
                 b2: float, eps: float, wd: float) -> None:
    """One AdamW step on a chunk, in place and in fp32, whatever the
    tensors' dtype: the moments' EMAs, Adam's update with the bias
    correction at count + 1 and eps outside the sqrt (eps_root 0), the
    decoupled weight decay (none when wd is 0), then p -= lr * update.
    p, mu and nu are written back in their own dtypes."""
    bc1 = 1 - b1 ** (count + 1)
    bc2 = 1 - b2 ** (count + 1)
    g32 = g.float()
    m32 = (1 - b1) * g32 + b1 * mu.float()
    v32 = (1 - b2) * g32 * g32 + b2 * nu.float()
    u = (m32 / bc1) / ((v32 / bc2).sqrt() + eps)
    p32 = p.float()
    if wd:
        u = u + wd * p32
    p.copy_(p32 - lr * u)
    mu.copy_(m32)
    nu.copy_(v32)


def pinned_zeros(numel: int, dtype: torch.dtype) -> torch.Tensor:
    """`numel` zeros in pinned host memory; raises when the host cannot
    pin them (never falls back to pageable memory)."""
    try:
        return torch.zeros(numel, dtype=dtype, pin_memory=True)
    except RuntimeError as e:
        gib = numel * dtype.itemsize / 2**30
        raise RuntimeError(f"offload_optimizer: could not pin {gib:.3f} GiB "
                           f"of host memory for the AdamW moments: {e}") from e


def zero_moments(named, offload: bool) -> Dict[str, torch.Tensor]:
    """A zero moment for each (name, parameter): beside it, or with
    `offload` on the host. Offloaded moments of parameters on the card are
    views of one pinned buffer per dtype: one allocation, where one per
    tensor would each be rounded up to a power of two by the pinned
    allocator."""
    named = list(named)
    if not offload:
        return {n: torch.zeros_like(p) for n, p in named}
    views = {}
    for dtype in {p.dtype for _, p in named}:
        group = [(n, p) for n, p in named if p.dtype == dtype]
        total = sum(p.numel() for _, p in group)
        flat = (pinned_zeros(total, dtype) if group[0][1].is_cuda
                else torch.zeros(total, dtype=dtype))
        start = 0
        for n, p in group:
            views[n] = flat[start:start + p.numel()].view(p.shape)
            start += p.numel()
    return {n: views[n] for n, _ in named}


class _Offload:
    """Streams host moments through the device for `adamw_chunk_`: two
    device staging slots (mu, nu) per dtype, a load stream (host -> device)
    and a store stream (device -> host), so both PCIe directions run at
    once. Chunk i's update waits on its load, its store waits on its
    update, and load(i + 2) waits on store(i), which frees the slot; load
    (i + 1) is queued before chunk i's update, so it crosses PCIe while
    chunk i is updated. Each host chunk (a slice of the moment itself) is
    read and written once per step. On the CPU the copies are plain
    copies, in order."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.load_stream = torch.cuda.Stream(device) if self.cuda else None
        self.store_stream = torch.cuda.Stream(device) if self.cuda else None
        self.slots: Dict[torch.dtype, List[Tuple[torch.Tensor, ...]]] = {}

    def _slot(self, dtype: torch.dtype, i: int):
        if dtype not in self.slots:
            self.slots[dtype] = [
                (torch.empty(CHUNK, dtype=dtype, device=self.device),
                 torch.empty(CHUNK, dtype=dtype, device=self.device))
                for _ in range(2)]
            if self.cuda:
                # the slots come from the main stream's pool, which hands
                # out memory that kernels still queued there may write:
                # the copy streams touch them only after those kernels
                self.load_stream.wait_stream(
                    torch.cuda.current_stream(self.device))
        return self.slots[dtype][i % 2]

    def _on(self, stream):
        return (torch.cuda.stream(stream) if self.cuda
                else contextlib.nullcontext())

    def _copy(self, stream, after, pairs):
        """dst.copy_(src) for each pair on `stream`, once the event `after`
        (if any) has passed; returns the event of their end."""
        with self._on(stream):
            if after is not None:
                stream.wait_event(after)
            for dst, src in pairs:
                dst.copy_(src, non_blocking=True)
            if not self.cuda:
                return None
            ev = torch.cuda.Event()
            ev.record(stream)
            return ev

    @torch.no_grad()
    def run(self, items, step) -> None:
        """items: (p, g, mu_host, nu_host) chunks; step(i, p, g, mu, nu)
        updates chunk i with device-side moments."""
        main = torch.cuda.current_stream(self.device) if self.cuda else None
        stored = [None, None]       # the last store of each slot
        loaded = [None, None]

        def load(i):
            _, _, mh, nh = items[i]
            md, nd = (b[:mh.numel()] for b in self._slot(mh.dtype, i))
            loaded[i % 2] = self._copy(self.load_stream, stored[i % 2],
                                       ((md, mh), (nd, nh)))
            return md, nd

        nxt = load(0) if items else None
        for i, (p, g, mh, nh) in enumerate(items):
            md, nd = nxt
            ready = loaded[i % 2]
            if i + 1 < len(items):
                nxt = load(i + 1)
            if self.cuda:
                main.wait_event(ready)
            step(i, p, g, md, nd)
            updated = None
            if self.cuda:
                updated = torch.cuda.Event()
                updated.record(main)
            stored[i % 2] = self._copy(self.store_stream, updated,
                                       ((mh, md), (nh, nd)))
        if self.cuda:
            # the host moments are read (checkpoints, the next step) only
            # after every store has landed
            self.store_stream.synchronize()


class AdamW:
    """The optax chain of `metamorph_tpu/train/optimizer.py:make_optimizer`
    over a module's parameters. `init` makes the state ({"count", "mu",
    "nu"}, moments for trainable parameters only; on the host with
    `cfg.offload_optimizer`); `update` applies one step in place from the
    parameters' `.grad` and returns the global norm of the raw trainable
    gradients."""

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
        self._offload = None
        # parameter name -> the process group over which its gradient's
        # local sums of squares add up (set by the sharded step)
        self.norm_groups: Dict[str, object] = {}

    def trainable(self, model: nn.Module):
        return [(n, p) for n, p in model.named_parameters() if self.mask[n]]

    def init(self, model: nn.Module) -> dict:
        off = self.cfg.offload_optimizer
        named = [(n, local(p)) for n, p in self.trainable(model)]
        return {"count": 0,
                "mu": zero_moments(named, off),
                "nu": zero_moments(named, off)}

    @torch.no_grad()
    def global_norm(self, model: nn.Module) -> torch.Tensor:
        """sqrt of the sum of squares of the trainable gradients (fp32),
        over the whole of each sharded gradient."""
        params = self.trainable(model)
        device = local(params[0][1]).device if params else None
        sums: Dict[object, torch.Tensor] = {}
        for name, p in params:
            group = self.norm_groups.get(name)
            if group not in sums:
                sums[group] = torch.zeros((), dtype=torch.float32,
                                          device=device)
            if p.grad is not None:
                for c in _chunks(local(p.grad).contiguous()):
                    sums[group] += c.float().square().sum()
        total = None
        for group, s in sums.items():
            if group is not None:
                dist.all_reduce(s, group=group)
            total = s if total is None else total + s
        if total is None:
            total = torch.zeros((), dtype=torch.float32, device=device)
        return total.sqrt()

    @torch.no_grad()
    def update(self, model: nn.Module, state: dict) -> torch.Tensor:
        cfg = self.cfg
        with trace.span("train.grad_norm"):
            norm = self.global_norm(model)
        count = state["count"]
        max_norm = cfg.grad_clip_norm
        clip = norm >= max_norm
        items, lrs = [], []
        for name, p in self.trainable(model):
            lr = self.schedules[self.labels[name]](count)
            if p.grad is None:
                # a trainable parameter the loss does not reach (the tower
                # under freeze_vision): Adam sees g = 0 and weight decay
                # still applies, as with optax's zero gradients
                p.grad = torch.zeros_like(p)
            g = local(p.grad).contiguous()
            for chunk in zip(_chunks(local(p)), _chunks(g),
                             _chunks(state["mu"][name]),
                             _chunks(state["nu"][name])):
                items.append(chunk)
                lrs.append(lr)

        def step(i, pc, gc, mc, nc):
            g32 = gc.float()
            g32 = torch.where(clip, g32 / norm * max_norm, g32)
            adamw_chunk_(pc, g32, mc, nc, lrs[i], count, cfg.adam_b1,
                         cfg.adam_b2, cfg.adam_eps, cfg.weight_decay)

        if cfg.offload_optimizer and items:
            if self._offload is None:
                self._offload = _Offload(norm.device)
            self._offload.run(items, step)
        else:
            for i, chunk in enumerate(items):
                step(i, *chunk)
        state["count"] = count + 1
        return norm


class PlainAdamW:
    """optax's `adamw(schedule, b1, b2, eps=1e-8, eps_root=0,
    weight_decay)` over every parameter of a module: no clip, no mask,
    weight decay on every leaf, moments in the parameters' dtype, lr read
    from `schedule` at the count before the increment (so a schedule that
    starts at 0 leaves step 1 without effect). `update` applies one step
    in place from the parameters' `.grad`."""

    def __init__(self, schedule: Callable[[int], float], b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 1e-4):
        self.schedule = schedule
        self.b1, self.b2, self.eps, self.wd = b1, b2, eps, weight_decay

    @staticmethod
    def init(module: nn.Module) -> dict:
        params = list(module.named_parameters())
        return {"count": 0,
                "mu": {n: torch.zeros_like(p) for n, p in params},
                "nu": {n: torch.zeros_like(p) for n, p in params}}

    @torch.no_grad()
    def update(self, module: nn.Module, state: dict) -> None:
        count = state["count"]
        lr = self.schedule(count)
        for name, p in module.named_parameters():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            for pc, gc, mc, nc in zip(_chunks(p), _chunks(g.contiguous()),
                                      _chunks(state["mu"][name]),
                                      _chunks(state["nu"][name])):
                adamw_chunk_(pc, gc, mc, nc, lr, count, self.b1, self.b2,
                             self.eps, self.wd)
        state["count"] = count + 1


def make_optimizer(cfg: TrainConfig, model: nn.Module) -> AdamW:
    return AdamW(cfg, model)
