"""The train step (counterpart of `metamorph_tpu/train/train_step.py`): on
one device, and sharded over a (data, fsdp, tensor) mesh
(`make_sharded_train_step`).

A train state is a dict {"params": MetaMorph, "opt_state": AdamW state,
"step": int}; a step updates it in place and returns it with the step's
metrics. Gradient accumulation loops over microbatches, summing the
gradients in `.grad` and averaging them before the update.

`metrics["grad_norm"]` is the global norm of the raw gradients of the
trainable parameters. The JAX step takes it over every gradient, frozen
ones included (`train_step.py:61`); the two agree whenever the frozen
parameters get no gradient (stage 2 with a frozen tower), and in stage 1
the port's is the one the clip sees.

The sharded step computes what JAX's global-batch step computes: each
rank runs the forward on its rows (or its slice of its data group's rows
under sequence parallelism, with ring attention), divides its loss terms
by the global batch's token counts, FSDP2 sums the gradients over the
ranks, and the update runs on each rank's shards (`train/optimizer.py`).
Each rank runs SigLIP and the projector on its own images; ranks that
share rows (sequence peers) encode the same images.

Traced (`utils/trace`), each microbatch is a `train.forward` and a
`train.backward` span (with its index), and the update a
`train.optimizer` span holding `train.grad_norm`, with the update's
elements by kernel H and by the plain chain and kernel H's launches
(`AdamW.counts`) as its attrs.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from metamorph_tpu_torch.config import MetaMorphConfig
from metamorph_tpu_torch.models.metamorph import MetaMorph
from metamorph_tpu_torch.parallel.context import BatchShard
from metamorph_tpu_torch.train.optimizer import AdamW, make_optimizer
from metamorph_tpu_torch.utils import trace

TrainState = dict   # {"params", "opt_state", "step"}


def init_train_state(model: MetaMorph, cfg: MetaMorphConfig) -> TrainState:
    """Marks the trainable parameters (requires_grad from the trainable
    mask) and makes the optimizer state."""
    tx = make_optimizer(cfg.train, model)
    for name, p in model.named_parameters():
        p.requires_grad_(tx.mask[name])
    return {"params": model, "opt_state": tx.init(model), "step": 0}


def loss_fn(model: MetaMorph, cfg: MetaMorphConfig, batch, pixels,
            shard: BatchShard = None):
    return model(cfg, batch, pixels, remat=cfg.train.remat,
                 remat_policy=cfg.train.remat_policy, shard=shard)


def _zero_grads(model: MetaMorph) -> None:
    for p in model.parameters():
        p.grad = None


def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
               pixels: torch.Tensor, cfg: MetaMorphConfig, tx: AdamW,
               shard: BatchShard = None
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimizer step. The metrics are those of the forward before the
    update."""
    cfg.llama.require_gqa("train_step")
    model = state["params"]
    _zero_grads(model)
    with trace.span("train.forward", index=0):
        total, metrics = loss_fn(model, cfg, batch, pixels, shard)
    with trace.span("train.backward", index=0):
        total.backward()
    metrics = dict(metrics)
    with trace.span("train.optimizer") as span:
        metrics["grad_norm"] = tx.update(model, state["opt_state"])
        span.set(**tx.counts)
    state["step"] += 1
    return state, metrics


def accum_train_step(state: TrainState, batches: Dict[str, torch.Tensor],
                     pixels: torch.Tensor, cfg: MetaMorphConfig, tx: AdamW,
                     shard: BatchShard = None
                     ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """Gradient accumulation: batches/pixels carry a leading microbatch
    axis; gradients and metrics are averaged over the microbatches."""
    cfg.llama.require_gqa("train_step")
    model = state["params"]
    n = pixels.shape[0]
    _zero_grads(model)
    sums: Dict[str, torch.Tensor] = {}
    for i in range(n):
        micro = {k: v[i] for k, v in batches.items()}
        with trace.span("train.forward", index=i):
            total, metrics = loss_fn(model, cfg, micro, pixels[i], shard)
        with trace.span("train.backward", index=i):
            total.backward()
        for k, v in metrics.items():
            sums[k] = sums[k] + v if k in sums else v
    for p in model.parameters():
        if p.grad is not None:
            p.grad.div_(n)
    metrics = {k: v / n for k, v in sums.items()}
    with trace.span("train.optimizer") as span:
        metrics["grad_norm"] = tx.update(model, state["opt_state"])
        span.set(**tx.counts)
    state["step"] += 1
    return state, metrics


def make_sharded_train_step(cfg: MetaMorphConfig, mesh, model: MetaMorph):
    """Shard `model` (its full weights, on this rank's device) over `mesh`
    (`parallel/mesh.build_mesh`) and make its step. Returns (step_fn, tx,
    state): step_fn(state, batch, pixels) -> (state, metrics) takes this
    rank's batch and images (`parallel/mesh.dp_coordinate` says which
    rows; with `cfg.train.grad_accum_steps` > 1 they carry a leading
    microbatch axis, as the one-device accumulating step takes them); the
    state's "params" is the sharded model. Registers the mesh, and with
    `cfg.train.sequence_parallel` the "fsdp" axis as the sequence axis,
    in `parallel/context.py`, which makes the decoder's attention the
    ring. Every rank returns the global metrics."""
    from metamorph_tpu_torch.parallel import context, mesh as mesh_lib
    from metamorph_tpu_torch.parallel import sharding

    device = next(model.parameters()).device
    mesh_lib.check_backend(device)
    sp = cfg.train.sequence_parallel
    context.set_current_mesh(mesh)
    context.set_sequence_axis("fsdp" if sp else None)
    sizes = mesh_lib.axis_sizes(mesh)
    shard = BatchShard(
        group=mesh_lib.subgroup(mesh, ("data", "fsdp")),
        seq_index=mesh.get_local_rank("fsdp") if sp else 0,
        seq_count=sizes["fsdp"] if sp else 1)
    fsdp_group = mesh.get_group("fsdp")
    cut_group = mesh_lib.subgroup(mesh, ("fsdp", "tensor"))

    tx = make_optimizer(cfg.train, model)
    for name, p in model.named_parameters():
        p.requires_grad_(tx.mask[name])
    cut = sharding.apply_tensor_parallel(model, mesh)
    sharding.apply_fsdp(model, mesh)
    tx.norm_groups = {n: (cut_group if n in cut else fsdp_group)
                      for n, _ in model.named_parameters()}
    # the tensor cut's layout goes with the state, for the checkpoint's
    # gather and re-cut
    state = {"params": model, "opt_state": tx.init(model), "step": 0,
             "tensor_cut": cut,
             "tensor_group": mesh.get_group("tensor") if cut else None}
    fn = accum_train_step if cfg.train.grad_accum_steps > 1 else train_step

    def step_fn(state: TrainState, batch, pixels, step_cfg=None):
        """step_cfg: a variant of cfg for the batch (another per-image
        token count K); the weights are the same."""
        return fn(state, batch, pixels, step_cfg or cfg, tx, shard)

    return step_fn, tx, state
