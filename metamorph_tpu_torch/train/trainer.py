"""Training orchestration: the `train()` entry point (counterpart of
`metamorph_tpu/train/trainer.py`), on one device or over a
(data, fsdp, tensor) mesh of cards.

config -> params (random from a seed, then HF LLaMA / SigLIP weights and a
stage-1 adapter where the arguments name them) -> train state -> loop with
gradient accumulation, per-step metrics, checkpoint saves (plus the
adapter-only save in stage 1 and the LoRA save under `lora_enable`) and
auto-resume. The port runs eagerly, so a batch with another per-image
token count K (multi-res buckets) just runs with the matching config
variant; nothing recompiles.

The data iterator runs in a worker process (`ProcessPrefetcher`), two
batches ahead, so its Python (reading, tokenising, collating) does not
hold the GIL that the loop launching the step's kernels needs; the loop
gets each batch with the iterator's state at that batch, for resume, and
the packer counts it added (`multimodal/native.PACKS`, added to this
process's).

Besides the step's metrics, each logged step records two host-clock times:
`data_wait_s`, how long the step waited on the prefetch queue for its
batches (0 when the background loader kept ahead), and `step_s`, from the
first wait to the metrics read back from the device (which waits for the
step to finish).

`lora_enable` trains the LoRA factors the LLM carries and freezes the rest
of it. As in the JAX package, `train()` adds no factors itself
(`models/lora.add_lora` is the caller's), so a model without them trains
no LLM weight under `lora_enable`.

`cfg.train.offload_optimizer` keeps the AdamW moments in pinned host
memory (`train/optimizer.py`). W&B logging is not ported (refused).

Over several cards (`multihost=True`, one process per card as torchrun
starts them, or any process group that exists when `train()` is called)
each rank takes its device from LOCAL_RANK, builds the mesh of
`cfg.mesh` over the group and trains through `make_sharded_train_step`;
`data_iter` yields the rank's own shard of each global batch
(`DataIterator(process_index, process_count)` with the rank's
`parallel/mesh.dp_coordinate`). Every rank takes part in each checkpoint;
rank 0 alone writes it and the metrics, and prints.
"""

from __future__ import annotations

import os
import time
from collections import Counter
from dataclasses import dataclass
from typing import Any, Dict, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist

from metamorph_tpu_torch.config import MetaMorphConfig, resolve_dtype
from metamorph_tpu_torch.convert import init_params, resolve_device
from metamorph_tpu_torch.models import hf_import
from metamorph_tpu_torch.multimodal import native
from metamorph_tpu_torch.multimodal.packing import PackedBatch, batch_to_arrays
from metamorph_tpu_torch.train import checkpoint as ckpt_lib
from metamorph_tpu_torch.train.optimizer import make_optimizer
from metamorph_tpu_torch.train.prefetch import ProcessPrefetcher
from metamorph_tpu_torch.parallel import mesh as mesh_lib
from metamorph_tpu_torch.train.train_step import (accum_train_step,
                                                  init_train_state,
                                                  make_sharded_train_step,
                                                  train_step)
from metamorph_tpu_torch.utils.logging import MetricsLogger, rank0_print


@dataclass
class TrainerArgs:
    output_dir: str = "./out"
    # a checkpoint every save_steps steps and at the end; 0 writes none (the
    # 8B stage-2 state is ~49 GB, more than some hosts' disks take)
    save_steps: int = 500
    save_total_limit: int = 1
    logging_steps: int = 1
    resume: bool = True
    pretrain_mm_mlp_adapter: Optional[str] = None
    hf_llama_path: Optional[str] = None
    hf_siglip_path: Optional[str] = None
    use_wandb: bool = False
    # JAX's choice, checked and read nowhere: the port's decoder attention
    # is the flash Function (its kernels on the card, its plain version on
    # the CPU) for every impl, and ring attention for every impl under
    # sequence parallelism (`ops/attention.attention`)
    attn_impl: str = "flash"


def _check_supported(args: TrainerArgs) -> None:
    if args.attn_impl not in ("flash", "xla", "ring"):
        raise ValueError(f"unknown attn_impl {args.attn_impl!r}")


def rank_device(device) -> torch.device:
    """This rank's device, with its index: cuda:LOCAL_RANK when the caller
    named the card without an index (or as cuda:0) and torchrun set
    LOCAL_RANK, else the named card or the current one; it becomes the
    current device."""
    device = resolve_device(device)
    if device.type != "cuda":
        return device
    if device.index in (None, 0) and "LOCAL_RANK" in os.environ:
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    elif device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    torch.cuda.set_device(device)
    return device


def build_params(cfg: MetaMorphConfig, args: TrainerArgs, seed: int = 0,
                 device="cuda"):
    """Random weights from `seed` in the config's parameter dtype, then, as
    the JAX `build_params` does, the HF LLaMA weights of
    `args.hf_llama_path`, the HF SigLIP weights of `args.hf_siglip_path`
    and the stage-1 adapter of `args.pretrain_mm_mlp_adapter` over them."""
    model = init_params(cfg, seed=seed, device=device,
                        dtype=resolve_dtype(cfg.train.param_dtype))
    if args.hf_llama_path:
        hf_import.llama_params_from_hf(
            hf_import.load_safetensors_dir(args.hf_llama_path), model.llama)
    if args.hf_siglip_path:
        hf_import.siglip_params_from_hf(
            hf_import.load_safetensors_dir(args.hf_siglip_path), model.siglip)
    if args.pretrain_mm_mlp_adapter:
        ckpt_lib.load_adapter(args.pretrain_mm_mlp_adapter, model)
    return model


def _to_device(arrays: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in arrays.items()}


def train(cfg: MetaMorphConfig, args: TrainerArgs,
          data_iter: Iterable, multihost: bool = False,
          device="cuda") -> Dict[str, Any]:
    """data_iter yields (PackedBatch | dict-of-arrays, pixels [N,S,S,3]),
    this rank's shard of each batch when sharded. Trains on the card
    unless the caller passes another `device`; raises when no CUDA device
    exists and none was named. `multihost` starts the process group from
    torchrun's environment unless one exists; with a process group the
    step is sharded over `cfg.mesh`, else it runs on one device (and
    `cfg.mesh` must cover one)."""
    cfg.llama.require_gqa("train()")
    _check_supported(args)
    device = rank_device(device)
    if multihost:
        mesh_lib.init_distributed(device.type, device=device)
    sharded = dist.is_initialized()
    rank0_print(f"device: {device}")

    model = build_params(cfg, args, device=device)
    if sharded:
        mesh = mesh_lib.build_mesh(cfg.mesh, device.type)
        rank0_print(f"mesh: {mesh_lib.axis_sizes(mesh)}")
        step_fn, tx, state = make_sharded_train_step(cfg, mesh, model)
    else:
        mesh_lib.mesh_shape(cfg.mesh, 1)
        state = init_train_state(model, cfg)
        tx = make_optimizer(cfg.train, model)
        step_fn = None
    rank0 = not sharded or dist.get_rank() == 0
    n_chips = dist.get_world_size() if sharded else 1

    # ---- auto-resume ----
    start_step = 0
    data_state = None
    latest = ckpt_lib.latest_checkpoint(args.output_dir) if args.resume else None
    if latest:
        rank0_print(f"resuming from {latest}")
        state = ckpt_lib.restore_train_state(latest, state)
        meta = ckpt_lib.restore_meta(latest)
        start_step = meta["step"]
        data_state = meta.get("data_state")
    if data_state and hasattr(data_iter, "load_state_dict"):
        data_iter.load_state_dict(data_state)

    preempt = ckpt_lib.PreemptionSaver()
    os.makedirs(args.output_dir, exist_ok=True)
    metrics_log = MetricsLogger(
        log_path=(os.path.join(args.output_dir, "metrics.jsonl") if rank0
                  else None),
        use_wandb=args.use_wandb)
    # throughput counts real tokens (attention-mask sums, on the host);
    # sharded, the log step sums them over the ranks, and each rank's rows
    # are loaded by `peers` ranks (tensor and sequence peers)
    peers = (n_chips // mesh_lib.dp_coordinate(
        mesh, cfg.train.sequence_parallel)[1] if sharded else 1)
    tokens_since_log = 0

    # in the worker: each item carries the iterator state at production
    # time, so resume replays from the right position even with batches in
    # flight, and the packs it made
    packs_seen = [Counter(native.PACKS)]

    def _with_state(item):
        ds = data_iter.state_dict() if hasattr(data_iter, "state_dict") else None
        packs = Counter(native.PACKS)
        new, packs_seen[0] = packs - packs_seen[0], packs
        return item, ds, new

    it = ProcessPrefetcher(iter(data_iter), depth=2, transform=_with_state)
    consumed_data_state = [None]

    def save(step):
        ckpt_lib.save_train_state(args.output_dir, step, state, cfg.to_json(),
                                  consumed_data_state[0])
        if rank0:
            ckpt_lib.prune_checkpoints(args.output_dir, args.save_total_limit)
        for on, name, write, keep in (
                (cfg.train.tune_mm_mlp_adapter, "mm_projector.safetensors",
                 ckpt_lib.save_adapter, ckpt_lib.adapter_param),
                (cfg.train.lora_enable, "lora.safetensors",
                 ckpt_lib.save_lora, ckpt_lib.lora_param)):
            if on:
                # a sharded model is gathered, by every rank
                model = ckpt_lib.full_model(state, keep)
                if rank0:
                    write(os.path.join(args.output_dir, name), model)

    step = start_step
    last_metrics = {}
    saving = args.save_steps > 0
    try:
        accum = cfg.train.grad_accum_steps
        while step < cfg.train.total_steps:
            micro, micro_K = [], []
            t_start = time.perf_counter()
            data_wait = 0.0
            for _ in range(accum):
                t = time.perf_counter()
                (packed, pixels), ds, packs = next(it)
                data_wait += time.perf_counter() - t
                native.PACKS.update(packs)
                consumed_data_state[0] = ds
                if isinstance(packed, PackedBatch):
                    b = batch_to_arrays(packed)
                    micro_K.append(packed.ar_valid.shape[0]
                                   // packed.image_slot_used.shape[0])
                else:
                    b = dict(packed)
                    micro_K.append(cfg.mm.num_image_tokens)
                tokens_since_log += int(np.asarray(b["attn_mask"]).sum())
                micro.append((b, np.asarray(pixels)))
            K = micro_K[0]
            if any(k != K for k in micro_K):
                # multi-res buckets must be constant within one optimizer
                # step; mixed K would stack incompatible packed shapes
                raise ValueError(
                    f"grad-accum group has mixed num_image_tokens {micro_K}; "
                    f"construct DataIterator with accum_steps={accum}")
            step_cfg = (cfg if K == cfg.mm.num_image_tokens
                        else cfg.with_num_image_tokens(K))
            if accum > 1:
                batch = _to_device({k: np.stack([m[0][k] for m in micro])
                                    for k in micro[0][0]}, device)
                pixels = torch.from_numpy(
                    np.stack([m[1] for m in micro])).to(device)
            else:
                batch = _to_device(micro[0][0], device)
                pixels = torch.from_numpy(micro[0][1]).to(device)
            if step_fn is not None:
                state, m = step_fn(state, batch, pixels, step_cfg)
            elif accum > 1:
                state, m = accum_train_step(state, batch, pixels, step_cfg,
                                            tx)
            else:
                state, m = train_step(state, batch, pixels, step_cfg, tx)
            step += 1
            if step % args.logging_steps == 0:
                m = {k: float(v) for k, v in m.items()}
                m.update(data_wait_s=data_wait,
                         step_s=time.perf_counter() - t_start)
                tokens = _rank_sum(tokens_since_log, sharded, device) // peers
                last_metrics = metrics_log.log(step, m, tokens, n_chips)
                tokens_since_log = 0
                rank0_print(f"step {step}: loss={m['loss']:.4f} "
                            f"(lang={m['loss_language']:.4f} "
                            f"img_ar={m['loss_image_ar']:.4f})")
            if _any_rank(preempt.should_save(), sharded, device):
                if saving:
                    save(step)
                rank0_print("preemption: saved and exiting" if saving
                            else "preemption: exiting (saves are off)")
                break
            if saving and step % args.save_steps == 0:
                save(step)
    finally:
        it.close()
        metrics_log.close()

    if saving:
        save(step)
    return {"state": state, "step": step, "metrics": last_metrics}


def _rank_sum(n: int, sharded: bool, device) -> int:
    """n summed over the ranks."""
    if not sharded:
        return n
    t = torch.tensor([n], dtype=torch.int64, device=device)
    dist.all_reduce(t)
    return int(t.item())


def _any_rank(flag: bool, sharded: bool, device) -> bool:
    """True on every rank when it is True on one (a preemption signal
    reaches the ranks apart; the save that follows is collective)."""
    if not sharded:
        return flag
    t = torch.tensor([int(flag)], device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())
