"""Where the training step spends its time on the card.

Builds the stage-2 dual-loss step of `configs/stage2_finetune.json` cut to
one card (LLaMA-3.1-8B + SigLIP-SO400M, random bf16 weights from seed 0,
batch 1, one packed row with a prompt and an answer image, 4 image slots,
`save_attn_qkv`), takes two warm steps, times steps with the host clock
(forward + backward and the AdamW update apart), then profiles one more
step. Prints JSON lines: the wall times, the device's busy share, device
time by kernel group (flash forward, kernels C and D, GEMMs, the rest), and
the kernels that take the most device time.

    python -m metamorph_tpu_torch.train.profile_train [--steps 3] [--seq-len 4096] [--out DIR]

Needs a CUDA device; it refuses to run on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

from metamorph_tpu_torch.config import MetaMorphConfig
from metamorph_tpu_torch.constants import (IGNORE_INDEX, IM_END_TOKEN_ID,
                                           IM_START_TOKEN_ID,
                                           IMAGE_TOKEN_INDEX)
from metamorph_tpu_torch.convert import init_params
from metamorph_tpu_torch.inference.profile_serve import _kernel_table
from metamorph_tpu_torch.multimodal.packing import (PackedBatch,
                                                    batch_to_arrays,
                                                    pack_sequences)
from metamorph_tpu_torch.train.optimizer import make_optimizer
from metamorph_tpu_torch.train.train_step import init_train_state, loss_fn

STAGE2 = Path(__file__).resolve().parents[2] / "configs" / "stage2_finetune.json"
GROUPS = (("flash_fwd", ("flash_fwd_kernel",)),
          ("flash_bwd_dq", ("flash_bwd_dq_kernel",)),
          ("flash_bwd_dkv", ("flash_bwd_dkv_kernel",)),
          ("gemm", ("gemm", "nvjet", "xmma", "cutlass")))


def packed_row(T: int, K: int, n_slots: int, seed: int) -> PackedBatch:
    """One packed training row of T tokens: bos, text, a prompt image,
    text, then <image_start>, an answer image (K AR targets) and
    <image_end>, text, and 45 tokens of right padding."""
    rng = np.random.default_rng(seed)
    n_text = T - 2 * K - 8
    a, b = n_text // 4, n_text // 3
    c = n_text - a - b - 40

    def text(n):
        return rng.integers(10, 120000, n).tolist()

    prompt = [1] + text(a) + [IMAGE_TOKEN_INDEX] + text(b)
    answer = [IM_START_TOKEN_ID, IMAGE_TOKEN_INDEX, IM_END_TOKEN_ID] + text(c)
    labels = [IGNORE_INDEX] * len(prompt) + [IM_START_TOKEN_ID, 0,
                                             IM_END_TOKEN_ID] + answer[3:]
    return pack_sequences([prompt + answer], [labels], K, T, n_slots)


def stage2_one_card(seq_len: int = 4096) -> tuple:
    """(config, reductions) of the stage-2 finetune cut to one card."""
    cfg = MetaMorphConfig.from_json(STAGE2.read_text())
    reduced = dict(batch_size=1, max_seq_len=seq_len, max_images_per_batch=4,
                   total_steps=8, remat_policy="save_attn_qkv")
    return dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, **reduced)), reduced


def _group(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "other"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=3, help="steps timed")
    ap.add_argument("--seq-len", type=int, default=4096)
    ap.add_argument("--out", default=None,
                    help="directory for profile_train.json (kernel table)")
    args = ap.parse_args(argv)
    # as chip_smoke.py: the 8B step runs near the card's memory (the
    # setting is read when CUDA first initialises)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA device")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, _ = stage2_one_card(args.seq_len)
    T, N = cfg.train.max_seq_len, cfg.train.max_images_per_batch
    model = init_params(cfg, seed=0, device=dev, dtype=torch.bfloat16)
    state = init_train_state(model, cfg)
    tx = make_optimizer(cfg.train, model)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_to_arrays(
        packed_row(T, cfg.mm.num_image_tokens, N, seed=21)).items()}
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    s = cfg.siglip.image_size
    pixels = torch.randn((N, s, s, 3), generator=gen, device=dev)

    def step():
        """(forward + backward s, AdamW s) on the host clock."""
        for p in model.parameters():
            p.grad = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        total, _ = loss_fn(model, cfg, batch, pixels)
        total.backward()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        tx.update(model, state["opt_state"])
        torch.cuda.synchronize()
        return t1 - t0, time.perf_counter() - t1

    def note(msg):
        print(f"profile_train: {msg}", file=sys.stderr, flush=True)

    note("built; two warm steps")
    for _ in range(2):
        step()
    times = [step() for _ in range(args.steps)]
    note(f"timed {args.steps} steps; profiling one")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = _kernel_table(prof)
    dev_ms = sum(r["ms"] for r in kernels)
    groups = {g: 0.0 for g, _ in GROUPS + (("other", ()),)}
    for r in kernels:
        groups[_group(r["name"])] += r["ms"]
    fb = statistics.median(t for t, _ in times)
    opt = statistics.median(u for _, u in times)
    summary = {
        "device": torch.cuda.get_device_name(0),
        "seq_len": T,
        "fwd_bwd_s": fb,
        "adamw_s": opt,
        "step_s": fb + opt,
        "tokens_per_s": T / (fb + opt),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "profiled_step_ms": prof_wall_ms,
        "device_ms_per_step": dev_ms,
        "device_busy_share": dev_ms / prof_wall_ms,
        "kernel_launches_per_step": sum(r["calls"] for r in kernels),
        "device_ms_by_group": groups,
    }
    print(json.dumps(summary), flush=True)
    for r in kernels[:15]:
        print(json.dumps({"kernel": r["name"][:90], "calls": r["calls"],
                          "ms": r["ms"], "share": r["ms"] / dev_ms}),
              flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "profile_train.json"), "w") as f:
            json.dump({"summary": summary, "kernels": kernels}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
