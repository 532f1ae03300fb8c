"""The sharded path across cards (NCCL), one process per card:

    torchrun --nproc_per_node 4 -m metamorph_tpu_torch.parallel.check_cards

and the same code on the CPU over gloo, at a small size, as a rehearsal:

    torchrun --nproc_per_node 4 -m metamorph_tpu_torch.parallel.check_cards \
        --device cpu --small

1. ring: ring attention over all ranks, each holding T_loc positions of
   one row (on the card `configs/longctx_sp.json`'s chunk: T_loc = 2,048,
   H = 32, KV = 8, Dh = 128, bf16), forward and backward with a seeded
   cotangent. Rank 0 holds the gathered o, dq, dk and dv against one
   causal call over the whole sequence (kernels A, C and D on the card):
   o within 2e-2 of each row's max |ref|, each gradient within 3e-2 of its
   tensor's max |ref| (the kernels' own tolerances). Times the ring and the
   one call.
2. exchange: the ring's traffic (`ring_attention._Exchange`): a rank's K/V
   chunk sent to each other rank and theirs received, in bf16 as the ring
   sends them and in fp32, ms and bytes per rank.
3. step: `make_sharded_train_step` on a narrow model (2 layers of width
   512) over (data 2, fsdp 2) and over (fsdp 4) with the sequence split
   and remat (`configs/longctx_sp.json`'s form),
   three steps of a 4-row global batch (the first at the warm-up's lr 0),
   against the one-card step on rank 0
   on the whole batch: the token counts exact, the losses within 1e-2 and
   the grad norms within 5e-2 relative. Products over another number of
   rows round differently in bf16, and the gradients are summed in bf16
   across the cards; the CPU tests hold the same code to the JAX package
   at 1e-5 in fp32.

Rank 0 prints one JSON line (and writes it to --out); the exit code is
nonzero when a check failed.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from metamorph_tpu_torch.config import (LlamaConfig, MeshConfig,
                                        MetaMorphConfig, MultimodalConfig,
                                        SiglipConfig, TrainConfig)
from metamorph_tpu_torch.constants import (IGNORE_INDEX, IM_END_TOKEN_ID,
                                           IM_START_TOKEN_ID,
                                           IMAGE_TOKEN_INDEX)
from metamorph_tpu_torch.ops import flash_attention as fa
from metamorph_tpu_torch.parallel import context
from metamorph_tpu_torch.parallel import mesh as mesh_lib
from metamorph_tpu_torch.parallel import ring_attention as R

O_TOL, BWD_TOL = 2e-2, 3e-2
LOSS_RTOL, NORM_RTOL = 1e-2, 5e-2


def _ms(fn, dev, reps: int, together: bool = True) -> float:
    """Median ms of fn() over `reps` calls after one warm-up; `together`:
    every rank calls it, and each call starts on all ranks at once."""
    fn()
    out = []
    for _ in range(reps):
        if together:
            dist.barrier()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t = time.perf_counter()
        fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        out.append(1e3 * (time.perf_counter() - t))
    return statistics.median(out)


def _gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts, dim)


def _max_over_ranks(x: float, dev) -> float:
    t = torch.tensor([x], dtype=torch.float64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t.item())


def check_ring(dev, small: bool, reps: int) -> dict:
    n, me = dist.get_world_size(), dist.get_rank()
    B, C, H, KV, Dh = (1, 64, 4, 2, 64) if small else (1, 2048, 32, 8, 128)
    dtype = torch.float32 if dev.type == "cpu" else torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(14)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    q, k, v, do = (randn(B, n * C, H, Dh), randn(B, n * C, KV, Dh),
                   randn(B, n * C, KV, Dh), randn(B, n * C, H, Dh))
    sl = slice(me * C, (me + 1) * C)
    group = dist.group.WORLD
    kernels = (fa.FLASH_FWD, fa.FLASH_BWD_DQ, fa.FLASH_BWD_DKV)

    def ring():
        x = [t[:, sl].clone().requires_grad_() for t in (q, k, v)]
        o = R.ring_attention(*x, group)
        o.backward(do[:, sl])
        return [o.detach()] + [t.grad for t in x]

    before = [kern.launches for kern in kernels]
    got = [_gather(t, 1) for t in ring()]
    launches = [kern.launches - b for kern, b in zip(kernels, before)]
    ring_ms = _max_over_ranks(_ms(ring, dev, reps), dev)
    out = {"shape": dict(B=B, T=n * C, T_loc=C, H=H, KV=KV, Dh=Dh,
                         dtype=str(dtype)),
           "launches_rank": launches, "ring_ms": ring_ms}
    ok = True
    if me == 0:
        def whole():
            x = [t.clone().requires_grad_() for t in (q, k, v)]
            o = fa.flash_attention(*x, causal=True)
            o.backward(do)
            return [o.detach()] + [t.grad for t in x]

        ref = whole()
        diff = (got[0].float() - ref[0].float()).abs().amax(-1)
        rows = ref[0].float().abs().amax(-1).clamp_min(1e-3)
        errs = {"o": (diff / rows).max().item()}
        for name, a, r in zip(("dq", "dk", "dv"), got[1:], ref[1:]):
            errs[name] = ((a.float() - r.float()).abs().max()
                          / r.float().abs().max()).item()
        ok = errs["o"] <= O_TOL and all(errs[x] <= BWD_TOL
                                        for x in ("dq", "dk", "dv"))
        if dev.type == "cuda":
            # rank 0's only chunk is its diagonal: one of each kernel
            ok = ok and launches == [1, 1, 1]
        out.update(rel_err=errs,
                   one_call_ms=_ms(whole, dev, reps, together=False))
    dist.barrier()
    out["ok"] = ok
    return out


def check_exchange(dev, small: bool, reps: int) -> dict:
    n = dist.get_world_size()
    B, C, KV, Dh = (1, 64, 2, 64) if small else (1, 2048, 8, 128)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        kv = [torch.ones((B, C, KV, Dh), dtype=dtype, device=dev)
              for _ in range(2)]
        sends = [(t, i) for i in range(1, n) for t in kv]
        ms = _max_over_ranks(_ms(lambda: R._permute(sends, dist.group.WORLD),
                                 dev, reps), dev)
        sent = sum(t.numel() * t.element_size() for t, _ in sends)
        out[str(dtype).split(".")[-1]] = {
            "ms": ms, "bytes_sent_per_rank": sent,
            "GB_per_s_per_rank": sent / ms / 1e6}
    return out


def step_cfg(small: bool) -> MetaMorphConfig:
    width = 128 if small else 512
    return MetaMorphConfig(
        llama=LlamaConfig(hidden_size=width, intermediate_size=2 * width,
                          num_layers=2, num_heads=4, num_kv_heads=1,
                          head_dim=width // 4, vocab_size=128258),
        siglip=SiglipConfig.tiny(), mm=MultimodalConfig(num_image_tokens=4),
        train=TrainConfig(batch_size=4, max_seq_len=256 if small else 1024,
                          max_images_per_batch=4, learning_rate=1e-3,
                          total_steps=3, remat=False))


def global_rows(T: int, seed: int = 0):
    """Four rows of uneven length; rows 0 and 2 end with an answer image."""
    rng = np.random.default_rng(seed)
    ids, labs = [], []
    for b in range(4):
        n = int(rng.integers(T // 8, T // 2))
        text = rng.integers(10, 120000, n).tolist()
        ids.append([1] + text)
        labs.append([IGNORE_INDEX] * (1 + n // 2) + text[n // 2:])
        if b % 2 == 0:
            tail = rng.integers(10, 120000, 8).tolist()
            ids[-1] += [IM_START_TOKEN_ID, IMAGE_TOKEN_INDEX,
                        IM_END_TOKEN_ID] + tail
            labs[-1] += [IM_START_TOKEN_ID, 0, IM_END_TOKEN_ID] + tail
    pixels = rng.normal(size=(4, 28, 28, 3)).astype(np.float32)
    return ids, labs, pixels


def _inputs(cfg, dev, idx: int, count: int):
    from metamorph_tpu_torch.multimodal.packing import (batch_to_arrays,
                                                        pack_sequences)

    ids, labs, pixels = global_rows(cfg.train.max_seq_len)
    sl = slice(idx * 4 // count, (idx + 1) * 4 // count)
    arrays = batch_to_arrays(pack_sequences(
        ids[sl], labs[sl], cfg.mm.num_image_tokens, cfg.train.max_seq_len,
        cfg.train.max_images_per_batch // count))
    return ({k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
             for k, v in arrays.items()},
            torch.from_numpy(pixels[sl]).to(dev))


def check_step(dev, small: bool) -> dict:
    from metamorph_tpu_torch.convert import init_params
    from metamorph_tpu_torch.train import train_step as TS
    from metamorph_tpu_torch.train.optimizer import make_optimizer

    dtype = torch.float32 if dev.type == "cpu" else torch.bfloat16
    base = step_cfg(small)
    keys = ("loss", "n_text_tokens", "n_image_ar_tokens", "grad_norm")
    ref = None
    if dist.get_rank() == 0:
        model = init_params(base, seed=0, device=dev, dtype=dtype)
        state = TS.init_train_state(model, base)
        tx = make_optimizer(base.train, model)
        batch, pixels = _inputs(base, dev, 0, 1)
        ref = [{k: float(m[k]) for k in keys} for m in
               (TS.train_step(state, batch, pixels, base, tx)[1]
                for _ in range(3))]
        del model, state, tx
    out = {"ok": True}
    for name, mesh_shape, sp in (("dp2_fsdp2", (2, 2, 1), False),
                                 ("fsdp4_sp_remat", (1, 4, 1), True)):
        # with the sequence split, remat as configs/longctx_sp.json: the
        # recompute exchanges the ring's chunks again
        cfg = dataclasses.replace(
            base, mesh=MeshConfig(*mesh_shape),
            train=dataclasses.replace(base.train, sequence_parallel=sp,
                                      remat=sp))
        mesh = mesh_lib.build_mesh(cfg.mesh, dev.type)
        idx, count = mesh_lib.dp_coordinate(mesh, sp)
        model = init_params(cfg, seed=0, device=dev, dtype=dtype)
        step, _, state = TS.make_sharded_train_step(cfg, mesh, model)
        batch, pixels = _inputs(cfg, dev, idx, count)
        got = [{k: float(m[k]) for k in keys} for m in
               (step(state, batch, pixels)[1] for _ in range(3))]
        context.set_current_mesh(None)
        context.set_sequence_axis(None)
        del model, state
        if ref is None:
            continue
        rel = {k: max(abs(g[k] - r[k]) / max(abs(r[k]), 1e-30)
                      for g, r in zip(got, ref)) for k in keys}
        ok = (rel["n_text_tokens"] == 0 and rel["n_image_ar_tokens"] == 0
              and rel["loss"] <= LOSS_RTOL and rel["grad_norm"] <= NORM_RTOL)
        out[name] = {"rel_err": rel, "losses": [g["loss"] for g in got],
                     "ok": ok}
        out["ok"] = out["ok"] and ok
    if ref is not None:
        out["one_card_losses"] = [r["loss"] for r in ref]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    p.add_argument("--small", action="store_true")
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--out", default=None, help="also write the JSON here")
    args = p.parse_args(argv)
    from metamorph_tpu_torch.train.trainer import rank_device

    dev = rank_device(args.device)
    mesh_lib.init_distributed(dev.type, device=dev)
    try:
        n = dist.get_world_size()
        result = {"world": n, "backend": dist.get_backend()}
        if dev.type == "cuda":
            result["device"] = torch.cuda.get_device_name(dev)
        result["ring"] = check_ring(dev, args.small, args.reps)
        result["exchange"] = check_exchange(dev, args.small, args.reps)
        result["step"] = check_step(dev, args.small)
        ok = torch.tensor([int(result["ring"]["ok"]
                               and result["step"]["ok"])], device=dev)
        dist.all_reduce(ok, op=dist.ReduceOp.MIN)
        result["ok"] = bool(ok.item())
        if dist.get_rank() == 0:
            line = json.dumps(result)
            print(line, flush=True)
            if args.out:
                os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                            exist_ok=True)
                with open(args.out, "w") as f:
                    f.write(line + "\n")
        return 0 if result["ok"] else 1
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
