"""Driver of a training cell: the port's accumulating train step
(`train/train_step.accum_train_step`), called as `trainer.train()` calls
it, on batches that the port's collation packs (`PackedCollator`, which
packs with `multimodal/native.pack`) on the port's `Prefetcher` thread
from the benchmark's seeded samples.

Set-up builds one train state and drives it through the first steps,
which the comparison reads: each step's loss, each leaf's gradient as
AdamW got it (its first moment after step 1, over 1 - b1), and each
leaf's change after step 3. The same state then runs the window. Once
the window has closed and the state is freed, the plain reference
(`benchmark/reference/train.py`) runs the same first steps.
"""

from __future__ import annotations

import gc
import itertools
import time

import numpy as np

from benchmark import traffic
from benchmark.runtime import Spans
from benchmark.weights import fill_model_

CHECK_STEPS = 3


def build_batches(ctx, mmcfg, plan):
    """An endless stream of (step index, batch arrays [n, 1, T], pixels
    [n, N, S, S, 3], real lengths, (real images, answer-image targets)),
    packed on the Prefetcher's thread."""
    from metamorph_tpu_torch.multimodal.packing import batch_to_arrays
    from metamorph_tpu_torch.train.data import PackedCollator
    from metamorph_tpu_torch.train.prefetch import Prefetcher

    tc = mmcfg.train
    collate = PackedCollator(num_image_tokens=mmcfg.mm.num_image_tokens,
                             max_seq_len=tc.max_seq_len,
                             num_image_slots=tc.max_images_per_batch,
                             image_size=mmcfg.siglip.image_size)

    def samples():
        for i in itertools.count():
            yield i, step_samples(ctx, mmcfg, plan, i)

    def pack(item):
        i, smp = item
        arrays, pixels = [], []
        for s in smp:
            inst = dict(input_ids=s["input_ids"], labels=s["labels"],
                        pixels=s["pixels"])
            packed, px = collate([inst])
            arrays.append(batch_to_arrays(packed))
            pixels.append(px)
        stacked = {k: np.stack([a[k] for a in arrays]) for k in arrays[0]}
        lens = [int(a["attn_mask"].sum()) for a in arrays]
        images = sum(s["pixels"] is not None for s in smp)
        ar = int(sum(a["image_ar_mask"].sum() for a in arrays))
        return i, stacked, np.stack(pixels), lens, (images, ar)

    return Prefetcher(samples(), depth=2, transform=pack)


def step_samples(ctx, mmcfg, plan, i):
    """The raw samples of step i: planned step i (the plan's order is the
    same for every seed, so every window does the same work), its rows in
    the seed's order, their ids and pixels drawn from the seed."""
    rows = plan[i % len(plan)]
    order = traffic.rng_for(ctx.seed, "rows", i).permutation(len(rows))
    return [traffic.sample(rows[j], ctx.seed, i * len(rows) + k,
                           mmcfg.siglip.image_size)
            for k, j in enumerate(order)]


def run(ctx) -> dict:
    torch = ctx.torch
    from metamorph_tpu_torch.config import MetaMorphConfig
    from metamorph_tpu_torch.models.metamorph import MetaMorph
    from metamorph_tpu_torch.train.optimizer import make_optimizer
    from metamorph_tpu_torch.train.train_step import (accum_train_step,
                                                       init_train_state)

    dev, mix = ctx.device, ctx.traffic
    mmcfg = MetaMorphConfig.from_dict(ctx.config)
    plan = traffic.train_plan(mix, mix["planned_steps"])
    b1 = mmcfg.train.adam_b1

    with torch.no_grad():
        model = MetaMorph(mmcfg, dtype=torch.bfloat16, device=dev)
        fill_model_(model, ctx.config, ctx.seed)
    state = init_train_state(model, mmcfg)
    tx = make_optimizer(mmcfg.train, model)
    batches = build_batches(ctx, mmcfg, plan)
    spans = Spans()
    steps = []

    def one_step(traced=False):
        s0 = time.perf_counter_ns()
        i, arrays, pixels, lens, (images, ar) = next(batches)
        s1 = time.perf_counter_ns()
        spans.add("data wait", s0, s1)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}
        px = torch.from_numpy(pixels).to(dev)
        s2 = time.perf_counter_ns()
        spans.add("batch to card", s1, s2)
        _, metrics = accum_train_step(state, batch, px, mmcfg, tx)
        s3 = time.perf_counter_ns()
        spans.add("accum_train_step", s2, s3)
        loss = float(metrics["loss"])           # the step's end
        s4 = time.perf_counter_ns()
        spans.add("wait for the card", s3, s4)
        steps.append(dict(t0=s0, t1=s4, lens=lens, images=images,
                          ar_targets=ar, traced=traced, index=i))
        return loss

    # -- set-up: the first steps, read for the comparison -------------------
    losses, grad_norms = [], {}
    trainable = [n for n, p in model.named_parameters() if p.requires_grad]
    for k in range(CHECK_STEPS):
        losses.append(one_step())
        if k == 0:
            mu = state["opt_state"]["mu"]
            grad_norms = {n: float(mu[n].float().norm()) / (1 - b1)
                          for n in trainable}
            del mu
            ctx.log(f"step 1 peak {torch.cuda.max_memory_allocated() / 2**30:.2f}"
                    f" GiB" if dev.type == "cuda" else "step 1 done")
    from benchmark.reference.train import change_norms
    named = dict(model.named_parameters())
    changes = change_norms(ctx.config, ctx.seed, named, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    ctx.log(f"set-up steps' losses {losses}")

    # -- the window --------------------------------------------------------------
    tracer = None
    profile_at = mix.get("trace", {}).get("profile_steps", [2, 3])
    if ctx.trace:
        from benchmark.trace import DeviceTrace
        tracer = DeviceTrace(torch)
        tracer.warm()
    t0 = time.perf_counter()
    ctx.mark_measured(t0)
    n0 = len(steps)
    k = 0
    while True:
        traced = tracer is not None and k in profile_at
        if traced and k == profile_at[0]:
            tracer.start()
        one_step(traced)
        if traced and k == profile_at[-1]:
            tracer.stop()
        k += 1
        if time.perf_counter() - t0 >= ctx.seconds and k > profile_at[-1]:
            break
    t_end = time.perf_counter()
    window = steps[n0:]
    tokens = sum(sum(s["lens"]) for s in window)
    peak = (torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0)
    e2e = {"train_tok_per_s": tokens / (t_end - t0)}
    step_s = [(s["t1"] - s["t0"]) / 1e9 for s in window]
    ctx.log(f"window {t_end - t0:.2f} s: {len(window)} steps, {tokens} real "
            f"tokens of {len(window) * mix['microbatches'] * mmcfg.train.max_seq_len} "
            f"positions; step s median {float(np.median(step_s)):.3f}")
    records = dict(kind="train", config=ctx.config, steps=window,
                   spans=spans.items,
                   trace=tracer.record() if tracer is not None else None)
    program = dict(losses=losses, grad_norms=grad_norms, changes=changes)
    result = dict(attempted=len(window), failed=0, e2e=e2e, records=records,
                  memory_peak_bytes=peak, tracer=tracer, spans=spans.items,
                  program=program)
    del state, model, tx, named, batches
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    first = [step_samples(ctx, mmcfg, plan, i) for i in range(CHECK_STEPS)]
    result["judge"] = lambda modes=("fp32",), **kw: judge(
        ctx, first, program, modes, **kw)
    return result


def readings(program: dict, ref: dict) -> dict:
    """The numbers compared, from the program's and a reference's first
    steps: the widest relative gap of a step's loss; by the worst leaf, the
    gap of the first gradient's norm and of the change's norm after the
    steps, each against the reference's norm of that leaf or of the median
    leaf, whichever is larger. Leaves whose reference gradient is under a
    thousandth of the median leaf's are left out of the change."""
    loss = max(abs(a - b) / abs(b)
               for a, b in zip(program["losses"], ref["losses"]))
    g_ref = ref["grad_norms"]
    g_med = float(np.median(list(g_ref.values())))
    grad = max(abs(program["grad_norms"][n] - g) / max(g, g_med)
               for n, g in g_ref.items())
    c_ref = {n: c for n, c in ref["changes"].items()
             if g_ref.get(n, 0.0) >= 1e-3 * g_med}
    c_med = float(np.median(list(c_ref.values())))
    worst, change = None, 0.0
    for n, c in c_ref.items():
        gap = abs(program["changes"][n] - c) / max(c, c_med, 1e-30)
        if gap >= change:
            worst, change = n, gap
    return dict(loss_gap=loss, grad_norm_gap=grad, change_norm_gap=change,
                worst_change_leaf=worst,
                left_out=len(ref["changes"]) - len(c_ref))


def reference_run(ctx, first, mode="fp32", rows=None):
    """The reference's first steps: losses, step 1's leaf gradient norms
    and the leaf changes after the last; `rows` keeps that many
    microbatches of each step (a fault: part of the batch left out)."""
    from benchmark.reference.precision import fp32_only
    from benchmark.reference.train import RefTrainer

    fp32_only()
    ref = RefTrainer(ctx.config, ctx.seed, ctx.device, mode)
    losses, grads = [], {}
    for k, smp in enumerate(first):
        out = ref.step(smp[:rows] if rows else smp)
        losses.append(out["loss"])
        if k == 0:
            grads = out["grad_norms"]
    changes = ref.change_norms(ctx.seed)
    del ref
    gc.collect()
    if ctx.device.type == "cuda":
        ctx.torch.cuda.empty_cache()
    return dict(losses=losses, grad_norms=grads, changes=changes)


def judge(ctx, first, program, modes=("fp32",), faults=()) -> dict:
    """The program's readings against the float32 reference; with
    `modes`, the control's (the reference in a lower precision put in the
    program's place); with `faults` ("half_batch"), the reference with
    that fault planted, in the program's place."""
    ref = reference_run(ctx, first)
    out = readings(program, ref)
    out["ref_losses"] = ref["losses"]
    for mode in modes:
        if mode != "fp32":
            r = readings(reference_run(ctx, first, mode), ref)
            out.update({f"control_{mode}_{k}": v for k, v in r.items()})
    for fault in faults:
        if fault == "half_batch":
            n = ctx.traffic["microbatches"] // 2
            r = readings(reference_run(ctx, first, rows=n), ref)
            out.update({f"fault_{fault}_{k}": v for k, v in r.items()})
    return out
