"""Where the serving path spends its time on the card.

Builds the full-width engine (LLaMA-3.1-8B + SigLIP-SO400M, random bf16
weights from seed 0, 8 slots, 4096-token cache), admits 8 text requests,
then times steady decode ticks with the host clock and again under
torch.profiler. Prints JSON lines: admission and per-step wall times, the
device's busy share (kernel time over wall time), and the kernels that
take the most device time.

    python -m metamorph_tpu_torch.inference.profile_serve [--ticks 4] [--out DIR]
        [--spec-k 4] [--fill-chunk 256] [--kv-int8]

--kv-int8 serves from the int8 KV cache. --spec-k K routes every decode
tick through the speculative verify program (random weights accept almost
no drafts, so the engine's own routing would fall back to plain ticks; the
profile forces the spec program to show what one costs). --fill-chunk F
admits 6 short requests, then streams two 2048-token prompts through
chunked fill while they decode, and profiles those fill ticks.

The profiler records the card's kernels only (no host ops): the tables
read nothing else, and host events would stretch the profiled wall time
that the busy share divides by.

Needs a CUDA device; it refuses to run on the CPU. `profile_ticks` is the
same measurement on a model the caller built (`chip_smoke.py` 11b).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from metamorph_tpu_torch.config import MetaMorphConfig
from metamorph_tpu_torch.convert import init_params
from metamorph_tpu_torch.inference.serve import Request, ServeEngine
from metamorph_tpu_torch.kernels._build import LIBRARY

PROMPTS = (40, 300, 700, 1500, 77, 200, 120, 1000)
FILL_PROMPT = 2048

# kernel groups by name, for the per-tick breakdown
GROUPS = (("decode_attn", "decode_attn_kernel"),
          ("chunk_attn", "verify_attn_kernel"),
          ("chunk_fill", "chunk_fill_kernel"),
          ("flash_fwd", "flash_fwd_kernel"),
          ("gemm", ("gemm", "nvjet", "cutlass", "sm90_xmma", "gemv",
                    "w8_")))


def _kernel_table(prof) -> list:
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        rows.append({"name": e.key, "calls": e.count, "ms": us / 1e3})
    return sorted(rows, key=lambda r: -r["ms"])


def _groups(table, n: int) -> dict:
    """Device ms per tick step by kernel group (the rest is "other")."""
    out = {name: 0.0 for name, _ in GROUPS}
    out["other"] = 0.0
    for r in table:
        low = r["name"].lower()
        for name, keys in GROUPS:
            keys = (keys,) if isinstance(keys, str) else keys
            if any(k in low for k in keys):
                out[name] += r["ms"] / n
                break
        else:
            out["other"] += r["ms"] / n
    return out


def _profiled(fn):
    """(kernel table, wall ms) of fn() under the profiler, which records
    the card's kernels only."""
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return _kernel_table(prof), wall_ms


def profile_ticks(model, cfg, ticks: int = 4, spec_k: int = 0,
                  fill_chunk: int = 0, kv_int8: bool = False):
    """The engine (8 slots, 4096-token cache) on `model`'s device: one
    admission tick of PROMPTS, a warm tick, `ticks` decode ticks on the
    host clock and again under the profiler (and, with fill_chunk, the fill
    ticks of two long prompts). Returns (summary, [(phase, kernel table,
    device ms, steps)])."""
    dev = model.llama.embed.device
    eng = ServeEngine(model, cfg, n_slots=8, max_cache_len=4096,
                      spec_k=spec_k, fill_chunk=fill_chunk, kv_int8=kv_int8)
    if spec_k:
        eng.spec_overhead_frac = 0.0   # every decode tick runs the spec program
    rng = np.random.default_rng(0)
    budget = 8 * (2 * ticks + 10)
    prompts = PROMPTS[:6] if fill_chunk else PROMPTS
    for t in prompts:
        eng.submit(Request(prompt_ids=rng.integers(10, 128000, (t,)).astype(
            np.int32), max_new_tokens=budget, uid=t))
    LIBRARY.get()                  # build the kernels outside the timings
    torch.ones(8, 8, device=dev) @ torch.ones(8, 8, device=dev)
    admit, admit_wall_ms = _profiled(eng.step)  # one prefill per bucket
    admit_ms = sum(r["ms"] for r in admit)
    eng.step()                     # warm decode tick

    def run_ticks():
        for _ in range(ticks):
            eng.step()

    # tokens the rows produced, accepted drafts included (no row finishes
    # or is admitted inside the timed ticks)
    tok0 = int(eng.state.steps.sum())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_ticks()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    new_tokens = int(eng.state.steps.sum()) - tok0
    steps = ticks * eng.steps_per_sync
    step_ms = wall_s * 1e3 / steps
    kernels, prof_wall_ms = _profiled(run_ticks)
    dev_ms = sum(r["ms"] for r in kernels)
    summary = {
        "device": torch.cuda.get_device_name(0),
        "options": {"spec_k": eng.spec_k, "fill_chunk": eng.fill_chunk,
                    "kv_int8": kv_int8},
        "admit_tick_s": admit_wall_ms / 1e3,
        "admit_tick_device_ms": admit_ms,
        "admit_tick_flash_fwd_ms": sum(r["ms"] for r in admit
                                       if "flash_fwd_kernel" in r["name"]),
        "decode_tick_kind": "spec" if eng.spec_k else "plain",
        "decode_step_ms": step_ms,
        "decode_tok_per_s": new_tokens / wall_s,
        "profiled_step_ms": prof_wall_ms / steps,
        "device_ms_per_step": dev_ms / steps,
        "device_busy_share": dev_ms / prof_wall_ms,
        "device_ms_per_step_by_group": _groups(kernels, steps),
        "decode_attn_ms_per_step": sum(
            r["ms"] for r in kernels if "decode_attn_kernel" in r["name"])
            / steps,
        "kernel_launches_per_step": sum(r["calls"] for r in kernels) / steps,
        "spec_accepted": eng.spec_accepted,
    }
    tables = [("admit", admit, admit_ms, 1), ("decode", kernels, dev_ms,
                                              steps)]
    if fill_chunk:
        ids = rng.integers(10, 128000, (2, FILL_PROMPT)).astype(np.int32)

        def fill_window():
            for i in range(2):
                eng.submit(Request(prompt_ids=ids[i], max_new_tokens=1,
                                   uid=f"fill{i}"))
            while eng._fills or eng.pending:
                eng.step()

        n0 = eng.tick_counts["fill"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fill_window()
        torch.cuda.synchronize()
        fill_wall_ms = (time.perf_counter() - t0) * 1e3
        n_fill = eng.tick_counts["fill"] - n0
        for _ in range(2):             # harvest the two admitted rows
            eng.step()
        n0 = eng.tick_counts["fill"]
        fill_k, fill_prof_ms = _profiled(fill_window)
        n_fill_p = eng.tick_counts["fill"] - n0
        fill_steps = n_fill_p * eng.steps_per_sync
        fill_dev = sum(r["ms"] for r in fill_k)
        summary.update({
            "fill_prompt_tokens": FILL_PROMPT,
            "fill_ticks": n_fill,
            "fill_tick_ms": fill_wall_ms / max(n_fill, 1),
            "fill_step_ms": fill_wall_ms / max(n_fill * eng.steps_per_sync,
                                               1),
            "fill_profiled_tick_ms": fill_prof_ms / max(n_fill_p, 1),
            "fill_device_ms_per_step": fill_dev / max(fill_steps, 1),
            "fill_device_busy_share": fill_dev / fill_prof_ms,
            "fill_device_ms_per_step_by_group": _groups(fill_k,
                                                        max(fill_steps, 1)),
            "fill_kernel_launches_per_step": sum(r["calls"] for r in fill_k)
            / max(fill_steps, 1),
        })
        tables.append(("fill", fill_k, fill_dev, max(fill_steps, 1)))
    return summary, tables


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ticks", type=int, default=4,
                    help="decode ticks timed (each is steps_per_sync=8 steps)")
    ap.add_argument("--out", default=None,
                    help="directory for profile_serve.json (full kernel tables)")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculate spec_k-1 drafts per step; every decode "
                         "tick is a spec tick")
    ap.add_argument("--fill-chunk", type=int, default=0,
                    help="chunked fill: profile the fill ticks of two long "
                         "prompts")
    ap.add_argument("--kv-int8", action="store_true",
                    help="int8 KV cache")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve needs a CUDA device")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = MetaMorphConfig()
    model = init_params(cfg, seed=0, device=dev, dtype=torch.bfloat16)
    summary, tables = profile_ticks(model, cfg, args.ticks, args.spec_k,
                                    args.fill_chunk, args.kv_int8)
    print(json.dumps(summary), flush=True)
    for phase, table, total, n in tables:
        for r in table[:10]:
            print(json.dumps({"phase": phase, "kernel": r["name"][:90],
                              "calls": r["calls"], "ms_per_step": r["ms"] / n,
                              "share": r["ms"] / total}), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "profile_serve.json"), "w") as f:
            json.dump({"summary": summary,
                       "kernels": {p: t for p, t, _, _ in tables}}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
