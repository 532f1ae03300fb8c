"""Readings that set a cell's limits and rate, made on the card in one
process (set-up is long, so the seeds share it). Not part of a benchmark
run.

    python3 -m benchmark.calibrate --workload W --seeds 1,2,3 [--seconds S]
        [--control fp8] [--faults half_batch] [--out FILE]
    python3 -m benchmark.calibrate --workload W --seeds 1 --rates 3,4,5 [--seconds S]

With --seeds, each seed runs the cell as a benchmark run does (set-up,
a window of --seconds, the reference), and prints the program's readings
and, with --control, those of the reference put in the program's place one
precision lower, and with --faults, those of the reference with the fault
planted. With --rates (a serving cell), one set-up serves a window at each
rate in turn and prints its latencies, throughput and backlog: the sweep
that finds the highest rate the cell sustains.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time

from benchmark import runtime, spec as spec_lib
from benchmark.run import make_ctx


def _emit(out, row):
    line = json.dumps(row)
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--control", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--rates", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    runtime.set_cache_dirs()
    cell = spec_lib.cell(spec_lib.load_spec(), args.workload)
    seconds = args.seconds or spec_lib.load_spec()["run_seconds"]
    import torch

    if not torch.cuda.is_available():
        runtime.log("calibrate needs a CUDA device")
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(0)
    runtime.log(runtime.power_limit())
    seeds = [int(s) for s in args.seeds.split(",")]
    drv = spec_lib.driver(cell["traffic"]["driver"])
    if args.rates:
        ctx = make_ctx(torch, dev, cell, seeds[0], seconds, False)
        sess = drv.Session(ctx)
        for rate in [float(r) for r in args.rates.split(",")]:
            mix = copy.deepcopy(cell["traffic"])
            mix["arrivals"]["rate_per_s"] = rate
            t = time.perf_counter()
            res = drv.measure(ctx, sess, mix, seconds, False)
            _emit(args.out, dict(workload=args.workload, rate=rate,
                                 **res["e2e"], **res["sweep"],
                                 wall_s=time.perf_counter() - t))
        sess.free()
        return 0
    modes = ("fp32",) + tuple(m for m in args.control.split(",") if m)
    faults = tuple(f for f in args.faults.split(",") if f)
    for seed in seeds:
        ctx = make_ctx(torch, dev, cell, seed, seconds, False)
        t = time.perf_counter()
        res = drv.run(ctx)
        kw = dict(faults=faults) if faults else {}
        r = res["judge"](modes, **kw)
        _emit(args.out, dict(workload=args.workload, seed=seed,
                             e2e=res["e2e"], readings=r,
                             memory_peak_bytes=res["memory_peak_bytes"],
                             wall_s=time.perf_counter() - t))
        torch.cuda.empty_cache()
    if runtime.forbidden_modules():
        runtime.log(f"loaded: {runtime.forbidden_modules()}")
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
