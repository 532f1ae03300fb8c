"""Run one cell of the benchmark and print its result as the last line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

One run is one process: it loads the cell's files, makes the weights and
inputs from --seed on the card, warms the cell's own shapes, measures for
--seconds, then frees the program's state and runs the comparison that
decides `correct`. With --trace 0 the line's metrics are the cell's
end-to-end metrics, with --trace 1 its per-layer metrics (read from the
same window, a slice of it under the profiler). The numbers compared and
their limits are the last lines on standard error and the last key of the
result line. A run that finds no card, or fewer than the cell asks for,
fails without a result; so does one that has loaded JAX or the JAX
package.
"""

from __future__ import annotations

import time

T_TOP = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

from benchmark import runtime, spec as spec_lib  # noqa: E402


def _process_age() -> float:
    """Seconds between this process's start and T_TOP (interpreter
    start-up), from /proc; 0 where /proc has no answer."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        import os
        return max(up - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


T_START = T_TOP - _process_age()


def make_ctx(torch, device, cell: dict, seed: int, seconds: float,
             trace: bool, log=runtime.log) -> SimpleNamespace:
    ctx = SimpleNamespace(torch=torch, device=device, config=cell["config"],
                          traffic=cell["traffic"], limits=cell["limits"],
                          seed=seed, seconds=seconds, trace=trace, log=log,
                          t_measured=None)

    def mark_measured(t):
        ctx.t_measured = t

    ctx.mark_measured = mark_measured
    return ctx


def compare(readings: dict, limits: dict) -> dict:
    """{name: {value, limit}} for each limited number; a number the
    readings lack, or that is not finite, reads as 1e30 (over any
    limit)."""
    out = {}
    for name, limit in limits.get("limits", {}).items():
        v = readings.get(name)
        v = float(v) if v is not None and math.isfinite(float(v)) else 1e30
        out[name] = {"value": v, "limit": float(limit)}
    return out


def per_layer(cell: dict, records: dict) -> dict:
    out = {}
    for m in cell["per_layer"]:
        v = spec_lib.metric(m["name"]).read(records)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def run_cell(ctx, cell: dict, device_info: dict) -> dict:
    """Drive the cell, judge it, and assemble the result line."""
    drv = spec_lib.driver(cell["traffic"]["driver"])
    res = drv.run(ctx)
    readings = res["judge"]()
    compared = compare(readings, ctx.limits)
    correct = bool(compared) and all(
        c["value"] <= c["limit"] for c in compared.values())
    ctx.log("readings " + json.dumps({k: v for k, v in readings.items()
                                      if not isinstance(v, (list, dict))}))
    device = dict(device_info, memory_peak_bytes=int(res["memory_peak_bytes"]))
    line = dict(correct=correct, attempted=res["attempted"],
                failed=res["failed"])
    if ctx.trace:
        tracer = res["tracer"]
        line["metrics"] = per_layer(cell, res["records"])
        if tracer is not None:
            from benchmark.trace import breakdown
            device.update(busy_s=tracer.busy_s(), window_s=tracer.window_s)
            line["breakdown"] = breakdown(res["records"]["trace"],
                                          res["spans"])
    else:
        units = {m["name"]: m["unit"] for m in cell["end_to_end"]}
        line["metrics"] = {k: {"value": float(v), "unit": units[k]}
                           for k, v in res["e2e"].items() if k in units}
        line["metrics"]["setup_s"] = {"value": ctx.t_measured - T_START,
                                      "unit": units["setup_s"]}
    ctx.log(f"setup_s {ctx.t_measured - T_START:.3f}; memory peak "
            f"{device['memory_peak_bytes'] / 2**30:.2f} GiB")
    line["device"] = device
    line["compared"] = compared
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    runtime.set_cache_dirs()
    cell = spec_lib.cell(spec_lib.load_spec(), args.workload)
    chips = cell["workload"]["chips"]

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        runtime.log(f"needs {chips} CUDA device(s); found "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    torch.set_num_threads(4)
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    runtime.log(f"{runtime.power_limit()}; torch {torch.__version__}, "
                f"CUDA {torch.version.cuda}")
    info = dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                count=chips)
    ctx = make_ctx(torch, dev, cell, args.seed, args.seconds,
                   bool(args.trace))
    line = run_cell(ctx, cell, info)
    found = runtime.forbidden_modules()
    if found:
        runtime.log(f"loaded modules of JAX or the JAX package: {found}")
        return 3
    for name, c in line["compared"].items():
        runtime.log(f"compared {name} = {c['value']!r} (limit {c['limit']!r})")
    sys.stdout.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
