"""The program's own phases in a cell: its spans (`serve.*`, `train.*`,
recorded by `metamorph_tpu_torch/utils/trace.py` on the host clock),
laid against the device trace of a `--trace 1` run, so each idle gap is
put down to the phase the host was in.

    python3 -m benchmark.phases --workload <cell> --seed <n> --seconds <s> \
        [--spans 0|1] [--out FILE]

runs the cell's own window as a `--trace 1` run does (the same
traced slice), with the program's tracer on from the window's
start (`--spans 1`) or off (`--spans 0`, for what the tracer costs), and
prints one JSON line: the phase readings below, the cell's per-layer
metrics read from the same run, the idle time by phase, and how much of
each tick or step its phases cover. It judges nothing (`benchmark.run`
does). `--out` also writes the spans and the trace's gaps there.

The readers take a window's records, with two more keys:
`program_spans` (`trace.drain()`) and, in the trace, `launches` (for
each device operation of `events`, the host time of the runtime call
that launched it, or None).
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict
from typing import Dict, List, Optional

from benchmark import runtime, spec as spec_lib
from benchmark.trace import DeviceTrace

LAUNCH_PREFIXES = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset")


class LaunchTrace(DeviceTrace):
    """The device trace that also keeps, for each device operation, the
    host time of the runtime call that launched it (by the profiler's
    correlation id), on the same aligned clock. `stop()` only keeps the
    profile; `record()`, called once the window is over, pairs
    the launches, so the open loop waits no longer at the slice's end
    than under the plain trace."""

    def __init__(self, torch):
        super().__init__(torch)
        self._results = None

    def stop(self) -> None:
        prof = self.prof
        super().stop()
        self._results = prof.profiler.kineto_results

    def launches(self) -> List[Optional[int]]:
        cuda = self.torch.autograd.DeviceType.CUDA
        kernels, calls = {}, {}
        for e in self._results.events():
            if e.device_type() == cuda:
                kernels[(e.start_ns(), e.duration_ns(), e.name())] = \
                    e.correlation_id()
            elif e.name().startswith(LAUNCH_PREFIXES):
                calls[e.correlation_id()] = e.start_ns()
        # the offset DeviceTrace.stop() took: from the marker kernel
        first = sorted(kernels)[:8]
        off = next((k for k in first if "fill" in k[2].lower()),
                   first[0])[0] - self._t_mark
        out = []
        for name, s, d in self.events:
            t = calls.get(kernels.get((s + off, d, name)))
            out.append(None if t is None else t - off)
        return out

    def record(self) -> dict:
        return dict(super().record(), launches=self.launches())


# -- readers -----------------------------------------------------------------

def _spans(records, name=None) -> List[dict]:
    return [s for s in records.get("program_spans") or ()
            if s["t1"] is not None and (name is None or s["name"] == name)]


def _slice_t0(records) -> float:
    rec = records.get("trace")
    return rec["t0"] if rec is not None else float("inf")


def _mean_ms(durations) -> Optional[float]:
    return sum(durations) / len(durations) / 1e6 if durations else None


def decode_host_ms(records) -> Optional[float]:
    """Host ms a decode step: each `serve.decode` span over its steps,
    the mean over the ticks before the traced slice."""
    until = _slice_t0(records)
    per_step = [(s["t1"] - s["t0"]) / s["attrs"]["steps"]
                for s in _spans(records, "serve.decode") if s["t1"] < until]
    return _mean_ms(per_step)


def admit_host_ms(records) -> Optional[float]:
    """Host ms of one blocking admission (`serve.admit`), the mean before
    the traced slice."""
    until = _slice_t0(records)
    return _mean_ms([s["t1"] - s["t0"] for s in _spans(records, "serve.admit")
                     if s["t1"] < until])


def harvest_host_ms(records) -> Optional[float]:
    """Host ms of a tick's harvest (`serve.harvest`, its wait on the
    snapshot included), the mean over the ticks before the slice."""
    until = _slice_t0(records)
    return _mean_ms([s["t1"] - s["t0"]
                     for s in _spans(records, "serve.harvest")
                     if s["t1"] < until])


def prefill_pad_pct(records) -> Optional[float]:
    """Padding's share of the positions the blocking admissions ran
    (`serve.admit`: bucket x rows, less the rows' lengths) before the
    traced slice, in %."""
    until = _slice_t0(records)
    admits = [s["attrs"] for s in _spans(records, "serve.admit")
              if s["t1"] < until]
    pos = sum(a["bucket"] * a["rows"] for a in admits)
    tok = sum(n for a in admits for n in a["lens"])
    return 100.0 * (pos - tok) / pos if pos else None


def innermost(spans: List[dict], t: int) -> Optional[dict]:
    """The span open at host time t that opened last (the deepest)."""
    best = None
    for s in spans:
        if s["t0"] <= t < s["t1"] and (best is None or s["t0"] >= best["t0"]):
            best = s
    return best


def _chain(s: dict, by_id: Dict[int, dict]) -> List[str]:
    """The names of s and the spans around it, innermost first."""
    out = []
    while s is not None:
        out.append(s["name"])
        s = by_id.get(s["parent"])
    return out


def idle_by_phase(records) -> Optional[Dict[str, float]]:
    """The traced slice's idle ns by the program span the host was in
    at each gap's middle, as 'outer > inner' names; outside the
    program's spans, by the benchmark's ('bench: tick'), else 'between
    calls'."""
    rec = records.get("trace")
    spans = _spans(records)
    if rec is None or not spans:
        return None
    lo, hi = rec["t0"], rec["t1"]
    near = [s for s in spans if s["t1"] >= lo and s["t0"] <= hi]
    by_id = {s["id"]: s for s in near}
    out = defaultdict(float)
    for a, b in rec["gaps"]:
        mid = (a + b) // 2
        s = innermost(near, mid)
        if s is not None:
            key = " > ".join(reversed(_chain(s, by_id)))
        else:
            key = next((f"bench: {sp['name']}"
                        for sp in records.get("spans", ())
                        if sp["t0"] <= mid < sp["t1"]), "between calls")
        out[key] += b - a
    return dict(out)


def idle_in_pct(records, names) -> Optional[float]:
    """% of the traced slice idle while the host was inside a span named
    in `names` (at any depth: a child's gaps count for its parent)."""
    split = idle_by_phase(records)
    if split is None:
        return None
    rec = records["trace"]
    ns = sum(v for k, v in split.items()
             if any(n in names for n in k.split(" > ")))
    return 100.0 * ns / (rec["t1"] - rec["t0"])


def _window_steps(records, traced: bool) -> List[dict]:
    return [s for s in records.get("steps", ()) if s["traced"] == traced]


def _within(spans, lo, hi) -> List[dict]:
    return [s for s in spans if lo <= s["t0"] and s["t1"] <= hi]


def optimizer_host_ms(records) -> Optional[float]:
    """Host ms of `train.optimizer`, the mean over the window's untraced
    steps."""
    opt = _spans(records, "train.optimizer")
    return _mean_ms([s["t1"] - s["t0"] for st in _window_steps(records, False)
                     for s in _within(opt, st["t0"], st["t1"])])


def optimizer_device_ms(records) -> Optional[float]:
    """Device ms a traced step of the operations launched while the host
    was inside `train.optimizer`. None without launch records."""
    rec = records.get("trace")
    steps = _window_steps(records, True)
    if rec is None or not steps or not rec.get("launches"):
        return None
    opt = _spans(records, "train.optimizer")
    if not opt or all(t is None for t in rec["launches"]):
        return None
    ns = 0
    for (_, _, d), t in zip(rec["events"], rec["launches"]):
        if t is not None and any(s["t0"] <= t < s["t1"] for s in opt):
            ns += d
    return ns / 1e6 / len(steps)


def covered_pct(records, parent: List[dict], children) -> Optional[float]:
    """% of the host time of the `parent` spans that spans named in
    `children` inside them cover."""
    kids = [s for s in _spans(records) if s["name"] in children]
    total = sum(p["t1"] - p["t0"] for p in parent)
    if not kids or not total:
        return None
    inside = sum(s["t1"] - s["t0"] for p in parent
                 for s in _within(kids, p["t0"], p["t1"]))
    return 100.0 * inside / total


SERVE_PHASES = ("serve.harvest", "serve.admit", "serve.fill", "serve.decode",
                "serve.snapshot")
TRAIN_PHASES = ("train.forward", "train.backward", "train.optimizer")


def read(records) -> dict:
    """Every phase reading the records hold (None where they hold none)."""
    if records.get("kind") == "serve":
        until = _slice_t0(records)
        steps = [s for s in _spans(records, "serve.step") if s["t1"] < until]
        return {"decode_host_ms": decode_host_ms(records),
                "admit_host_ms": admit_host_ms(records),
                "harvest_host_ms": harvest_host_ms(records),
                "idle_in_decode_pct": idle_in_pct(records, ("serve.decode",)),
                "idle_in_admit_pct": idle_in_pct(records, ("serve.admit",)),
                "prefill_pad_pct": prefill_pad_pct(records),
                "step_covered_pct": covered_pct(records, steps,
                                                SERVE_PHASES)}
    untraced = [a for a in records.get("spans", ())
                if a["name"] == "accum_train_step"
                and any(st["t0"] <= a["t0"] and a["t1"] <= st["t1"]
                        for st in _window_steps(records, False))]
    return {"optimizer_host_ms.train": optimizer_host_ms(records),
            "optimizer_device_ms.train": optimizer_device_ms(records),
            "idle_in_optimizer_pct.train": idle_in_pct(
                records, ("train.optimizer",)),
            "idle_in_fwd_bwd_pct.train": idle_in_pct(
                records, ("train.forward", "train.backward")),
            "step_covered_pct.train": covered_pct(records, untraced,
                                                  TRAIN_PHASES)}


# -- the run -------------------------------------------------------------------

def run(ctx, cell: dict, spans: bool) -> dict:
    """One window of the cell with the program's tracer on (or off) from
    the window's start; returns the window's result with the two keys
    above in its records."""
    from benchmark import trace as trace_mod
    from metamorph_tpu_torch.utils import trace

    drv = spec_lib.driver(cell["traffic"]["driver"])
    mark = ctx.mark_measured

    def window_starts(t):
        mark(t)
        trace.drain()
        if spans:
            trace.enable()

    ctx.mark_measured = window_starts
    trace_mod.DeviceTrace, plain = LaunchTrace, trace_mod.DeviceTrace
    try:
        res = drv.run(ctx)
    finally:
        trace.disable()
        trace_mod.DeviceTrace = plain
        ctx.mark_measured = mark
    res["dropped_spans"] = trace.dropped()
    res["records"]["program_spans"] = trace.drain()
    return res


def summary(ctx, cell: dict, res: dict) -> dict:
    from benchmark.run import per_layer

    records = res["records"]
    line = dict(workload=cell["workload"]["name"], seed=ctx.seed,
                spans=len(records["program_spans"]),
                dropped_spans=res["dropped_spans"],
                e2e=res["e2e"], metrics=per_layer(cell, records),
                phases=read(records))
    split = idle_by_phase(records)
    rec = records.get("trace")
    if rec is not None:
        window = rec["t1"] - rec["t0"]
        line.update(window_s=window / 1e9,
                    idle_s=sum(b - a for a, b in rec["gaps"]) / 1e9)
        line["idle_by_phase_s"] = (
            {k: v / 1e9 for k, v in sorted(split.items(),
                                           key=lambda kv: -kv[1])}
            if split else None)
    steps = _window_steps(records, False)
    if steps:
        ms = sorted((s["t1"] - s["t0"]) / 1e6 for s in steps)
        line["step_ms_median"] = ms[len(ms) // 2]
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--spans", type=int, choices=(0, 1), default=1)
    ap.add_argument("--out", default=None,
                    help="also write the spans and the trace's gaps here")
    args = ap.parse_args(argv)
    runtime.set_cache_dirs()
    cell = spec_lib.cell(spec_lib.load_spec(), args.workload)
    import torch

    from benchmark.run import make_ctx

    if not torch.cuda.is_available():
        runtime.log("needs a CUDA device")
        return 2
    torch.set_num_threads(4)
    torch.cuda.set_device(0)
    card = runtime.power_limit()
    runtime.log(f"{card}; torch {torch.__version__}")
    ctx = make_ctx(torch, torch.device("cuda", 0), cell, args.seed,
                   args.seconds, True)
    res = run(ctx, cell, bool(args.spans))
    line = dict(summary(ctx, cell, res), card=card)
    if args.out:
        rec = res["records"]
        tr = rec["trace"]
        with open(args.out, "w") as f:
            json.dump(dict(line, program_spans=rec["program_spans"],
                           bench_spans=rec["spans"],
                           trace=tr and dict(t0=tr["t0"], t1=tr["t1"],
                                             gaps=tr["gaps"])), f)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
