"""The device trace of a steady slice of the window: `torch.profiler` with
CUDA activity only (host ops would stretch the host-bound steps), read
event by event and put on the host clock, so that each device operation
and each idle gap can be laid against the benchmark's host spans.

Alignment: with the card idle, the host notes its clock and launches one
fill kernel; that kernel's start in the trace, less the host's note, is
the offset between the clocks (off by the launch latency, some
microseconds).
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import List, Tuple

# kernel groups by name: the names of `profile_train` and `profile_serve`
GROUPS = (("flash_fwd", ("flash_fwd_kernel",)),
          ("flash_bwd_dq", ("flash_bwd_dq_kernel",)),
          ("flash_bwd_dkv", ("flash_bwd_dkv_kernel",)),
          ("decode_attn", ("decode_attn_kernel",)),
          ("chunk_attn", ("verify_attn_kernel", "chunk_fill_kernel")),
          ("gemm", ("gemm", "nvjet", "xmma", "cutlass", "gemv", "w8_")),
          ("copy", ("memcpy", "memset")))


def group(name: str) -> str:
    low = name.lower()
    for g, keys in GROUPS:
        if any(k in low for k in keys):
            return g
    return "elementwise"


class DeviceTrace:
    def __init__(self, torch):
        self.torch = torch
        self.prof = None
        self.events: List[Tuple[str, int, int]] = []   # name, start, dur
        self.t0 = self.t1 = 0

    def warm(self) -> None:
        """Start and stop the profiler once (set-up): its first start
        initialises CUPTI, which takes seconds."""
        self.start()
        self.stop()

    def start(self) -> None:
        torch = self.torch
        torch.cuda.synchronize()
        mark = torch.empty(1, device="cuda")
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize()
        self._t_mark = time.perf_counter_ns()
        mark.fill_(1.0)
        torch.cuda.synchronize()
        self.t0 = time.perf_counter_ns()

    def stop(self) -> None:
        torch = self.torch
        torch.cuda.synchronize()
        self.t1 = time.perf_counter_ns()
        self.prof.__exit__(None, None, None)
        cuda = torch.autograd.DeviceType.CUDA
        raw = sorted((e.start_ns(), e.duration_ns(), e.name())
                     for e in self.prof.profiler.kineto_results.events()
                     if e.device_type() == cuda)
        self.prof = None
        if not raw:
            raise RuntimeError("the profiler recorded no device activity")
        # the marker: the fill launched alone with the card idle
        first = next((r for r in raw[:8] if "fill" in r[2].lower()), raw[0])
        off = first[0] - self._t_mark
        self.events = [(name, s - off, d) for s, d, name in raw
                       if s - off >= self.t0]

    # -- readings -------------------------------------------------------

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        out = []
        for _, s, d in sorted(self.events, key=lambda e: e[1]):
            e = min(s + d, self.t1)
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [tuple(x) for x in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def gaps(self) -> List[Tuple[int, int]]:
        out, prev = [], self.t0
        for s, e in self.busy_intervals():
            if s > prev:
                out.append((prev, s))
            prev = max(prev, e)
        if self.t1 > prev:
            out.append((prev, self.t1))
        return out

    def record(self) -> dict:
        """The trace as plain data for the metric readers."""
        return dict(t0=self.t0, t1=self.t1, events=self.events,
                    busy=self.busy_intervals(), gaps=self.gaps())


def breakdown(rec: dict, spans: List[dict]) -> dict:
    """The device operations that took most time ("group: kernel name"),
    and the device's idle time summed by what the host was doing (the
    benchmark's span around each gap's middle); at most 10 of each."""
    by = defaultdict(float)
    for name, _, d in rec["events"]:
        by[f"{group(name)}: {name[:72]}"] += d / 1e9
    ops = sorted(by.items(), key=lambda kv: -kv[1])[:10]
    idle = defaultdict(float)
    for s, e in rec["gaps"]:
        mid = (s + e) // 2
        where = next((sp["name"] for sp in spans
                      if sp["t0"] <= mid < sp["t1"]), "between calls")
        idle[f"host: {where}"] += (e - s) / 1e9
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return dict(device_ops=[[n, s] for n, s in ops],
                idle_gaps=[[n, s] for n, s in gaps])
