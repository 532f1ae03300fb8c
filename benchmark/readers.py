"""What the per-layer metric readers share: the traced ticks of a serving
window with the device operations that started in each, and the traced
steps of a training window."""

from __future__ import annotations

from typing import List, Optional

from benchmark.trace import group


def is_kernel(name: str) -> bool:
    return group(name) != "copy"


def traced_ticks(records: dict) -> Optional[List[dict]]:
    """Each traced tick with `events`: the device operations that started
    between its host start and the next tick's (the last: the trace's
    end). None without a trace."""
    rec = records.get("trace")
    if rec is None:
        return None
    ticks = [t for t in records["ticks"] if t["traced"]]
    if not ticks:
        return None
    out = []
    for k, t in enumerate(ticks):
        end = ticks[k + 1]["t0"] if k + 1 < len(ticks) else rec["t1"]
        evs = [e for e in rec["events"] if t["t0"] <= e[1] < end]
        out.append(dict(t, events=evs))
    return out


def decode_events(tick: dict) -> List[tuple]:
    """The device operations of the tick's decode steps: from its first
    launch of kernel B (`decode_attn_kernel`, which only decode steps
    launch) to its end. The admissions run before them; the first step's
    first layer up to its kernel B (some 20 of ~4,800 kernels a step)
    falls outside."""
    starts = [e[1] for e in tick["events"] if "decode_attn_kernel" in e[0]]
    if not starts:
        return []
    first = min(starts)
    return [e for e in tick["events"] if e[1] >= first]


def start_lengths(tick: dict) -> List[int]:
    """Each row's cache length when the tick's decode steps began: the
    tick's start, or the prompt's length for a row admitted in it."""
    start = list(tick["lens0"])
    for slot, plen, _ in tick["admitted"]:
        start[slot] = plen
    return start


def step_lengths(tick: dict, j: int, active_only: bool) -> List[int]:
    """Keys each row reads at decode step j of the tick (its cache length
    + 1; a row that has stopped reads at its final length). With
    `active_only`, only the rows that advance at step j."""
    out = []
    for s0, s1 in zip(start_lengths(tick), tick["lens1"]):
        active = s0 + j < s1
        if active_only and not active:
            continue
        out.append(min(s0 + j, s1) + 1)
    return out


def idle_pct(records: dict) -> Optional[float]:
    rec = records.get("trace")
    if rec is None:
        return None
    window = rec["t1"] - rec["t0"]
    busy = sum(e - s for s, e in rec["busy"])
    return 100.0 * (1.0 - busy / window)


def traced_steps(records: dict) -> Optional[List[dict]]:
    if records.get("trace") is None:
        return None
    steps = [s for s in records["steps"] if s["traced"]]
    return steps or None
