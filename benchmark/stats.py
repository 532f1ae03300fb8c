"""Percentiles, spreads and the peaks of one NVIDIA H100 SXM.

`bound`, `rates` and `causal_pairs` are copies of `chip_smoke.py`'s, so
that the yardstick does not move when the program's files do.
"""

from __future__ import annotations

import math
import statistics
from typing import Iterable, Sequence

# NVIDIA's data sheet, H100 SXM, dense, at the 700 W limit
PEAK_BF16_TFLOPS = 989.0
PEAK_HBM_TBS = 3.35


def percentile(values: Iterable[float], q: float) -> float:
    """The q-th percentile (0..100), linear between the closest ranks
    (numpy's default). Raises on an empty sample."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of an empty sample")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def spread(values: Sequence[float]) -> float:
    """Distance between the first and third quartile (Python's
    `statistics.quantiles(values, n=4)`) as a share of the median."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take: bytes each read or written
    once over the memory rate, or the FLOPs over the bf16 tensor rate,
    whichever is larger."""
    t_bytes = nbytes / (PEAK_HBM_TBS * 1e12) * 1e3
    t_ops = flops / (PEAK_BF16_TFLOPS * 1e12) * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, flops=flops)


def rates(b: dict, ms: float) -> dict:
    """What a kernel row achieved: FLOP/s and bytes/s of the work its bound
    counts, and the bound's share of the measured time."""
    return dict(tflops=b["flops"] / ms / 1e9, gb_per_s=b["bytes"] / ms / 1e6,
                bound_share=b["bound_ms"] / ms)


def causal_pairs(T: int, lens) -> int:
    """Visible (query, key) pairs of a causal T x T problem with per-row
    key lengths: query i sees keys j <= i, j < len."""
    total = 0
    for n in lens:
        m = min(n, T)
        # queries i < m see i + 1 keys; queries i >= m see m keys
        total += m * (m + 1) // 2 + (T - m) * m
    return total
