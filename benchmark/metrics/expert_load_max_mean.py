"""MoE layer (`metamorph_tpu_torch/models/mla_moe.py`, routed experts):
the 90th percentile, over the traced decode steps and their expert
layers, of the busiest expert's picks over the mean picks an expert
(the advancing rows' picks over the experts), from the program's routing
counter. 1 is a perfectly even load; the busiest expert's rows set the
grouped products' longest group. Moves ttft_p90_ms."""

from benchmark import readers
from benchmark.stats import percentile


def read(records):
    if records.get("kind") != "serve":
        return None
    ratios = []
    for t in readers.traced_ticks(records) or []:
        routes = t.get("routes")
        if not routes:
            continue
        for j in range(t["steps"]):
            for counts in routes[j]:
                picks = sum(counts)
                if picks:
                    ratios.append(max(counts) * len(counts) / picks)
    return percentile(ratios, 90) if ratios else None
