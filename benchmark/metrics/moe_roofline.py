"""Kernels (the routed experts' grouped products, `torch._grouped_mm`
from `metamorph_tpu_torch/ops/moe.py`): the least time of the traced
decode steps' expert products (`rooflines/moe_experts.py`: each expert
that the advancing rows touched in a step and layer counted once, from
the program's routing counter, plus the picked rows' activations) over
the device time of the grouped-product kernels in those steps, in %. The
idle slots' rows ride along in the products at a fixed cost and count
nothing. Moves ttft_p90_ms."""

from benchmark import readers
from benchmark.rooflines import moe_experts
from benchmark.stats import bound


def read(records):
    if records.get("kind") != "serve":
        return None
    lc = records["config"]["llama"]
    if not lc.get("n_routed_experts"):
        return None
    D, Fe = lc["hidden_size"], lc["moe_intermediate_size"]
    bound_ms = dev_ms = 0.0
    for t in readers.traced_ticks(records) or []:
        routes = t.get("routes")
        if not routes or not t["steps"]:
            continue
        ms = sum(d for name, _, d in readers.decode_events(t)
                 if moe_experts.is_grouped_mm(name)) / 1e6
        if not ms:
            continue
        dev_ms += ms
        for j in range(t["steps"]):
            for counts in routes[j]:
                picks = sum(counts)
                if picks:
                    f, b = moe_experts.layer(
                        picks, sum(1 for c in counts if c), D, Fe)
                    bound_ms += bound(b, f)["bound_ms"]
    return 100.0 * bound_ms / dev_ms if dev_ms and bound_ms else None
