"""Device: the traced slice's roofline share of one H100 on the
DeepSeek-V3 block, in %: the sum over its work of max(FLOPs / 989 TFLOP/s,
bytes / 3.35 TB/s) over the slice's time. The work is every decode step
(the rows that advance, at their real lengths, with the bytes of the
experts their picks touched, from the program's routing counter), every
admission's prefill (real prompt lengths, active-parameter FLOPs) and
every image encoded in the slice (`rooflines/mla_moe.py`,
`rooflines/decode_step.image_encode`). Moves ttft_p90_ms."""

from benchmark import readers
from benchmark.rooflines import decode_step, mla_moe
from benchmark.stats import bound


def read(records):
    if records.get("kind") != "serve":
        return None
    cfg = records["config"]
    lc = cfg["llama"]
    if not lc.get("n_routed_experts"):
        return None
    ticks = readers.traced_ticks(records)
    if not ticks:
        return None
    rec = records["trace"]
    n_moe = lc["num_layers"] - lc["first_k_dense_replace"]
    total = 0.0
    for t in ticks:
        routes = t.get("routes")
        for j in range(t["steps"]):
            lens = readers.step_lengths(t, j, True)
            if not lens:
                continue
            # a tick whose counts were not harvested: every expert
            touched = ([sum(1 for c in counts if c) for counts in routes[j]]
                       if routes else [lc["n_routed_experts"]] * n_moe)
            f, b = mla_moe.decode_step(lc, lens, touched)
            total += bound(b, f)["bound_ms"]
        if t["admitted"]:
            f, b = mla_moe.prefill(lc, [p for _, p, _ in t["admitted"]])
            total += bound(b, f)["bound_ms"]
    images = sum(1 for s in records["spans"]
                 if s["name"] == "submit" and s.get("image")
                 and rec["t0"] <= s["t0"] < rec["t1"])
    if images:
        f, b = decode_step.image_encode(cfg, 1)
        total += images * bound(b, f)["bound_ms"]
    return 100.0 * total / ((rec["t1"] - rec["t0"]) / 1e6)
