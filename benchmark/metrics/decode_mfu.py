"""Device: the traced slice's roofline share of one H100, in %: the sum
over its work of max(FLOPs / 989 TFLOP/s, bytes / 3.35 TB/s) over the
slice's time. The work is every decode step (the rows that advance, at
their real lengths; the weights read once a step), every admission's
prefill (real prompt lengths) and every image encoded in the slice
(`rooflines/decode_step.py`). Moves ttft_p90_ms."""

from benchmark import readers
from benchmark.rooflines import decode_step
from benchmark.stats import bound


def read(records):
    if records.get("kind") != "serve":
        return None
    ticks = readers.traced_ticks(records)
    if not ticks:
        return None
    rec = records["trace"]
    cfg = records["config"]
    lc = cfg["llama"]
    total = 0.0
    for t in ticks:
        for j in range(t["steps"]):
            lens = readers.step_lengths(t, j, True)
            if lens:
                f, b = decode_step.decode_step(lc, lens)
                total += bound(b, f)["bound_ms"]
        if t["admitted"]:
            f, b = decode_step.prefill(lc, [p for _, p, _ in t["admitted"]])
            total += bound(b, f)["bound_ms"]
    images = sum(1 for s in records["spans"]
                 if s["name"] == "submit" and s.get("image")
                 and rec["t0"] <= s["t0"] < rec["t1"])
    if images:
        f, b = decode_step.image_encode(cfg, 1)
        total += images * bound(b, f)["bound_ms"]
    return 100.0 * total / ((rec["t1"] - rec["t0"]) / 1e6)
