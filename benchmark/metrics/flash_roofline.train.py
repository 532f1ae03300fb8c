"""Kernels (`csrc/flash_fwd.cu`, `csrc/flash_bwd.cu`: A, C, D): the sum of
their launches' least times at the rows' real lengths
(`rooflines/kernel{A,C,D}.py`) over the sum of their device time in the
traced optimizer steps, in %. Each launch of A counts once, the
recompute's too (launches per layer and row read from the trace). Moves
train_tok_per_s."""

from benchmark import readers
from benchmark.rooflines import kernelA, kernelC, kernelD
from benchmark.stats import bound

NAMES = (("flash_fwd_kernel", kernelA), ("flash_bwd_dq_kernel", kernelC),
         ("flash_bwd_dkv_kernel", kernelD))


def read(records):
    if records.get("kind") != "train":
        return None
    steps = readers.traced_steps(records)
    if not steps:
        return None
    lc = records["config"]["llama"]
    L, H, KV, Dh = (lc["num_layers"], lc["num_heads"], lc["num_kv_heads"],
                    lc["head_dim"])
    rows = [n for s in steps for n in s["lens"]]
    events = records["trace"]["events"]
    bound_ms = dev_ms = 0.0
    for key, mod in NAMES:
        evs = [d for name, _, d in events if key in name]
        if not evs:
            continue
        per_row_layer = len(evs) / (L * len(rows))
        dev_ms += sum(evs) / 1e6
        for n in rows:
            f, b = mod.causal_row(n, H, KV, Dh)
            bound_ms += L * per_row_layer * bound(b, f)["bound_ms"]
    return 100.0 * bound_ms / dev_ms if dev_ms else None
