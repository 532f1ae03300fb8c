"""Kernels (`csrc/decode_attn.cu`, kernel B): the least time of its
launches in the traced ticks (`rooflines/kernelB.py`, at the lengths of
the rows that advance at each step: a finished or empty slot's row, which
the launch is handed too, is no work a request needs) over their device
time, in %. Moves ttft_p90_ms."""

from benchmark import readers
from benchmark.rooflines import kernelB
from benchmark.stats import bound


def read(records):
    if records.get("kind") != "serve":
        return None
    ticks = readers.traced_ticks(records) or []
    lc = records["config"]["llama"]
    H, KV, Dh = lc["num_heads"], lc["num_kv_heads"], lc["head_dim"]
    bound_ms = dev_ms = 0.0
    for t in ticks:
        ms = sum(d for name, _, d in t["events"]
                 if "decode_attn_kernel" in name) / 1e6
        if not ms:
            continue
        dev_ms += ms
        for j in range(t["steps"]):
            lens = readers.step_lengths(t, j, True)
            if not lens:
                continue
            f, b = kernelB.launch(lens, H, KV, Dh)
            bound_ms += lc["num_layers"] * bound(b, f)["bound_ms"]
    return 100.0 * bound_ms / dev_ms if dev_ms and bound_ms else None
