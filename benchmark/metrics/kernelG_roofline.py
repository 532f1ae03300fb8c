"""Kernels (`metamorph_tpu_torch/ops/mla_decode.py`, kernel G): the least
time of its launches in the traced ticks (`rooflines/kernelG.py`, at the
lengths of the rows that advance at each step: a finished or empty
slot's row, which the launch is handed too, is no work a request needs)
over their device time, in %. Moves ttft_p90_ms."""

from benchmark import readers
from benchmark.rooflines import kernelG
from benchmark.stats import bound

NAME = "mla_decode_attn_kernel"


def read(records):
    if records.get("kind") != "serve":
        return None
    lc = records["config"]["llama"]
    if not lc.get("kv_lora_rank"):
        return None
    ticks = readers.traced_ticks(records) or []
    d_lat = lc["kv_lora_rank"] + lc["qk_rope_head_dim"]
    bound_ms = dev_ms = 0.0
    for t in ticks:
        ms = sum(d for name, _, d in t["events"] if NAME in name) / 1e6
        if not ms:
            continue
        dev_ms += ms
        for j in range(t["steps"]):
            lens = readers.step_lengths(t, j, True)
            if not lens:
                continue
            f, b = kernelG.launch(lens, lc["num_heads"], d_lat,
                                  lc["kv_lora_rank"])
            bound_ms += lc["num_layers"] * bound(b, f)["bound_ms"]
    return 100.0 * bound_ms / dev_ms if dev_ms and bound_ms else None
