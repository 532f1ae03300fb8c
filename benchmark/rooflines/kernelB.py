"""Kernel B (`csrc/decode_attn.cu`, decode attention): operations and
bytes of one launch, one new query per row against each row's cached
keys.

`lengths` are the keys each row that advances at the step reads (its
cache length + 1). The rows of finished or empty slots that the launch is
also handed are no work the requests need, so the caller leaves them out
(`readers.step_lengths(..., active_only=True)`). FLOPs: 4 * H * Dh per
key of a row (q k and p v). Bytes: each row's keys and values (bf16, KV
heads) once, the queries read and the outputs written (bf16, H heads per
row).
"""


def launch(lengths, H: int, KV: int, Dh: int):
    keys = sum(lengths)
    flops = 4 * H * Dh * keys
    nbytes = 2 * 2 * KV * Dh * keys + 2 * 2 * len(lengths) * H * Dh
    return flops, nbytes
