"""Kernel G (`metamorph_tpu_torch/ops/mla_decode.py`, the absorbed
latent-attention decode): operations and bytes of one launch, one new
query of H heads per row against the row's latent cache rows.

`lengths` are the keys each row that advances at the step reads (its
cache length + 1); the rows of finished or empty slots that the launch is
also handed are no work the requests need, so the caller leaves them out
(`readers.step_lengths(..., active_only=True)`). FLOPs: 2 * H * (d_latent
+ d_v) per key of a row (q . row over the whole row, p . row over its
first d_v columns). Bytes: each row's latent rows (bf16, d_latent wide,
shared by the heads) once, the queries read and the outputs written
(bf16).
"""


def launch(lengths, H: int, d_latent: int, d_v: int):
    keys = sum(lengths)
    flops = 2 * H * (d_latent + d_v) * keys
    nbytes = 2 * d_latent * keys + 2 * len(lengths) * H * (d_latent + d_v)
    return flops, nbytes
