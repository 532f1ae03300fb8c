"""Kernel A (`csrc/flash_fwd.cu`, the flash forward): operations and bytes
of one causal row of n real positions, all heads.

FLOPs: two products (q k^T, then p v) over each visible (query, key)
pair, 2 * Dh each per query head: 4 * pairs * H * Dh, pairs = n (n + 1) / 2.
Bytes: q and o (n * H * Dh bf16), k and v (n * KV * Dh bf16) once each,
and the float32 log-sum-exp written (n * H).
"""

from benchmark.stats import causal_pairs


def causal_row(n: int, H: int, KV: int, Dh: int):
    pairs = causal_pairs(n, [n])
    flops = 4 * pairs * H * Dh
    nbytes = 2 * (2 * n * H * Dh + 2 * n * KV * Dh) + 4 * n * H
    return flops, nbytes
