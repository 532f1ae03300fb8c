"""Kernel C (`csrc/flash_bwd.cu` `flash_bwd_dq_kernel`): operations and
bytes of the dq backward of one causal row of n real positions.

FLOPs: three products per visible pair (s = q k^T again, dp = do v^T,
dq = ds k), 2 * Dh each per query head: 6 * pairs * H * Dh.
Bytes: q, do (n * H * Dh) and k, v (n * KV * Dh) read in bf16, the
float32 log-sum-exp and delta (n * H each) read, dq (bf16) written.
"""

from benchmark.stats import causal_pairs


def causal_row(n: int, H: int, KV: int, Dh: int):
    pairs = causal_pairs(n, [n])
    flops = 6 * pairs * H * Dh
    nbytes = (2 * (2 * n * H * Dh + 2 * n * KV * Dh) + 2 * 4 * n * H
              + 2 * n * H * Dh)
    return flops, nbytes
