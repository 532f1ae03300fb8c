"""Kernel D (`csrc/flash_bwd.cu` `flash_bwd_dkv_kernel`): operations and
bytes of the dk/dv backward of one causal row of n real positions.

FLOPs: four products per visible pair (s = q k^T again, dv = p^T do,
dp = do v^T, dk = ds^T q), 2 * Dh each per query head: 8 * pairs * H * Dh.
Bytes: q, do (n * H * Dh) and k, v (n * KV * Dh) read in bf16, the
float32 log-sum-exp and delta (n * H each) read, dk and dv (bf16,
n * KV * Dh each) written.
"""

from benchmark.stats import causal_pairs


def causal_row(n: int, H: int, KV: int, Dh: int):
    pairs = causal_pairs(n, [n])
    flops = 8 * pairs * H * Dh
    nbytes = (2 * (2 * n * H * Dh + 2 * n * KV * Dh) + 2 * 4 * n * H
              + 2 * 2 * n * KV * Dh)
    return flops, nbytes
