"""The routed experts' grouped products (`torch._grouped_mm`, which
`metamorph_tpu_torch/ops/moe.py` calls three times an expert layer):
their kernels' names in a device trace, and the operations and bytes of
one expert layer's three products.

Of a layer that routes `picks` (token, expert) pairs to `touched`
distinct experts: FLOPs 2 * 3 * D * Fe per pick (gate, up and down);
bytes the touched experts' three weights once (bf16), and per pick its
row read, the gate and up outputs written, their product read back and
the expert's output written (bf16). Experts that no counted row picks
are no work the requests need, whatever the kernels read.
"""

# substrings of the names of the grouped GEMM's kernels in a trace
# (CUTLASS's GemmUniversal over a GroupProblemShape, and the kernel
# that lays out its problems)
KERNELS = ("GroupProblemShape", "grouped_gemm")


def is_grouped_mm(name: str) -> bool:
    return any(k in name for k in KERNELS)


def layer(picks: int, touched: int, D: int, Fe: int):
    flops = 2 * 3 * D * Fe * picks
    nbytes = 2 * 3 * D * Fe * touched + 2 * picks * (2 * D + 3 * Fe)
    return flops, nbytes
