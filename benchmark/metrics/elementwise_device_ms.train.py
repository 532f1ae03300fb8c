"""Train step and optimizer (`train/optimizer.py`): device milliseconds
per optimizer step in kernels that are neither GEMMs nor kernels A, C, D
(AdamW, norms, casts, the cross-entropy, the tower's attention), over
the traced steps. Moves train_tok_per_s."""

from benchmark import readers
from benchmark.trace import group


def read(records):
    if records.get("kind") != "train":
        return None
    steps = readers.traced_steps(records)
    if not steps:
        return None
    ns = sum(d for name, _, d in records["trace"]["events"]
             if group(name) == "elementwise")
    return ns / 1e6 / len(steps)
