"""Train step (`train/train_step.py`): device milliseconds per optimizer
step in GEMM kernels (the name groups of `profile_train`), over the
traced steps. Moves train_tok_per_s."""

from benchmark import readers
from benchmark.trace import group


def read(records):
    if records.get("kind") != "train":
        return None
    steps = readers.traced_steps(records)
    if not steps:
        return None
    ns = sum(d for name, _, d in records["trace"]["events"]
             if group(name) == "gemm")
    return ns / 1e6 / len(steps)
