"""Device: model FLOPs of the traced optimizer steps' real tokens
(`rooflines/train_step.py`: no recompute, no padding) over the traced
time at 989 TFLOP/s, in %. Moves train_tok_per_s."""

from benchmark import readers
from benchmark.rooflines import train_step
from benchmark.stats import PEAK_BF16_TFLOPS


def read(records):
    if records.get("kind") != "train":
        return None
    steps = readers.traced_steps(records)
    if not steps:
        return None
    rec = records["trace"]
    flops = sum(train_step.model_flops(records["config"], s["lens"],
                                       s["images"], s["ar_targets"])
                for s in steps)
    seconds = (rec["t1"] - rec["t0"]) / 1e9
    return 100.0 * flops / (seconds * PEAK_BF16_TFLOPS * 1e12)
