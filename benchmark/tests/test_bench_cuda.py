"""The tiny cells on the card, through the port's kernels, traced: the
run completes with every number compared finite, the device trace lands
on the host clock inside its window, and every per-layer metric of the
cell reads a value. (Correctness at this size is the CPU tests' and the
full cells' concern.) Skips without a card.

    python -m pytest benchmark/tests -q -m cuda
"""

import pytest
import torch

from benchmark.run import run_cell
from benchmark.tests.tiny import tiny_ctx


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["nemo12b-chat", "ministral8b-sft"])
def test_tiny_cell_on_the_card_traced(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ctx, cell = tiny_ctx(workload, device="cuda", seconds=4.0)
    ctx.trace = True
    if workload == "nemo12b-chat":
        ctx.traffic["trace"] = dict(start_frac=0.25, min_ticks=4,
                                    max_seconds=2.0)
    else:
        ctx.traffic["trace"] = dict(profile_steps=[1, 2])
    info = dict(platform="gpu", kind=torch.cuda.get_device_name(0), count=1)
    line = run_cell(ctx, cell, info)
    assert all(c["value"] < 1e30 for c in line["compared"].values())
    dev = line["device"]
    assert 0 < dev["busy_s"] <= dev["window_s"]
    names = {m["name"] for m in cell["per_layer"]}
    assert set(line["metrics"]) == names, line["metrics"]
    for name, m in line["metrics"].items():
        if m["unit"] == "%":
            assert 0 <= m["value"] <= 105, (name, m)
    assert line["breakdown"]["device_ops"]
