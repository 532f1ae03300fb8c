"""Tiny versions of the cells for the CPU tests: the configurations at a
few dozen wide (the decoder's width 64 against 4 heads of 32, so
D != H * Dh as in Mistral-Nemo), the mixes cut to match."""

import copy

import torch

from benchmark import spec as spec_lib
from benchmark.run import make_ctx


def tiny_config(cfg: dict, card: bool = False) -> dict:
    """With `card`, heads of 128 in groups of 4, which the card's kernels
    take (width 256 against 4 x 128)."""
    cfg = copy.deepcopy(cfg)
    cfg["llama"].update(hidden_size=64, intermediate_size=128, num_layers=2,
                        num_heads=4, num_kv_heads=2, head_dim=32)
    if card:
        cfg["llama"].update(hidden_size=256, intermediate_size=512,
                            num_kv_heads=1, head_dim=128)
    cfg["siglip"].update(image_size=28, patch_size=14, hidden_size=32,
                         intermediate_size=64, num_layers=2, num_heads=4)
    cfg["mm"]["num_image_tokens"] = 4
    if "train" in cfg:
        cfg["train"].update(max_seq_len=128, total_steps=100)
    return cfg


def tiny_traffic(mix: dict) -> dict:
    mix = copy.deepcopy(mix)
    if mix["driver"] == "serve_open_loop":
        mix["arrivals"]["rate_per_s"] = 10.0
        mix["requests"]["prompt_tokens"].update(median=20, min=8, max=60)
        mix["requests"]["output_tokens"].update(median=8, min=4, max=16)
        mix["engine"].update(n_slots=8, max_cache_len=256,
                             max_new_tokens_cap=32)
        mix.update(tail_seconds=5, drain_cap_seconds=20)
        mix["check"]["requests"] = 4
    else:
        for m in mix["mix"]:
            for k in ("question", "answer", "prompt", "length"):
                if k in m:
                    m[k].update(median=min(m[k]["median"], 20),
                                max=min(m[k]["max"], 40),
                                min=min(m[k]["min"], 4))
        mix["planned_steps"] = 8
    return mix


# Limits of the comparison at this size, on the CPU: the cells' own limits
# are set from readings at their full size on the card (benchmark/limits/),
# and a two-layer model of width 64 rounds differently. Set from six seeds
# of the sound program and of the fp8 control here (largest sound reading,
# smallest control reading): served-token gap 0.022 / 0.10; loss 6.0e-4 /
# 1.2e-3; first gradient 0.016 / 0.038; change 0.015 / 0.019.
TINY_LIMITS = {
    "nemo12b-chat": {"logit_gap_max": 0.05},
    "ministral8b-sft": {"loss_gap": 9e-4, "grad_norm_gap": 0.025,
                        "change_norm_gap": 0.03},
}


def tiny_cell(workload: str, card: bool = False) -> dict:
    cell = spec_lib.cell(spec_lib.load_spec(), workload)
    cell.update(config=tiny_config(cell["config"], card),
                traffic=tiny_traffic(cell["traffic"]),
                limits={"limits": TINY_LIMITS[workload]})
    return cell


def tiny_ctx(workload: str, seed: int = 2 ** 33 + 5, seconds: float = 2.0,
             device="cpu", log=lambda *a: None):
    torch.set_num_threads(4)
    cell = tiny_cell(workload, card=device != "cpu")
    return make_ctx(torch, torch.device(device), cell, seed, seconds, False,
                    log), cell
