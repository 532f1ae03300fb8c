"""Checkpoint / resume (counterpart of `metamorph_tpu/train/checkpoint.py`).

Same directory layout as the JAX package: `{ckpt_dir}/step_{n}/` holds the
state, `meta.json` ({"step", "data_state"}) and `config.json`; a step
directory counts once its `meta.json` exists. The state (model weights,
optimizer moments and count, step) goes through `torch.save` into
`state.pt`. The adapter, LoRA and HF-export saves come with the loader
slice.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import signal
import threading
from typing import Dict, Optional

import torch


def save_train_state(ckpt_dir: str, step: int, state: dict,
                     config_json: Optional[str] = None,
                     data_state: Optional[Dict] = None) -> str:
    """Write the train state under {ckpt_dir}/step_{step}."""
    path = os.path.join(os.path.abspath(ckpt_dir), f"step_{step}")
    os.makedirs(path, exist_ok=True)
    torch.save({"params": state["params"].state_dict(),
                "opt_state": state["opt_state"], "step": state["step"]},
               os.path.join(path, "state.pt"))
    meta = {"step": step}
    if data_state is not None:
        meta["data_state"] = data_state
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)
    if config_json is not None:
        with open(os.path.join(path, "config.json"), "w") as f:
            f.write(config_json)
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        m = re.match(r"step_(\d+)$", name)
        if m and os.path.exists(os.path.join(ckpt_dir, name, "meta.json")):
            steps.append(int(m.group(1)))
    if not steps:
        return None
    return os.path.join(ckpt_dir, f"step_{max(steps)}")


@torch.no_grad()
def restore_train_state(path: str, template: dict) -> dict:
    """Restore into the template state in place (its devices and dtypes)
    and return it."""
    model = template["params"]
    device = next(model.parameters()).device
    saved = torch.load(os.path.join(path, "state.pt"), map_location=device,
                       weights_only=True)
    model.load_state_dict(saved["params"])
    opt = template["opt_state"]
    for key in ("mu", "nu"):
        for name, t in opt[key].items():
            t.copy_(saved["opt_state"][key][name])
    opt["count"] = saved["opt_state"]["count"]
    template["step"] = saved["step"]
    return template


def restore_meta(path: str) -> Dict:
    with open(os.path.join(path, "meta.json")) as f:
        return json.load(f)


def prune_checkpoints(ckpt_dir: str, keep: int = 1):
    """Keep the newest `keep` step directories (save_total_limit)."""
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted(
        (int(m.group(1)) for name in os.listdir(ckpt_dir)
         for m in [re.match(r"step_(\d+)$", name)] if m), reverse=True)
    for s in steps[keep:]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"), ignore_errors=True)


class PreemptionSaver:
    """Install a SIGTERM/SIGUSR1 handler that requests a synchronous save at
    the next step boundary."""

    def __init__(self):
        self.requested = threading.Event()
        for sig in (signal.SIGTERM, signal.SIGUSR1):
            try:
                signal.signal(sig, self._handler)
            except ValueError:
                pass  # not the main thread

    def _handler(self, signum, frame):
        self.requested.set()

    def should_save(self) -> bool:
        return self.requested.is_set()
