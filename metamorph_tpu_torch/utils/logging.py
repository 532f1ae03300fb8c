"""Per-step scalar reporting (counterpart of `metamorph_tpu/utils/logging.py`):
`MetricsLogger` writes one JSON line per logged step; `rank0_print` prints
on rank 0 of `torch.distributed`, or always when it is not initialised.
W&B is not available to the port: `use_wandb=True` raises."""

from __future__ import annotations

import json
import sys
import time
from typing import Dict, Optional

import torch


def rank0_print(*args):
    """Print to stderr on process 0 only."""
    dist = torch.distributed
    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_rank() == 0:
        print(*args, file=sys.stderr, flush=True)


class MetricsLogger:
    """Per-step scalars {loss, loss_language, loss_image_ar, grad_norm,
    tokens/s/chip} to JSONL. `tokens` of a `log` call are those trained
    since the previous logged step, which it divides by the time between
    the two."""

    def __init__(self, log_path: Optional[str] = None, use_wandb: bool = False):
        if use_wandb:
            raise NotImplementedError("W&B logging is not ported; metrics go "
                                      "to the JSONL file")
        self.log_path = log_path
        self._t_last = None
        self._f = open(log_path, "a") if log_path else None

    def log(self, step: int, metrics: Dict[str, float],
            tokens: Optional[int] = None, n_chips: int = 1):
        now = time.time()
        row = {"step": step, "time": now}
        row.update({k: float(v) for k, v in metrics.items()})
        if tokens and self._t_last is not None:
            dt = now - self._t_last
            if dt > 0:
                row["tokens_per_sec_per_chip"] = tokens / dt / n_chips
        self._t_last = now
        if self._f:
            self._f.write(json.dumps(row) + "\n")
            self._f.flush()
        return row

    def close(self):
        if self._f:
            self._f.close()
