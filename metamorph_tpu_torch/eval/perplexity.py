"""Evaluation: perplexity and per-component losses over a packed eval set
(counterpart of `metamorph_tpu/eval/perplexity.py`).

`metamorph_forward` runs under `torch.no_grad()` on the model's device
(kernel A, the flash forward, on the card); each batch's mean losses are
weighted by its supervised text tokens and answer-image tokens.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Tuple

import numpy as np
import torch

from metamorph_tpu_torch.config import MetaMorphConfig
from metamorph_tpu_torch.models.metamorph import metamorph_forward
from metamorph_tpu_torch.multimodal.packing import PackedBatch, batch_to_arrays


@torch.no_grad()
def evaluate(model, cfg: MetaMorphConfig,
             batches: Iterable[Tuple[Any, np.ndarray]],
             max_batches: int = 0) -> Dict[str, float]:
    """(PackedBatch | dict of arrays, pixels [N, S, S, 3]) batches ->
    {perplexity, loss_language, mean_visual_cosine, loss_image_ar
    (= -mean cosine), n_text_tokens, n_image_ar_tokens, n_batches}."""
    dev = model.llama.embed.device
    total_nll = total_text = total_cos = total_img = 0.0
    n = 0
    for packed, pixels in batches:
        arrays = (batch_to_arrays(packed) if isinstance(packed, PackedBatch)
                  else dict(packed))
        batch = {k: torch.as_tensor(np.asarray(v), device=dev)
                 for k, v in arrays.items()}
        _, m = metamorph_forward(model, cfg, batch,
                                 torch.as_tensor(np.asarray(pixels),
                                                 device=dev))
        m = {k: float(v) for k, v in m.items()}     # one sync per batch
        nt, ni = m["n_text_tokens"], m["n_image_ar_tokens"]
        total_nll += m["loss_language"] * nt
        total_text += nt
        total_cos += -m["loss_image_ar"] * ni
        total_img += ni
        n += 1
        if max_batches and n >= max_batches:
            break
    mean_nll = total_nll / max(total_text, 1.0)
    mean_cos = total_cos / max(total_img, 1.0)
    return {
        "perplexity": float(np.exp(mean_nll)),
        "loss_language": mean_nll,
        "mean_visual_cosine": mean_cos,
        "loss_image_ar": -mean_cos,
        "n_text_tokens": total_text,
        "n_image_ar_tokens": total_img,
        "n_batches": float(n),
    }
