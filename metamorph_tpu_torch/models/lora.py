"""LoRA adapters for the LLaMA backbone (counterpart of
`metamorph_tpu/models/lora.py`).

The factors are optional parameters of each `LlamaLayer`: `{w}_lora_a`
[D_in, r] and `{w}_lora_b` [r, D_out] beside the dense weight `w`.
`models/llama._dense` applies `x @ w + ((x @ a) @ b) * alpha / r` on every
path (forward, prefill, decode and the chunk steps) when the config's
`lora_r` is positive, with no merged copy of the weight (it is the port's
`apply_lora_dense`); `merge_lora` folds them in for export. The
optimizer's trainable mask (`"_lora_"` in a parameter's name,
`train/optimizer.trainable_mask`) picks them up under `lora_enable`.

Files and the JAX package see the factors stacked over layers, as the JAX
tree holds them (`layers/<sub>/<w>_lora_a` [L, D_in, r]).
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from metamorph_tpu_torch.models.llama import Llama

# (subtree, weight) pairs that can carry LoRA: every decoder linear, the
# subtree being where the JAX tree (and a LoRA file) keeps the weight
LORA_TARGETS = (
    ("attn", "wq"), ("attn", "wk"), ("attn", "wv"), ("attn", "wo"),
    ("mlp", "w_gate"), ("mlp", "w_up"), ("mlp", "w_down"),
)


@torch.no_grad()
def add_lora(llama: Llama, r: int, seed: int = 0) -> Llama:
    """Give every layer LoRA factors for every target, in place, in the
    weight's dtype: A ~ N(0, 1/D_in) drawn in fp32 from a generator seeded
    with `seed` (the numbers differ from `jax.random`'s), B = 0, so the
    model computes what it did. The scale alpha / r comes from the config
    (`lora_r`, `lora_alpha`) when the factors are used."""
    llama.cfg.require_gqa("LoRA (add_lora)")
    device = llama.embed.device
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    for _, name in LORA_TARGETS:
        for layer in llama.layers:
            w = getattr(layer, name)
            d_in, d_out = w.shape
            a = torch.randn((d_in, r), generator=gen, device=device,
                            dtype=torch.float32) * d_in ** -0.5
            setattr(layer, f"{name}_lora_a", nn.Parameter(a.to(w.dtype)))
            setattr(layer, f"{name}_lora_b", nn.Parameter(
                torch.zeros((r, d_out), dtype=w.dtype, device=device)))
    return llama


def lora_scale(r: int, alpha: float) -> float:
    return alpha / r


@torch.no_grad()
def merge_lora(llama: Llama, r: int, alpha: float) -> Llama:
    """Fold the factors into the base weights in place (w + a @ b * scale,
    in fp32, cast back to w's dtype) and drop them (merge-and-unload)."""
    scale = lora_scale(r, alpha)
    for layer in llama.layers:
        for _, name in LORA_TARGETS:
            a = getattr(layer, f"{name}_lora_a")
            if a is None:
                continue
            b = getattr(layer, f"{name}_lora_b")
            w = getattr(layer, name)
            delta = (a.float() @ b.float()) * scale
            w.copy_((w.float() + delta).to(w.dtype))
            setattr(layer, f"{name}_lora_a", None)
            setattr(layer, f"{name}_lora_b", None)
    return llama


def split_lora_state(llama: Llama) -> Dict[str, Dict]:
    """Only the factors, stacked over layers in the JAX tree's layout:
    {"layers": {sub: {"<w>_lora_a": [L, D_in, r], "<w>_lora_b": ...}}}."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for sub, name in LORA_TARGETS:
        for part in ("a", "b"):
            key = f"{name}_lora_{part}"
            factors = [getattr(layer, key, None) for layer in llama.layers]
            if any(f is None for f in factors):
                continue
            out.setdefault(sub, {})[key] = torch.stack(
                [f.detach() for f in factors])
    return {"layers": out}

