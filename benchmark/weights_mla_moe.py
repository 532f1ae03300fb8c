"""Seeded random weights of a MetaMorph model whose decoder is the
DeepSeek-V3 block (latent attention, routed experts), made by the
benchmark itself.

The draw is `benchmark/weights.py`'s: one group is a parameter name with
its layer index replaced by `*`, drawn in ONE call on the device from a
generator seeded by (run seed, group name), in layer order; dense
weights N(0, fan_in^-1/2), the embedding N(0, 1), norm scales 1, biases
0. The tower, the projector, the vision head, the embedding, the final
norm and the head keep that module's names and draws; the decoder layers
are the block's, in the names the port's `MlaMoeLayer` gives them:

  wq [D, H * (nope + rope)], wkv_a [D, rank + rope], kv_norm [rank],
  wkv_b [rank, H * (nope + v)], wo [H * v, D], input_norm, post_attn_norm;
  a leading dense layer: w_gate, w_up [D, F], w_down [F, D];
  an expert layer: router [D, E], e_score_bias [E] (float32 zeros, a
  buffer of the module), experts_gate, experts_up [E, D, Fe],
  experts_down [E, Fe, D] (fan-in D and Fe), and the shared expert's
  w_gate, w_up [D, n_shared * Fe], w_down [n_shared * Fe, D].
"""

from __future__ import annotations

import zlib
from collections import OrderedDict
from typing import Dict, Iterator, List, Tuple

import torch

from benchmark import weights as dense


def layer_entries(lc: dict, i: int) -> List[Tuple[str, tuple, tuple]]:
    """(name, shape, draw) of decoder layer i's parameters."""
    D, H, R = lc["hidden_size"], lc["num_heads"], lc["kv_lora_rank"]
    nope, rope, dv = (lc["qk_nope_head_dim"], lc["qk_rope_head_dim"],
                      lc["v_head_dim"])
    p = f"llama.layers.{i}."
    out = [(p + "wq", (D, H * (nope + rope)), ("normal", D)),
           (p + "wkv_a", (D, R + rope), ("normal", D)),
           (p + "kv_norm", (R,), ("ones",)),
           (p + "wkv_b", (R, H * (nope + dv)), ("normal", R)),
           (p + "wo", (H * dv, D), ("normal", H * dv)),
           (p + "input_norm", (D,), ("ones",)),
           (p + "post_attn_norm", (D,), ("ones",))]
    if i < lc["first_k_dense_replace"]:
        F = lc["intermediate_size"]
    else:
        E, Fe = lc["n_routed_experts"], lc["moe_intermediate_size"]
        F = lc["n_shared_experts"] * Fe
        out += [(p + "router", (D, E), ("normal", D)),
                (p + "e_score_bias", (E,), ("zeros",)),
                (p + "experts_gate", (E, D, Fe), ("normal", D)),
                (p + "experts_up", (E, D, Fe), ("normal", D)),
                (p + "experts_down", (E, Fe, D), ("normal", Fe))]
    out += [(p + "w_gate", (D, F), ("normal", D)),
            (p + "w_up", (D, F), ("normal", D)),
            (p + "w_down", (F, D), ("normal", F))]
    return out


def layout(cfg: dict) -> List[Tuple[str, tuple, tuple]]:
    """(name, shape, draw) of every parameter: `weights.layout`'s without
    its dense decoder layers, and this block's in their place."""
    lc = cfg["llama"]
    out = [e for e in dense.layout(cfg)
           if not e[0].startswith("llama.layers.")]
    for i in range(lc["num_layers"]):
        out += layer_entries(lc, i)
    return out


def groups(cfg: dict) -> "OrderedDict[str, list]":
    out: "OrderedDict[str, list]" = OrderedDict()
    for entry in layout(cfg):
        out.setdefault(dense.group_of(entry[0]), []).append(entry)
    return out


def draw_group(cfg: dict, seed: int, group: str, device,
               dtype=torch.bfloat16) -> torch.Tensor:
    """The flat tensor of one group, drawn in one call (as
    `weights.draw_group`; the correction bias is float32)."""
    entries = groups(cfg)[group]
    total = sum(dense._numel(s) for _, s, _ in entries)
    kind = entries[0][2]
    if group.endswith(".e_score_bias"):
        dtype = torch.float32
    if kind[0] == "ones":
        return torch.ones(total, dtype=dtype, device=device)
    if kind[0] == "zeros":
        return torch.zeros(total, dtype=dtype, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003 + zlib.crc32(group.encode()))
                    % (2 ** 63))
    flat = torch.randn(total, generator=gen, dtype=dtype, device=device)
    return flat.mul_(float(kind[1]) ** -0.5)


def iter_params(cfg: dict, seed: int, device, dtype=torch.bfloat16,
                only=None) -> Iterator[Tuple[str, torch.Tensor]]:
    for group, entries in groups(cfg).items():
        if only is not None and group not in only:
            continue
        flat = draw_group(cfg, seed, group, device, dtype)
        off = 0
        for name, shape, _ in entries:
            n = dense._numel(shape)
            yield name, flat[off:off + n].view(shape)
            off += n
        del flat


@torch.no_grad()
def fill_model_(model: torch.nn.Module, cfg: dict, seed: int) -> None:
    """Copy the seeded weights into the port's module (its parameters and
    its float32 buffers), in place, one group at a time. Every parameter
    of the module must be in the layout, and the reverse."""
    params = dict(model.named_parameters())
    slots = dict(params, **dict(model.named_buffers()))
    seen = set()
    dev = next(iter(params.values())).device
    dtype = next(iter(params.values())).dtype
    for name, t in iter_params(cfg, seed, dev, dtype):
        p = slots.get(name)
        if p is None or tuple(p.shape) != tuple(t.shape):
            raise ValueError(f"the port's module has no parameter {name} of "
                             f"shape {tuple(t.shape)}")
        p.copy_(t)
        seen.add(name)
    missing = sorted(set(params) - seen)
    if missing:
        raise ValueError(f"parameters the layout does not draw: {missing[:5]}")


def weights(cfg: dict, seed: int, device, dtype=torch.bfloat16
            ) -> Dict[str, torch.Tensor]:
    """Every parameter, drawn anew, as name -> tensor."""
    return dict(iter_params(cfg, seed, device, dtype))
