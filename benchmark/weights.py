"""Seeded random weights, made by the benchmark itself.

`layout(cfg)` lists every parameter of a MetaMorph model (name, shape and
how it is drawn) from the configuration alone, in the names the port's
`MetaMorph` module gives its parameters. Parameters are drawn in groups:
one group is a parameter name with its layer index replaced by `*`
(`llama.layers.*.wq` is every layer's wq), drawn in ONE call on the device
from a generator seeded by (run seed, group name), in layer order. So a
group can be drawn again alone, bit for bit, on the same device: the
references draw the weights anew, group by group, rather than read the
program's modules.

Draws: dense weights N(0, fan_in^-1/2), the token embedding N(0, 1), norm
and layer-norm scales 1, biases 0.
"""

from __future__ import annotations

import re
import zlib
from collections import OrderedDict
from typing import Dict, Iterator, List, Tuple

import torch

_LAYER = re.compile(r"\.(\d+)\.")


def _dense_stack(prefix: str, dims) -> list:
    out = []
    for j, (di, do) in enumerate(dims):
        out.append((f"{prefix}.layers.{j}.kernel", (di, do), ("normal", di)))
        out.append((f"{prefix}.layers.{j}.bias", (do,), ("zeros",)))
    return out


def projector_dims(mm: dict, d_vis: int, d_model: int) -> list:
    """The projector's layer dims (mlpNx_gelu or linear)."""
    kind = mm["projector_type"]
    if kind == "linear":
        return [(d_vis, d_model)]
    depth = int(re.match(r"^mlp(\d+)x_gelu$", kind).group(1))
    return ([(d_vis, d_model)] + [(d_model, d_model)] * (depth - 1)
            if depth > 1 else [(d_vis, d_model)])


def head_dims(mm: dict, d_model: int, d_vis: int) -> list:
    """The vision head's layer dims (`mlp` or `linear`-to-vision)."""
    kind = mm["vision_head_type"]
    if kind == "mlp":
        return [(d_model, d_model), (d_model, d_vis)]
    if kind == "mlp2x_gelu":
        return [(d_model, d_model), (d_model, d_model), (d_model, d_vis)]
    return [(d_model, d_vis)]


def layout(cfg: dict) -> List[Tuple[str, tuple, tuple]]:
    """(name, shape, draw) of every parameter, for the configuration dict
    of a configuration file (`llama`, `siglip`, `mm` sections)."""
    lc, sc, mm = cfg["llama"], cfg["siglip"], cfg["mm"]
    D, F, V = lc["hidden_size"], lc["intermediate_size"], lc["vocab_size"]
    H, KV, Dh = lc["num_heads"], lc["num_kv_heads"], lc["head_dim"]
    out = [("llama.embed", (V, D), ("normal", 1))]
    for i in range(lc["num_layers"]):
        p = f"llama.layers.{i}."
        out += [(p + "wq", (D, H * Dh), ("normal", D)),
                (p + "wk", (D, KV * Dh), ("normal", D)),
                (p + "wv", (D, KV * Dh), ("normal", D)),
                (p + "wo", (H * Dh, D), ("normal", H * Dh)),
                (p + "w_gate", (D, F), ("normal", D)),
                (p + "w_up", (D, F), ("normal", D)),
                (p + "w_down", (F, D), ("normal", F)),
                (p + "input_norm", (D,), ("ones",)),
                (p + "post_attn_norm", (D,), ("ones",))]
    out.append(("llama.final_norm", (D,), ("ones",)))
    if not lc.get("tie_word_embeddings", False):
        out.append(("llama.lm_head", (D, V), ("normal", D)))
    Ds, Fs, P = sc["hidden_size"], sc["intermediate_size"], sc["patch_size"]
    n_patch = (sc["image_size"] // P) ** 2
    out += [("siglip.patch_kernel", (P, P, 3, Ds), ("normal", P * P * 3)),
            ("siglip.patch_bias", (Ds,), ("zeros",)),
            ("siglip.pos_embed", (n_patch, Ds), ("normal", Ds))]
    for i in range(sc["num_layers"]):
        p = f"siglip.layers.{i}."
        for ln in ("ln1", "ln2"):
            out += [(p + ln + "_scale", (Ds,), ("ones",)),
                    (p + ln + "_bias", (Ds,), ("zeros",))]
        for w in ("wq", "wk", "wv", "wo"):
            out += [(p + w, (Ds, Ds), ("normal", Ds)),
                    (p + "b" + w[1], (Ds,), ("zeros",))]
        out += [(p + "fc1", (Ds, Fs), ("normal", Ds)),
                (p + "fc1_bias", (Fs,), ("zeros",)),
                (p + "fc2", (Fs, Ds), ("normal", Fs)),
                (p + "fc2_bias", (Ds,), ("zeros",))]
    out += [("siglip.final_ln_scale", (Ds,), ("ones",)),
            ("siglip.final_ln_bias", (Ds,), ("zeros",))]
    out += _dense_stack("projector", projector_dims(mm, Ds, D))
    out += _dense_stack("vision_head", head_dims(mm, D, Ds))
    return out


def group_of(name: str) -> str:
    return _LAYER.sub(".*.", name)


def groups(cfg: dict) -> "OrderedDict[str, list]":
    """group name -> [(name, shape, draw)] in layer order."""
    out: "OrderedDict[str, list]" = OrderedDict()
    for entry in layout(cfg):
        out.setdefault(group_of(entry[0]), []).append(entry)
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def draw_group(cfg: dict, seed: int, group: str, device,
               dtype=torch.bfloat16) -> torch.Tensor:
    """The flat tensor of one group, drawn in one call."""
    entries = groups(cfg)[group]
    total = sum(_numel(s) for _, s, _ in entries)
    kind = entries[0][2]
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
    """(name, tensor) of every parameter (or of the groups in `only`),
    group by group; each tensor is a view of its group's flat draw."""
    for group, entries in groups(cfg).items():
        if only is not None and group not in only:
            continue
        flat = draw_group(cfg, seed, group, device, dtype)
        off = 0
        for name, shape, _ in entries:
            n = _numel(shape)
            yield name, flat[off:off + n].view(shape)
            off += n


@torch.no_grad()
def fill_model_(model: torch.nn.Module, cfg: dict, seed: int) -> None:
    """Copy the seeded weights into the port's module, in place. Every
    parameter of the module must be in the layout, and the reverse."""
    params = dict(model.named_parameters())
    seen = set()
    dev = next(iter(params.values())).device
    dtype = next(iter(params.values())).dtype
    for name, t in iter_params(cfg, seed, dev, dtype):
        p = params.get(name)
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
    """Every parameter, drawn anew, as name -> tensor (views of one flat
    tensor per group)."""
    return dict(iter_params(cfg, seed, device, dtype))
