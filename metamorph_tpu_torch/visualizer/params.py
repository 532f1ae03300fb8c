"""The visualizer's weights as modules shaped like the JAX package's trees.

The JAX visualizer keeps its weights in nested dicts and lists
(`down/0/resnets/1/conv1/kernel`); its functions read them by key. The
port keeps the same tree as a module: a dict node is a `ParamTree`, a list
node an `nn.ModuleList`, a leaf a parameter (made frozen, as the render
path needs no gradient; the train step in `visualizer/train.py` sets
`requires_grad` on the trees it trains), so `.to(device, dtype)` moves
the whole tree and the port's functions read it as JAX's read theirs (`p["kernel"]`, `"shortcut" in p`,
`p.get("attns")`). A key JAX holds as None (a UNet level without
attention carries `attns: None`) stays None; a tree read back from files,
where JAX's `flatten_tree` drops it, lacks the key, which reads the same.
`state_dict()` names are the JAX keys with "." for "/".

Layouts: a dense kernel is [D_in, D_out] as in JAX; a conv kernel (every
4-d `kernel`) is torch's [out, in, kh, kw] where JAX's is HWIO.
`tree_from_jax` / `tree_to_jax` move numpy trees across;
`flat_to_jax` gives the flat keys and layouts JAX's checkpoint files hold.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn


class ParamTree(nn.Module):
    """One dict node of a parameter tree (see the module docstring)."""

    def __init__(self, tree: Mapping[str, Any]):
        super().__init__()
        self._none = []
        for k, v in tree.items():
            if v is None:
                self._none.append(k)
            elif isinstance(v, torch.Tensor):
                self.register_parameter(
                    k, nn.Parameter(v, requires_grad=False))
            elif isinstance(v, Mapping):
                self.add_module(k, ParamTree(v))
            else:
                self.add_module(k, nn.ModuleList(ParamTree(x) for x in v))

    def __getitem__(self, k: str):
        if k in self._none:
            return None
        if k in self._parameters:
            return self._parameters[k]
        if k in self._modules:
            return self._modules[k]
        raise KeyError(k)

    def __contains__(self, k: str) -> bool:
        return k in self._parameters or k in self._modules or k in self._none

    def get(self, k: str, default=None):
        return self[k] if k in self else default

    def keys(self):
        return [*self._parameters, *self._modules, *self._none]

    def copy_to(self, device, dtype: Optional[torch.dtype] = None
                ) -> "ParamTree":
        """A copy of the tree on `device`, floating leaves cast to `dtype`
        when given."""

        def leaf(path, t):
            to = dtype if dtype is not None and t.is_floating_point() \
                else t.dtype
            return t.to(device=device, dtype=to, copy=True)

        return ParamTree(map_leaves(self.to_tree(), leaf))

    def to_tree(self) -> Dict[str, Any]:
        """The nested dict of tensors (views of the parameters)."""
        out: Dict[str, Any] = {}
        for k in self.keys():
            v = self[k]
            if isinstance(v, ParamTree):
                v = v.to_tree()
            elif isinstance(v, nn.ModuleList):
                v = [x.to_tree() for x in v]
            out[k] = v.data if isinstance(v, nn.Parameter) else v
        return out


def map_leaves(tree, fn, path: str = ""):
    """The tree with each leaf x replaced by fn(path, x), path being its
    flatten_tree key ("down/0/resnets/1/conv1/kernel"); None stays."""
    if tree is None:
        return None
    if isinstance(tree, Mapping):
        return {k: map_leaves(v, fn, f"{path}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_leaves(v, fn, f"{path}{i}/") for i, v in enumerate(tree)]
    return fn(path[:-1], tree)


def is_conv(path: str, x) -> bool:
    """Whether the leaf at `path` is a conv kernel (4-d, layouts differ)."""
    return path.rsplit("/", 1)[-1] == "kernel" and x.ndim == 4


def tree_from_jax(tree, device, dtype: Optional[torch.dtype] = None
                  ) -> ParamTree:
    """A tree in JAX's layout (HWIO convs; numpy arrays or tensors, e.g.
    the views of a mapped safetensors file) -> ParamTree of copies on
    `device` in the port's layout. Floating leaves are cast to `dtype`
    when given; their bits are kept otherwise."""

    def leaf(path, x):
        if isinstance(x, torch.Tensor):
            t, copied = x, False
        elif np.asarray(x).dtype.name == "bfloat16":   # ml_dtypes
            t = torch.from_numpy(np.array(x, np.float32)).bfloat16()
            copied = True
        else:
            t, copied = torch.from_numpy(np.array(x)), True
        if is_conv(path, t):
            t = t.permute(3, 2, 0, 1)
        to = dtype if dtype is not None and t.is_floating_point() else t.dtype
        return t.to(device=device, dtype=to, copy=not copied).contiguous()

    return ParamTree(map_leaves(tree, leaf))


def tree_to_jax(module: ParamTree) -> Dict[str, Any]:
    """ParamTree -> the JAX numpy tree (HWIO convs), bit for bit (bf16
    leaves as float32, which holds them exactly)."""

    def leaf(key, t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        a = t.numpy()
        return np.ascontiguousarray(a.transpose(2, 3, 1, 0)
                                    if is_conv(key, a) else a)

    return map_leaves(module.to_tree(), leaf)


def flat_to_jax(module: ParamTree) -> Dict[str, torch.Tensor]:
    """ParamTree -> {JAX flatten_tree key: tensor in JAX's layout} (views,
    on the module's device), as `save_visualizer` writes them."""
    out = {}
    for name, p in module.state_dict().items():
        key = name.replace(".", "/")
        out[key] = p.permute(2, 3, 1, 0) if is_conv(key, p) else p
    return out
