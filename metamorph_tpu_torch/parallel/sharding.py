"""The sharding plan (counterpart of `metamorph_tpu/parallel/sharding.py`).

JAX annotates each parameter with a PartitionSpec over ("fsdp", "tensor")
from a table of path rules and lets GSPMD shard it and emit the
collectives. The port follows the same table with PyTorch's own stack:
  * the "fsdp" axis is FSDP2 (`fully_shard`) over the (data, fsdp) submesh,
    "data" being its replicate dimension (HSDP): each LLaMA decoder layer
    and each SigLIP layer is a unit of its own, everything else belongs to
    the root unit. FSDP2 cuts every parameter of a unit on dim 0 (torch.
    chunk's uneven cut), so the optimizer moments, which are made from the
    local shards, are sharded alike (ZeRO-3 with ZeRO-2's moments). Its
    gradients are summed, not averaged: the loss is already normalized by
    the global batch's token counts;
  * the "tensor" axis is Megatron's cut of each LLaMA decoder layer
    (`apply_tensor_parallel`): wq/wk/wv/w_gate/w_up on D_out, wo/w_down on
    D_in, with the two collectives of `parallel/tensor.py`. A layer whose
    heads or MLP width do not divide by the tensor size stays whole (JAX
    replicates a dim that does not divide).

`partition_specs` reports where each parameter of the port lives, in
JAX's notation (one entry per dim: an axis name, a tuple of names, or
None). It differs from JAX's table where the port deliberately differs:
  * FSDP2 shards every parameter, norm scales and biases included, and
    always on dim 0, unevenly where the dim does not divide (JAX
    replicates those);
  * the embedding, lm_head, the SigLIP tower, the projector and the
    vision head are not cut on "tensor" (they are sharded by FSDP only;
    the numbers are the same);
  * wo and w_down are cut on dim 0 by both axes ((tensor, fsdp)), where
    JAX puts tensor on dim 0 and fsdp on dim 1.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from metamorph_tpu_torch.models.llama import DENSE_NAMES, ROW_NAMES

# (parameter name in a LlamaLayer) -> dim cut over "tensor"
TENSOR_DIMS = {**{n: 1 for n in DENSE_NAMES if n not in ROW_NAMES},
               **{n: 0 for n in ROW_NAMES}}
# LoRA factors: a column product's b is cut on D_out, a row product's a on
# D_in; the other factor stays whole
TENSOR_DIMS.update({f"{n}_lora_b": 1 for n in DENSE_NAMES
                    if n not in ROW_NAMES})
TENSOR_DIMS.update({f"{n}_lora_a": 0 for n in ROW_NAMES})


def _layer_splits(cfg, t: int) -> bool:
    return (cfg.num_heads % t == 0 and cfg.num_kv_heads % t == 0
            and cfg.intermediate_size % t == 0)


@torch.no_grad()
def apply_tensor_parallel(model: nn.Module, mesh) -> Dict[str, int]:
    """Cut each LLaMA decoder layer over the mesh's "tensor" axis in place
    (each rank keeps its slice of the full weights it holds) and set the
    layer's tensor group. Returns {parameter name: cut dim} of the cut
    parameters. A no-op on a tensor axis of one rank."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    t = sizes["tensor"]
    if t == 1:
        return {}
    llama = model.llama
    llama.cfg.require_gqa("tensor parallelism")
    if not _layer_splits(llama.cfg, t):
        return {}
    group = mesh.get_group("tensor")
    r = mesh.get_local_rank("tensor")
    cut = {}
    for l, layer in enumerate(llama.layers):
        for name, dim in TENSOR_DIMS.items():
            p = getattr(layer, name)
            if p is None:
                continue
            part = p.detach().chunk(t, dim)[r].clone()
            setattr(layer, name, nn.Parameter(part,
                                              requires_grad=p.requires_grad))
            cut[f"llama.layers.{l}.{name}"] = dim
        layer.tp_group = group
    return cut


def fsdp_units(model: nn.Module):
    """The modules FSDP2 wraps on their own, before the root: each LLaMA
    decoder layer and each SigLIP layer."""
    return [*model.llama.layers, *model.siglip.layers]


def apply_fsdp(model: nn.Module, mesh) -> nn.Module:
    """FSDP2 over the (data, fsdp) submesh (HSDP: replicated over data,
    sharded over fsdp), each unit of `fsdp_units` and then the root, with
    summed (not averaged) gradients."""
    from torch.distributed.fsdp import fully_shard

    dp_mesh = mesh["data", "fsdp"]
    units = fsdp_units(model)
    for unit in units:
        fully_shard(unit, mesh=dp_mesh)
    fully_shard(model, mesh=dp_mesh)
    for unit in [*units, model]:
        unit.set_gradient_divide_factor(1.0)
        # plain sums: gloo has no pre-multiplied sum, and with a factor of
        # 1 there is nothing to scale
        unit.set_force_sum_reduction_for_comms(True)
    return model


def partition_specs(model: nn.Module, mesh,
                    tensor_cut: Optional[Dict[str, int]] = None
                    ) -> Dict[str, Tuple]:
    """{parameter name: spec}: for each dim of the full parameter, the mesh
    axes it is cut over ("tensor", "fsdp", both as a tuple, or None). With
    `tensor_cut` (from `apply_tensor_parallel`) the tensor cut is the one
    applied, else the one `apply_tensor_parallel` would apply. A tensor
    cut needs the dim to divide, as JAX's rule; FSDP2's cut of dim 0 does
    not (see the module docstring)."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    t, f = sizes["tensor"], sizes["fsdp"]
    if tensor_cut is None:
        tensor_cut = {}
        if t > 1 and _layer_splits(model.llama.cfg, t):
            for n, p in model.named_parameters():
                parts = n.split(".")
                if n.startswith("llama.layers.") and parts[-1] in TENSOR_DIMS:
                    tensor_cut[n] = TENSOR_DIMS[parts[-1]]
    out = {}
    for n, p in model.named_parameters():
        spec = [[] for _ in range(p.dim())]
        if n in tensor_cut:
            spec[tensor_cut[n]].append("tensor")
        if f > 1 and p.dim():
            spec[0].append("fsdp")
        out[n] = tuple(None if not s else s[0] if len(s) == 1 else tuple(s)
                       for s in spec)
    return out
