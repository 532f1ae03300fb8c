"""The device mesh (counterpart of `metamorph_tpu/parallel/mesh.py`).

JAX builds a `jax.sharding.Mesh` over its devices and lets XLA emit the
collectives. The port builds a `torch.distributed.DeviceMesh` of the same
three axes ("data", "fsdp", "tensor") over the ranks of a process group,
one rank per card: NCCL on cards, gloo on the CPU (which the tests use).
The collectives are PyTorch's own (FSDP2's all-gather and reduce-scatter,
all-reduces, point-to-point sends for ring attention).

A process group comes from `init_distributed`: from torchrun's environment
(`env://`), or from a store the caller passes (the tests give each run a
`FileStore` under its temporary directory, so that parallel test workers
never race for a TCP port). On a card the backend is NCCL and nothing
falls back: a missing NCCL raises.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from metamorph_tpu_torch.config import MeshConfig

AXES = ("data", "fsdp", "tensor")


def mesh_shape(cfg: MeshConfig, n: int) -> Tuple[int, int, int]:
    """(data, fsdp, tensor) over n devices: an axis of -1 absorbs the
    remaining devices; JAX's `build_mesh` errors otherwise."""
    sizes = [cfg.data, cfg.fsdp, cfg.tensor]
    n_fixed = 1
    for s in sizes:
        if s != -1:
            n_fixed *= s
    n_auto = sizes.count(-1)
    if n_auto > 1:
        raise ValueError("at most one mesh axis may be -1")
    if n_auto == 1:
        sizes = [n // n_fixed if s == -1 else s for s in sizes]
    total = sizes[0] * sizes[1] * sizes[2]
    if total != n:
        raise ValueError(f"mesh {sizes} does not cover {n} devices")
    return tuple(sizes)


def backend_for(device_type: str) -> str:
    """NCCL for cards, gloo for the CPU; raises when NCCL is missing."""
    if device_type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("training on cards needs NCCL, which this "
                               "PyTorch build lacks")
        return "nccl"
    if device_type == "cpu":
        return "gloo"
    raise ValueError(f"no process-group backend for device type "
                     f"{device_type!r}")


def init_distributed(device_type: str = "cuda", store=None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     device: Optional[torch.device] = None) -> None:
    """Start the default process group unless one exists. Without a store,
    from torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT;
    raises when they are missing); with one, the caller names rank and
    world size. On a card the group is NCCL, bound to `device`."""
    if dist.is_initialized():
        group_backend = dist.get_backend()
        if group_backend != backend_for(device_type):
            raise RuntimeError(f"a {group_backend} process group exists; "
                               f"{device_type} tensors need "
                               f"{backend_for(device_type)}")
        return
    backend = backend_for(device_type)
    kw = {}
    if device_type == "cuda" and device is not None:
        kw["device_id"] = device
    if store is None:
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                               "MASTER_PORT") if k not in os.environ]
        if missing:
            raise RuntimeError(
                f"multihost training reads torchrun's environment, which "
                f"lacks {missing}: launch with `torchrun --nproc_per_node N "
                f"...`, or initialise torch.distributed first")
        dist.init_process_group(backend, init_method="env://", **kw)
    else:
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world_size, **kw)


def check_backend(device: torch.device, group=None) -> None:
    """Raises unless the backend of `group` (default: the default group)
    serves `device`'s tensors (NCCL for a card, gloo for the CPU): no CUDA
    tensor goes over gloo."""
    want = backend_for(device.type)
    have = dist.get_backend(group)
    if have != want:
        raise RuntimeError(f"{device.type} tensors on a {have} process "
                           f"group: {want} is needed")


def build_mesh(cfg: MeshConfig, device_type: str = "cuda") -> DeviceMesh:
    """A (data, fsdp, tensor) DeviceMesh over every rank of the default
    process group, rank r at the row-major position r (JAX's reshape of
    its device list)."""
    if not dist.is_initialized():
        raise RuntimeError("build_mesh needs a process group "
                           "(init_distributed)")
    n = dist.get_world_size()
    shape = mesh_shape(cfg, n)
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=AXES)


def single_device_mesh(device_type: str = "cuda") -> DeviceMesh:
    """The (1, 1, 1) mesh of a one-rank process group."""
    return build_mesh(MeshConfig(data=1, fsdp=1, tensor=1), device_type)


def axis_sizes(mesh: DeviceMesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def dp_coordinate(mesh: DeviceMesh, sequence_parallel: bool
                  ) -> Tuple[int, int]:
    """(index, count) of this rank's share of the global batch: its place
    in data x fsdp, or, with the sequence over fsdp, in data alone. Ranks
    with one coordinate (tensor peers, sequence peers) load the same
    rows."""
    sizes = axis_sizes(mesh)
    d = mesh.get_local_rank("data")
    if sequence_parallel:
        return d, sizes["data"]
    return d * sizes["fsdp"] + mesh.get_local_rank("fsdp"), \
        sizes["data"] * sizes["fsdp"]


def subgroup(mesh: DeviceMesh, dims: Tuple[str, ...]):
    """The process group of the ranks that share this rank's coordinates
    on every axis outside `dims` (a flattened submesh). Every rank must
    call it, in the same order: each group of the partition is made."""
    names = mesh.mesh_dim_names
    keep = [names.index(d) for d in dims]
    rest = [i for i in range(len(names)) if i not in keep]
    n_keep = 1
    for i in keep:
        n_keep *= mesh.mesh.shape[i]
    grid = mesh.mesh.permute(*rest, *keep).reshape(-1, n_keep)
    mine = None
    for ranks in grid.tolist():
        g = dist.new_group(ranks)
        if dist.get_rank() in ranks:
            mine = g
    return mine
