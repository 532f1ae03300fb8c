"""The process-wide parallel context (counterpart of
`metamorph_tpu/parallel/context.py`).

`make_sharded_train_step` registers its mesh here, and with sequence
parallelism the axis the sequence is split over; the attention dispatch
(`ops/attention.py`) reads both to choose ring attention.

JAX's `constrain` and `act_spec` pin activation layouts for GSPMD. Eager
PyTorch needs no counterpart: each tensor is computed on the rank that
owns it, in the layout its code gives it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

_current_mesh = None
_sequence_axis: Optional[str] = None


def set_current_mesh(mesh) -> None:
    global _current_mesh
    _current_mesh = mesh


def get_current_mesh():
    return _current_mesh


def set_sequence_axis(axis: Optional[str]) -> None:
    """Enable sequence parallelism: each rank holds T / size(axis)
    positions of its rows. None disables."""
    global _sequence_axis
    _sequence_axis = axis


def get_sequence_axis() -> Optional[str]:
    return _sequence_axis


def sequence_group():
    """The process group of the registered sequence axis, or None when no
    axis of more than one rank is registered."""
    mesh, axis = _current_mesh, _sequence_axis
    if mesh is None or axis is None:
        return None
    sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    if sizes.get(axis, 1) == 1:
        return None
    return mesh.get_group(axis)


@dataclasses.dataclass(frozen=True)
class BatchShard:
    """This rank's share of the global batch in a sharded step: `group`
    holds the ranks whose rows (or, with the sequence split, positions)
    make up the global batch, over which the loss normalizers and the
    metrics are summed; with sequence parallelism the rank holds slice
    `seq_index` of `seq_count` equal slices of every row."""
    group: Any = None
    seq_index: int = 0
    seq_count: int = 1
