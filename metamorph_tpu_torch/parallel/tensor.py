"""Megatron tensor parallelism's two collectives, as autograd Functions
(the port's counterpart of the `tensor` entries of JAX's sharding rules,
`metamorph_tpu/parallel/sharding.py:23-47`, where GSPMD inserts them).

A decoder layer split over the tensor group holds wq/wk/wv/w_gate/w_up cut
on D_out and wo/w_down cut on D_in. `copy_in` goes before the column
products (identity forward, all-reduce of the input's gradient backward);
`reduce_out` after the row products (all-reduce of the partial sums
forward, identity backward). With no group both are the identity.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_in(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyIn.apply(x, group)


def reduce_out(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceOut.apply(x, group)
