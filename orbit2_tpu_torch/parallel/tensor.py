"""Megatron tensor parallelism's two collectives and the split a Linear
carries (the reference's dist_functions.py, as autograd functions).

A column-split Linear holds the output rows of its rank (for a packed
projection such as attention's qkv: the rank's heads of each of q, k and v)
and computes on a replicated input: `copy_to_tensor` passes the input on
and sums its gradient over the tensor group. A row-split Linear holds the
input columns of its rank and produces a partial sum: `reduce_from_tensor`
sums it over the tensor group, and passes the gradient on. The parameters
are DTensors (parallel/sharding.py); the products run on their local
shards (`local`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor


def local(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """The local shard of a DTensor (differentiable), else t itself."""
    return t.to_local() if isinstance(t, DTensor) else t


class _CopyToTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_tensor(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the gradient summed over `group`."""
    return _CopyToTensor.apply(x, group)


def reduce_from_tensor(x: torch.Tensor, group) -> torch.Tensor:
    """x summed over `group`; the gradient passed on."""
    return _ReduceFromTensor.apply(x, group)


@dataclass(frozen=True)
class TensorSplit:
    """How a Linear is split over the tensor axis: mode "col" (output rows)
    or "row" (input columns), the axis's process group, size and this rank's
    coordinate, and `packs`, the number of projections packed in a column
    split's rows (3 for qkv, 2 for var_agg's kv), each split by heads."""

    mode: str
    group: object
    size: int
    rank: int
    packs: int = 1

    def copy_in(self, x: torch.Tensor) -> torch.Tensor:
        """A column split's replicated input (its gradient summed)."""
        return copy_to_tensor(x, self.group)

    def heads_of(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of each pack of a replicated [packs * n, ...]
        tensor (differentiable; the gradient is summed over the group, so the
        replicated tensor's gradient is whole on every rank)."""
        t = self.copy_in(t)
        return t.reshape(self.packs, self.size, -1, *t.shape[1:])[:, self.rank].reshape(
            -1, *t.shape[1:])


__all__ = ["TensorSplit", "copy_to_tensor", "local", "reduce_from_tensor"]
