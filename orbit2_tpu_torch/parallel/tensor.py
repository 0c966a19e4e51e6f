"""The mesh's autograd collectives: Megatron tensor parallelism's two and
the split a Linear carries (the reference's dist_functions.py), the token
split over the seq axis, and the expert axis's sum.

A column-split Linear holds the output rows of its rank (for a packed
projection such as attention's qkv: the rank's heads of each of q, k and v)
and computes on a replicated input: `copy_to_tensor` passes the input on
and sums its gradient over the tensor group. A row-split Linear holds the
input columns of its rank and produces a partial sum: `reduce_from_tensor`
sums it over the tensor group, and passes the gradient on. The parameters
are DTensors (parallel/sharding.py); the products run on their local
shards (`local`). Both take any process group: an MoE layer sums its
experts' outputs over the expert (x tensor) group with them
(models/components/moe.py).

Over the seq axis (`SeqSplit`) a rank holds one contiguous slice of the
tokens:
  * `split_tokens` takes the rank's slice of replicated tokens; its
    backward all-gathers the slices' gradients, so what ran before the
    split gets the whole gradient on every rank;
  * `gather_tokens` all-gathers the slices back into replicated tokens;
    its backward takes the rank's slice (every rank computes the same
    loss from them, so the gradient is already whole);
  * `gather_seq` all-gathers a slice whose consumers on every rank
    contribute to its gradient (sequence attention's k and v): the
    backward reduce-scatters, summing each slice's gradient on its home
    rank;
  * `all_to_all` swaps one dim's split for another's (Ulysses: tokens for
    heads); its backward swaps back;
  * `ring_shift` (no autograd) hands a tensor to the next rank of the ring
    and takes the previous rank's, with one all_to_all_single whose only
    non-empty piece goes to the next rank (NCCL and gloo both take it, on
    CUDA tensors too; gloo refuses send/recv on them).

Over the data axes, `all_reduce_sum` sums a tensor whose every rank's
copy feeds that rank's loss (BatchNorm's batch moments,
models/components/cnn.py): its backward sums the gradients the same way,
so each rank's input gets the gradient of every rank's loss through the
sum.

Over the stage axis (parallel/pipeline.py) `stage_shift` hands a
microbatch's activations to the next stage, and from the last to the first
where the schedule is interleaved; its backward hands the gradient back the
other way. Both are a ring_shift, so the hop uses no point-to-point op.
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


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """x summed over `group`; the gradient summed over it too."""
    return _AllReduceSum.apply(x, group)


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


@dataclass(frozen=True)
class ExpertSplit:
    """How an MoE layer is split over the expert and tensor axes: `group`,
    the expert x tensor ranks its output is summed over; experts `first` ..
    `first + count - 1` are this rank's; the tensor axis's group, size and
    this rank's coordinate (its rank 0 alone adds the output bias, which
    every tensor rank holds)."""

    group: object
    first: int
    count: int
    tensor_group: object
    tensor_size: int
    tensor_rank: int


@dataclass(frozen=True)
class SeqSplit:
    """The seq axis a ResSlimViT's tokens are split over: its process group,
    size, this rank's coordinate and the sequence attention (`impl`:
    gather | ring | ulysses, ops/seq_attention.py)."""

    group: object
    size: int
    rank: int
    impl: str = "gather"


def _gather(x: torch.Tensor, dim: int, group, size: int) -> torch.Tensor:
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((size * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out.movedim(0, dim)


def _reduce_scatter(x: torch.Tensor, dim: int, group, size: int) -> torch.Tensor:
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((x.shape[0] // size, *x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, group=group)
    return out.movedim(0, dim)


def _slice(x: torch.Tensor, dim: int, size: int, rank: int) -> torch.Tensor:
    return x.chunk(size, dim)[rank]


class _SplitTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, split):
        ctx.dim, ctx.split = dim, split
        return _slice(x, dim, split.size, split.rank).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return _gather(grad, ctx.dim, ctx.split.group, ctx.split.size), None, None


class _GatherTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, split):
        ctx.dim, ctx.split = dim, split
        return _gather(x, dim, split.group, split.size)

    @staticmethod
    def backward(ctx, grad):
        return _slice(grad, ctx.dim, ctx.split.size, ctx.split.rank).contiguous(), None, None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, split):
        ctx.dim, ctx.split = dim, split
        return _gather(x, dim, split.group, split.size)

    @staticmethod
    def backward(ctx, grad):
        return _reduce_scatter(grad, ctx.dim, ctx.split.group, ctx.split.size), None, None


def _all_to_all(x: torch.Tensor, split_dim: int, concat_dim: int, group,
                size: int) -> torch.Tensor:
    parts = torch.stack(x.chunk(size, split_dim)).contiguous()
    out = torch.empty_like(parts)
    dist.all_to_all_single(out, parts, group=group)
    return torch.cat(out.unbind(0), concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, split):
        ctx.dims, ctx.split = (split_dim, concat_dim), split
        return _all_to_all(x, split_dim, concat_dim, split.group, split.size)

    @staticmethod
    def backward(ctx, grad):
        split_dim, concat_dim = ctx.dims
        return (_all_to_all(grad, concat_dim, split_dim, ctx.split.group, ctx.split.size),
                None, None, None)


def split_tokens(x: torch.Tensor, split: SeqSplit, dim: int = 1) -> torch.Tensor:
    """This rank's slice of replicated x along `dim` (which `split.size`
    must divide); the gradient all-gathered."""
    if x.shape[dim] % split.size:
        raise ValueError(f"{x.shape[dim]} tokens do not split over a seq axis of {split.size}")
    return _SplitTokens.apply(x, dim, split)


def gather_tokens(x: torch.Tensor, split: SeqSplit, dim: int = 1) -> torch.Tensor:
    """The slices of every seq rank along `dim`, in rank order; the gradient
    the rank's slice."""
    return _GatherTokens.apply(x, dim, split)


def gather_seq(x: torch.Tensor, split: SeqSplit, dim: int = 1) -> torch.Tensor:
    """The slices of every seq rank along `dim`, in rank order; the gradient
    reduce-scattered (each slice's summed over the ranks, on its rank)."""
    return _GatherSeq.apply(x, dim, split)


def all_to_all(x: torch.Tensor, split: SeqSplit, split_dim: int, concat_dim: int) -> torch.Tensor:
    """Piece i of x along `split_dim` to rank i; the pieces received, in rank
    order, concatenated along `concat_dim`. Differentiable."""
    return _AllToAll.apply(x, split_dim, concat_dim, split)


def ring_shift(t: torch.Tensor, group, size: int, rank: int, step: int = 1,
               wrap: bool = True) -> torch.Tensor:
    """t of rank r - step (mod size) on rank r: every rank hands its t to
    the rank `step` (1 or -1) further on. wrap=False keeps the ring's ends
    apart: the last rank along `step` hands nothing on, and the first
    receives zeros. Not differentiable."""
    flat = t.contiguous().view(-1)
    send, recv = [0] * size, [0] * size
    to, frm = rank + step, rank - step
    if wrap or 0 <= to < size:
        send[to % size] = flat.numel()
    if wrap or 0 <= frm < size:
        recv[frm % size] = flat.numel()
    out = torch.empty_like(flat) if sum(recv) else torch.zeros_like(flat)
    # the pieces' sizes must add up to each tensor's
    dist.all_to_all_single(out[:sum(recv)], flat[:sum(send)], output_split_sizes=recv,
                           input_split_sizes=send, group=group)
    return out.view(t.shape)


class _StageShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, rank, wrap):
        ctx.args = group, size, rank, wrap
        return ring_shift(x, group, size, rank, 1, wrap)

    @staticmethod
    def backward(ctx, grad):
        group, size, rank, wrap = ctx.args
        return ring_shift(grad, group, size, rank, -1, wrap), None, None, None, None


def stage_shift(x: torch.Tensor, split) -> torch.Tensor:
    """x of the previous stage of `split` (parallel/pipeline.py::StageSplit)
    on this one: the last stage's on the first where the schedule is
    interleaved (split.interleave > 1), else zeros there. The gradient goes
    back the other way. Every stage calls it at once."""
    return _StageShift.apply(x, split.group, split.size, split.rank, split.interleave > 1)


__all__ = ["ExpertSplit", "SeqSplit", "TensorSplit", "all_reduce_sum", "all_to_all",
           "copy_to_tensor", "gather_seq", "gather_tokens", "local", "reduce_from_tensor",
           "ring_shift", "split_tokens", "stage_shift"]
