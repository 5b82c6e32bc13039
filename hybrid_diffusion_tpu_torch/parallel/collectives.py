"""The collectives the parallel layer differentiates through.

  - `group_sum`: a statistic of the global batch that every rank computes
    identically from its own rows' partial sum. Forward: all-reduce (sum).
    Backward: all-reduce (sum) of the incoming gradient. Every rank then
    holds W·∂L/∂(its partial), and the data-parallel average (1/W) gives
    each parameter the global batch's gradient.
  - `copy_to_model` / `reduce_from_model`: Megatron's f and g conjugates
    around a head-sharded layer. f is identity forward and all-reduce
    backward (before the sharded in-projection: each rank's input gradient
    holds only its heads' part; summed in fp32); g is all-reduce forward and identity
    backward (after the sharded out-projection: the output is replicated,
    so every rank's gradient is already whole).
    `torch.distributed.nn.functional.all_reduce` sums in its backward too,
    which would give the replicated activations here W times their
    gradient; hence these Functions.
  - `all_gather_rows`: the rows of every rank, concatenated, through an
    all-reduce of zero-padded buffers (adding zeros is exact). All-reduce
    is the one reduction every backend takes for CPU and CUDA tensors
    alike (gloo's all_gather does not take CUDA tensors).

With group None (one rank) each is the identity and calls nothing.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """In-place sum over `group` (no autograd); x when group is None."""
    if group is not None:
        dist.all_reduce(x, group=group)
    return x


class _GroupSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(), ctx.group), None


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        # Summed in fp32: a bf16 sum of the ranks' partial gradients would
        # round once more than one process's fp32-accumulated product.
        return all_reduce_(grad.float(), ctx.group).to(grad.dtype), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def group_sum(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _GroupSum.apply(x, group)


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFromModel.apply(x, group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


@torch.no_grad()
def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's `x` stacked along dim 0 in group-rank order (each rank
    holds x.shape[0] rows); on every rank."""
    n = size(group)
    if n == 1:
        return x
    rows = x.shape[0]
    out = x.new_zeros((rows * n,) + tuple(x.shape[1:]))
    r = group_rank(group)
    out[r * rows:(r + 1) * rows] = x
    return all_reduce_(out, group)
