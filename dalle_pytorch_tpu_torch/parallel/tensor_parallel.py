"""What the model code reads of the mesh while the sharded train step runs
it (`parallel/train_step.py`), and Megatron's collectives as autograd
functions.

The JAX package writes no collective: GSPMD derives them from the sharding
annotations.  The port runs one process per device and calls them itself:

  copy_to_tp       Megatron's f: the identity forward, an all-reduce of the
                   gradient over tp backward (the input of a column-parallel
                   projection)
  reduce_from_tp   Megatron's g: an all-reduce over tp forward, the identity
                   backward (the output of a row-parallel projection)
  gather_rows      the rows of every data rank, in rank order (CLIP's
                   contrastive loss over the global batch); backward, each
                   rank's rows of the summed gradient
  gather_seq       the sequence parts of every sp rank along a dim (K and
                   V of the attention that sp gathers, as GSPMD partitions
                   the JAX package's dense attention); backward, this
                   rank's part of the summed gradient (a reduce-scatter)

They read the step's `core/shard.ShardContext` (the tp group and this
rank's place in it, the data ranks' group).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from dalle_pytorch_tpu_torch.core.shard import current


def local_slice(total: int, rank: int, parts: int) -> slice:
    """The contiguous part `rank` of `parts` of a dim of `total`; a dim that
    `parts` does not divide raises."""
    if total % parts:
        raise ValueError(f"a dim of {total} does not split into {parts} equal parts")
    size = total // parts
    return slice(rank * size, (rank + 1) * size)


# torch 2.13 has `all_gather_single` and `reduce_scatter_single` and warns
# on the old names; a release without the new names takes the old ones
_ALL_GATHER = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def all_gather_into(out: torch.Tensor, x: torch.Tensor, group) -> None:
    _ALL_GATHER(out, x.contiguous(), group=group)


def reduce_scatter_into(out: torch.Tensor, x: torch.Tensor, group) -> None:
    _REDUCE_SCATTER(out, x.contiguous(), group=group)


def gather_dim(x: torch.Tensor, dim: int, group, parts: int) -> torch.Tensor:
    """The parts of `x` on the ranks of `group`, concatenated along `dim` in
    rank order."""
    if parts == 1:
        return x
    moved = x.movedim(dim, 0).contiguous()
    out = torch.empty((parts * moved.shape[0], *moved.shape[1:]), dtype=x.dtype, device=x.device)
    all_gather_into(out, moved, group)
    return out.movedim(0, dim)


def scatter_dim(x: torch.Tensor, dim: int, group, parts: int) -> torch.Tensor:
    """This rank's part along `dim` of the sum of `x` over `group`
    (a reduce-scatter)."""
    if parts == 1:
        return x
    moved = x.movedim(dim, 0).contiguous()
    out = torch.empty((moved.shape[0] // parts, *moved.shape[1:]), dtype=x.dtype, device=x.device)
    reduce_scatter_into(out, moved, group)
    return out.movedim(0, dim)


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, parts, rank):
        ctx.slice = local_slice(x.shape[-1] * parts, rank, parts)
        return gather_dim(x, x.ndim - 1, group, parts)

    @staticmethod
    def backward(ctx, g):
        return g[..., ctx.slice], None, None, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, parts, dim=0):
        ctx.group, ctx.parts, ctx.dim = group, parts, dim
        return gather_dim(x, dim, group, parts)

    @staticmethod
    def backward(ctx, g):
        return scatter_dim(g, ctx.dim, ctx.group, ctx.parts), None, None, None


def copy_to_tp(x: torch.Tensor) -> torch.Tensor:
    ctx = current()
    return _CopyToTP.apply(x, ctx.tp_group) if ctx.tp else x


def reduce_from_tp(x: torch.Tensor) -> torch.Tensor:
    ctx = current()
    return _ReduceFromTP.apply(x, ctx.tp_group) if ctx.tp else x


def max_over_tp(x: torch.Tensor) -> torch.Tensor:
    """The elementwise max of `x` over the tp ranks (no gradient)."""
    ctx = current()
    if ctx.tp:
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=ctx.tp_group)
    return x


def gather_from_tp(x: torch.Tensor) -> torch.Tensor:
    """The tp ranks' parts of the last dim, concatenated (the whole
    vocabulary of vocab-parallel logits); backward, this rank's part."""
    ctx = current()
    return _GatherLast.apply(x, ctx.tp_group, ctx.tp_size, ctx.tp_rank) if ctx.tp else x


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every data rank's rows of `x`, in rank order (the global batch);
    backward, this rank's rows of the gradient summed over the data ranks,
    so that a loss every data rank computes on the global rows gives, once
    the step averages the gradients over those ranks, the global gradient."""
    ctx = current()
    return x if ctx.data_size == 1 else _GatherRows.apply(x, ctx.data_group, ctx.data_size)


def gather_seq(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Every sp rank's part of `x` along `dim` (the sequence), in rank
    order; backward, this rank's part of the gradient summed over the sp
    ranks."""
    ctx = current()
    return x if not ctx.sp else _GatherRows.apply(x, ctx.sp_group, ctx.sp_size, dim)


def tp_linear_out(x: torch.Tensor, linear: torch.nn.Module) -> torch.Tensor:
    """A row-parallel projection: the product of this rank's input columns,
    summed over tp (g), then the bias once."""
    if not current().tp:
        return linear(x)
    y = reduce_from_tp(torch.nn.functional.linear(x, linear.weight))
    return y if linear.bias is None else y + linear.bias
