"""What model code reads of the sharded train step it runs under, and the
random draws that do not depend on how the batch is sharded.

`ShardContext` is what the step (`parallel/sharding.MeshPlan.context`)
publishes around its forward and backward: the tp group with this rank's
place in it, this rank's rows of the global micro-batch, and, when the model
shards the sequence over sp or pipelines its layers over pp, this rank's
place on those axes (its part of the sequence, its stage's layers).  It is a plain
module global, not a thread-local: the backward, which rebuilds layers
under remat and reversible execution, may run on autograd's device threads.
Outside a sharded step `current()` is the one-process context.

`uniform` draws each element from a hash of (a key the generator draws,
the element's row in the global micro-batch, its index within the row), so
a rank computes its own rows, sequence positions and columns alone and gets
the values a one-process run gets at the same places.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ShardContext:
    tp_group: Optional[object] = None
    tp_rank: int = 0
    tp_size: int = 1
    # this rank's rows [row_start, row_start + local rows) of a micro-batch
    # of row_total rows
    row_start: int = 0
    row_total: Optional[int] = None
    data_group: Optional[object] = None
    data_size: int = 1
    # the sequence sharded over sp: the group, this rank's place, the global
    # ranks of the group in order (its ring), and the first global position
    # of this rank's part
    sp_group: Optional[object] = None
    sp_rank: int = 0
    sp_size: int = 1
    sp_ranks: Tuple[int, ...] = ()
    seq_start: int = 0
    # the layers pipelined over pp: this rank's stage, the global ranks of
    # the stages in order, and the stage's chunks of layers ((start, stop),
    # in the order a micro-batch reaches them)
    pp_rank: int = 0
    pp_size: int = 1
    pp_ranks: Tuple[int, ...] = ()
    pp_chunks: Tuple[Tuple[int, int], ...] = ()

    @property
    def tp(self) -> bool:
        return self.tp_size > 1

    @property
    def sp(self) -> bool:
        return self.sp_size > 1

    @property
    def pp(self) -> bool:
        return self.pp_size > 1


_current = ShardContext()


def current() -> ShardContext:
    return _current


@contextlib.contextmanager
def shard_context(ctx: ShardContext):
    global _current
    outer, _current = _current, ctx
    try:
        yield ctx
    finally:
        _current = outer


_M32 = 0xFFFFFFFF


def _mix(x: torch.Tensor) -> torch.Tensor:
    """A bijective 32-bit integer hash of int64 values in [0, 2^32); the
    products stay below 2^59."""
    x = ((x >> 16) ^ x) * 0x45D9F3B & _M32
    x = ((x >> 16) ^ x) * 0x45D9F3B & _M32
    return (x >> 16) ^ x


def uniform(shape: Sequence[int], generator: torch.Generator, device, cols: Optional[slice] = None,
            last_total: Optional[int] = None) -> torch.Tensor:
    """f32 draws in [0, 1) (24 bits) for this rank's part of a tensor whose
    leading dim is rows of the micro-batch: its rows under `current()`,
    for a (rows, positions, channels) tensor its sequence positions, and,
    with `cols`, those columns of a last dim of `last_total`.  The
    generator gives one key a call, so every rank advances it alike."""
    ctx = current()
    shape = list(shape)
    key = torch.randint(0, _M32 + 1, (), generator=generator, device=generator.device, dtype=torch.int64)
    start = ctx.row_start if ctx.row_total is not None else 0
    rows = _mix(key.to(device) ^ torch.arange(start, start + shape[0], device=device, dtype=torch.int64))
    width = shape[-1] if cols is None else last_total
    first = 0 if cols is None else cols.start
    inner = shape[1:]
    if inner:
        lead = torch.arange(math.prod(inner[:-1]), device=device, dtype=torch.int64)
        if len(inner) == 2:  # (rows, positions, channels): positions are global under sp
            lead = lead + ctx.seq_start
        index = (lead[:, None] * width + torch.arange(first, first + inner[-1], device=device,
                                                      dtype=torch.int64)).reshape(inner) & _M32
    else:
        index = torch.zeros((), device=device, dtype=torch.int64)
    bits = _mix(rows.view(-1, *([1] * len(inner))) ^ _mix(index))
    return (bits >> 8).to(torch.float32) * 2.0 ** -24
