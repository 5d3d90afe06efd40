"""Token-shift mixing (counterpart of `dalle_pytorch_tpu/ops/shift.py`).

Text positions take the first half of their channels from the position
before; image positions (a fmap x fmap raster) take their first channel
quarter from the row above and their second quarter from the left
neighbour.  Uncovered cells are zero.  The cached one-token form lives with
the decode cache in `models/transformer.py`.

On a sequence sharded over sp (`core/shard.ShardContext`), each rank shifts
its own positions: the fmap positions before its first one come from the
previous sp rank (`halo`, an exchange whose gradient goes back to the rank
the halo came from), and the first rank's halo is the zero padding at
global position 0.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from dalle_pytorch_tpu_torch.core.shard import current
from dalle_pytorch_tpu_torch.parallel.p2p import exchange


def _shift_seq(x: torch.Tensor, amount: int) -> torch.Tensor:
    """Shift (b, n, d) forward by `amount` positions, zeros in front."""
    return F.pad(x, (0, 0, amount, 0))[:, : x.shape[1]]


class _Halo(torch.autograd.Function):
    """The last `width` positions of the previous sp rank (zeros on the
    first rank); backward, the halo's gradient goes back to that rank,
    which adds it to its last positions' gradient."""

    @staticmethod
    def forward(ctx, x, width):
        shard = current()
        ranks, me, size = shard.sp_ranks, shard.sp_rank, shard.sp_size
        ctx.args = (ranks, me, size, width, x.shape[1])
        halo, = exchange([x[:, -width:]], ranks[(me + 1) % size], ranks[(me - 1) % size])
        return torch.zeros_like(halo) if me == 0 else halo

    @staticmethod
    def backward(ctx, g):
        ranks, me, size, width, n = ctx.args
        g = torch.zeros_like(g) if me == 0 else g.contiguous()
        # the next rank's halo is this rank's tail; the last rank's comes from the first, which sends zeros
        back, = exchange([g], ranks[(me - 1) % size], ranks[(me + 1) % size])
        return F.pad(back, (0, 0, n - width, 0)), None


def halo(x: torch.Tensor, width: int) -> torch.Tensor:
    """(b, width, d): the `width` positions before this sp rank's first, from
    the previous rank, zeros on the first; differentiable."""
    if x.shape[1] < width:
        raise ValueError(f"a sequence part of {x.shape[1]} positions is shorter than the token shift's halo of "
                         f"{width}: use fewer sp ranks")
    return _Halo.apply(x, width)


def token_shift(x: torch.Tensor, seq_len: int, image_fmap_size: int, start: int = 0,
                total: Optional[int] = None) -> torch.Tensor:
    """x: (batch, n, dim) laid out as [text (text_len), image raster], with
    text_len = seq_len + 1 - fmap**2.  Sequences shorter than text_len pass
    through untouched.  Under sequence sharding x holds the global positions
    [start, start + n) of a sequence of `total`, and the previous sp rank
    supplies the fmap positions before them (`halo`)."""
    b, n, d = x.shape
    fmap = image_fmap_size
    text_len = seq_len + 1 - fmap * fmap
    if d % 4:
        raise ValueError("token shift requires dim divisible by 4")
    if (n if total is None else total) < text_len:
        return x

    q = d // 4
    p = start + torch.arange(n, device=x.device)[:, None]
    c = torch.arange(d, device=x.device)[None, :]
    in_text = p < text_len
    img_pos = p - text_len
    col0 = img_pos % fmap == 0
    row0 = img_pos < fmap

    if total is None:
        shift1 = _shift_seq(x, 1)      # p-1: text shift and image 'left'
        shiftf = _shift_seq(x, fmap)   # p-fmap: image 'row above'
    else:
        ext = torch.cat([halo(x, fmap), x], dim=1)
        shift1, shiftf = ext[:, fmap - 1:fmap - 1 + n], ext[:, :n]

    take1 = (in_text & (c < d // 2)) | (~in_text & ~col0 & (c >= q) & (c < 2 * q))
    takef = ~in_text & ~row0 & (c < q)
    keep = torch.where(in_text, c >= d // 2, c >= 2 * q)

    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return (
        torch.where(keep, x, zero)
        + torch.where(take1, shift1, zero)
        + torch.where(takef, shiftf, zero)
    )
