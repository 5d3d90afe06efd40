"""The work of one flash kernel call: the bytes it must move and the
floating-point operations it must do.

One arithmetic serves the kernels' bounds (`chip_smoke.py`: the least time
a call could take on the card) and the FLOPs tally of a training step
(`flash_attention.tally_work`, which `observability/cuda.step_cost_analysis`
adds to what `AtenFlops` counts of the step), so that a kernel's work is
counted once, by one formula, on either route.

  dense grid, no pattern   the (query, key) pairs the causal triangle and the
                           key mask leave, `products` matrix products of
                           2 flops a multiply-add over each (the forward 2:
                           S = QK^T and PV; dq 3; dk/dv 4)
  a pattern's tiles        its live (query tile, key tile) pairs inside the
                           causal triangle, whole, on either grid: the JAX
                           kernels' `pl.CostEstimate` (`2·2·bh·T·bq·bk·d`) at
                           the port's own tiles; the VFA max pass 1 product,
                           its fixed-max pass 2

Bytes: each input read once and each output written once, the rows of Q
only where a query sees a key and K, V only for the live keys on the dense
grid, whole tensors and the pattern's tile bytes on a pattern's grid.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

# (products, (bh, n, d) row reads, (bh, n) f32 reads, (bh, n, d) writes,
# (bh, n) f32 writes) of each dense-grid kernel; a pattern kernel's
# (products, (bh, n, d) tensors, (bh, n) f32 tensors) moved once
DENSE = {"fwd": (2, 1, 0, 1, 1), "dq": (3, 3, 1, 1, 1), "dkv": (4, 2, 2, 2, 0)}
PATTERN = {"fwd": (2, 4, 1), "dq": (3, 6, 2), "dkv": (4, 6, 2), "vfa_max": (1, 2, 1), "vfa_fwd": (2, 4, 2)}


def attention_work(kmask: Optional[torch.Tensor], b: int, h: int, n: int, causal: bool) -> Tuple[int, int, int]:
    """What a key mask leaves of attention's work over the b*h batch-heads:
    the (query, key) pairs that are scored, the live keys (rows of K and V to
    read) and the query rows that see a key (rows of Q to read); with no
    mask every key lives."""
    live = torch.ones(b, n) if kmask is None else (kmask > 0).float().cpu()
    seen = live.cumsum(1) if causal else live.sum(1, keepdim=True).expand(b, n)  # keys each query sees
    return int(seen.sum()) * h, int(live.sum()) * h, int((seen > 0).sum()) * h


def dense_work(kind: str, b: int, h: int, n: int, d: int, dtype: torch.dtype, causal: bool,
               kmask: Optional[torch.Tensor]) -> Tuple[float, float]:
    """(bytes, flops) of one dense-grid kernel (`kind` "fwd", "dq" or "dkv")
    without a pattern, under key mask `kmask` (b, n) or None: its row
    inputs and f32 inputs read for the rows that see a key, K and V for the
    live keys, its outputs written for every row, the mask read once;
    its products over the scored pairs."""
    products, row_reads, float_reads, writes, float_writes = DENSE[kind]
    esize = torch.tensor([], dtype=dtype).element_size()
    pairs, live_keys, live_rows = attention_work(kmask, b, h, n, causal)
    nbytes = (row_reads * live_rows + 2 * live_keys + writes * b * h * n) * d * esize
    nbytes += (float_reads * live_rows + float_writes * b * h * n) * 4 + (0 if kmask is None else b * n * 4)
    return float(nbytes), float(products * 2 * pairs * d)


def pattern_work(kind: str, bh: int, n: int, d: int, dtype: torch.dtype, live_tiles: int, heads: int,
                 tile: Tuple[int, int]) -> Tuple[float, float]:
    """(bytes, flops) of one pattern kernel (`kind` "fwd", "dq", "dkv",
    "vfa_max" or "vfa_fwd"), dense or compacted grid: its tensors moved
    once and the pattern's bytes of its `live_tiles` (tile[0] x tile[1])
    tiles, summed over `heads` table heads, read once; its products over
    the live tiles' elements."""
    products, tensors, floats = PATTERN[kind]
    esize = torch.tensor([], dtype=dtype).element_size()
    tq, tk = tile
    nbytes = tensors * bh * n * d * esize + floats * bh * n * 4 + live_tiles * tq * tk
    flops = products * 2 * bh * live_tiles / heads * tq * tk * d
    return float(nbytes), float(flops)
