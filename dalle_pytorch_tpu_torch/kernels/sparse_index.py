"""Index tables for block-sparse flash attention (counterpart of
`dalle_pytorch_tpu/kernels/sparse_index.py`, numpy only).

A static pattern's tile liveness becomes lists of the tiles a kernel visits.
The JAX package flattens them for a sequential TPU grid: per-step tile
coordinates with first/last/valid flags (`build_compacted_tables`).  A CUDA
block instead walks its own list, so `csr_tables` turns those tables into
per-head compressed rows: for the forward and dq kernels, the ascending key
tiles of each query tile; for the dk/dv kernel, the ascending query tiles of
each key tile.  Sparse-aware cached decode gathers the keys a pattern row
permits (`build_decode_tables`).

Everything here runs on the host over static masks, once per pattern, length
and tile shape.

Table layout of `build_compacted_tables` (all int32):

  row-major (forward / dq traversal: query tiles outer, live key tiles inner,
  ascending j, the visit order of the dense grid):
    qrow[H, T]   query-tile index i of step t
    kcol[H, T]   key-tile index j of step t
    first[H, T]  1 on the first live entry of a query row
    last[H, T]   1 on the last live entry of a query row
    valid[H, T]  1 on real entries, 0 on padding and placeholders

  column-major (dk/dv traversal: key tiles outer, live query tiles inner,
  ascending i):
    qrowT/kcolT/firstT/lastT/validT[H, T2], the same roles with rows and
    columns swapped.

H is 1 for a shared mask and `heads` for a per-head mask.  A query row (or
key column) with no live tile gets one placeholder entry with
first = last = 1, valid = 0; padding entries (to equalize T across heads)
repeat the previous entry with first = last = valid = 0.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

# keys of the table dict, in the fixed order the JAX kernels consume them
TABLE_KEYS = (
    "qrow", "kcol", "first", "last", "valid",
    "qrowT", "kcolT", "firstT", "lastT", "validT",
)


def block_causal_live_np(nq: int, nk: int, block_q: int, block_k: int) -> np.ndarray:
    """(nq, nk) bool: tiles with at least one causally allowed (j <= i)
    element, the tile-granular causal triangle the dense kernels skip by."""
    i = np.arange(nq)[:, None]
    j = np.arange(nk)[None, :]
    return j * block_k <= i * block_q + block_q - 1


def _compact_axis(live: np.ndarray, transpose: bool) -> Tuple[list, list, list, list, list]:
    """Flatten one head's (nq, nk) liveness into entry lists.  Row-major when
    transpose=False (query rows outer); column-major when True."""
    E = live.T if transpose else live
    qi, ki, first, last, valid = [], [], [], [], []
    for a in range(E.shape[0]):
        hits = np.flatnonzero(E[a])
        if hits.size == 0:
            # placeholder: the row (column) has no live tile
            qi.append(a)
            ki.append(0)
            first.append(1)
            last.append(1)
            valid.append(0)
            continue
        for s, b in enumerate(hits):
            qi.append(a)
            ki.append(int(b))
            first.append(1 if s == 0 else 0)
            last.append(1 if s == hits.size - 1 else 0)
            valid.append(1)
    if transpose:  # entries are (column, row): swap back to (qrow, kcol)
        qi, ki = ki, qi
    return qi, ki, first, last, valid


def _pad_entries(cols, length: int):
    qi, ki, first, last, valid = cols
    assert len(qi) <= length, (len(qi), length)
    while len(qi) < length:
        qi.append(qi[-1])
        ki.append(ki[-1])
        first.append(0)
        last.append(0)
        valid.append(0)
    return cols


def build_compacted_tables(
    block_live: np.ndarray,
    block_q: int,
    block_k: int,
    *,
    causal: bool = True,
    pad_to: Optional[Tuple[int, int]] = None,
) -> Dict[str, np.ndarray]:
    """Compacted-grid tables from a pattern's block liveness.

    block_live: (nq, nk), or per-head (h, nq, nk), nonzero = some element of
    the tile is pattern-allowed (`ops.masks.block_live_np`).  Causality is
    folded in here, tile-granular, so callers pass the pattern-only table.
    pad_to=(T, T2) pads the row-major and column-major lengths."""
    bl = np.asarray(block_live)
    if bl.ndim == 2:
        bl = bl[None]
    heads, nq, nk = bl.shape
    live = bl.astype(bool)
    if causal:
        live = live & block_causal_live_np(nq, nk, block_q, block_k)[None]

    per_head = [
        (_compact_axis(live[h], False), _compact_axis(live[h], True))
        for h in range(heads)
    ]
    T = max(len(row[0][0]) for row in per_head)
    T2 = max(len(row[1][0]) for row in per_head)
    if pad_to is not None:
        assert pad_to[0] >= T and pad_to[1] >= T2, (pad_to, T, T2)
        T, T2 = pad_to

    out = {k: [] for k in TABLE_KEYS}
    for fwd_cols, bwd_cols in per_head:
        qi, ki, first, last, valid = _pad_entries(fwd_cols, T)
        out["qrow"].append(qi)
        out["kcol"].append(ki)
        out["first"].append(first)
        out["last"].append(last)
        out["valid"].append(valid)
        qi, ki, first, last, valid = _pad_entries(bwd_cols, T2)
        out["qrowT"].append(qi)
        out["kcolT"].append(ki)
        out["firstT"].append(first)
        out["lastT"].append(last)
        out["validT"].append(valid)
    return {k: np.asarray(v, np.int32) for k, v in out.items()}


def live_tile_counts(tables: Dict[str, np.ndarray]) -> Tuple[int, int]:
    """(live row-major entries, live column-major entries), summed over
    heads."""
    return int(np.asarray(tables["valid"]).sum()), int(np.asarray(tables["validT"]).sum())


def _csr(major: np.ndarray, minor: np.ndarray, valid: np.ndarray, n_major: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-head CSR of the valid entries: (ptr (H, n_major + 1), idx (H, L))
    with L the most entries of any head (at least 1), padded with 0."""
    heads = major.shape[0]
    counts = np.zeros((heads, n_major), np.int64)
    lists = []
    for h in range(heads):
        keep = valid[h] > 0
        rows, cols = major[h][keep], minor[h][keep]
        # the tables hold a row's entries together and in ascending order
        assert np.all(np.diff(rows) >= 0), "entries are not grouped by row"
        np.add.at(counts[h], rows, 1)
        lists.append(cols)
    ptr = np.zeros((heads, n_major + 1), np.int32)
    ptr[:, 1:] = np.cumsum(counts, axis=1)
    idx = np.zeros((heads, max(1, max(len(c) for c in lists))), np.int32)
    for h, cols in enumerate(lists):
        idx[h, : len(cols)] = cols
    return ptr, idx


def csr_tables(tables: Dict[str, np.ndarray], nq: int, nk: int) -> Dict[str, np.ndarray]:
    """The per-head CSR form of `build_compacted_tables` output, for kernels
    whose blocks each walk their own list.

    Returns int32 arrays: `row_ptr` (H, nq + 1) and `col` (H, T), the live key
    tiles of query tile i being col[h, row_ptr[h, i]:row_ptr[h, i + 1]], in
    ascending order; `col_ptr` (H, nk + 1) and `row` (H, T2), the live query
    tiles of each key tile.  Placeholders and padding (valid = 0) are
    dropped: a row or column with no live tile has an empty range."""
    row_ptr, col = _csr(tables["qrow"], tables["kcol"], tables["valid"], nq)
    col_ptr, row = _csr(tables["kcolT"], tables["qrowT"], tables["validT"], nk)
    return {"row_ptr": row_ptr, "col": col, "col_ptr": col_ptr, "row": row}


# ---------------------------------------------------------------------------
# sparse-aware decode
# ---------------------------------------------------------------------------


def decode_kv_counts(pattern: np.ndarray) -> np.ndarray:
    """Per-position permitted-key counts: counts[..., t] = |{j <= t :
    pattern[t, j]}|.  pattern: static (n, n) or (h, n, n) bool."""
    p = np.asarray(pattern, dtype=bool)
    n = p.shape[-1]
    return (p & np.tril(np.ones((n, n), dtype=bool))).sum(axis=-1).astype(np.int32)


def decode_kv_span(pattern: Optional[np.ndarray], n: int) -> int:
    """Most keys any decode step reads under the pattern (the gather width
    Kmax).  None (a 'full' layer) reads the whole cache: returns n."""
    if pattern is None:
        return n
    return int(decode_kv_counts(pattern).max())


def build_decode_tables(
    pattern: np.ndarray,
    *,
    pad_to: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Gather tables for sparse-aware cached decode.

    Returns (idx, counts): idx[..., t, :] lists the ascending key positions
    {j <= t : pattern[t, j]} padded with 0 up to Kmax (padded entries are
    masked off by counts before the softmax); counts[..., t] is the live
    prefix length.  Shapes (n, Kmax)/(n,) for a shared pattern,
    (h, n, Kmax)/(h, n) per head."""
    p = np.asarray(pattern, dtype=bool)
    shared = p.ndim == 2
    if shared:
        p = p[None]
    heads, n, _ = p.shape
    counts = decode_kv_counts(p)
    kmax = int(counts.max())
    if pad_to is not None:
        assert pad_to >= kmax, (pad_to, kmax)
        kmax = pad_to
    idx = np.zeros((heads, n, kmax), np.int32)
    for h in range(heads):
        for t in range(n):
            hits = np.flatnonzero(p[h, t, : t + 1])
            idx[h, t, : hits.size] = hits
    if shared:
        return idx[0], counts[0]
    return idx, counts
