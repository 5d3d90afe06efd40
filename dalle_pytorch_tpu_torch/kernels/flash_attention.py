"""Flash attention, forward and backward: the CUDA kernels' wrappers and
their plain versions.

Counterpart of `dalle_pytorch_tpu/kernels/flash_attention.py`: the dense-grid
forward (`_fwd_kernel` / `_flash_fwd`) and two-pass backward (`_dq_kernel`
and `_dkv_kernel` / `_flash_bwd`), their compacted-grid twins for static
patterns (`_fwd_kernel_compact` / `_flash_fwd_compact`, `_dq_kernel_compact`
and `_dkv_kernel_compact` / `_flash_bwd_compact`), the compacted grid's VFA
forward (`_max_kernel_compact` then `_fwd_kernel_compact_vfa`, the
`vfa=True` branch of `_flash_fwd_compact`), the grid choice
(`_resolve_tables`) and the `custom_vjp` that joins forward and backward
(`_flash_vjp_fwd` / `_flash_vjp_bwd`).  Attention runs on (b·h, n, d) with
f32 accumulation, causal masking, an optional static pattern ((n, n) or
per-head (h, n, n), True = may attend) and an optional per-batch key-padding
row; the log-sum-exp comes back as (b·h, n), not broadcast over 128 lanes as
on the TPU.

For CUDA tensors `flash_fwd` and `flash_bwd` launch the dense-grid kernels of
`csrc/flash_fwd.cu` and `csrc/flash_bwd.cu`, or hand a pattern whose tiles
die inside the causal triangle to `flash_fwd_compact` and
`flash_bwd_compact` (`csrc/flash_compact.cu`); the tile tables come from
`pattern_tables`, built on the host at the kernels' own tile shape.  With
`vfa=True` a compacted forward runs the VFA pair instead of the online
kernel; the dense grid ignores `vfa`, as the JAX package does.  CPU tensors
take the plain versions (`flash_attention_reference`,
`flash_attention_backward_reference`, and `vfa_max_reference` then
`vfa_fwd_reference` where the grid rule compacts a `vfa=True` call).  There
is no fallback from a kernel to a plain version.  `flash_attention` goes
through the autograd function `FlashAttention` whenever a gradient is
wanted, and straight to `flash_fwd` otherwise.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from dalle_pytorch_tpu_torch.kernels import build
from dalle_pytorch_tpu_torch.kernels.sparse_index import (
    block_causal_live_np,
    build_compacted_tables,
    csr_tables,
)
from dalle_pytorch_tpu_torch.ops.masks import block_live_np

_NEG = -1e30  # the TPU kernel's fill for masked scores
# lse at or below this: the row sees no key (its lse is -1e30, see _delta)
_DEAD_LSE = _NEG / 2
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)
_GRIDS = ("auto", "dense", "compact")


def _masked_scores(q, k, causal, scale, mask, key_mask, h):
    s = torch.einsum("bid,bjd->bij", q.float() * scale, k.float())
    n = q.shape[1]
    neg = torch.tensor(_NEG, dtype=torch.float32, device=s.device)
    if causal:
        pos = torch.arange(n, device=s.device)
        s = torch.where(pos[None, :] <= pos[:, None], s, neg)
    if mask is not None:
        mask = mask.to(s.device)
        if mask.ndim == 3:  # per-head (h, n, n): tile over the batch
            mask = mask.repeat(q.shape[0] // mask.shape[0], 1, 1)
        s = torch.where(mask.to(torch.bool), s, neg)
    if key_mask is not None:
        keep = torch.repeat_interleave(key_mask > 0, h, dim=0)[:, None, :]
        s = torch.where(keep, s, neg)
    return s


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    h: int = 1,
    causal: bool = True,
    scale: Optional[float] = None,
    mask: Optional[torch.Tensor] = None,
    key_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch forward of the same function as the kernels, the
    forward math of the JAX package's `_dense_recompute_grads`.

    q, k, v: (bh, n, d); key_mask: optional (bh // h, n), nonzero = attend;
    mask: optional (n, n) or per-head (h, n, n) pattern, True = attend.
    Returns (out (bh, n, d) in q's dtype, lse (bh, n) f32)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = _masked_scores(q, k, causal, scale, mask, key_mask, h)
    lse = torch.logsumexp(s, dim=-1)
    # softmax, not exp(s - lse): a fully masked row (every score -1e30) must
    # average v, and -1e30 + log(n) rounds back to -1e30 in f32
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bij,bjd->bid", p, v.float())
    return out.to(q.dtype), lse


def vfa_max_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    h: int = 1,
    causal: bool = True,
    scale: Optional[float] = None,
    mask: Optional[torch.Tensor] = None,
    key_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the VFA max pass (`_max_kernel_compact`):
    each row's maximum of the masked scores, (bh, n) f32; -1e30 for a row
    that sees no key.  Arguments as `flash_attention_reference`."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _masked_scores(q, k, causal, scale, mask, key_mask, h).amax(dim=-1)


def vfa_fwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    gmax: torch.Tensor,
    h: int = 1,
    causal: bool = True,
    scale: Optional[float] = None,
    mask: Optional[torch.Tensor] = None,
    key_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the VFA accumulation pass
    (`_fwd_kernel_compact_vfa`): p = exp(s - gmax) against the max pass's
    gmax (bh, n), l = sum p, out = p v / max(l, 1e-30), lse = gmax +
    log(max(l, 1e-30)).  A row that sees no key has gmax = -1e30 and every
    one of its n scores -1e30, so p = 1 for each: it averages v over all n
    keys with lse -1e30, the port's rule for such rows.  Returns (out in q's
    dtype, lse (bh, n) f32)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = _masked_scores(q, k, causal, scale, mask, key_mask, h)
    p = torch.exp(s - gmax[..., None])
    lc = p.sum(dim=-1).clamp_min(1e-30)
    out = torch.einsum("bij,bjd->bid", p, v.float()) / lc[..., None]
    return out.to(q.dtype), gmax + torch.log(lc)


def _delta(out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(do * out), (bh, n) f32, as `_flash_bwd` computes it:
    the plain version of the delta the dq kernels compute before their walk
    (and write for the dk/dv kernels).

    A row that sees no key has lse = -1e30, so p = exp(s - lse) is 1 for
    every one of its n keys and the JAX package's `_dense_recompute_grads`
    takes delta = do . sum_j v_j for it, not do . out (out averages v)."""
    do32 = do.float()
    live = (do32 * out.float()).sum(-1)
    dead = (do32 * v.float().sum(1, keepdim=True)).sum(-1)
    return torch.where(lse <= _DEAD_LSE, dead, live)


def _delta_limit(out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """How far a delta summed in another order of f32 additions (the
    kernels') may lie from `_delta`'s, (bh, n) f64: d * 2^-24 of sum_d |do *
    out|; for a row that sees no key the same of sum_d |do * sum_j v_j|,
    plus n * 2^-24 of sum_d |do| sum_j |v_j| for the column sums of v."""
    n, d = do.shape[1:]
    do64, v64 = do.double(), v.double()
    live = d * 2.0 ** -24 * (do64 * out.double()).abs().sum(-1)
    dead = d * 2.0 ** -24 * (do64 * v64.sum(1, keepdim=True)).abs().sum(-1) + n * 2.0 ** -24 * (
        do64.abs() * v64.abs().sum(1, keepdim=True)).sum(-1)
    return torch.where(lse <= _DEAD_LSE, dead, live)


def flash_attention_backward_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    h: int = 1,
    causal: bool = True,
    scale: Optional[float] = None,
    mask: Optional[torch.Tensor] = None,
    key_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch backward of the same function as the kernels: the math
    of the JAX package's `_dense_recompute_grads`, with p = exp(s - lse)
    recomputed over all n keys and delta from `_delta`.

    out, lse: the forward's; do: (bh, n, d).  Returns (dq, dk, dv) in the
    dtypes of q, k and v, computed in f32."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = _masked_scores(q, k, causal, scale, mask, key_mask, h)
    p = torch.exp(s - lse[..., None])
    do32 = do.float()
    dv = torch.einsum("bij,bid->bjd", p, do32)
    dp = torch.einsum("bid,bjd->bij", do32, v.float())
    ds = p * (dp - _delta(out, lse, do, v)[..., None])
    dq = torch.einsum("bij,bjd->bid", ds, k.float()) * scale
    dk = torch.einsum("bij,bid->bjd", ds, q.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# tile tables of a static pattern
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _tile_constants() -> Dict[str, int]:
    """The `constexpr int kTile... = N;` lines of csrc/flash_tiles.cuh: the
    one definition of the kernels' tile shape."""
    text = (build.CSRC / "flash_tiles.cuh").read_text()
    return {name: int(value) for name, value in re.findall(r"constexpr int (kTile\w+) = (\d+);", text)}


def tile_shapes(d: int) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """((query rows, keys) of the forward and dq kernels' tile, (query rows,
    keys) of the dk/dv kernel's tile) at head dim d, as the kernels define
    them: 64 x 64 at d <= 64; 64 x 32 and 32 x 64 at d = 128."""
    c = _tile_constants()
    inner = c["kTileInnerNarrow"] if d <= 64 else c["kTileInnerWide"]
    return (c["kTileRows"], inner), (inner, c["kTileRows"])


@dataclasses.dataclass(frozen=True)
class PatternTables:
    """A static pattern's tile tables at one length n and head dim, on one
    device, for the kernels (the counterpart of `_resolve_tables`' output).

    `live_rows` (H, ceil(n/tq), ceil(n/tk)) uint8 is the pattern's tile
    liveness at the forward/dq tile `row_tile` = (tq, tk), for the dense
    kernels; `live_cols` (H, ceil(n/ck), ceil(n/cq)) uint8 the same at the
    dk/dv tile `col_tile` = (cq, ck), stored by key tile.  `row_ptr`/`col`
    and `col_ptr`/`row` are the CSR lists (`sparse_index.csr_tables`) of the
    live tiles inside the causal triangle, by query tile and by key tile, for
    the compacted kernels.  H is 1 (shared) or the head count.  `compact` is
    the grid the rule chose: compacted exactly when the pattern kills a tile
    inside the causal triangle at `row_tile`.  `live_tiles` and
    `causal_tiles` count (query tile, key tile) pairs at `row_tile`, summed
    over the H heads; `live_tiles_dkv` and `causal_tiles_dkv` at
    `col_tile`."""

    n: int
    heads: int
    causal: bool
    row_tile: Tuple[int, int]
    col_tile: Tuple[int, int]
    compact: bool
    live_rows: torch.Tensor
    live_cols: torch.Tensor
    row_ptr: torch.Tensor
    col: torch.Tensor
    col_ptr: torch.Tensor
    row: torch.Tensor
    live_tiles: int
    causal_tiles: int
    live_tiles_dkv: int
    causal_tiles_dkv: int


def pattern_tables(
    mask,
    n: int,
    d: int,
    causal: bool = True,
    grid: str = "auto",
    device=None,
) -> PatternTables:
    """Build a pattern's tables on the host with numpy and put them on
    `device`.  mask: (n, n) or (h, n, n) bool (numpy or torch), True = may
    attend, or None for no pattern (every tile live).  grid: "auto" (compact
    exactly when the pattern kills a tile inside the causal triangle, the
    JAX package's rule computed at this port's tile), "dense" or
    "compact"."""
    if grid not in _GRIDS:
        raise ValueError(f"grid must be one of {_GRIDS}, got {grid!r}")
    (tq, tk), (cq, ck) = tile_shapes(d)
    if mask is None:
        m = np.ones((1, n, n), bool)
    else:
        m = (mask.cpu().numpy() if isinstance(mask, torch.Tensor) else np.asarray(mask)) != 0
        if m.ndim == 2:
            m = m[None]
    if m.shape[1:] != (n, n):
        raise ValueError(f"mask of shape {m.shape[1:]} for length {n}")
    live_r = block_live_np(m, tq, tk)
    live_c = block_live_np(m, cq, ck)
    heads, nq, nk = live_r.shape
    nq2, nk2 = live_c.shape[1:]
    causal_r = block_causal_live_np(nq, nk, tq, tk) if causal else np.ones((nq, nk), bool)
    causal_c = block_causal_live_np(nq2, nk2, cq, ck) if causal else np.ones((nq2, nk2), bool)
    rows = csr_tables(build_compacted_tables(live_r, tq, tk, causal=causal), nq, nk)
    cols = csr_tables(build_compacted_tables(live_c, cq, ck, causal=causal), nq2, nk2)
    compact = grid == "compact" or (grid == "auto" and bool(np.any(~live_r & causal_r[None])))

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return PatternTables(
        n=n, heads=heads, causal=causal, row_tile=(tq, tk), col_tile=(cq, ck), compact=compact,
        live_rows=put(live_r.astype(np.uint8)),
        live_cols=put(live_c.transpose(0, 2, 1).astype(np.uint8)),
        row_ptr=put(rows["row_ptr"]), col=put(rows["col"]),
        col_ptr=put(cols["col_ptr"]), row=put(cols["row"]),
        live_tiles=int((live_r & causal_r).sum()), causal_tiles=int(causal_r.sum()) * heads,
        live_tiles_dkv=int((live_c & causal_c).sum()), causal_tiles_dkv=int(causal_c.sum()) * heads,
    )


def _check_pattern(q, h, mask, tables, causal, grid) -> None:
    """The checks of `_resolve_tables`, on any device."""
    if grid not in _GRIDS:
        raise ValueError(f"grid must be one of {_GRIDS}, got {grid!r}")
    bh, n, d = q.shape
    if mask is not None and tuple(mask.shape) not in ((n, n), (h, n, n)):
        raise ValueError(f"mask must be ({n}, {n}) or ({h}, {n}, {n}); got {tuple(mask.shape)}")
    if tables is None:
        return
    if tables.heads not in (1, h):
        raise ValueError(f"tables head dim {tables.heads} incompatible with h={h}")
    if mask is not None and mask.ndim == 3 and tables.heads != h:
        # shared tables would skip tiles that a head's own pattern needs
        raise ValueError("per-head mask requires per-head compacted tables")
    if tables.n != n or tables.causal != causal:
        raise ValueError(f"tables for n={tables.n}, causal={tables.causal}; the call has n={n}, causal={causal}")
    if (tables.row_tile, tables.col_tile) != tile_shapes(d):
        raise ValueError(f"tables built at tiles {tables.row_tile}, {tables.col_tile}; "
                         f"the kernels' tiles at d={d} are {tile_shapes(d)}")


def _tables_for(q, mask, causal, grid, tables) -> Optional[PatternTables]:
    """The tables a CUDA call runs with: the caller's, or built here from the
    mask (a copy of the mask to the host: callers on a hot path build them
    once with `pattern_tables`); None for the dense grid without a
    pattern."""
    if tables is None and (mask is not None or grid == "compact"):
        tables = pattern_tables(mask, q.shape[1], q.shape[2], causal, grid, q.device)
    return tables


def _compact(tables: Optional[PatternTables], grid: str) -> bool:
    return tables is not None and (tables.compact if grid == "auto" else grid == "compact")


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------


def _is_cuda(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def _check_cuda_inputs(q, k, v, h, key_mask):
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must all lie on the same CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash attention takes float32 or bfloat16 q, k, v of one dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash attention takes q, k, v of one shape (bh, n, d); got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    bh, n, d = q.shape
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash attention takes head dims {_HEAD_DIMS}; got {d}")
    if bh % h or not 0 < bh <= 65535:
        raise ValueError(f"bh = {bh} must be a positive multiple of h = {h}, at most 65535")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if key_mask is not None:
        if key_mask.shape != (bh // h, n) or key_mask.dtype != torch.int32:
            raise ValueError(f"key_mask must be int32 of shape {(bh // h, n)}; got {key_mask.dtype} {tuple(key_mask.shape)}")
        if key_mask.device != q.device or not key_mask.is_contiguous():
            raise ValueError("key_mask must be contiguous on q's device")


def _check_cuda_residuals(q, out, lse, do):
    for name, t in (("out", out), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q's shape, dtype and device; got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if lse.shape != q.shape[:2] or lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError(f"lse must be float32 of shape {tuple(q.shape[:2])}; got {lse.dtype} {tuple(lse.shape)}")
    if not lse.is_contiguous():
        raise ValueError("lse must be contiguous")


# bytes past a pattern's last element that the kernels may read: the bf16
# tensor-core bodies copy each pattern row's bytes as whole 16-byte chunks,
# and the last chunk of the last row can reach up to 15 bytes past the mask
_MASK_SLACK = 16


def mask_with_slack(mask: torch.Tensor) -> torch.Tensor:
    """The pattern as contiguous 1-byte 0/1 (bool or uint8 as given) whose
    storage runs on at least `_MASK_SLACK` bytes (zeros) past its last
    element, so that the kernels' 16-byte copies stay inside it: the mask
    itself when its storage already does, else a copy.  A caller that keeps
    a mask for many calls (`Transformer.attention_inputs`) keeps this one,
    and no call copies it again."""
    m = mask if mask.dtype in (torch.bool, torch.uint8) else mask != 0
    m = m.contiguous()
    if m.untyped_storage().nbytes() - (m.storage_offset() + m.numel()) * m.element_size() >= _MASK_SLACK:
        return m
    buf = torch.zeros(m.numel() + _MASK_SLACK, dtype=m.dtype, device=m.device)
    buf[: m.numel()] = m.reshape(-1)
    return buf[: m.numel()].view(m.shape)


def _device_mask(q, mask, h):
    """(the pattern on q's device as `mask_with_slack` gives it, or None; its
    head count for the kernels)."""
    if mask is None:
        return None, 1
    m = mask_with_slack(mask.to(q.device))
    return m, (h if m.ndim == 3 else 1)


def _device_tables(q, tables: PatternTables) -> PatternTables:
    if tables.row_ptr.device != q.device:
        raise ValueError(f"tables on {tables.row_ptr.device}, q on {q.device}")
    return tables


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry point -> (its source in csrc/, how many pointers it takes first)
_ENTRIES = {
    "flash_fwd": ("flash_fwd", 8),
    "flash_bwd_dq": ("flash_bwd", 11),
    "flash_bwd_dkv": ("flash_bwd", 11),
    "flash_fwd_compact": ("flash_compact", 9),
    "flash_max_compact": ("flash_compact", 7),
    "flash_fwd_compact_vfa": ("flash_compact", 10),
    "flash_dq_compact": ("flash_compact", 12),
    "flash_dkv_compact": ("flash_compact", 12),
}


def _entry(name: str):
    """The C entry point `name`, its library built and loaded at first use.
    Every entry takes its pointers, then (bh, n, d, h, mask_heads,
    tab_heads, tab_len, tile_q, tile_k, scale, causal, dtype, stream)."""
    source, n_ptrs = _ENTRIES[name]
    fn = getattr(build.load(source), name)
    if fn.argtypes is None:
        fn.argtypes = [_P] * n_ptrs + [_I] * 9 + [_F, _I, _I, _P]
        fn.restype = ctypes.c_int
    return fn


def _call(name: str, q, tensors, h, causal, scale, mask_heads=1, tab_heads=1, tab_len=0,
          tile=(0, 0)) -> None:
    """Launch entry `name` on q's card, on its current stream; `tensors` are
    its pointer arguments in order (None for a null pointer); `tile` is the
    tile the tables were built at ((0, 0) without tables)."""
    bh, n, d = q.shape
    fn = _entry(name)
    with torch.cuda.device(q.device):
        rc = fn(*(None if t is None else t.data_ptr() for t in tensors), bh, n, d, h,
                mask_heads, tab_heads, tab_len, tile[0], tile[1],
                float(scale), int(causal), _DTYPES[q.dtype],
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with code {rc}")


def flash_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    h: int = 1,
    causal: bool = True,
    scale: Optional[float] = None,
    mask: Optional[torch.Tensor] = None,
    key_mask: Optional[torch.Tensor] = None,
    grid: str = "auto",
    tables: Optional[PatternTables] = None,
    vfa: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(bh, n, d) attention forward -> (out (bh, n, d), lse (bh, n) f32).

    On CUDA tensors this launches the dense-grid kernel, counted in
    `flash_fwd.launches` (and in `flash_fwd.masked_launches` when it takes a
    pattern), or, where `grid` and the tables choose the compacted grid,
    `flash_fwd_compact` (with `vfa`, its VFA pair); or it raises.  On CPU
    tensors it runs the plain version, the VFA pair's where the grid rule
    compacts a `vfa` call.  The dense grid ignores `vfa`.  It builds no
    autograd graph of its own: `flash_attention` gives it its gradient."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if key_mask is not None:
        key_mask = key_mask.to(torch.int32).contiguous()
    _check_pattern(q, h, mask, tables, causal, grid)
    cpu = q.device.type == "cpu"
    if not (cpu or _is_cuda(q)):
        raise ValueError(f"flash_fwd runs on CUDA or CPU tensors, not {q.device}")
    if vfa or not cpu:
        tables = _tables_for(q, mask, causal, grid, tables)
        if _compact(tables, grid):
            return flash_fwd_compact(q, k, v, tables, h, causal, scale, mask, key_mask, vfa)
    if cpu:
        return flash_attention_reference(q, k, v, h, causal, scale, mask, key_mask)
    _check_cuda_inputs(q, k, v, h, key_mask)
    m, mask_heads = _device_mask(q, mask, h)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    if tables is None:
        _call("flash_fwd", q, (q, k, v, key_mask, None, None, out, lse), h, causal, scale)
    else:
        t = _device_tables(q, tables)
        _call("flash_fwd", q, (q, k, v, key_mask, m, t.live_rows, out, lse), h, causal, scale,
              mask_heads, t.heads, 0, t.row_tile)
        flash_fwd.masked_launches += int(m is not None)
    flash_fwd.launches += 1
    return out, lse


flash_fwd.launches = 0
flash_fwd.masked_launches = 0


def flash_fwd_compact(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    tables: PatternTables,
    h: int = 1,
    causal: bool = True,
    scale: Optional[float] = None,
    mask: Optional[torch.Tensor] = None,
    key_mask: Optional[torch.Tensor] = None,
    vfa: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward over the live tiles of `tables` only.  On CUDA tensors it
    launches `csrc/flash_compact.cu`'s online forward, equal to the dense
    grid given the same mask bit for bit (counted in
    `flash_fwd_compact.launches`), or with `vfa` the max pass then the
    fixed-max pass (counted in `flash_fwd_compact.max_launches` and
    `vfa_launches`), equal to it to rounding; or it raises.  On CPU tensors
    it runs the plain version of the same."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if key_mask is not None:
        key_mask = key_mask.to(torch.int32).contiguous()
    _check_pattern(q, h, mask, tables, causal, "compact")
    if q.device.type == "cpu":
        if vfa:
            gmax = vfa_max_reference(q, k, h, causal, scale, mask, key_mask)
            return vfa_fwd_reference(q, k, v, gmax, h, causal, scale, mask, key_mask)
        return flash_attention_reference(q, k, v, h, causal, scale, mask, key_mask)
    if not _is_cuda(q):
        raise ValueError(f"flash_fwd_compact runs on CUDA or CPU tensors, not {q.device}")
    _check_cuda_inputs(q, k, v, h, key_mask)
    t = _device_tables(q, tables)
    m, mask_heads = _device_mask(q, mask, h)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    grid_args = (h, causal, scale, mask_heads, t.heads, t.col.shape[1], t.row_tile)
    if vfa:
        gmax = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
        _call("flash_max_compact", q, (q, k, key_mask, m, t.row_ptr, t.col, gmax), *grid_args)
        flash_fwd_compact.max_launches += 1
        _call("flash_fwd_compact_vfa", q, (q, k, v, key_mask, m, t.row_ptr, t.col, gmax, out, lse),
              *grid_args)
        flash_fwd_compact.vfa_launches += 1
        return out, lse
    _call("flash_fwd_compact", q, (q, k, v, key_mask, m, t.row_ptr, t.col, out, lse), *grid_args)
    flash_fwd_compact.launches += 1
    return out, lse


flash_fwd_compact.launches = 0
flash_fwd_compact.max_launches = 0
flash_fwd_compact.vfa_launches = 0


def flash_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    h: int = 1,
    causal: bool = True,
    scale: Optional[float] = None,
    mask: Optional[torch.Tensor] = None,
    key_mask: Optional[torch.Tensor] = None,
    grid: str = "auto",
    tables: Optional[PatternTables] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(bh, n, d) attention backward -> (dq, dk, dv), from the forward's
    out and lse and the output gradient do.

    On CUDA tensors the dense-grid dq kernel launches, which also writes
    delta = rowsum(do * out) (XLA in the JAX package), then the dk/dv kernel,
    which reads it, on the same stream, each counted in
    `flash_bwd.dq_launches` / `flash_bwd.dkv_launches`; or, where `grid` and
    the tables choose the compacted grid, `flash_bwd_compact`; or it raises.
    On CPU tensors it runs the plain version."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if key_mask is not None:
        key_mask = key_mask.to(torch.int32).contiguous()
    _check_pattern(q, h, mask, tables, causal, grid)
    if q.device.type == "cpu":
        return flash_attention_backward_reference(q, k, v, out, lse, do, h, causal, scale, mask, key_mask)
    if not _is_cuda(q):
        raise ValueError(f"flash_bwd runs on CUDA or CPU tensors, not {q.device}")
    tables = _tables_for(q, mask, causal, grid, tables)
    if _compact(tables, grid):
        return flash_bwd_compact(q, k, v, out, lse, do, tables, h, causal, scale, mask, key_mask)
    _check_cuda_inputs(q, k, v, h, key_mask)
    _check_cuda_residuals(q, out, lse, do)
    m, mask_heads = _device_mask(q, mask, h)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    if tables is None:
        _call("flash_bwd_dq", q, (q, k, v, do, out, lse, key_mask, None, None, dq, delta), h, causal, scale)
        flash_bwd.dq_launches += 1
        _call("flash_bwd_dkv", q, (q, k, v, do, lse, delta, key_mask, None, None, dk, dv), h, causal, scale)
        flash_bwd.dkv_launches += 1
        return dq, dk, dv
    t = _device_tables(q, tables)
    _call("flash_bwd_dq", q, (q, k, v, do, out, lse, key_mask, m, t.live_rows, dq, delta), h, causal, scale,
          mask_heads, t.heads, 0, t.row_tile)
    flash_bwd.dq_launches += 1
    _call("flash_bwd_dkv", q, (q, k, v, do, lse, delta, key_mask, m, t.live_cols, dk, dv), h, causal,
          scale, mask_heads, t.heads, 0, t.col_tile)
    flash_bwd.dkv_launches += 1
    return dq, dk, dv


flash_bwd.dq_launches = 0
flash_bwd.dkv_launches = 0


def flash_bwd_compact(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    tables: PatternTables,
    h: int = 1,
    causal: bool = True,
    scale: Optional[float] = None,
    mask: Optional[torch.Tensor] = None,
    key_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward over the live tiles of `tables` only: dq by query tile
    from the row lists, dk/dv by key tile from the column lists, each equal
    to the dense kernel given the same mask bit for bit.  On CUDA tensors it
    launches `csrc/flash_compact.cu`'s two backward kernels, dq (which also
    writes delta) then dk/dv, on one stream (counted in
    `flash_bwd_compact.dq_launches` / `dkv_launches`), or raises; on CPU
    tensors it runs the plain version."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if key_mask is not None:
        key_mask = key_mask.to(torch.int32).contiguous()
    _check_pattern(q, h, mask, tables, causal, "compact")
    if q.device.type == "cpu":
        return flash_attention_backward_reference(q, k, v, out, lse, do, h, causal, scale, mask, key_mask)
    if not _is_cuda(q):
        raise ValueError(f"flash_bwd_compact runs on CUDA or CPU tensors, not {q.device}")
    _check_cuda_inputs(q, k, v, h, key_mask)
    _check_cuda_residuals(q, out, lse, do)
    t = _device_tables(q, tables)
    m, mask_heads = _device_mask(q, mask, h)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    _call("flash_dq_compact", q, (q, k, v, do, out, lse, key_mask, m, t.row_ptr, t.col, dq, delta), h,
          causal, scale, mask_heads, t.heads, t.col.shape[1], t.row_tile)
    flash_bwd_compact.dq_launches += 1
    _call("flash_dkv_compact", q, (q, k, v, do, lse, delta, key_mask, m, t.col_ptr, t.row, dk, dv), h,
          causal, scale, mask_heads, t.heads, t.row.shape[1], t.col_tile)
    flash_bwd_compact.dkv_launches += 1
    return dq, dk, dv


flash_bwd_compact.dq_launches = 0
flash_bwd_compact.dkv_launches = 0


class FlashAttention(torch.autograd.Function):
    """(bh, n, d) flash attention with its gradient: the forward saves
    (q, k, v, out, lse) as `_flash_vjp_fwd` does, and carries the pattern,
    the grid and the tables it ran with to the backward, `flash_bwd`.  A
    VFA forward's lse feeds the same backward, as in `_flash_vjp_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, h, causal, scale, mask, key_mask, grid, tables, vfa):
        if _is_cuda(q):
            tables = _tables_for(q, mask, causal, grid, tables)
        out, lse = flash_fwd(q, k, v, h, causal, scale, mask, key_mask, grid, tables, vfa)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (h, causal, scale, mask, key_mask, grid, tables)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, out, lse, do.contiguous(), *ctx.args)
        return dq, dk, dv, None, None, None, None, None, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    causal: bool = True,
    scale: Optional[float] = None,
    key_mask: Optional[torch.Tensor] = None,
    grid: str = "auto",
    tables: Optional[PatternTables] = None,
    vfa: bool = False,
) -> torch.Tensor:
    """(b, h, n, d) attention, the counterpart of the JAX package's
    `flash_attention`.  q is unscaled (scale defaults to d^-1/2); mask:
    optional static (n, n) or per-head (h, n, n) pattern, True = may attend;
    key_mask: optional (b, n), nonzero = attend; grid: "auto" | "dense" |
    "compact"; tables: the pattern's `pattern_tables` (built from the mask
    on each CUDA call when None); vfa: on the compacted grid, the two-pass
    VFA forward (ignored on the dense grid).  Differentiable through
    `FlashAttention` when grad is enabled and an input requires it; a plain
    `flash_fwd` call otherwise."""
    b, h, n, d = q.shape
    qf, kf, vf = (t.reshape(b * h, n, d).contiguous() for t in (q, k, v))
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        out = FlashAttention.apply(qf, kf, vf, h, causal, scale, mask, key_mask, grid, tables, vfa)
    else:
        out, _ = flash_fwd(qf, kf, vf, h=h, causal=causal, scale=scale, mask=mask, key_mask=key_mask,
                           grid=grid, tables=tables, vfa=vfa)
    return out.reshape(b, h, n, d)
