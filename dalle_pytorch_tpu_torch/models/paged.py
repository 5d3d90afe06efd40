"""Paged KV state and the per-slot paged decode step (counterpart of the
paged half of `dalle_pytorch_tpu/models/transformer.py`: `init_paged_pool`,
`init_slot_rings`, `write_prefill_to_pool`, `paged_decode_step`).

One pool of KV blocks serves every sequence the serving engine holds: per
layer, k and v of shape (num_blocks, heads, block_size, dim_head).  A slot
addresses its blocks through a row of the block tables (S, max_blocks).
Block 0 is the trash block: an inactive slot's table is all zeros, so its
column writes land there and can only clobber garbage.

A decode step advances S independent sequences at per-slot offsets (S,).
Each slot's attention gathers its blocks into a dense (heads, seq_len,
dim_head) view and attends over it as the dense cached step does (both
through `models/transformer._attend_view`) under j <= offsets[s], with the
layer's `DecodePattern` on pattern layers.  Positions past a slot's offset
hold stale values of evicted sequences; the mask fills their scores with
the f32 minimum before the softmax, so they weigh exactly 0.  The pool, the
rings, the tables and the offsets are device tensors written in place, and
the step reads the offsets only as tensors: it has one static shape, so
admissions and evictions change values, never shapes, and a CUDA graph may
capture it (`serving/engine.py`).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from dalle_pytorch_tpu_torch.models.reversible import twin_stream
from dalle_pytorch_tpu_torch.models.transformer import (
    Attention,
    DecodePattern,
    Layer,
    Transformer,
    TransformerConfig,
    _attend_view,
    _feed_forward,
    _pattern_key,
    _qkv_heads,
    resolve_layer_range,
)
from dalle_pytorch_tpu_torch.quantization import KV_DTYPES, KV_SCALE_DTYPE, quantize_kv


def paged_blocks_per_seq(cfg: TransformerConfig, block_size: int) -> int:
    """Blocks a full sequence occupies (the admission unit)."""
    return -(-cfg.seq_len // block_size)


def init_paged_pool(cfg: TransformerConfig, num_blocks: int, block_size: int, dtype=torch.float32,
                    device=None, quantize: Optional[str] = None) -> dict:
    """Zeroed pool: per layer, k/v of (num_blocks, heads, block_size,
    dim_head).  The caller counts the trash block in `num_blocks`.
    `quantize="int8"` stores int8 k/v with per-token bf16 scales beside the
    blocks (`k_scale` / `v_scale`, the block shape without dim_head); every
    paged op keys off the scales' presence."""
    shape = (num_blocks, cfg.heads, block_size, cfg.dim_head)
    if quantize in (None, "none"):
        return {"layers": [{"k": torch.zeros(shape, dtype=dtype, device=device),
                            "v": torch.zeros(shape, dtype=dtype, device=device)} for _ in range(cfg.depth)]}
    if quantize not in KV_DTYPES:
        raise ValueError(f"kv quant must be one of {KV_DTYPES}, got {quantize!r}")
    return {"layers": [{"k": torch.zeros(shape, dtype=torch.int8, device=device),
                        "v": torch.zeros(shape, dtype=torch.int8, device=device),
                        "k_scale": torch.zeros(shape[:-1], dtype=KV_SCALE_DTYPE, device=device),
                        "v_scale": torch.zeros(shape[:-1], dtype=KV_SCALE_DTYPE, device=device)}
                       for _ in range(cfg.depth)]}


def init_slot_rings(cfg: TransformerConfig, num_slots: int, dtype=torch.float32, device=None) -> Optional[dict]:
    """Per-slot token-shift rings, (S, fmap, 2, dim // 4) per layer and
    branch; None without token shift."""
    if not cfg.shift_tokens:
        return None
    shape = (num_slots, cfg.image_fmap_size, 2, cfg.dim // 4)
    return {"layers": [{"shift_attn": torch.zeros(shape, dtype=dtype, device=device),
                        "shift_ff": torch.zeros(shape, dtype=dtype, device=device)} for _ in range(cfg.depth)]}


def _pack(buf: torch.Tensor, n_pre: int, block_size: int) -> torch.Tensor:
    """(b, h, >= n_pre, dh) -> (b, nb, h, block_size, dh): the first n_pre
    positions in blocks, the last block padded with zeros; a scale buffer
    (b, h, >= n_pre) -> (b, nb, h, block_size)."""
    nb = -(-n_pre // block_size)
    scale = buf.ndim == 3
    if scale:
        buf = buf[..., None]
    buf = buf[:, :, :n_pre]
    pad = nb * block_size - n_pre
    if pad:
        buf = F.pad(buf, (0, 0, 0, pad))
    b, h, _, dh = buf.shape
    out = buf.reshape(b, h, nb, block_size, dh).transpose(1, 2)
    return out[..., 0] if scale else out


@torch.no_grad()
def write_prefill_to_pool(cfg: TransformerConfig, pool: dict, block_tables: torch.Tensor, cache_layers,
                          n_pre: int, block_size: int) -> dict:
    """Scatter the first n_pre positions of a prefilled dense cache
    (`cache["layers"]`, b rows) into the blocks of `block_tables` (b,
    max_blocks), in place.  Pure data movement, except into a quantized
    pool, where a float cache is quantized per token at the scatter (an
    already quantized cache is moved as it is: per-token scales make the
    two orders equal)."""
    nb = -(-n_pre // block_size)
    tables = block_tables[:, :nb]
    for lp, lc in zip(pool["layers"], cache_layers):
        packed = {name: _pack(lc[name], n_pre, block_size) for name in ("k", "v")}
        if "k_scale" in lp:
            if "k_scale" in lc:
                packed.update({name: _pack(lc[name], n_pre, block_size) for name in ("k_scale", "v_scale")})
            else:
                (packed["k"], packed["k_scale"]), (packed["v"], packed["v_scale"]) = (
                    quantize_kv(packed["k"]), quantize_kv(packed["v"]))
        for name, value in packed.items():
            lp[name][tables] = value.to(lp[name].dtype)
    return pool


def _rows_at(table: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """A decode table's rows at the per-slot offsets: (n, K) -> (S, K), per
    head (h, n, K) -> (S, h, K)."""
    if table.ndim == 3:
        return table.index_select(1, offsets).transpose(0, 1)
    return table.index_select(0, offsets)


def _gathered(buf: torch.Tensor, block_tables: torch.Tensor, seq: int) -> torch.Tensor:
    """Each slot's blocks as a dense (S, h, seq, dh) view (a copy); a scale
    pool (blocks, h, block_size) as (S, h, seq)."""
    s, mb = block_tables.shape
    h, bs = buf.shape[1:3]
    return buf[block_tables].transpose(1, 2).reshape(s, h, mb * bs, *buf.shape[3:])[:, :, :seq]


def _paged_attention_step(attn: Attention, cfg: TransformerConfig, layer_pool: dict, block_tables, offsets,
                          x, rotary, pattern: Optional[DecodePattern], block_size: int) -> torch.Tensor:
    """One token per slot, x: (S, 1, dim) at positions `offsets` (S,): write
    each slot's key and value into its block, then attend over the slot's
    gathered view as `_attention_cached` does over a dense cache (both
    through `_attend_view`).  On a quantized pool the column is quantized
    once at the write, the gathered view stays int8 with its scales, and
    attention reads dequantized values (in a gathering pattern layer only
    the Kmax gathered keys')."""
    s = x.shape[0]
    lanes = torch.arange(s, device=x.device)
    ang = None if rotary is None else rotary.index_select(0, offsets)[:, None, None, None]
    q, k, v = _qkv_heads(attn, cfg, x, ang)  # (S, h, 1, dh)
    q = q * (cfg.dim_head ** -0.5)
    bids = block_tables[lanes, offsets // block_size]
    within = offsets % block_size
    cols = {"k": k[:, :, 0], "v": v[:, :, 0]}
    if "k_scale" in layer_pool:
        (cols["k"], cols["k_scale"]), (cols["v"], cols["v_scale"]) = quantize_kv(cols["k"]), quantize_kv(cols["v"])
    for name, col in cols.items():
        layer_pool[name][bids, :, within] = col.to(layer_pool[name].dtype)
    view = {name: _gathered(buf, block_tables, cfg.seq_len) for name, buf in layer_pool.items()}
    if pattern is not None and pattern.idx is not None:
        sel = _rows_at(pattern.idx, offsets)  # (S, Kmax) or per head (S, h, Kmax)
        valid = _rows_at(pattern.valid, offsets)
        return _attend_view(attn, cfg, q, view, valid[:, :, None] if sel.ndim == 3 else valid[:, None, None], sel)
    mask = torch.arange(cfg.seq_len, device=x.device)[None] <= offsets[:, None]  # (S, seq)
    if pattern is not None:
        rows = _rows_at(pattern.rows, offsets)
        mask = mask[:, None] & rows if rows.ndim == 3 else mask & rows
    return _attend_view(attn, cfg, q, view, mask[:, :, None] if mask.ndim == 3 else mask[:, None, None])


def _paged_shift_step(cfg: TransformerConfig, ring: torch.Tensor, x: torch.Tensor,
                      offsets: torch.Tensor) -> torch.Tensor:
    """`_shift_cached_step` with a per-slot offset: ring (S, fmap, 2, q),
    x (S, 1, dim).  The ring is updated in place."""
    fmap, q = cfg.image_fmap_size, cfg.dim // 4
    lanes = torch.arange(x.shape[0], device=x.device)
    slot = (offsets - cfg.text_len) % fmap
    cur = x[:, 0]
    top = ring[lanes, slot, 0]  # the token one row above lives in this slot
    left = ring[lanes, (slot - 1) % fmap, 1]
    left = torch.where((slot == 0)[:, None], torch.zeros_like(left), left)
    shifted = torch.cat([top, left, cur[:, 2 * q:]], dim=-1)[:, None]
    ring[lanes, slot] = torch.stack([cur[:, :q], cur[:, q:2 * q]], dim=1).to(ring.dtype)
    return shifted


def _paged_branch(cfg: TransformerConfig, layer: Layer, x, kind: str, layer_pool, block_tables, offsets,
                  ring_layer, pattern, rotary, block_size: int) -> torch.Tensor:
    """The decode-mode residual branch (`_residual_branch`, the sandwich
    norm included) over paged per-slot state."""
    h = (layer.attn_norm if kind == "attn" else layer.ff_norm)(x)
    if cfg.shift_tokens:
        h = _paged_shift_step(cfg, ring_layer[f"shift_{kind}"], h, offsets)
    if kind == "attn":
        h = _paged_attention_step(layer.attn, cfg, layer_pool, block_tables, offsets, h, rotary, pattern,
                                  block_size)
    else:
        h = _feed_forward(layer.ff, h)
    if cfg.sandwich_norm:
        h = (layer.attn_norm_out if kind == "attn" else layer.ff_norm_out)(h)
    scale = layer.attn_scale if kind == "attn" else layer.ff_scale
    return h * scale.to(h.dtype)


@torch.no_grad()
def paged_decode_step(model: Transformer, x: torch.Tensor, pool: dict, block_tables: torch.Tensor,
                      offsets: torch.Tensor, rings: Optional[dict], block_size: int,
                      layer_start: int = 0, layer_stop: Optional[int] = None) -> torch.Tensor:
    """One decode step for S independent sequences at per-slot positions.
    x: (S, 1, dim) embedded tokens; `offsets`: (S,) int64, the position each
    slot's token takes; `block_tables`: (S, max_blocks) int64; `rings`:
    `init_slot_rings` state or None.  Writes each slot's KV column and ring
    slots in place and returns the output (S, 1, dim).  Layers run
    sequentially, or under execution="reversible" as the twin stream over
    the same pool and rings.  `layer_start` / `layer_stop` run only those
    layers (`resolve_layer_range`: the speculative draft and verify halves);
    the other layers' pool and rings stay as they are."""
    cfg = model.cfg
    layers = resolve_layer_range(cfg, layer_start, layer_stop)
    if block_tables.shape[1] * block_size < cfg.seq_len:
        raise ValueError(f"block tables must cover a full sequence: {block_tables.shape[1]} x {block_size} "
                         f"< {cfg.seq_len}")
    rotary = model.rotary(x.device)

    def branch(i, kind, h, params=None):
        pattern = model.decode_inputs(_pattern_key(model.specs[i]), x.device)
        ring = None if rings is None else rings["layers"][i]
        return _paged_branch(cfg, model.layers[i], h, kind, pool["layers"][i], block_tables, offsets, ring,
                             pattern, rotary, block_size)

    if cfg.execution == "reversible":
        x1, x2 = twin_stream(branch, cfg.depth, x)
        return (x1 + x2) / 2
    h = x
    for i in layers:
        fa = branch(i, "attn", h)
        fb = branch(i, "ff", h + fa)
        h = h + fa + fb
    return h
