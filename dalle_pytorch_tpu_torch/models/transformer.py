"""The transformer core (counterpart of `dalle_pytorch_tpu/models/transformer.py`),
for sequential or rematerialised execution of unshared layers with full or
pattern attention (`axial_row`, `axial_col`, `conv_like`, `sparse`, shared
or per head).

Each layer is PreShiftToken? -> PreNorm -> attention or GEGLU feed-forward
(-> dropout) -> LayerScale, run in three modes: a full sequence
(`apply_transformer`, differentiable, the training mode), a prompt that also
fills the KV cache (`prefill`), and one cached token (`decode_step`).
Full-sequence attention, in the first two modes, goes through the flash
attention of `kernels/flash_attention.py`: the CUDA kernels on the card, at
any sequence length, with the backward kernels under autograd.  A pattern
layer passes its static mask and the mask's tile tables, built once per
pattern, length and device; the kernels take the compacted grid where the
pattern kills tiles.  The one-token decode attention is plain tensor ops
over the cache, as in the JAX package: a pattern layer gathers only the keys
its pattern row permits (`sparse_decode`) or masks the full cache with that
row.

The decode cache is a dict `{"offset": int, "layers": [per-layer dict]}`
whose k/v buffers and token-shift rings are updated in place (the JAX
package returns new arrays instead).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from dalle_pytorch_tpu_torch.core.module import LayerNorm, dropout, fan_in_uniform_
from dalle_pytorch_tpu_torch.kernels.flash_attention import PatternTables, flash_attention, pattern_tables
from dalle_pytorch_tpu_torch.kernels.sparse_index import build_decode_tables
from dalle_pytorch_tpu_torch.ops.attention import attend
from dalle_pytorch_tpu_torch.ops.masks import ATTN_TYPES, _block_sparse_mask_np, _block_sparse_mask_np_heads, _pattern_mask_np
from dalle_pytorch_tpu_torch.ops.rotary import apply_rotary, build_dalle_rotary
from dalle_pytorch_tpu_torch.ops.shift import token_shift


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    dim: int
    depth: int
    seq_len: int
    causal: bool = True
    heads: int = 8
    dim_head: int = 64
    ff_mult: int = 4
    # drawn only in `apply_transformer` with a generator (training)
    attn_dropout: float = 0.0
    ff_dropout: float = 0.0
    attn_types: Tuple[str, ...] = ("full",)
    image_fmap_size: Optional[int] = None
    stable: bool = False
    sandwich_norm: bool = False
    shift_tokens: bool = False
    rotary_emb: bool = True
    shared_attn_ids: Optional[Tuple[int, ...]] = None
    shared_ff_ids: Optional[Tuple[int, ...]] = None
    execution: str = "sequential"
    # what execution="remat" saves across a layer: the port runs "full"
    # (recompute everything); the JAX package's selective policies wait
    remat_policy: str = "full"
    # the patterns: conv_like's kernel and dilation; sparse's block size,
    # random blocks per query block (None: seq_len // block // 4) and
    # whether each head draws its own layout
    conv_kernel_size: int = 5
    conv_dilation: int = 1
    sparse_block_size: int = 16
    sparse_num_random_blocks: Optional[int] = None
    sparse_per_head: bool = False
    # flash grid: "auto" runs the compacted (live tiles only) grid where a
    # layer's pattern kills tiles inside the causal triangle, the dense grid
    # otherwise; "compact" / "dense" force.  The two give equal results.
    attn_grid: str = "auto"
    # the VFA global-max forward on the compacted grid (not ported yet)
    attn_vfa: bool = False
    # cached decode: a pattern layer gathers only the keys its pattern row
    # permits (Kmax per step) instead of masking the whole cache
    sparse_decode: bool = True

    def __post_init__(self):
        unsupported = {
            "stable": self.stable,
            "sandwich_norm": self.sandwich_norm,
            "shared_attn_ids": self.shared_attn_ids is not None,
            "shared_ff_ids": self.shared_ff_ids is not None,
            "execution": self.execution not in ("sequential", "remat"),
        }
        bad = [k for k, v in unsupported.items() if v]
        if bad:
            raise NotImplementedError(
                f"the PyTorch port runs unshared, sequential or rematerialised "
                f"layers only; unsupported settings: {', '.join(bad)}"
            )
        if self.attn_vfa:
            raise NotImplementedError(
                "attn_vfa: the VFA forward (`_max_kernel_compact`, `_fwd_kernel_compact_vfa`) "
                "comes with a later slice of the port (ROADMAP.md Queue 2)"
            )
        if self.attn_grid not in ("auto", "dense", "compact"):
            raise ValueError(f"attn_grid must be auto|dense|compact, got {self.attn_grid!r}")

    @property
    def inner_dim(self) -> int:
        return self.heads * self.dim_head

    @property
    def text_len(self) -> int:
        """Layout text length (bos + text) = seq_len + 1 - fmap**2."""
        if self.image_fmap_size is None:
            raise ValueError("text_len needs image_fmap_size")
        return self.seq_len + 1 - self.image_fmap_size ** 2


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    index: int
    attn_type: str
    attn_id: str
    ff_id: str


def derive_layer_specs(cfg: TransformerConfig) -> List[LayerSpec]:
    """Cycle attn_types over depth (layers are unshared in the port)."""
    specs = []
    for i in range(cfg.depth):
        attn_type = cfg.attn_types[i % len(cfg.attn_types)]
        if attn_type not in ATTN_TYPES:
            raise ValueError(f'attention type "{attn_type}" is not valid')
        specs.append(LayerSpec(i, attn_type, str(i), str(i)))
    return specs


def _layerscale_eps(layer_one_indexed: int) -> float:
    if layer_one_indexed <= 18:
        return 0.1
    if layer_one_indexed <= 24:
        return 1e-5
    return 1e-6


# ---------------------------------------------------------------------------
# patterns
# ---------------------------------------------------------------------------


def _pattern_for(cfg: TransformerConfig, attn_type: str, seed: int = 0) -> Optional[np.ndarray]:
    """(seq_len, seq_len), or (heads, seq_len, seq_len) for per-head
    'sparse', numpy pattern mask; None for 'full'.  `seed` picks the random
    block layout of 'sparse' (see `_pattern_seed`)."""
    if attn_type == "full":
        return None
    if attn_type == "sparse":
        nr = cfg.sparse_num_random_blocks
        if nr is None:
            nr = cfg.seq_len // cfg.sparse_block_size // 4
        if cfg.sparse_per_head:
            return _block_sparse_mask_np_heads(
                cfg.seq_len, cfg.image_fmap_size, cfg.sparse_block_size, nr, 4, seed, cfg.heads)
        return _block_sparse_mask_np(cfg.seq_len, cfg.image_fmap_size, cfg.sparse_block_size, nr, 4, seed)
    return _pattern_mask_np(attn_type, cfg.seq_len, cfg.image_fmap_size, cfg.conv_kernel_size,
                            cfg.conv_dilation)


def _pattern_seed(spec: LayerSpec) -> int:
    """Random-layout seed of a 'sparse' layer: its attention id (the layer
    index: the port runs no shared layers), so distinct layers draw
    distinct layouts, as the JAX package has it."""
    return int(spec.attn_id)


def _pattern_key(spec: LayerSpec) -> Tuple[str, int]:
    """Key of a layer's pattern: (type, layout seed)."""
    return (spec.attn_type, _pattern_seed(spec) if spec.attn_type == "sparse" else 0)


def spec_patterns(cfg: TransformerConfig, specs: List[LayerSpec]) -> Dict[Tuple[str, int], Optional[np.ndarray]]:
    """One pattern mask per distinct (type, seed) of the given layers."""
    return {key: _pattern_for(cfg, key[0], key[1]) for key in dict.fromkeys(_pattern_key(s) for s in specs)}


class DecodePattern(NamedTuple):
    """A pattern layer's cached-decode inputs on one device: the gather
    tables (`idx` (n, Kmax) or (h, n, Kmax) key positions, `valid` the same
    shape, True on the live prefix) when `sparse_decode` is on, else the
    pattern itself (`rows`, (n, n) or (h, n, n))."""

    idx: Optional[torch.Tensor]
    valid: Optional[torch.Tensor]
    rows: Optional[torch.Tensor]


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        # qkv columns are head-major: [h0:(q|k|v), h1:(q|k|v), ...]
        self.qkv = nn.Linear(cfg.dim, cfg.inner_dim * 3, bias=False)
        self.out = nn.Linear(cfg.inner_dim, cfg.dim)


class FeedForward(nn.Module):
    """GEGLU as two matrices: values (`w1`) and gates (`w1g`)."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        hidden = cfg.dim * cfg.ff_mult
        self.w1 = nn.Linear(cfg.dim, hidden)
        self.w1g = nn.Linear(cfg.dim, hidden)
        self.w2 = nn.Linear(hidden, cfg.dim)


class Layer(nn.Module):
    def __init__(self, cfg: TransformerConfig, index: int):
        super().__init__()
        eps = _layerscale_eps(index + 1)
        self.attn_norm = LayerNorm(cfg.dim)
        self.ff_norm = LayerNorm(cfg.dim)
        self.attn_scale = nn.Parameter(torch.full((1, 1, cfg.dim), eps))
        self.ff_scale = nn.Parameter(torch.full((1, 1, cfg.dim), eps))
        self.attn = Attention(cfg)
        self.ff = FeedForward(cfg)


class Transformer(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        self.specs = derive_layer_specs(cfg)
        self.layers = nn.ModuleList(Layer(cfg, s.index) for s in self.specs)
        # f32 angle tables by device; kept out of the buffers so that casting
        # the module to bf16 leaves the angles in f32
        self._rotary: Dict[torch.device, torch.Tensor] = {}
        # numpy masks by pattern key, and what attention reads of them on a
        # device, built at first use
        self.patterns = spec_patterns(cfg, self.specs)
        self._attn_inputs: Dict[tuple, Tuple[Optional[torch.Tensor], Optional[PatternTables]]] = {}
        self._decode_inputs: Dict[tuple, DecodePattern] = {}

    def rotary(self, device: torch.device) -> Optional[torch.Tensor]:
        cfg = self.cfg
        if not cfg.rotary_emb:
            return None
        table = self._rotary.get(device)
        if table is None:
            table = build_dalle_rotary(cfg.dim_head, cfg.text_len, cfg.image_fmap_size, device)
            self._rotary[device] = table
        return table

    def attention_inputs(self, key, n: int, causal: bool, device: torch.device):
        """(mask, tables) of the layers with pattern key `key` for
        full-sequence attention at length n: the pattern cut to (n, n) on
        `device` (None for 'full'), and on a CUDA device its kernel tables
        (None on the CPU, and for 'full' unless attn_grid is "compact")."""
        cfg = self.cfg
        pattern = self.patterns[key]
        if pattern is None and cfg.attn_grid != "compact":
            return None, None
        cache_key = (key, n, causal, device)
        got = self._attn_inputs.get(cache_key)
        if got is None:
            mask_np = None if pattern is None else np.ascontiguousarray(pattern[..., :n, :n])
            mask = None if mask_np is None else torch.from_numpy(mask_np).to(device)
            tables = None
            if device.type == "cuda":
                tables = pattern_tables(mask_np, n, cfg.dim_head, causal, cfg.attn_grid, device)
            got = self._attn_inputs[cache_key] = (mask, tables)
        return got

    def decode_inputs(self, key, device: torch.device) -> Optional[DecodePattern]:
        """The cached-decode inputs of the layers with pattern key `key`, or
        None for 'full'."""
        pattern = self.patterns[key]
        if pattern is None:
            return None
        got = self._decode_inputs.get((key, device))
        if got is None:
            if self.cfg.sparse_decode:
                idx, counts = build_decode_tables(pattern)
                valid = np.arange(idx.shape[-1]) < counts[..., None]
                got = DecodePattern(torch.from_numpy(idx).long().to(device), torch.from_numpy(valid).to(device),
                                    None)
            else:
                got = DecodePattern(None, None, torch.from_numpy(np.ascontiguousarray(pattern)).to(device))
            self._decode_inputs[(key, device)] = got
        return got

    def forward(self, x: torch.Tensor, key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return apply_transformer(self, x, key_mask)


@torch.no_grad()
def init_transformer_(model: Transformer, generator: Optional[torch.Generator] = None) -> None:
    """Seeded in-place initialisation with the JAX package's distributions
    (norms and LayerScale keep their constructor values)."""
    for layer in model.layers:
        for lin in (layer.attn.qkv, layer.attn.out, layer.ff.w1, layer.ff.w1g, layer.ff.w2):
            fan_in_uniform_(lin, generator)


# ---------------------------------------------------------------------------
# branches
# ---------------------------------------------------------------------------


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, n, h * d)


def _qkv_heads(attn: Attention, cfg: TransformerConfig, x: torch.Tensor, ang):
    """Project to qkv and split into (q, k, v), each (b, h, n_x, dh); the
    rotary rotation (`ang`: (n_x, rot) or None) runs on all three."""
    b, n_x, _ = x.shape
    qkv = attn.qkv(x).reshape(b, n_x, cfg.heads, 3, cfg.dim_head).permute(0, 2, 3, 1, 4)
    if ang is not None:
        qkv = apply_rotary(ang, qkv)
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


def _attention_full(attn, cfg, x, rotary, key_mask, causal, layer_cache=None, pattern=(None, None)):
    """Full-sequence attention through flash attention; `pattern` is the
    layer's (mask, tables) at this length.  With a `layer_cache` (prefill)
    the keys and values also fill the cache from position 0."""
    n = x.shape[1]
    q, k, v = _qkv_heads(attn, cfg, x, None if rotary is None else rotary[:n])
    if layer_cache is not None:
        layer_cache["k"][:, :, :n] = k
        layer_cache["v"][:, :, :n] = v
    mask, tables = pattern
    out = flash_attention(
        q, k, v, mask=mask, causal=causal, scale=cfg.dim_head ** -0.5,
        key_mask=None if key_mask is None else key_mask[:, :n],
        grid=cfg.attn_grid, tables=tables,
    )
    return attn.out(_merge_heads(out))


def _feed_forward(ff: FeedForward, x: torch.Tensor, rate: float = 0.0,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    h = ff.w1(x) * F.gelu(ff.w1g(x))  # exact-erf gelu
    return ff.w2(dropout(h, rate, generator))


def _attention_cached(attn, cfg, layer_cache, x, rotary, offset: int,
                      pattern: Optional[DecodePattern] = None):
    """One cached token x: (b, 1, dim) at position `offset`; writes its key
    and value into the cache and attends over positions 0..offset, or, in a
    pattern layer, over those its pattern row permits: the gathered Kmax
    keys (padded slots masked off) or the cache masked with the row."""
    ang = None if rotary is None else rotary[offset:offset + 1]
    q, k, v = _qkv_heads(attn, cfg, x, ang)
    q = q * (cfg.dim_head ** -0.5)
    k_buf, v_buf = layer_cache["k"], layer_cache["v"]
    k_buf[:, :, offset] = k[:, :, 0]
    v_buf[:, :, offset] = v[:, :, 0]
    if pattern is None:
        out = attend(q, k_buf[:, :, :offset + 1], v_buf[:, :, :offset + 1])
    elif pattern.idx is not None:
        sel = pattern.idx[..., offset, :]  # (Kmax,) or per head (h, Kmax)
        if sel.ndim == 2:
            b, h, _, d = k_buf.shape
            gather = sel[None, :, :, None].expand(b, h, sel.shape[-1], d)
            k_sel, v_sel = torch.gather(k_buf, 2, gather), torch.gather(v_buf, 2, gather)
            amask = pattern.valid[:, offset][None, :, None, :]
        else:
            k_sel, v_sel = k_buf.index_select(2, sel), v_buf.index_select(2, sel)
            amask = pattern.valid[offset][None, None, None, :]
        out = attend(q, k_sel, v_sel, mask=amask)
        decode_step.gathers += 1
    else:
        row = pattern.rows[..., offset, :offset + 1]  # (offset+1,) or per head (h, offset+1)
        amask = row[None, :, None, :] if row.ndim == 2 else row[None, None, None, :]
        out = attend(q, k_buf[:, :, :offset + 1], v_buf[:, :, :offset + 1], mask=amask)
    return attn.out(_merge_heads(out))


def _shift_cached_step(cfg, rb: torch.Tensor, x: torch.Tensor, offset: int) -> torch.Tensor:
    """One-token token shift against the ring buffer rb (b, fmap, 2, dim//4),
    which holds each past image token's first and second channel quarters
    in its raster-column slot.  Returns the shifted x; rb is updated in
    place."""
    fmap = cfg.image_fmap_size
    q = cfg.dim // 4
    slot = (offset - cfg.text_len) % fmap
    cur = x[:, 0]
    top = rb[:, slot, 0]  # the token one row above lives in this slot
    left = rb[:, (slot - 1) % fmap, 1]
    if slot == 0:
        left = torch.zeros_like(left)
    shifted = torch.cat([top, left, cur[:, 2 * q:]], dim=-1)[:, None]
    rb[:, slot, 0] = cur[:, :q]
    rb[:, slot, 1] = cur[:, q:2 * q]
    return shifted


def _fill_ring(cfg, rb: torch.Tensor, pre_shift: torch.Tensor) -> None:
    """Fill the ring buffer in place from a length-n prefix: the raw channel
    quarters of the last min(n - text_len, fmap) image tokens."""
    b, n, d = pre_shift.shape
    fmap = cfg.image_fmap_size
    q = d // 4
    n_img = n - cfg.text_len
    if n_img <= 0:
        return
    take = min(n_img, fmap)
    for t in range(take):
        img_pos = n_img - take + t
        row = pre_shift[:, n - take + t]
        rb[:, img_pos % fmap, 0] = row[:, :q]
        rb[:, img_pos % fmap, 1] = row[:, q:2 * q]


def _residual_branch(cfg, layer: Layer, x, kind: str, mode: str, rotary=None,
                     key_mask=None, layer_cache=None, offset: int = 0,
                     text_mode: bool = False, dropout_seed: Optional[int] = None,
                     pattern=None):
    """PreShiftToken? -> PreNorm -> attention or feed-forward (-> dropout)
    -> LayerScale, in mode 'full', 'prefill' or 'decode'; `pattern` is the
    layer's `Transformer.attention_inputs` (or, decoding, `decode_inputs`).
    The dropout generator is built here from `dropout_seed`, so a
    rematerialised layer draws the same masks again when it is recomputed."""
    gen = None if dropout_seed is None else torch.Generator(device=x.device).manual_seed(dropout_seed)
    h = (layer.attn_norm if kind == "attn" else layer.ff_norm)(x)
    if cfg.shift_tokens:
        if mode == "decode":
            if not text_mode:  # the shift is the identity in the text region
                h = _shift_cached_step(cfg, layer_cache[f"shift_{kind}"], h, offset)
        else:
            if mode == "prefill":  # the ring takes the normed, pre-shift values
                _fill_ring(cfg, layer_cache[f"shift_{kind}"], h)
            h = token_shift(h, cfg.seq_len, cfg.image_fmap_size)
    if kind == "attn":
        if mode == "decode":
            h = _attention_cached(layer.attn, cfg, layer_cache, h, rotary, offset, pattern)
        else:
            h = _attention_full(
                layer.attn, cfg, h, rotary, key_mask,
                causal=cfg.causal or mode == "prefill",
                layer_cache=layer_cache if mode == "prefill" else None,
                pattern=pattern,
            )
            h = dropout(h, cfg.attn_dropout, gen)
    else:
        h = _feed_forward(layer.ff, h, cfg.ff_dropout, gen)
    scale = layer.attn_scale if kind == "attn" else layer.ff_scale
    return h * scale.to(h.dtype)


def _layer_step(cfg, layer: Layer, x, mode, rotary, key_mask, layer_cache, offset,
                text_mode, seeds, pattern):
    for kind, seed in zip(("attn", "ff"), seeds):
        x = x + _residual_branch(cfg, layer, x, kind, mode, rotary, key_mask,
                                 layer_cache, offset, text_mode, seed, pattern)
    return x


def _run_layers(model: Transformer, x, mode, cache=None, key_mask=None, text_mode=False,
                seeds=None, remat=False):
    """seeds: per layer, the (attention, feed-forward) dropout seeds, or
    None.  remat: wrap each layer in a non-reentrant checkpoint, the JAX
    package's "full" remat policy: the backward recomputes the layer."""
    cfg = model.cfg
    rotary = model.rotary(x.device)
    offset = 0 if cache is None else cache["offset"]
    causal = cfg.causal or mode == "prefill"
    for i, (layer, spec) in enumerate(zip(model.layers, model.specs)):
        lc = None if cache is None else cache["layers"][i]
        key = _pattern_key(spec)
        if mode == "decode":
            pattern = model.decode_inputs(key, x.device)
        else:
            pattern = model.attention_inputs(key, x.shape[1], causal, x.device)
        args = (cfg, layer, x, mode, rotary, key_mask, lc, offset, text_mode,
                (None, None) if seeds is None else seeds[i], pattern)
        x = checkpoint(_layer_step, *args, use_reentrant=False) if remat else _layer_step(*args)
    return x


def _dropout_seeds(cfg: TransformerConfig, generator: Optional[torch.Generator]):
    """One seed per layer and branch, drawn up front from `generator`, as the
    JAX package splits its dropout key per layer; None without dropout."""
    if generator is None or (cfg.attn_dropout == 0 and cfg.ff_dropout == 0):
        return None
    seeds = torch.randint(0, 2 ** 62, (cfg.depth, 2), generator=generator, device=generator.device)
    return [tuple(pair) for pair in seeds.tolist()]


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def apply_transformer(model: Transformer, x: torch.Tensor,
                      key_mask: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """x: (batch, n, dim), n <= seq_len.  Full-sequence (training) mode,
    differentiable.  `generator` draws the dropout masks (none when it is
    None); a CPU generator draws the per-layer seeds without a device sync.
    execution="remat" recomputes each layer in the backward; it only
    matters while a gradient is taken."""
    cfg = model.cfg
    remat = cfg.execution == "remat" and torch.is_grad_enabled()
    if remat and cfg.remat_policy != "full":
        raise NotImplementedError(
            f"remat_policy {cfg.remat_policy!r}: the port trains with the 'full' "
            "policy only; the selective policies (flash, flash_qkv, flash_qkv_ff) "
            "come with a later PR"
        )
    return _run_layers(model, x, "full", key_mask=key_mask,
                       seeds=_dropout_seeds(cfg, generator), remat=remat)


def init_cache(cfg: TransformerConfig, batch: int, dtype=torch.float32, device=None) -> dict:
    """Zeroed KV cache and token-shift rings; `offset` counts the positions
    already consumed."""

    def entry():
        e = {
            "k": torch.zeros((batch, cfg.heads, cfg.seq_len, cfg.dim_head), dtype=dtype, device=device),
            "v": torch.zeros((batch, cfg.heads, cfg.seq_len, cfg.dim_head), dtype=dtype, device=device),
        }
        if cfg.shift_tokens:
            shape = (batch, cfg.image_fmap_size, 2, cfg.dim // 4)
            e["shift_attn"] = torch.zeros(shape, dtype=dtype, device=device)
            e["shift_ff"] = torch.zeros(shape, dtype=dtype, device=device)
        return e

    return {"offset": 0, "layers": [entry() for _ in range(cfg.depth)]}


@torch.no_grad()
def prefill(model: Transformer, x: torch.Tensor, cache: dict,
            key_mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, dict]:
    """Consume a length-n prefix from offset 0, filling the cache, and return
    the transformer output for the prefix."""
    out = _run_layers(model, x, "prefill", cache=cache, key_mask=key_mask)
    cache["offset"] = x.shape[1]
    return out, cache


@torch.no_grad()
def decode_step(model: Transformer, x: torch.Tensor, cache: dict,
                text_only: bool = False) -> Tuple[torch.Tensor, dict]:
    """Process one token x: (b, 1, dim) at position cache['offset'].
    text_only: the position is in the text region, where the token shift is
    the identity."""
    out = _run_layers(model, x, "decode", cache=cache, text_mode=text_only)
    cache["offset"] += 1
    return out, cache


decode_step.gathers = 0  # pattern-layer decode steps that took the gather branch
