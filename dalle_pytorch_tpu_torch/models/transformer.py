"""The transformer core (counterpart of `dalle_pytorch_tpu/models/transformer.py`),
for sequential, rematerialised or reversible execution of layers with full
or pattern attention (`axial_row`, `axial_col`, `conv_like`, `sparse`,
shared or per head), weight sharing across layers (`shared_attn_ids`,
`shared_ff_ids`: the ids cycle over depth, and layers with one id hold one
`Attention` or `FeedForward` module), the `stable` softmax in the plain
attention and the sandwich norm after each branch (`sandwich_norm`).

Rematerialisation (`execution="remat"`) wraps each layer in a
non-reentrant `torch.utils.checkpoint` and takes the JAX package's save
policies (`remat_policy`): "full" keeps only the layer's input and
recomputes the rest in the backward, the flash forward included; "flash",
"flash_qkv" and "flash_qkv_ff" keep what their names say: the layer's first
run keeps the flash forward's (out, lse) and the named projections'
outputs (`_Kept`), and the recompute takes them back in place of running
them again, so the backward runs each forward kernel no second time.

Reversible execution (`execution="reversible"`) runs the layers as a twin
stream (`models/reversible.py`): attention on the second stream into the
first, then feed-forward on the first into the second, the output the mean
of the two.  While a gradient is taken, `Reversible` keeps only the two
final streams and rebuilds each layer's input in its backward; otherwise,
and in prefill and the cached decode step, the twin stream runs as plain
tensor ops over the same caches.

Each layer is PreShiftToken? -> PreNorm -> attention or GEGLU feed-forward
(-> dropout) -> sandwich norm? -> LayerScale, run in three modes: a full
sequence (`apply_transformer`, differentiable, the training mode), a prompt
that also fills the KV cache (`prefill`), and one cached token
(`decode_step`).
Full-sequence attention, in the first two modes, goes through the flash
attention of `kernels/flash_attention.py`: the CUDA kernels on the card, at
any sequence length, with the backward kernels under autograd.  A pattern
layer passes its static mask and the mask's tile tables, built once per
pattern, length and device; the kernels take the compacted grid where the
pattern kills tiles, and with `attn_vfa` run the two-pass VFA forward
there.  The online softmax is stable as it is, so `stable` changes only
the plain attention.  The one-token decode attention is plain tensor ops
over the cache, as in the JAX package: a pattern layer gathers only the
keys its pattern row permits (`sparse_decode`) or masks the full cache with
that row.

Under the sharded train step (`parallel/`) the full-sequence mode also runs
on a sequence sharded over sp, when `seq_shard_axis` names it: each rank
holds its part of the sequence (global positions seq_start + i, which the
rotary angles, the patterns, the token shift's halo and the dropout masks
read).  No flash kernel runs there, as in the JAX package: with
`attn_kernel="ring"` a layer whose pattern is 2-D (or none) takes ring
attention (`parallel/ring.py`), every other layer all-gathers K and V over
sp and attends its query rows with the plain attention under the global
causal and pattern masks (what GSPMD makes of the JAX package's dense
attention).  With `pipeline_axis` and a pipelined step the layers run as
the stages of `parallel/pipeline.py` (`stage_runner`); reversible execution
refuses a pipeline, as in the JAX package.

The decode cache is a dict `{"offset": (), "layers": [per-layer dict]}`
whose offset (an int64 tensor on the cache's device), k/v buffers and
token-shift rings are updated in place (the JAX package returns new arrays
instead).  A decode step is static, as the JAX package's is: it reads the
offset only as a tensor (rotary, pattern tables and ring slots by
`index_select`, cache writes by `index_copy_`, attention over the whole
cache under `j <= offset`), so every step runs the same ops on the same
shapes, never syncs with the host, and can be captured in a CUDA graph
(`models/sampling.DecodeGraphs`).
"""
from __future__ import annotations

import dataclasses
import functools
import threading
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from dalle_pytorch_tpu_torch.core import shard as shard_mod
from dalle_pytorch_tpu_torch.core.module import LayerNorm, dropout, fan_in_uniform_
from dalle_pytorch_tpu_torch.kernels.flash_attention import PatternTables, flash_attention, mask_with_slack, pattern_tables
from dalle_pytorch_tpu_torch.kernels.sparse_index import build_decode_tables
from dalle_pytorch_tpu_torch.models.reversible import reversible, twin_stream
from dalle_pytorch_tpu_torch.ops.attention import attend
from dalle_pytorch_tpu_torch.ops.masks import ATTN_TYPES, _block_sparse_mask_np, _block_sparse_mask_np_heads, _pattern_mask_np
from dalle_pytorch_tpu_torch.ops.rotary import apply_rotary, build_dalle_rotary
from dalle_pytorch_tpu_torch.ops.shift import token_shift
from dalle_pytorch_tpu_torch.parallel import tensor_parallel as tp
from dalle_pytorch_tpu_torch.quantization import dequantize_kv, quantize_kv


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
    # "sequential", "remat" (each layer recomputed in the backward) or
    # "reversible" (the twin stream, its layers' inputs rebuilt in the backward)
    execution: str = "sequential"
    # what execution="remat" keeps across a layer besides its input:
    #   "full"         nothing: the backward recomputes the whole layer, and
    #                  with it the flash forward (or the VFA pair)
    #   "flash"        the flash forward's out and lse
    #   "flash_qkv"    also the qkv projection (before the rotary)
    #   "flash_qkv_ff" also the GEGLU's two up-projections
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
    # the compacted grid's forward as VFA: a max pass, then accumulation
    # against the fixed row maxima (the dense grid ignores it)
    attn_vfa: bool = False
    # cached decode: a pattern layer gathers only the keys its pattern row
    # permits (Kmax per step) instead of masking the whole cache
    sparse_decode: bool = True
    # the JAX package's execution knobs of a mesh: "ring" takes ring
    # attention where the sequence is sharded over `seq_shard_axis` (the
    # other values run the flash kernels, or under sequence sharding the
    # gathered plain attention); `pipeline_axis` pipelines the layers over
    # that axis in M micro-batches (None: the JAX choice), `pp_interleave`
    # chunks a stage
    attn_kernel: str = "auto"
    seq_shard_axis: Optional[str] = None
    pipeline_axis: Optional[str] = None
    pp_num_micro: Optional[int] = None
    pp_interleave: int = 1

    def __post_init__(self):
        if self.execution not in ("sequential", "remat", "reversible"):
            raise ValueError(f"execution must be sequential|remat|reversible, got {self.execution!r}")
        if self.attn_kernel not in ("auto", "flash", "xla", "ring"):
            raise ValueError(f"attn_kernel must be auto|flash|xla|ring, got {self.attn_kernel!r}")
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
    """Cycle attn_types over depth and the sharing ids over depth (each
    layer its own id when they are None), as the JAX package does; a shared
    attention id reused under another attention type raises."""
    attn_ids = cfg.shared_attn_ids or tuple(range(cfg.depth))
    ff_ids = cfg.shared_ff_ids or tuple(range(cfg.depth))
    specs = []
    seen_attn_types: Dict[str, str] = {}
    for i in range(cfg.depth):
        attn_type = cfg.attn_types[i % len(cfg.attn_types)]
        if attn_type not in ATTN_TYPES:
            raise ValueError(f'attention type "{attn_type}" is not valid')
        attn_id = str(attn_ids[i % len(attn_ids)])
        ff_id = str(ff_ids[i % len(ff_ids)])
        if attn_id in seen_attn_types and seen_attn_types[attn_id] != attn_type:
            raise ValueError(
                f"attn_types do not match shared_attn_ids (ind = {i}, "
                f'attn_type = "{attn_type}", reused = "{seen_attn_types[attn_id]}")'
            )
        seen_attn_types[attn_id] = attn_type
        specs.append(LayerSpec(i, attn_type, attn_id, ff_id))
    return specs


def _layerscale_eps(layer_one_indexed: int) -> float:
    if layer_one_indexed <= 18:
        return 0.1
    if layer_one_indexed <= 24:
        return 1e-5
    return 1e-6


# ---------------------------------------------------------------------------
# selective rematerialisation
# ---------------------------------------------------------------------------


# what each selective policy keeps, by the JAX package's checkpoint names
REMAT_SAVE_NAMES = {
    "flash": ("flash_out", "flash_lse"),
    "flash_qkv": ("flash_out", "flash_lse", "attn_qkv"),
    "flash_qkv_ff": ("flash_out", "flash_lse", "attn_qkv", "ff_pre"),
}


def remat_names(policy: str) -> Tuple[str, ...]:
    """What a remat policy keeps across a layer besides its input: nothing
    for "full", the JAX package's checkpoint names otherwise.  An unknown
    policy raises."""
    if policy == "full":
        return ()
    if policy not in REMAT_SAVE_NAMES:
        raise ValueError(f"remat_policy {policy!r} is not valid; choose from 'full', "
                         f"{', '.join(map(repr, REMAT_SAVE_NAMES))}")
    return REMAT_SAVE_NAMES[policy]


class _Kept:
    """What one rematerialised layer keeps between its forward and its
    backward.  The layer's checkpoint runs it twice, the forward and then
    the recompute in the backward, on one code path: the first run computes
    each value the policy names and keeps it (detached), in order; the
    second takes them back in that order instead of computing them."""

    def __init__(self, names: Tuple[str, ...]):
        self.names, self.values, self.replay = names, [], None

    def take(self, name: str, compute):
        if self.replay is not None:
            return next(self.replay)
        value = compute()
        self.values.append(tuple(t.detach() for t in value) if isinstance(value, tuple) else value.detach())
        return value


class _Running(threading.local):
    kept: Optional[_Kept] = None  # that of the layer running on this thread


_running = _Running()


def _keeper(name: str):
    """The running layer's `_Kept.take` for `name` when its policy keeps
    `name`, else None."""
    kept = _running.kept
    return None if kept is None or name not in kept.names else functools.partial(kept.take, name)


class _KeptLinear(torch.autograd.Function):
    """`F.linear` whose output the layer keeps (`keep`, a `_keeper`): the
    recompute takes it back instead of running the product again, and saves
    the same (input, weight).  The backward is the linear's own, as
    autograd's addmm computes it."""

    @staticmethod
    def forward(ctx, x, weight, bias, keep):
        ctx.save_for_backward(x, weight)
        ctx.bias = bias is not None
        return keep(lambda: F.linear(x, weight, bias))

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        dx = g2.mm(weight).view(x.shape)
        dw = g2.t().mm(x.reshape(-1, x.shape[-1]))
        return dx, dw, g2.sum(0) if ctx.bias else None, None


def _linear(linear: nn.Linear, x: torch.Tensor, name: str) -> torch.Tensor:
    """linear(x), kept under the JAX package's checkpoint name `name` when
    the running layer's policy keeps it."""
    keep = _keeper(name)
    return linear(x) if keep is None else _KeptLinear.apply(x, linear.weight, linear.bias, keep)


def remat_run(layer: Layer, names: Tuple[str, ...]):
    """The function a layer's checkpoint runs, in the forward and again in
    the backward, on the parameters the forward used (a caller's
    `functional_call`, such as the train step's bf16 working copy, has put
    the module's own back by the time the backward runs).  With `names`
    the first run keeps them (`_Kept`, also at `.kept`) and the second
    takes them back."""
    params = dict(layer.named_parameters())
    kept = _Kept(names) if names else None

    def run(*args):
        outer, _running.kept = _running.kept, kept
        try:
            return functional_call(layer, params, args)
        finally:
            _running.kept = outer
            if kept is not None:
                kept.replay = iter(kept.values)

    run.kept = kept
    return run


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
    """Random-layout seed of a 'sparse' layer: its attention id, so the
    layout belongs to the attention module, as the JAX package has it:
    distinct layers draw distinct layouts, and layers that share an id
    (`shared_attn_ids`) share its layout."""
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
    """One layer's own parameters (the pre-norms, the sandwich norms under
    `sandwich_norm`, LayerScale) and the attention and feed-forward of its
    ids: layers that share an id hold the same module."""

    def __init__(self, cfg: TransformerConfig, index: int, attn: Attention, ff: FeedForward):
        super().__init__()
        eps = _layerscale_eps(index + 1)
        self.attn_norm = LayerNorm(cfg.dim)
        self.ff_norm = LayerNorm(cfg.dim)
        self.attn_scale = nn.Parameter(torch.full((1, 1, cfg.dim), eps))
        self.ff_scale = nn.Parameter(torch.full((1, 1, cfg.dim), eps))
        if cfg.sandwich_norm:
            self.attn_norm_out = LayerNorm(cfg.dim)
            self.ff_norm_out = LayerNorm(cfg.dim)
        self.attn = attn
        self.ff = ff

    def forward(self, cfg, x, mode, rotary, key_mask, layer_cache, offset, text_mode, seeds, pattern,
                kind: Optional[str] = None):
        """The layer's attention then feed-forward residual branches
        (`_residual_branch`, with the branch's dropout seed); with `kind`
        ("attn" or "ff"), that branch's output alone (the twin stream)."""
        if kind is not None:
            return _residual_branch(cfg, self, x, kind, mode, rotary, key_mask, layer_cache, offset, text_mode,
                                    seeds[kind == "ff"], pattern)
        for kind, seed in zip(("attn", "ff"), seeds):
            x = x + _residual_branch(cfg, self, x, kind, mode, rotary, key_mask,
                                     layer_cache, offset, text_mode, seed, pattern)
        return x


class Transformer(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        self.specs = derive_layer_specs(cfg)
        attns: Dict[str, Attention] = {}
        ffs: Dict[str, FeedForward] = {}
        layers = []
        for s in self.specs:
            if s.attn_id not in attns:
                attns[s.attn_id] = Attention(cfg)
            if s.ff_id not in ffs:
                ffs[s.ff_id] = FeedForward(cfg)
            layers.append(Layer(cfg, s.index, attns[s.attn_id], ffs[s.ff_id]))
        self.layers = nn.ModuleList(layers)
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
        `device` (None for 'full'), and on a CUDA or meta device its kernel
        tables (None on the CPU, and for 'full' unless attn_grid is
        "compact").
        Under tensor parallelism a per-head pattern keeps this rank's
        heads."""
        cfg = self.cfg
        pattern = self.patterns[key]
        if pattern is None and cfg.attn_grid != "compact":
            return None, None
        shard = shard_mod.current()
        heads = None  # a per-head pattern under tensor parallelism: this rank's heads
        if pattern is not None and pattern.ndim == 3 and shard.tp:
            heads = tp.local_slice(cfg.heads, shard.tp_rank, shard.tp_size)
        cache_key = (key, n, causal, device, None if heads is None else (heads.start, heads.stop))
        got = self._attn_inputs.get(cache_key)
        if got is None:
            if heads is not None:
                pattern = pattern[heads]
            mask_np = None if pattern is None else np.ascontiguousarray(pattern[..., :n, :n])
            mask = None if mask_np is None else mask_with_slack(torch.from_numpy(mask_np).to(device))
            tables = None
            if device.type != "cpu":
                tables = pattern_tables(mask_np, n, cfg.dim_head, causal, cfg.attn_grid, device)
            got = self._attn_inputs[cache_key] = (mask, tables)
        return got

    def sp_pattern(self, key, n: int, device: torch.device) -> Optional[torch.Tensor]:
        """The pattern of the layers with pattern key `key` over the global
        sequence of n on `device` ((n, n), per head (h, n, n), this rank's
        heads under tensor parallelism), None for 'full': what a layer on a
        sequence sharded over sp slices its rows and columns from."""
        pattern = self.patterns[key]
        if pattern is None:
            return None
        shard = shard_mod.current()
        heads = None
        if pattern.ndim == 3 and shard.tp:
            heads = tp.local_slice(self.cfg.heads, shard.tp_rank, shard.tp_size)
        cache_key = ("sp", key, n, device, None if heads is None else (heads.start, heads.stop))
        got = self._attn_inputs.get(cache_key)
        if got is None:
            got = torch.from_numpy(np.ascontiguousarray((pattern if heads is None else pattern[heads])[..., :n, :n]))
            got = self._attn_inputs[cache_key] = got.to(device)
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

    def prepare_decode(self, device: torch.device) -> None:
        """Build what the cached decode step reads on `device` (the rotary
        angles, each pattern layer's decode inputs) ahead of the steps, so
        that no step makes a tensor from host data."""
        self.rotary(device)
        for spec in self.specs:
            self.decode_inputs(_pattern_key(spec), device)

    def forward(self, x: torch.Tensor, key_mask: Optional[torch.Tensor] = None, stage=None) -> torch.Tensor:
        """The full-sequence stack; with `stage` ((start, stop), dropout
        seeds), those layers alone under autograd (a pipeline stage's
        recompute, `stage_runner`)."""
        if stage is not None:
            (start, stop), seeds = stage
            return _run_layers(self, x, "full", seeds=seeds, remat=self.cfg.execution == "remat",
                               layers=range(start, stop))
        return apply_transformer(self, x, key_mask)


@torch.no_grad()
def init_transformer_(model: Transformer, generator: Optional[torch.Generator] = None) -> None:
    """Seeded in-place initialisation with the JAX package's distributions
    (norms and LayerScale keep their constructor values); a shared module
    is drawn once, at its first layer."""
    seen = set()
    for layer in model.layers:
        for lin in (layer.attn.qkv, layer.attn.out, layer.ff.w1, layer.ff.w1g, layer.ff.w2):
            if id(lin) not in seen:
                seen.add(id(lin))
                fan_in_uniform_(lin, generator)


# ---------------------------------------------------------------------------
# branches
# ---------------------------------------------------------------------------


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, n, h * d)


def _qkv_heads(attn: Attention, cfg: TransformerConfig, x: torch.Tensor, ang):
    """Project to qkv and split into (q, k, v), each (b, h, n_x, dh); the
    rotary rotation (`ang`: (n_x, rot) or None) runs on all three.  The
    projection is kept as "attn_qkv" (before the reshape and the rotary).
    h is the heads the projection holds: all of them, or under tensor
    parallelism this rank's (its qkv rows are head-major, so a contiguous
    part of them is whole heads)."""
    b, n_x, _ = x.shape
    qkv = _linear(attn.qkv, x, "attn_qkv").reshape(b, n_x, -1, 3, cfg.dim_head).permute(0, 2, 3, 1, 4)
    if ang is not None:
        qkv = apply_rotary(ang, qkv)
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


def _use_ring(cfg, pattern, key_mask) -> bool:
    """The JAX package's rule: the ring when asked for, on a sharded
    sequence, for a layer with no pattern or a 2-D one and no key mask."""
    return cfg.attn_kernel == "ring" and (pattern is None or pattern.ndim == 2) and key_mask is None


def _attention_seq(cfg, q, k, v, key_mask, causal, pattern):
    """Attention of this rank's queries on a sequence sharded over sp:
    `pattern` is the layer's global pattern (`Transformer.sp_pattern`).
    The ring, or K and V gathered over sp and the plain attention under
    the global masks (the JAX package's dense attention, which GSPMD
    partitions the same way)."""
    shard = shard_mod.current()
    n = q.shape[2]
    if _use_ring(cfg, pattern, key_mask):
        from dalle_pytorch_tpu_torch.parallel.ring import ring_attention

        return ring_attention(q, k, v, shard.sp_ranks, shard.sp_rank, causal=causal, scale=cfg.dim_head ** -0.5,
                              mask=pattern)
    k, v = tp.gather_seq(k, 2), tp.gather_seq(v, 2)
    total = k.shape[2]
    rows = shard.seq_start + torch.arange(n, device=q.device)
    mask = None
    if causal:
        mask = torch.arange(total, device=q.device)[None, :] <= rows[:, None]
    if pattern is not None:
        pm = pattern[..., rows, :total]  # (n, total) or per head (h, n, total)
        mask = pm if mask is None else mask & pm
    if mask is not None:
        mask = mask[None] if mask.ndim == 3 else mask[None, None]
    if key_mask is not None:
        km = key_mask[:, None, None, :total]
        mask = km if mask is None else mask & km
    return attend(q * (cfg.dim_head ** -0.5), k, v, mask=mask, stable=cfg.stable)


def _attention_full(attn, cfg, x, rotary, key_mask, causal, layer_cache=None, pattern=(None, None)):
    """Full-sequence attention through flash attention; `pattern` is the
    layer's (mask, tables) at this length.  With a `layer_cache` (prefill)
    the keys and values also fill the cache from position 0.  On a sequence
    sharded over sp, `pattern` is the layer's global pattern and the
    attention is `_attention_seq`'s."""
    n = x.shape[1]
    shard = shard_mod.current()
    start = shard.seq_start  # 0 unless the sequence is sharded
    q, k, v = _qkv_heads(attn, cfg, x, None if rotary is None else rotary[start:start + n])
    if shard.sp:
        out = _attention_seq(cfg, q, k, v, key_mask, causal, pattern)
        return tp.tp_linear_out(_merge_heads(out), attn.out)
    if layer_cache is not None:
        layer_cache["k"][:, :, :n] = k
        layer_cache["v"][:, :, :n] = v
    mask, tables = pattern
    out = flash_attention(
        q, k, v, mask=mask, causal=causal, scale=cfg.dim_head ** -0.5,
        key_mask=None if key_mask is None else key_mask[:, :n],
        grid=cfg.attn_grid, tables=tables, vfa=cfg.attn_vfa, keep=_keeper("flash_out"),
    )
    return tp.tp_linear_out(_merge_heads(out), attn.out)


def _feed_forward(ff: FeedForward, x: torch.Tensor, rate: float = 0.0,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """GEGLU; under tensor parallelism on this rank's hidden columns, the
    dropout mask drawn for them with the values a one-process run draws
    there, and w2 row-parallel."""
    a, gates = _linear(ff.w1, x, "ff_pre"), _linear(ff.w1g, x, "ff_pre")
    h = a * F.gelu(gates)  # exact-erf gelu
    shard = shard_mod.current()
    if shard.tp:
        hidden = h.shape[-1] * shard.tp_size
        h = dropout(h, rate, generator, tp.local_slice(hidden, shard.tp_rank, shard.tp_size), hidden)
    else:
        h = dropout(h, rate, generator)
    return tp.tp_linear_out(h, ff.w2)


def _at(table: torch.Tensor, offset: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """table's entry at the device scalar `offset` along `dim`, the dim
    kept (length 1)."""
    return table.index_select(dim, offset.view(1))


def _attend_view(attn, cfg, q: torch.Tensor, view: dict, mask: torch.Tensor,
                 sel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q's attention over a cache view (`view["k"]`, `view["v"]`: (b, h,
    seq, dh)) under `mask`: over the whole view, or over the keys that
    `sel` gathers ((b or 1, Kmax), per head (b or 1, h, Kmax)), `mask`
    then covering the gathered keys.  A quantized view (int8 with
    per-token `k_scale` / `v_scale`, (b, h, seq)) is dequantized on use,
    in a gathering layer only the gathered keys.  The dense cached step
    and the paged step (`models/paged.py`) both attend through it."""
    k, v = view["k"], view["v"]
    scales = (view["k_scale"], view["v_scale"]) if "k_scale" in view else None
    if sel is not None:
        b, h, _, d = k.shape
        idx = (sel if sel.ndim == 3 else sel[:, None]).expand(b, h, sel.shape[-1])
        gather = idx[..., None].expand(b, h, sel.shape[-1], d)
        k, v = torch.gather(k, 2, gather), torch.gather(v, 2, gather)
        if scales is not None:
            scales = torch.gather(scales[0], 2, idx), torch.gather(scales[1], 2, idx)
    if scales is not None:
        k, v = dequantize_kv(k, scales[0], q.dtype), dequantize_kv(v, scales[1], q.dtype)
    out = attend(q, k, v, mask=mask, stable=cfg.stable)
    return attn.out(_merge_heads(out))


def _attention_cached(attn, cfg, layer_cache, x, rotary, offset: torch.Tensor,
                      pattern: Optional[DecodePattern] = None):
    """One cached token x: (b, 1, dim) at position `offset` (a device
    scalar); writes its key and value into the cache and attends over the
    whole cache under j <= offset, or, in a pattern layer, over what its
    pattern row permits: the gathered Kmax keys (padded slots masked off)
    or the whole cache masked with the row.  A quantized cache (int8 k/v
    with per-token `k_scale` / `v_scale`, `quantization.quantize_cache_layers`)
    takes the new column quantized once and attends over dequantized
    values (`_attend_view`)."""
    ang = None if rotary is None else _at(rotary, offset)
    q, k, v = _qkv_heads(attn, cfg, x, ang)
    q = q * (cfg.dim_head ** -0.5)
    at = offset.view(1)
    cols = {"k": k, "v": v}
    if "k_scale" in layer_cache:
        (cols["k"], cols["k_scale"]), (cols["v"], cols["v_scale"]) = quantize_kv(k), quantize_kv(v)
    for name, col in cols.items():
        layer_cache[name].index_copy_(2, at, col.to(layer_cache[name].dtype))
    view = {name: layer_cache[name] for name in cols}
    if pattern is not None and pattern.idx is not None:
        sel = _at(pattern.idx, offset, -2)  # (1, Kmax) or per head (h, 1, Kmax)
        valid = _at(pattern.valid, offset, -2)
        per_head = sel.ndim == 3
        decode_step.gathers += 1
        return _attend_view(attn, cfg, q, view, valid[None] if per_head else valid[None, None],
                            sel[:, 0][None] if per_head else sel)
    mask = torch.arange(cfg.seq_len, device=offset.device) <= offset  # (seq,)
    if pattern is not None:
        mask = mask & _at(pattern.rows, offset, -2)  # (1, seq) or per head (h, 1, seq)
    return _attend_view(attn, cfg, q, view, mask[None] if mask.ndim == 3 else mask.view(1, 1, 1, -1))


def _shift_cached_step(cfg, rb: torch.Tensor, x: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
    """One-token token shift against the ring buffer rb (b, fmap, 2, dim//4),
    which holds each past image token's first and second channel quarters
    in its raster-column slot.  Returns the shifted x; rb is updated in
    place at the slot of `offset` (a device scalar)."""
    fmap = cfg.image_fmap_size
    q = cfg.dim // 4
    slot = (offset - cfg.text_len) % fmap
    cur = x[:, 0]
    top = _at(rb, slot, 1)[:, 0, 0]  # the token one row above lives in this slot
    left = _at(rb, (slot - 1) % fmap, 1)[:, 0, 1]
    left = torch.where(slot == 0, torch.zeros_like(left), left)
    shifted = torch.cat([top, left, cur[:, 2 * q:]], dim=-1)[:, None]
    rb.index_copy_(1, slot.view(1), torch.stack([cur[:, :q], cur[:, q:2 * q]], dim=1)[:, None].to(rb.dtype))
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
                     key_mask=None, layer_cache=None, offset: Optional[torch.Tensor] = None,
                     text_mode: bool = False, dropout_seed: Optional[int] = None,
                     pattern=None):
    """PreShiftToken? -> PreNorm -> attention or feed-forward (-> dropout)
    -> sandwich norm? -> LayerScale, in mode 'full', 'prefill' or 'decode';
    `pattern` is the layer's `Transformer.attention_inputs` (or, decoding,
    `decode_inputs`).  The dropout generator is built here from
    `dropout_seed`, so a rematerialised or reversible layer draws the same
    masks again when it is recomputed."""
    gen = None if dropout_seed is None else torch.Generator(device=x.device).manual_seed(dropout_seed)
    h = (layer.attn_norm if kind == "attn" else layer.ff_norm)(x)
    if cfg.shift_tokens:
        if mode == "decode":
            if not text_mode:  # the shift is the identity in the text region
                h = _shift_cached_step(cfg, layer_cache[f"shift_{kind}"], h, offset)
        else:
            if mode == "prefill":  # the ring takes the normed, pre-shift values
                _fill_ring(cfg, layer_cache[f"shift_{kind}"], h)
            shard = shard_mod.current()  # under sp: this rank's positions, a halo from the previous rank
            h = token_shift(h, cfg.seq_len, cfg.image_fmap_size, shard.seq_start,
                            h.shape[1] * shard.sp_size if shard.sp else None)
    if mode != "decode":
        h = tp.copy_to_tp(h)  # Megatron's f: the column-parallel projections' input
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
    if cfg.sandwich_norm:
        h = (layer.attn_norm_out if kind == "attn" else layer.ff_norm_out)(h)
    scale = layer.attn_scale if kind == "attn" else layer.ff_scale
    return h * scale.to(h.dtype)


def _run_layers(model: Transformer, x, mode, cache=None, key_mask=None, text_mode=False,
                seeds=None, remat=False, rebuild=False, layers: Optional[range] = None):
    """seeds: per layer, the (attention, feed-forward) dropout seeds, or
    None.  remat: wrap each layer in a non-reentrant checkpoint under the
    config's `remat_policy` (`remat_run`): under "full" the backward
    recomputes the layer, its forward kernels (the VFA pair with
    `attn_vfa`) included; the selective policies keep the flash forward's
    outputs, so it runs once.  Under execution="reversible" the layers run
    as the twin stream, over the same caches in the cached modes; rebuild:
    through `Reversible`, which rebuilds each layer's input in its
    backward, else as plain tensor ops.  layers: the layer range a decode
    step runs (`resolve_layer_range`), all of them when None."""
    cfg = model.cfg
    names = remat_names(cfg.remat_policy) if remat else ()
    rotary = model.rotary(x.device)
    offset = None if cache is None else cache["offset"]
    causal = cfg.causal or mode == "prefill"

    sp = shard_mod.current().sp and mode == "full"

    def args(i: int, h: torch.Tensor) -> tuple:
        key = _pattern_key(model.specs[i])
        if mode == "decode":
            pattern = model.decode_inputs(key, x.device)
        elif sp:  # the global pattern: the layer slices its rows and columns
            pattern = model.sp_pattern(key, h.shape[1] * shard_mod.current().sp_size, x.device)
        else:
            pattern = model.attention_inputs(key, h.shape[1], causal, x.device)
        return (cfg, h, mode, rotary, key_mask, None if cache is None else cache["layers"][i], offset, text_mode,
                (None, None) if seeds is None else seeds[i], pattern)

    if cfg.execution == "reversible":
        def branch(i, kind, h, params):
            layer = model.layers[i]
            if params is None:
                return layer(*args(i, h), kind=kind)
            return functional_call(layer, params, args(i, h), {"kind": kind})

        if rebuild:  # the parameters this forward runs on (a caller's functional_call's)
            return reversible(branch, [dict(layer.named_parameters()) for layer in model.layers], x)
        x1, x2 = twin_stream(branch, cfg.depth, x)
        return (x1 + x2) / 2
    for i in range(cfg.depth) if layers is None else layers:
        layer = model.layers[i]
        if remat:
            x = checkpoint(remat_run(layer, names), *args(i, x), use_reentrant=False)
        else:
            x = layer(*args(i, x))
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
                      generator: Optional[torch.Generator] = None,
                      rebuild: bool = True) -> torch.Tensor:
    """x: (batch, n, dim), n <= seq_len.  Full-sequence (training) mode,
    differentiable.  `generator` draws the dropout masks (none when it is
    None); a CPU generator draws the per-layer seeds without a device sync.
    execution="remat" recomputes each layer in the backward under
    `remat_policy` (an unknown policy raises ValueError); execution=
    "reversible" runs the twin stream, through `Reversible` (each layer's
    input rebuilt in the backward) unless `rebuild` is False, which takes
    plain autograd through the same loop.  Both only matter while a
    gradient is taken."""
    cfg = model.cfg
    check_pipeline(cfg)
    grad = torch.is_grad_enabled()
    return _run_layers(model, x, "full", key_mask=key_mask, seeds=_dropout_seeds(cfg, generator),
                       remat=cfg.execution == "remat" and grad, rebuild=rebuild and grad)


def check_pipeline(cfg: TransformerConfig) -> None:
    """The JAX package's refusal: a pipeline of reversible layers."""
    if cfg.pipeline_axis is not None and cfg.execution == "reversible":
        raise ValueError("pipeline_axis is not supported with execution='reversible'; use execution='remat' (or "
                         "'sequential')")


def stage_runner(model: Transformer, generator: Optional[torch.Generator] = None) -> Tuple[list, object]:
    """(the stage's parameters, the `parallel/pipeline.Run` of its chunks)
    on the step's pipeline (`core/shard.ShardContext.pp_chunks`): each chunk
    runs its layers on micro-batch `micro`, the dropout masks (seeds drawn
    from `generator` here, as `apply_transformer` draws them) at the
    micro-batch's rows of the global batch; on the module's own parameters
    in the forward, and on the given leaves (through `functional_call`) in
    the backward's recompute, under remat as the config says."""
    shard = shard_mod.current()
    seeds = _dropout_seeds(model.cfg, generator)
    canon = {id(p): name for name, p in model.named_parameters()}
    held = {canon[id(p)]: p for start, stop in shard.pp_chunks for i in range(start, stop)
            for p in model.layers[i].parameters()}
    names, params = list(held), list(held.values())

    def run(chunk: int, h: torch.Tensor, micro: int, leaves=None) -> torch.Tensor:
        outer = shard_mod.current()
        ctx = dataclasses.replace(outer, row_start=outer.row_start + micro * h.shape[0])
        with shard_mod.shard_context(ctx):
            span = ctx.pp_chunks[chunk]
            if leaves is None:
                return _run_layers(model, h, "full", seeds=seeds, layers=range(*span))
            return functional_call(model, dict(zip(names, leaves)), (h,), {"stage": (span, seeds)})

    return params, run


def init_cache(cfg: TransformerConfig, batch: int, dtype=torch.float32, device=None) -> dict:
    """Zeroed KV cache and token-shift rings; `offset`, an int64 device
    scalar, counts the positions already consumed."""

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

    return {"offset": torch.zeros((), dtype=torch.long, device=device),
            "layers": [entry() for _ in range(cfg.depth)]}


@torch.no_grad()
def prefill(model: Transformer, x: torch.Tensor, cache: dict,
            key_mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, dict]:
    """Consume a length-n prefix from offset 0, filling the cache, and return
    the transformer output for the prefix."""
    out = _run_layers(model, x, "prefill", cache=cache, key_mask=key_mask)
    cache["offset"].fill_(x.shape[1])
    return out, cache


def resolve_layer_range(cfg: TransformerConfig, layer_start: int = 0, layer_stop: Optional[int] = None) -> range:
    """The layers [layer_start, layer_stop) of a decode step: the speculative
    drafter runs [0, d), the verifier continues [d, depth) from the stored
    layer-d hidden.  An empty or out-of-range slice raises, and so does a
    partial one under reversible execution, whose twin streams have no
    single hidden to hand over."""
    stop = cfg.depth if layer_stop is None else layer_stop
    if not 0 <= layer_start < stop <= cfg.depth:
        raise ValueError(f"layer range [{layer_start}, {stop}) invalid for depth {cfg.depth}")
    if (layer_start != 0 or stop != cfg.depth) and cfg.execution == "reversible":
        raise ValueError("partial layer ranges (speculative drafting) require sequential execution; reversible "
                         "twin-stream layers cannot be split")
    return range(layer_start, stop)


@torch.no_grad()
def decode_step(model: Transformer, x: torch.Tensor, cache: dict, text_only: bool = False,
                layer_start: int = 0, layer_stop: Optional[int] = None) -> Tuple[torch.Tensor, dict]:
    """Process one token x: (b, 1, dim) at position cache['offset'] and
    advance the offset, all on the device: the same ops at every position,
    so a CUDA graph may capture the step.  text_only: the position is in the
    text region, where the token shift is the identity.  layer_start /
    layer_stop run only those layers (`resolve_layer_range`); the other
    layers' cache entries stay as they are."""
    layers = resolve_layer_range(model.cfg, layer_start, layer_stop)
    full = len(layers) == model.cfg.depth
    out = _run_layers(model, x, "decode", cache=cache, text_mode=text_only, layers=None if full else layers)
    cache["offset"].add_(1)
    return out, cache


# pattern-layer decode steps that took the gather branch (a captured step
# adds its count once per replay: `models/sampling.DecodeGraphs`)
decode_step.gathers = 0
