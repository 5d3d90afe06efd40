"""Post-training quantization for serving (counterpart of
`dalle_pytorch_tpu/quantization.py`): int8 / fp8 weights and the int8 paged
KV pool, both dequantized on use.  The products and the attention run in the
compute dtype; only storage shrinks.

* **Weights.**  `quantize_tree(model, "int8" | "fp8")` swaps, in place, every
  matmul `nn.Linear` of a `DALLE` (qkv, out, w1, w1g, w2, logits_linear) for
  a `QuantLinear` and the text and image embedding tables for a
  `QuantEmbedding`.  A linear is quantized per output channel: its (out, in)
  weight, PyTorch's layout (the JAX package's (in, out) block transposed),
  gets a scale (out,) = amax / 127 over the input axis (amax / 448 for fp8
  e4m3).  A table is quantized per row, its scale (N, 1).  The scale keeps
  the original float dtype, so it records the compute dtype
  (`weight_dtype`).  Position tables, norms and biases stay float.  An fp8
  block is held as the uint8 bits of `torch.float8_e4m3fn` (so that
  `module.to(dtype)` casts the scale and leaves the block alone); the v3
  bridge (`weights.py`) reads and writes it as the JAX package's fp8 leaf.
  Under the tied embeddings the text and image tables are rows of the
  quantized `logits_linear`: a lookup dequantizes only the gathered rows,
  the same elementwise product as the whole table's.

* **Paged KV.**  `init_paged_pool(..., quantize="int8")` stores int8 k/v
  blocks with per-token bf16 scales beside them (`quantize_kv`): writing one
  new column never rescales a block's other tokens.  bf16 scales cost
  2 / dim_head bytes an element (`kv_bytes_per_elem`).

The int8 value is computed with the f32 scale (zero channels get scale 0
and value 0) before the scale is cast (to bf16 for the KV, to the weight's
dtype for weights), and rounding is half to even, as `jnp.round` rounds.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

KV_SCALE_DTYPE = torch.bfloat16
KV_SCALE_ITEMSIZE = 2

# numerics budgets of the greedy parity harness (`greedy_parity_metrics`):
# the largest logit drift over the baseline logits' spread
KV_PARITY_REL_BUDGET = 0.05  # int8 KV only, weights untouched
FULL_PARITY_REL_BUDGET = 0.20  # int8 weights and int8 KV together

WEIGHT_DTYPES = ("int8", "fp8")
KV_DTYPES = ("int8",)
FP8 = torch.float8_e4m3fn
_QMAX = {"int8": 127.0, "fp8": 448.0}  # e4m3's largest finite value

# embedding tables that quantize_tree converts (per row); the position tables
# are summed, never multiplied, and stay float
QUANTIZED_TABLES = ("text_emb", "image_emb")


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------


def _quantize_rows(w: torch.Tensor, dtype: str, keepdim: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric quantization of each row of a 2-D `w` (its last axis
    reduced): (int8 values or fp8 bits as uint8, scale in w's dtype, (N,)
    or with `keepdim` (N, 1))."""
    if dtype not in _QMAX:
        raise ValueError(f"unknown weight quant dtype {dtype!r}")
    if w.ndim != 2:
        raise ValueError(f"quantizing wants a 2-D weight, got {tuple(w.shape)}")
    w32 = w.float()
    amax = w32.abs().amax(dim=1, keepdim=True)
    scale = amax / _QMAX[dtype]
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    if dtype == "int8":
        q = torch.clamp(torch.round(w32 / safe), -127, 127).to(torch.int8)
    else:
        q = (w32 / safe).to(FP8).view(torch.uint8)
    scale = scale.to(w.dtype)
    return q, scale if keepdim else scale[:, 0]


def quantize_weight(w: torch.Tensor, dtype: str = "int8") -> Dict[str, torch.Tensor]:
    """Per-output-channel quantization of one (out, in) linear weight:
    {"qvalue": (out, in), "scale": (out,)}."""
    q, scale = _quantize_rows(w, dtype, keepdim=False)
    return {"qvalue": q, "scale": scale}


def quantize_table(t: torch.Tensor, dtype: str = "int8") -> Dict[str, torch.Tensor]:
    """Per-row quantization of an (N, dim) embedding table: {"qvalue": (N,
    dim), "scale": (N, 1)}."""
    q, scale = _quantize_rows(t, dtype, keepdim=True)
    return {"qvalue": q, "scale": scale}


def _values(qvalue: torch.Tensor) -> torch.Tensor:
    """A block's values in their own dtype: int8, or fp8 from its bits."""
    return qvalue.view(FP8) if qvalue.dtype == torch.uint8 else qvalue


def maybe_dequant_weight(qvalue: torch.Tensor, scale: torch.Tensor, dtype=None) -> torch.Tensor:
    """qvalue * scale in the scale's dtype (a (N,) scale broadcast over the
    rows), optionally cast to `dtype`: the dequant-on-use hook."""
    if scale.ndim == 1:
        scale = scale[:, None]
    out = _values(qvalue).to(scale.dtype) * scale
    return out if dtype is None else out.to(dtype)


class _Quantized(nn.Module):
    """A quantized block (`qvalue`, `scale` buffers) and the lookup of its
    rows."""

    def _init_block(self, q: Dict[str, torch.Tensor]) -> None:
        self.register_buffer("qvalue", q["qvalue"])
        self.register_buffer("scale", q["scale"])

    @property
    def kind(self) -> str:
        return "fp8" if self.qvalue.dtype == torch.uint8 else "int8"

    @property
    def weight(self) -> torch.Tensor:
        """The whole block dequantized (a new tensor at every read)."""
        return maybe_dequant_weight(self.qvalue, self.scale)

    def rows(self, ids: torch.Tensor, start: int = 0) -> torch.Tensor:
        """Rows start + ids, dequantized: only the gathered rows, the same
        elementwise products as the whole block's."""
        ids = ids + start if start else ids
        scale = self.scale[ids]
        if scale.ndim == ids.ndim:
            scale = scale[..., None]
        return _values(self.qvalue[ids]).to(scale.dtype) * scale


class QuantLinear(_Quantized):
    """A linear layer whose (out, in) weight is held quantized per output
    channel and dequantized on use, in the input's dtype."""

    def __init__(self, q: Dict[str, torch.Tensor], bias: Optional[torch.Tensor]):
        super().__init__()
        self._init_block(q)
        self.bias = None if bias is None else nn.Parameter(bias.detach().clone(), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = maybe_dequant_weight(self.qvalue, self.scale, x.dtype)
        return F.linear(x, w, None if self.bias is None else self.bias.to(x.dtype))


class QuantEmbedding(_Quantized):
    """An embedding table held quantized per row."""

    def __init__(self, q: Dict[str, torch.Tensor]):
        super().__init__()
        self._init_block(q)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.rows(ids)


def _matmul_linears(model: nn.Module):
    """(parent, attribute) of every matmul linear of a `DALLE`: the
    transformer's qkv, out, w1, w1g, w2 (a shared module once) and
    logits_linear."""
    seen, out = set(), []
    for layer in model.transformer.layers:
        for parent, names in ((layer.attn, ("qkv", "out")), (layer.ff, ("w1", "w1g", "w2"))):
            for name in names:
                if (id(parent), name) not in seen:
                    seen.add((id(parent), name))
                    out.append((parent, name))
    out.append((model, "logits_linear"))
    return out


@torch.no_grad()
def quantize_tree(model: nn.Module, dtype: str = "int8") -> nn.Module:
    """Quantize a `DALLE` in place (see the module docstring) and return it.
    Idempotent: a quantized layer stays as it is."""
    if dtype not in WEIGHT_DTYPES:
        raise ValueError(f"dtype must be one of {WEIGHT_DTYPES}, got {dtype!r}")
    for parent, name in _matmul_linears(model):
        lin = getattr(parent, name)
        if isinstance(lin, nn.Linear):
            setattr(parent, name, QuantLinear(quantize_weight(lin.weight, dtype), lin.bias))
    for name in QUANTIZED_TABLES:
        emb = getattr(model, name, None)
        if isinstance(emb, nn.Embedding):
            setattr(model, name, QuantEmbedding(quantize_table(emb.weight, dtype)))
    return model


@torch.no_grad()
def dequantize_tree(model: nn.Module) -> nn.Module:
    """The inverse pass, up to rounding: every quantized layer back to a
    float `nn.Linear` / `nn.Embedding` holding its dequantized weight."""
    for parent, name in _matmul_linears(model):
        lin = getattr(parent, name)
        if isinstance(lin, QuantLinear):
            w = lin.weight
            plain = nn.Linear(w.shape[1], w.shape[0], bias=lin.bias is not None, device=w.device, dtype=w.dtype)
            plain.weight.copy_(w)
            if lin.bias is not None:
                plain.bias.copy_(lin.bias)
            setattr(parent, name, plain.requires_grad_(False))
    for name in QUANTIZED_TABLES:
        emb = getattr(model, name, None)
        if isinstance(emb, QuantEmbedding):
            w = emb.weight
            plain = nn.Embedding(*w.shape, device=w.device, dtype=w.dtype)
            plain.weight.copy_(w)
            setattr(model, name, plain.requires_grad_(False))
    return model


def tree_is_quantized(model: nn.Module) -> bool:
    return any(isinstance(m, _Quantized) for m in model.modules())


def weight_dtype(model: nn.Module) -> torch.dtype:
    """The model's float compute dtype: `logits_linear`'s weight dtype, or
    its scale's when quantized."""
    lin = model.logits_linear
    return lin.scale.dtype if isinstance(lin, QuantLinear) else lin.weight.dtype


def weight_quant_kind(model: nn.Module) -> Optional[str]:
    """"int8" or "fp8" when the matmul weights are quantized, else None."""
    lin = model.logits_linear
    return lin.kind if isinstance(lin, QuantLinear) else None


# ---------------------------------------------------------------------------
# paged KV
# ---------------------------------------------------------------------------


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token int8: x (..., dim_head) -> (int8 (..., dim_head), bf16
    scale (...,))."""
    x32 = x.float()
    scale = x32.abs().amax(dim=-1) / 127.0
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))[..., None]
    q = torch.clamp(torch.round(x32 / safe), -127, 127).to(torch.int8)
    return q, scale.to(KV_SCALE_DTYPE)


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """int8 (..., dim_head) and its scale (...,) -> (..., dim_head) in
    `dtype`."""
    return q.to(dtype) * scale.to(dtype)[..., None]


def quantize_cache_layers(layers):
    """A dense cache's k/v quantized per token (`k_scale`, `v_scale` beside
    them); the shift rings stay float.  The dense cached step
    (`models/transformer._attention_cached`) runs on such a cache."""

    def entry(e):
        kq, ks = quantize_kv(e["k"])
        vq, vs = quantize_kv(e["v"])
        return dict(e, k=kq, v=vq, k_scale=ks, v_scale=vs)

    return entry(layers) if isinstance(layers, dict) else [entry(e) for e in layers]


# ---------------------------------------------------------------------------
# pricing
# ---------------------------------------------------------------------------


def kv_bytes_per_elem(kv_quant: Optional[str], itemsize: float, dim_head: int) -> float:
    """Bytes a stored KV element costs: the dtype's itemsize, or for int8
    the byte plus the per-token scale spread over dim_head."""
    if not kv_quant or kv_quant == "none":
        return float(itemsize)
    if kv_quant not in KV_DTYPES:
        raise ValueError(f"kv quant must be one of {KV_DTYPES}, got {kv_quant!r}")
    return 1.0 + KV_SCALE_ITEMSIZE / float(dim_head)


def kv_pool_reduction(dim_head: int, itemsize: float = 2.0) -> float:
    """At-rest reduction of an int8 pool against an `itemsize`-byte one."""
    return float(itemsize) / kv_bytes_per_elem("int8", itemsize, dim_head)


def tree_weight_bytes(model: nn.Module, itemsize: Optional[int] = None) -> float:
    """Storage bytes of a model's weights, a shared tensor once: float
    tensors at their itemsize (or at `itemsize`), int8 blocks at one byte.
    An fp8 block is a float, as the JAX package prices it: one byte, or
    `itemsize` when repriced."""
    total = 0.0
    tensors = dict(model.named_parameters())
    tensors.update(dict(model.named_buffers()))
    for t in {id(t): t for t in tensors.values()}.values():
        if t.is_floating_point() or t.dtype == torch.uint8:  # uint8: fp8 bits
            total += t.numel() * (itemsize if itemsize is not None else t.element_size())
        elif t.dtype == torch.int8:
            total += t.numel()
    return total


def weight_reduction(plain: nn.Module, quant: nn.Module, baseline_itemsize: int = 2) -> float:
    """At-rest weight reduction of `quant` against `plain`, both priced at
    `baseline_itemsize` for their float tensors (bf16 storage, the JAX
    package's serving baseline)."""
    base = tree_weight_bytes(plain, itemsize=baseline_itemsize)
    q = tree_weight_bytes(quant, itemsize=baseline_itemsize)
    return base / q if q else float("inf")


def assert_quantized_reduction(name: str, reduction: float, floor: float = 1.9) -> float:
    """The at-rest reduction bar, for realistic geometry (a dim_head of 8
    misses it honestly)."""
    assert reduction >= floor, (f"{name}: quantized at-rest reduction {reduction:.3f}x is under the {floor}x bar "
                                "— scale overhead is eating the byte savings")
    return reduction


def dequant_overhead_flops(tcfg, kv_quant: Optional[str], weights: Optional[str], slots: int,
                           emb_rows: int = 0) -> Dict[str, float]:
    """The extra work one decode step pays for dequant-on-use, one multiply a
    dequantized element: each layer's (slots, heads, seq, dim_head) k and v,
    and ~12 dim² a layer plus `emb_rows` vocabulary rows of weights; beside
    the step's matmul work, 2 · 12 dim² · depth · slots."""
    kv = 0.0
    if kv_quant and kv_quant != "none":
        kv = 2.0 * tcfg.depth * slots * tcfg.heads * tcfg.seq_len * tcfg.dim_head
    w = 0.0
    if weights and weights != "none":
        w = 12.0 * tcfg.depth * tcfg.dim * tcfg.dim + float(emb_rows) * tcfg.dim
    step = 2.0 * (12.0 * tcfg.depth * tcfg.dim * tcfg.dim) * max(slots, 1)
    total = kv + w
    return {"kv_dequant_flops": kv, "weight_dequant_flops": w, "dequant_flops_per_step": total,
            "dequant_frac_of_step": total / step if step else 0.0}


# ---------------------------------------------------------------------------
# numerics parity harness
# ---------------------------------------------------------------------------


@torch.no_grad()
def paged_greedy_logits(model: nn.Module, text, quantize_kv_mode: Optional[str] = None,
                        steps: Optional[int] = None, block_size: int = 8) -> Dict[str, torch.Tensor]:
    """Greedy decode of one prompt through the serving path (dense prefill,
    `write_prefill_to_pool`, `paged_decode_step`), argmax feeding, with the
    KV pool quantized as `quantize_kv_mode` says.  Returns {"logits":
    (steps, V) masked, "codes": (steps,)}; compare a quantized run with a
    plain one of the same prompt (`greedy_parity_metrics`)."""
    from dalle_pytorch_tpu_torch.models import dalle as dalle_mod
    from dalle_pytorch_tpu_torch.models import sampling as sampling_mod
    from dalle_pytorch_tpu_torch.models.paged import (init_paged_pool, init_slot_rings, paged_blocks_per_seq,
                                                      paged_decode_step, write_prefill_to_pool)
    from dalle_pytorch_tpu_torch.models.transformer import init_cache

    cfg, dev, dt = model.cfg, model.device, model.dtype
    tcfg = cfg.transformer_config()
    n_pre = cfg.text_seq_len + 1
    n_steps = cfg.image_seq_len if steps is None else min(steps, cfg.image_seq_len)
    text = torch.as_tensor(text, device=dev).long().reshape(1, cfg.text_seq_len)
    cache = init_cache(tcfg, 1, dtype=dt, device=dev)
    cache, lg = sampling_mod._prefill_phase(model, text, None, 0, 1.0, cache)

    def code_of(logits):
        return (logits.argmax(-1) - cfg.num_text_tokens_padded).clamp(0, cfg.num_image_tokens - 1)

    bps = paged_blocks_per_seq(tcfg, block_size)
    pool = init_paged_pool(tcfg, bps + 1, block_size, dt, dev, quantize=quantize_kv_mode)
    tables = torch.arange(1, bps + 1, device=dev)[None]
    write_prefill_to_pool(tcfg, pool, tables, cache["layers"], n_pre, block_size)
    rings = init_slot_rings(tcfg, 1, dt, dev)
    if rings is not None:
        for ring, layer in zip(rings["layers"], cache["layers"]):
            for name in ("shift_attn", "shift_ff"):
                ring[name].copy_(layer[name])
    logits, codes = [lg], [code_of(lg)]
    for t in range(n_steps - 1):
        x = dalle_mod.embed_image_codes(model, codes[-1][:, None], torch.tensor([t], device=dev))
        out = paged_decode_step(model.transformer, x, pool, tables, torch.tensor([n_pre + t], device=dev), rings,
                                block_size)
        lg = sampling_mod._logits_at(model, out, image=True)
        logits.append(lg)
        codes.append(code_of(lg))
    return {"logits": torch.cat(logits), "codes": torch.cat(codes)}


def greedy_parity_metrics(base: Dict[str, torch.Tensor], quant: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Drift between two `paged_greedy_logits` runs: the largest |logit
    difference| over the baseline logits' spread (finite, unmasked entries),
    and the greedy codes' match fraction (reported, not gated)."""
    lb = base["logits"].float().cpu().numpy()
    lq = quant["logits"].float().cpu().numpy()
    finite = np.isfinite(lb) & np.isfinite(lq) & (lb > np.finfo(np.float32).min / 2)
    drift = float(np.max(np.abs(np.where(finite, lb - lq, 0.0))))
    spread = float(max(np.std(lb[finite]), 1e-6))
    match = float(np.mean(base["codes"].cpu().numpy() == quant["codes"].cpu().numpy()))
    return {"greedy_logit_drift_abs": drift, "greedy_logit_drift_rel": drift / spread, "logit_spread": spread,
            "token_match_frac": match}
