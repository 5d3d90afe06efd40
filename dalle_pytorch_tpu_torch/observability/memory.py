"""The HBM ledger of a step, its check against the card's allocator, the
in-place audit, live headroom tracking and out-of-memory forensics
(counterpart of `dalle_pytorch_tpu/observability/memory.py`, repriced for
the card).

* **Analytic ledger** (`step_memory_ledger` / `dalle_step_memory`) — a
  rank's resident bytes priced from the mesh shape, the StepSettings and
  the model's geometry: parameter storage (bf16 storage keeps no f32
  master), optimizer state (Adam's two moments, or Adafactor's factored
  statistics, from the live state when there is one), gradient and f32
  accumulator buffers, and the activation working set per execution and
  remat policy, with a fits / doesn't-fit verdict against the card's
  memory (`torch.cuda.mem_get_info`; None on the CPU).  On a mesh the
  shard fractions are the step's own placement (`sharding.MeshPlan`): a
  pipeline stage holds its layers whole and the leaves outside the stack
  replicated, ZeRO-3 adds the one layer it gathers at a time.  The
  arithmetic of the rows is the JAX package's.
* **Measured check** (`step_memory_analysis` + `MemoryCrosscheck`) — one
  step's `torch.cuda.max_memory_allocated` after `reset_peak_memory_stats`
  beside the ledger, under the JAX package's drift-from-first-ratio alarm.
  PyTorch has no buffer donation and the port's optimizers update in
  place, so `audit_donation` checks that a step leaves no second copy of
  the state behind: the bytes allocated after a step exceed those before
  by at most a stated slack (an alarm under the JAX name,
  `donation_dropped`).
* **Live headroom** (`HbmMonitor`) — the allocator's peak per flush window
  and a usage-fraction alarm (once per episode, re-armed with hysteresis)
  that routes through the telemetry hub into the on-alarm capture.
* **OOM forensics** (`is_oom_error` / `write_oom_report`) — a CLI that
  catches the allocator's out-of-memory error writes `oom_report_*.txt`
  (the ledger, the measured step, the allocator's stats and
  `memory_summary`, and `oom_suggestions`' ranked changes in the port's own
  flags) and exits `resilience.EXIT_OOM`.

Everything but the measured check is host arithmetic on shapes.
"""
from __future__ import annotations

import math
import re
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Mapping, Optional

import torch

from dalle_pytorch_tpu_torch.observability import metrics as metrics_mod
from dalle_pytorch_tpu_torch.observability.comms import tree_float_bytes
from dalle_pytorch_tpu_torch.observability.cuda import FlopsCrosscheck


def device_hbm_capacity(device=None, default: Optional[float] = None) -> Optional[float]:
    """The card's memory in bytes (`torch.cuda.mem_get_info(device)[1]`);
    `default` (None) on the CPU, where there is no capacity to hold a
    ledger against."""
    if device is not None and torch.device(device).type != "cuda":
        return default
    if not torch.cuda.is_available():
        return default
    return float(torch.cuda.mem_get_info(device)[1])


# ---------------------------------------------------------------------------
# the analytic ledger
# ---------------------------------------------------------------------------

def rest_shard_fraction(axes: Mapping[str, int], zero_stage: int = 0,
                        moments: bool = False) -> float:
    """Fraction of a param-shaped tree each chip holds AT REST — the comms
    ledger's shard-pricing rules (params are tp/pp-sharded at rest;
    fsdp-sharded under ZeRO-3, moments already under ZeRO-1).

    This is the every-leaf-shards APPROXIMATION for pricing hypothetical
    meshes without a tree in hand.  When the live trees exist, the ledgers
    price the EXACT fraction from the partitioning registry instead
    (`dalle_step_memory` from the step's `sharding.MeshPlan` — the
    placement that holds the state), so ledger and reality cannot drift
    apart silently."""
    t = int(axes.get("tp", 1))
    p = int(axes.get("pp", 1))
    f = int(axes.get("fsdp", 1))
    stage_floor = 1 if moments else 3
    fsdp_div = f if (zero_stage >= stage_floor and f > 1) else 1
    return 1.0 / max(t * p * fsdp_div, 1)


def activation_bytes(
    axes: Mapping[str, int],
    *,
    batch: int,
    seq_len: int,
    dim: int,
    depth: int,
    heads: int,
    dim_head: int,
    compute_itemsize: int = 4,
    grad_accum: int = 1,
    execution: str = "sequential",
    remat_policy: str = "full",
    ff_mult: int = 4,
    flash_attention: bool = False,
    pp_num_micro: Optional[int] = None,
) -> Dict[str, float]:
    """Per-chip activation working set of one training step.

    The model: the peak is (saved-for-backward bytes) + (one layer's live
    recompute working set).  What is *saved* depends on the execution
    engine:

      sequential         every layer's boundary AND internals stay live
      remat 'full'       only the per-layer residual boundaries
      remat 'flash'      + flash_out and the f32 lse rows per layer
      remat 'flash_qkv'  + the qkv projections per layer
      remat 'flash_qkv_ff' + the (GEGLU a, gates) ff pre-activation per layer
      reversible         two residual streams, depth-independent

    Micro-batching (grad_accum) means only ONE micro-batch's saved set is
    live at a time; sp shards the sequence; tp shards the per-branch
    internals (qkv, ff hidden) but not the residual stream; pp divides depth
    across stages but keeps ~pp micro-batches' boundaries in flight (the
    GPipe stash).  The plain attention materializes the (s, s) score
    matrix; the flash kernels never do.  The JAX package's arithmetic."""
    d_ax = int(axes.get("dp", 1))
    f_ax = int(axes.get("fsdp", 1))
    t = int(axes.get("tp", 1))
    s_ax = int(axes.get("sp", 1))
    p = int(axes.get("pp", 1))

    batch_local = max(batch // max(d_ax * f_ax, 1), 1)
    micro = max(batch_local // max(grad_accum, 1), 1)
    s_loc = max(seq_len // s_ax, 1)
    depth_local = max(depth // p, 1)
    bsd = 1.0 * micro * s_loc * dim * compute_itemsize
    # attention internals live at the INNER width (heads x dim_head), which
    # is wider than the residual stream whenever heads*dim_head != dim
    bsi = 1.0 * micro * s_loc * heads * dim_head * compute_itemsize

    qkv = 3.0 * bsi / t
    attn_out = bsi  # pre-out-projection attention context
    ff_hidden = 2.0 * ff_mult * bsd / t  # GEGLU: a + gates, each b.s.(mult*d)/tp
    misc = 2.0 * bsd  # norms / token-shift copies
    scores = 0.0 if flash_attention else (
        1.0 * micro * (heads / t) * s_loc * s_loc * compute_itemsize
    )
    layer_ws = qkv + attn_out + ff_hidden + misc + scores

    lse = 1.0 * micro * (heads / t) * s_loc * 4  # f32, flash kernels only
    if execution == "reversible":
        saved_per_layer = 0.0
        boundaries = 2.0 * bsd
    elif execution == "remat":
        extras = {
            "full": 0.0,
            "flash": bsi + lse,  # flash_out is (b, h, s, dh)
            "flash_qkv": bsi + lse + qkv,
            "flash_qkv_ff": bsi + lse + qkv + ff_hidden,
        }.get(remat_policy, 0.0)
        saved_per_layer = extras
        boundaries = depth_local * bsd
    else:  # sequential: everything stays live for backward
        saved_per_layer = layer_ws
        boundaries = depth_local * bsd
    saved = boundaries + depth_local * saved_per_layer

    in_flight = 1
    if p > 1:
        from dalle_pytorch_tpu_torch.parallel.pipeline import default_num_micro

        num_micro = pp_num_micro or default_num_micro(batch_local, p)
        in_flight = max(min(num_micro, p), 1)

    total = saved * in_flight + layer_ws
    return {
        "bytes": total,
        "saved_bytes": saved,
        "layer_working_set_bytes": layer_ws,
        "microbatch": micro,
        "in_flight_microbatches": in_flight,
    }


def step_memory_ledger(
    axes: Mapping[str, int],
    *,
    param_bytes: float,
    grad_bytes: float,
    opt_bytes: float,
    batch: int,
    seq_len: int,
    dim: int,
    depth: int,
    heads: int,
    dim_head: int,
    compute_itemsize: int = 4,
    zero_stage: int = 0,
    grad_accum: int = 1,
    accum_bytes: Optional[float] = None,
    execution: str = "sequential",
    remat_policy: str = "full",
    ff_mult: int = 4,
    flash_attention: bool = False,
    pp_num_micro: Optional[int] = None,
    input_bytes: float = 0.0,
    capacity_bytes: Optional[float] = None,
    device: Any = None,
    param_shard_fraction: Optional[float] = None,
    moment_shard_fraction: Optional[float] = None,
    extra_rows: Optional[List[Dict[str, Any]]] = None,
) -> Dict[str, Any]:
    """Per-chip resident HBM of one optimizer step, row by row.

    `axes` is {axis: size} (a plain dict works — hypothetical meshes are
    priced without devices; {} is a single chip).  `param_bytes` /
    `grad_bytes` / `opt_bytes` are WHOLE-tree bytes in their storage dtypes;
    the rows apply the at-rest shard fractions — the scalar
    `rest_shard_fraction` model by default, or the EXACT registry-priced
    `param_shard_fraction` / `moment_shard_fraction` when the caller has
    the live trees (dalle_step_memory passes them).  `accum_bytes` is the
    f32 microbatch accumulator (defaults to grad_bytes repriced at 4 bytes
    is the caller's job — pass it explicitly); `input_bytes` is the
    on-device batch (text ids + pixels, including prefetch depth);
    `extra_rows` are rows the caller prices itself (ZeRO-3's gathered
    layer)."""
    # host-sync-ok: mesh-axis sizes are static python ints
    axes = {k: int(v) for k, v in dict(axes).items()}
    p_frac = (param_shard_fraction if param_shard_fraction is not None
              else rest_shard_fraction(axes, zero_stage, moments=False))
    m_frac = (moment_shard_fraction if moment_shard_fraction is not None
              else rest_shard_fraction(axes, zero_stage, moments=True))

    rows: List[Dict[str, Any]] = [
        {"name": "params", "bytes": param_bytes * p_frac,
         "detail": f"storage x {p_frac:.4g} at-rest shard"},
        {"name": "grads", "bytes": grad_bytes * p_frac,
         "detail": f"grad_dtype buffer x {p_frac:.4g}"},
    ]
    if grad_accum > 1 and accum_bytes:
        rows.append({"name": "grad_accum", "bytes": accum_bytes * p_frac,
                     "detail": "f32 microbatch accumulator"})
    rows.append({"name": "opt_state", "bytes": opt_bytes * m_frac,
                 "detail": f"zero_stage {zero_stage} x {m_frac:.4g}"})
    act = activation_bytes(
        axes, batch=batch, seq_len=seq_len, dim=dim, depth=depth,
        heads=heads, dim_head=dim_head, compute_itemsize=compute_itemsize,
        grad_accum=grad_accum, execution=execution, remat_policy=remat_policy,
        ff_mult=ff_mult, flash_attention=flash_attention,
        pp_num_micro=pp_num_micro,
    )
    rows.append({"name": "activations", "bytes": act["bytes"],
                 "detail": (f"{execution}/{remat_policy} micro={act['microbatch']}"
                            f" in_flight={act['in_flight_microbatches']}")})
    if input_bytes:
        rows.append({"name": "inputs", "bytes": input_bytes * 1.0,
                     "detail": "device batch (+prefetch)"})
    rows.extend(extra_rows or [])

    return _finish_ledger(rows, axes=axes, batch=batch,
                          capacity_bytes=capacity_bytes, device=device,
                          activations=act)


def _finish_ledger(rows, *, axes=None, batch=None, capacity_bytes=None, device=None,
                   **extra) -> Dict[str, Any]:
    total = sum(r["bytes"] for r in rows)
    dominant = max(rows, key=lambda r: r["bytes"])["name"] if rows else None
    if capacity_bytes is None:
        capacity_bytes = device_hbm_capacity(device)
    ledger: Dict[str, Any] = {
        "rows": rows,
        "total_bytes": total + 0.0,
        "dominant": dominant,
        "capacity_bytes": capacity_bytes,
        "fits": (total <= capacity_bytes) if capacity_bytes else None,
        "headroom_frac": (1.0 - total / capacity_bytes) if capacity_bytes else None,
    }
    if axes is not None:
        ledger["mesh"] = dict(axes)
    if batch is not None:
        ledger["batch"] = batch
    ledger.update(extra)
    return ledger


def _itemsize(dtype) -> int:
    """Bytes of a torch dtype (or of a numpy one)."""
    if isinstance(dtype, torch.dtype):
        return torch.tensor([], dtype=dtype).element_size()
    import numpy as np

    return np.dtype(dtype).itemsize


def _opt_tensors(opt_state: Any) -> List[torch.Tensor]:
    """The tensors an optimizer's state holds: a grouped optimizer's
    statistics (Adam's moments, Adafactor's factored rows and columns) or a
    `torch.optim.Optimizer`'s per-parameter state."""
    if opt_state is None:
        return []
    if hasattr(opt_state, "groups"):
        return [v for g in opt_state.groups for v in g.stats.values()]
    if isinstance(opt_state, torch.optim.Optimizer):
        return [v for st in opt_state.state.values() for v in st.values() if isinstance(v, torch.Tensor)]
    return [v for v in _flat(opt_state) if isinstance(v, torch.Tensor)]


def _flat(tree):
    if isinstance(tree, Mapping):
        for v in tree.values():
            yield from _flat(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _flat(v)
    else:
        yield tree


_LAYER = re.compile(r"(^|\.)layers\.(\d+)\.")


def zero3_gather_row(plan, params: Mapping[str, Any], itemsize: int) -> Optional[Dict[str, Any]]:
    """ZeRO-3's transient on a rank (`sharding.Zero3Units`): the one layer
    whose parameters it gathers at a time (the largest), plus the sharded
    leaves no layer holds (the embeddings, the logits, the final norm),
    gathered for the whole step; each at its full size less the shard the
    rank keeps.  None when nothing is sharded over fsdp at rest."""
    if plan is None or plan.F <= 1:
        return None
    layers: Dict[str, float] = {}
    rest = 0.0
    for name in params:
        lay = plan.layouts[name]
        if lay.rest_dim is None or name in plan.elsewhere:
            continue
        full = math.prod(lay.shape) * itemsize
        gathered = full - full * plan.held_fraction([name])
        m = _LAYER.search(name)
        if m is None:
            rest += gathered
        else:
            layers[m.group(2)] = layers.get(m.group(2), 0.0) + gathered
    if not layers and not rest:
        return None
    largest = max(layers.values(), default=0.0)
    return {"name": "zero3_gather", "bytes": largest + rest,
            "detail": f"one gathered layer ({largest / 1e9:.4g} GB) + leaves outside the stack (transient)"}


def dalle_step_memory(
    mesh: Any,
    params: Mapping[str, Any],
    opt_state: Any,
    cfg: Any,
    batch: int,
    settings: Any = None,
    input_bytes: float = 0.0,
    capacity_bytes: Optional[float] = None,
    plan: Any = None,
    device: Any = None,
) -> Dict[str, Any]:
    """The ledger of a DALL-E training step on one rank: payload bytes from
    the parameters ({name: tensor}: the one-process model's, or a rank's
    pieces when `plan` gives their full shapes) at the run's storage dtype
    (`settings.param_dtype`: bf16 storage keeps no master), gradients at
    `settings.grad_dtype`, the optimizer's state from `opt_state` when it
    holds tensors (a grouped optimizer's, a `torch.optim` one's; a rank's
    pieces are scaled back to the whole tree by the plan's fraction) and
    otherwise priced as Adam (two f32 moments), the geometry and execution
    from the DALLEConfig.  `mesh` is a DeviceMesh, {axis: size} or None
    (one process).  `plan` (`step_fn.plan()`, or this rank's
    `sharding.Placement` before the mesh runs) gives the exact fractions the placement holds and
    ZeRO-3's gathered layer; without it the scalar `rest_shard_fraction`
    prices every leaf as sharding.  `device`: the card the verdict is
    priced against (the CPU has none), and whether the flash kernels run
    (on the card, without a sharded sequence)."""
    from dalle_pytorch_tpu_torch.parallel.mesh import axis_sizes

    axes: Mapping[str, int] = axis_sizes(mesh) if mesh is not None else {}
    param_itemsize = (_itemsize(settings.param_dtype)
                      if settings is not None and getattr(settings, "param_dtype", None) is not None else None)
    if plan is not None:
        numel = sum(math.prod(plan.layouts[n].shape) for n in params)
        store = param_itemsize or _itemsize(next(iter(params.values())).dtype)
        param_bytes = float(numel * store)
    else:
        numel = sum(p.numel() for p in params.values())
        param_bytes = tree_float_bytes(list(params.values()), itemsize=param_itemsize)
    grad_itemsize = 4
    if settings is not None and getattr(settings, "grad_dtype", None) is not None:
        grad_itemsize = _itemsize(settings.grad_dtype)
    grad_bytes = float(numel * grad_itemsize)
    compute_itemsize = 4
    if settings is not None and getattr(settings, "compute_dtype", None) is not None:
        compute_itemsize = _itemsize(settings.compute_dtype)
    grad_accum = int(getattr(settings, "grad_accum", 1) or 1) if settings is not None else 1
    zero_stage = int(getattr(settings, "zero_stage", 0) or 0) if settings is not None else 0

    p_frac = m_frac = None
    extra = []
    if plan is not None:
        p_frac = plan.held_fraction(list(params))
        m_frac = plan.held_fraction(list(params), moments=True)
        row = zero3_gather_row(plan, params, param_itemsize or 4)
        if row is not None:
            extra.append(row)
    held = _opt_tensors(opt_state)
    if held:
        opt_bytes = tree_float_bytes(held)
        if m_frac:  # a rank's pieces: the whole tree's bytes
            opt_bytes /= m_frac
    else:
        opt_bytes = 2.0 * numel * 4
    execution = getattr(cfg, "resolved_execution", None) or "sequential"
    return step_memory_ledger(
        axes,
        param_bytes=param_bytes,
        grad_bytes=grad_bytes,
        opt_bytes=opt_bytes,
        batch=batch,
        seq_len=cfg.total_seq_len,
        dim=cfg.dim,
        depth=cfg.depth,
        heads=cfg.heads,
        dim_head=cfg.dim_head,
        compute_itemsize=compute_itemsize,
        zero_stage=zero_stage,
        grad_accum=grad_accum,
        accum_bytes=numel * 4.0 if grad_accum > 1 else None,
        execution=execution,
        remat_policy=getattr(cfg, "remat_policy", "full") or "full",
        flash_attention=_resolves_to_flash(cfg, device, axes),
        pp_num_micro=getattr(cfg, "pp_num_micro", None),
        input_bytes=input_bytes,
        capacity_bytes=capacity_bytes,
        device=device,
        param_shard_fraction=p_frac,
        moment_shard_fraction=m_frac,
        extra_rows=extra,
    )


def _resolves_to_flash(cfg: Any, device: Any = None, axes: Optional[Mapping[str, int]] = None) -> bool:
    """The port's kernel choice: the flash kernels run on the card (they
    never hold the score matrix); on the CPU the plain attention, and on a
    sequence sharded over sp the ring or the gathered plain attention, hold
    it."""
    if device is None or torch.device(device).type != "cuda":
        return False
    return not (int((axes or {}).get("sp", 1)) > 1 and getattr(cfg, "seq_shard_axis", None) is not None)


def generic_memory_ledger(params: Mapping[str, Any], opt_state: Any = None, input_bytes: float = 0.0,
                          capacity_bytes: Optional[float] = None, device: Any = None) -> Dict[str, Any]:
    """Tree-only ledger for models without a priced geometry (train_vae):
    params + f32 grads + optimizer moments + the device batch.  Activations
    are deliberately absent — a conv working-set model would be guesswork —
    so the verdict is a LOWER bound (stated in the report)."""
    leaves = list(params.values())
    held = _opt_tensors(opt_state)
    rows = [
        {"name": "params", "bytes": tree_float_bytes(leaves), "detail": "storage dtypes"},
        {"name": "grads", "bytes": tree_float_bytes(leaves, itemsize=4), "detail": "f32 gradient buffer"},
        {"name": "opt_state", "bytes": tree_float_bytes(held) if held else 2.0 * tree_float_bytes(leaves, itemsize=4),
         "detail": "optimizer moments"},
    ]
    if input_bytes:
        rows.append({"name": "inputs", "bytes": input_bytes * 1.0, "detail": "device batch"})
    ledger = _finish_ledger(rows, capacity_bytes=capacity_bytes, device=device)
    ledger["lower_bound"] = True  # no activation row
    return ledger


def sampling_memory_ledger(cfg: Any, batch: int, model: Optional[torch.nn.Module] = None,
                           itemsize: Optional[int] = None, capacity_bytes: Optional[float] = None,
                           paged_pool: Optional[Mapping[str, Any]] = None, device: Any = None) -> Dict[str, Any]:
    """The generation path's ledger: the weights (int8 / fp8 blocks at their
    at-rest bytes) + the dense per-lane KV cache of `generate_images` (2 x
    depth x lanes x seq x heads x dim_head in the model's dtype; `batch`
    counts lanes, twice the images under classifier-free guidance) + the
    per-position logits.  The captured decode graphs replay on that cache
    (`DecodeGraphs`: it is their entry's largest buffer; the rest, the
    sampling state and rings, is not priced — 0.146 of the 12-layer CFG
    entry's 0.615 GiB, PERF.md §5).

    `paged_pool` ({num_blocks, block_size, num_slots, itemsize?, kv_quant?},
    `engine.memory_ledger`) switches the KV row to the serving engine's: the
    shared block pool at rest (an int8 pool at 1 + 2/dim_head bytes an
    element, its per-token scales included) plus the transient one-layer
    dense view the paged step gathers (`batch` then counts decode slots)."""
    if itemsize is None:
        itemsize = 4
        if model is not None:
            floats = [p for p in model.parameters() if p.is_floating_point()]
            if floats:
                itemsize = floats[0].element_size()
    rows = []
    if model is not None:
        from dalle_pytorch_tpu_torch.quantization import tree_is_quantized, tree_weight_bytes

        if tree_is_quantized(model):
            rows.append({"name": "params", "bytes": tree_weight_bytes(model),
                         "detail": "int8 matmul blocks + float scales/rest"})
        else:
            rows.append({"name": "params", "bytes": tree_weight_bytes(model), "detail": "storage dtypes"})
    if paged_pool is not None:
        nb = int(paged_pool["num_blocks"])
        bs = int(paged_pool["block_size"])
        slots = int(paged_pool.get("num_slots", batch))
        isz = int(paged_pool.get("itemsize", itemsize))
        kv_quant = paged_pool.get("kv_quant")
        if kv_quant:
            from dalle_pytorch_tpu_torch.quantization import kv_bytes_per_elem

            bpe = kv_bytes_per_elem(kv_quant, isz, cfg.dim_head)
            pool_bytes = 2.0 * cfg.depth * nb * cfg.heads * bs * cfg.dim_head * bpe
            detail = (f"{nb} blocks x {bs} tok x 2 x depth x h x dh, "
                      f"{kv_quant} + per-token scales (shared, at rest)")
        else:
            pool_bytes = 2.0 * cfg.depth * nb * cfg.heads * bs * cfg.dim_head * isz
            detail = f"{nb} blocks x {bs} tok x 2 x depth x h x dh (shared, at rest)"
        rows.append({"name": "paged_kv_pool", "bytes": pool_bytes, "detail": detail})
        gather = 2.0 * slots * cfg.heads * cfg.total_seq_len * cfg.dim_head * isz
        rows.append({"name": "paged_gather", "bytes": gather,
                     "detail": f"one layer's dense view x {slots} slots (transient)"})
    else:
        kv = 2.0 * cfg.depth * batch * cfg.total_seq_len * cfg.heads * cfg.dim_head * itemsize
        rows.append({"name": "kv_cache", "bytes": kv,
                     "detail": f"2 x depth x b{batch} x s{cfg.total_seq_len} x h x dh"})
    rows.append({"name": "logits", "bytes": 1.0 * batch * cfg.total_tokens * 4,
                 "detail": "per-position vocab logits (f32)"})
    extra = _decode_read_accounting(cfg, batch, itemsize)
    if extra is not None:
        gather_row, read_bytes = extra
        rows.append(gather_row)
        return _finish_ledger(rows, batch=batch, capacity_bytes=capacity_bytes, device=device,
                              decode_kv_read_bytes_per_step=read_bytes)
    return _finish_ledger(rows, batch=batch, capacity_bytes=capacity_bytes, device=device)


def _decode_read_accounting(cfg: Any, batch: int, itemsize: int):
    """Pattern-limited decode reads (`sparse_decode`): each pattern layer
    gathers only its Kmax permitted keys a step instead of reading the
    whole cache row.  Returns (the (b, h, Kmax, dh) K/V gather row, one
    layer live at a time, the most over layers; the KV bytes a step reads,
    summed over layers), or None without a pattern or with sparse decode
    off."""
    if not hasattr(cfg, "transformer_config"):
        return None
    tcfg = cfg.transformer_config()
    if not getattr(tcfg, "sparse_decode", False):
        return None
    from dalle_pytorch_tpu_torch.kernels.sparse_index import decode_kv_span
    from dalle_pytorch_tpu_torch.models.transformer import _pattern_for, _pattern_key, derive_layer_specs

    n = tcfg.seq_len
    spans = {}
    read_bytes = 0.0
    kmax = 0
    any_pattern = False
    for spec in derive_layer_specs(tcfg):
        key = _pattern_key(spec)
        if key not in spans:
            pm = _pattern_for(tcfg, key[0], key[1])
            spans[key] = decode_kv_span(pm, n)
            any_pattern |= pm is not None
        span = spans[key]
        read_bytes += 2.0 * batch * tcfg.heads * span * tcfg.dim_head * itemsize
        if span < n:  # full layers read the cache in place, no gather
            kmax = max(kmax, span)
    if not any_pattern:
        return None
    row = {
        "name": "decode_gather",
        "bytes": 2.0 * batch * tcfg.heads * kmax * tcfg.dim_head * itemsize,
        "detail": f"sparse decode K/V gather, Kmax {kmax} of s{n} (transient, one layer)",
    }
    return row, read_bytes


def publish_gauges(ledger: Mapping[str, Any], registry=None) -> None:
    """Mirror the ledger into `mem/*` gauges — one per row plus the total,
    the verdict, and the capacity the verdict was priced against."""
    reg = registry if registry is not None else metrics_mod.REGISTRY
    for row in ledger.get("rows", []):
        reg.gauge(f"mem/{row['name']}_bytes").set(row["bytes"])
    reg.gauge("mem/total_bytes").set(ledger["total_bytes"])
    if ledger.get("capacity_bytes"):
        reg.gauge("mem/capacity_bytes").set(ledger["capacity_bytes"])
        reg.gauge("mem/headroom_frac").set(ledger["headroom_frac"])
        reg.gauge("mem/fits").set(1.0 if ledger["fits"] else 0.0)


# ---------------------------------------------------------------------------
# the measured check + the in-place audit
# ---------------------------------------------------------------------------

def state_bytes(state: Any) -> float:
    """Bytes of a TrainState at rest on this rank: its parameters and its
    optimizer's state."""
    return tree_float_bytes(list(state.params.values())) + tree_float_bytes(_opt_tensors(state.opt_state))


def step_memory_analysis(fn: Callable[[], Any], argument_bytes: float = 0.0, device: Any = None):
    """Run one step `fn()` and read what it took on the card: (its result,
    {argument_bytes (the state's bytes, given), before_bytes (allocated
    before the step), temp_bytes (its peak less that), output_bytes (what
    it left allocated beyond that), alias_bytes (the state's bytes less
    that growth: what the step updated in place), generated_code_bytes (0),
    total_bytes (the peak)}), or (its result, None) on the CPU, where there
    is no allocator to read.  The peak is `max_memory_allocated` after
    `reset_peak_memory_stats`."""
    on_card = (device is None or torch.device(device).type == "cuda") and torch.cuda.is_available() \
        and torch.cuda.is_initialized()
    if not on_card:
        return fn(), None
    torch.cuda.synchronize(device)
    before = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    result = fn()
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device)
    grown = torch.cuda.memory_allocated(device) - before
    out = {
        "argument_bytes": float(argument_bytes),
        "before_bytes": float(before),
        "temp_bytes": float(peak - before),
        "output_bytes": float(grown),
        "alias_bytes": float(max(argument_bytes - max(grown, 0), 0.0)),
        "generated_code_bytes": 0.0,
        "total_bytes": float(peak),
    }
    return result, out


# a step may leave this much behind at its first call: cuBLAS's workspace and
# the per-stream buffers PyTorch allocates at first use
AUDIT_SLACK_BYTES = 64 * 2 ** 20


def audit_donation(analysis: Mapping[str, float], expected_bytes: float, slack_frac: float = 0.05,
                   slack_bytes: float = AUDIT_SLACK_BYTES) -> Dict[str, Any]:
    """Did the step update its state in place?  PyTorch has no donation;
    the port's optimizers write the parameters and moments in place, so a
    step that allocates a second copy of the state (a rebuilt optimizer
    state, a parameter replaced instead of written) shows as the bytes
    allocated after it exceeding those before by more than the slack
    (`slack_frac` of `expected_bytes`, the state's bytes, or `slack_bytes`,
    the larger).  The JAX package's keys: `donated_bytes` is the state less
    that growth."""
    grown = float(analysis.get("output_bytes") or 0.0)
    slack = max(slack_frac * expected_bytes, slack_bytes)
    donated = max(expected_bytes - max(grown, 0.0), 0.0)
    frac = donated / expected_bytes if expected_bytes > 0 else None
    ok = grown <= slack
    metrics_mod.gauge("mem/donated_bytes").set(donated)
    if not ok:
        metrics_mod.counter("donation_dropped_alarms").inc()
    return {"donated_bytes": donated, "expected_bytes": expected_bytes + 0.0, "donated_frac": frac,
            "grown_bytes": grown, "slack_bytes": slack, "ok": ok}


class MemoryCrosscheck(FlopsCrosscheck):
    """Analytic ledger vs the measured step's peak, with the same
    drift-from-first-ratio persistence alarm as the FLOPs check.  The two
    will never be equal (the allocator rounds blocks, keeps the autograd
    graph's saved tensors as the model makes them, the ledger prices
    coarsely) — the RATIO moving is what says a config change invalidated
    the ledger or a buffer doubled."""

    RATIO_GAUGE = "mem_measured_over_analytic_bytes"
    ALARM_COUNTER = "mem_divergence_alarms"


# ---------------------------------------------------------------------------
# live headroom
# ---------------------------------------------------------------------------

class HbmMonitor:
    """Live allocator tracking at the telemetry flush cadence.

    `observe(step, stats)` takes the {key: max-across-devices} dict
    `cuda.record_memory_gauges` returns, publishes the per-window
    `peak_bytes_in_use` delta, and fires ONE `hbm_headroom` alarm per
    episode when bytes_in_use crosses `headroom_frac` x capacity (re-armed
    with hysteresis when usage recedes below `rearm_frac`).  The alarm
    routes through the telemetry hub, so the on-alarm TraceTrigger captures
    the steps where the allocator is thrashing — while it still is.
    Episode state rides checkpoint meta (`state_dict`/`load_state_dict`,
    the DivergenceMonitor discipline) so a resumed run does not re-fire
    mid-episode."""

    def __init__(self, capacity_bytes: Optional[float] = None,
                 headroom_frac: float = 0.9,
                 rearm_frac: Optional[float] = None,
                 on_alarm: Optional[Callable[[Dict[str, Any]], None]] = None,
                 registry=None, device: Any = None):
        self.capacity_bytes = (capacity_bytes if capacity_bytes is not None
                               else device_hbm_capacity(device))
        self.headroom_frac = headroom_frac
        self.rearm_frac = rearm_frac if rearm_frac is not None else headroom_frac * 0.95
        self.on_alarm = on_alarm
        self.registry = registry if registry is not None else metrics_mod.REGISTRY
        self.alarmed = False
        self.last_peak: Optional[float] = None
        self.alarms = 0

    def observe(self, step: Optional[int], stats: Optional[Mapping[str, float]]
                ) -> Optional[Dict[str, Any]]:
        if not stats:
            return None  # CPU: no allocator stats — degrade silently
        in_use = stats.get("bytes_in_use")
        peak = stats.get("peak_bytes_in_use")
        rec: Dict[str, Any] = {"step": step}
        if peak is not None:
            delta = peak - self.last_peak if self.last_peak is not None else 0.0
            self.last_peak = peak
            rec["peak_bytes_in_use"] = peak
            rec["peak_window_delta_bytes"] = delta
            self.registry.gauge("mem/peak_window_delta_bytes").set(delta)
        if in_use is not None:
            rec["bytes_in_use"] = in_use
        usage = None
        basis = in_use if in_use is not None else peak
        if self.capacity_bytes and basis is not None:
            usage = basis / self.capacity_bytes
            rec["usage_frac"] = usage
            self.registry.gauge("mem/usage_frac").set(usage)
        if usage is not None and self.headroom_frac:
            if usage >= self.headroom_frac and not self.alarmed:
                self.alarmed = True
                self.alarms += 1
                self.registry.counter("hbm_headroom_alarms").inc()
                if self.on_alarm is not None:
                    self.on_alarm({
                        "type": "hbm_headroom", "step": step,
                        "usage_frac": usage, "threshold": self.headroom_frac,
                        "bytes_in_use": basis,
                        "capacity_bytes": self.capacity_bytes,
                    })
            elif usage < self.rearm_frac:
                self.alarmed = False  # episode over — the next crossing fires
        rec["alarmed"] = self.alarmed
        return rec

    def state_dict(self) -> Dict[str, Any]:
        return {"alarmed": self.alarmed, "last_peak": self.last_peak,
                "alarms": self.alarms}

    def load_state_dict(self, state: Optional[Mapping[str, Any]]) -> None:
        if not state:
            return
        self.alarmed = bool(state.get("alarmed", False))
        self.last_peak = state.get("last_peak")
        self.alarms = state.get("alarms", 0) or 0


# ---------------------------------------------------------------------------
# OOM forensics
# ---------------------------------------------------------------------------

_OOM_MARKERS = ("cuda out of memory", "resource_exhausted", "resource exhausted", "out of memory",
                "ran out of memory", "oom while")


def is_oom_error(exc: BaseException) -> bool:
    """True when `exc`, or anything on its cause/context chain, is the
    allocator's out-of-memory error (`torch.OutOfMemoryError`, which
    `torch.cuda.OutOfMemoryError` names) or an error saying so ("CUDA out of
    memory", and the JAX package's markers)."""
    seen = 0
    while exc is not None and seen < 8:
        if isinstance(exc, torch.OutOfMemoryError):
            return True
        msg = str(exc).lower()
        if any(m in msg for m in _OOM_MARKERS):
            return True
        exc = exc.__cause__ or exc.__context__
        seen += 1
    return False


def oom_suggestions(ledger: Optional[Mapping[str, Any]],
                    axes: Optional[Mapping[str, int]] = None,
                    settings: Any = None) -> List[str]:
    """Ranked, actionable changes in the port's flags, derived from which
    ledger row dominates, in the JAX package's order.  Suggestions already
    in effect (remat already on, ZeRO already 3, bf16 storage) are skipped,
    so the list stays applicable."""
    out: List[str] = []
    dominant = (ledger or {}).get("dominant")
    zero = int(getattr(settings, "zero_stage", 0) or 0) if settings is not None else 0
    accum = int(getattr(settings, "grad_accum", 1) or 1) if settings is not None else 1
    fsdp = int((axes or {}).get("fsdp", 1))

    def lowp(dtype_attr):
        dt = getattr(settings, dtype_attr, None) if settings is not None else None
        if dt is None:
            return False
        try:
            return _itemsize(dt) < 4
        except Exception:
            return False

    if dominant == "opt_state":
        if zero < 1:
            out.append("raise --zero_stage to 1 (shard optimizer moments over fsdp"
                       + ("; add --mesh_fsdp > 1 first" if fsdp <= 1 else "") + ")")
        elif zero < 3:
            out.append("raise --zero_stage to 3 (shard params + moments over fsdp)")
        out.append("switch the optimizer to optim.adafactor.Adafactor (factored f32 statistics are "
                   "O(rows+cols) instead of 2x params)")
    if dominant == "params":
        if not lowp("param_dtype"):
            out.append("--param_dtype bfloat16 (halves resident param storage; "
                       "stochastic-rounded updates)")
        if zero < 3:
            out.append("raise --zero_stage to 3 (params sharded over fsdp at rest)")
        out.append("add tensor/pipeline parallelism (--mesh_tp / --mesh_pp shard "
                   "params at rest)")
    if dominant in ("grads", "grad_accum"):
        if not lowp("grad_dtype"):
            out.append("set grad_dtype=torch.bfloat16 in StepSettings (halves the "
                       "gradient buffer; sound with scale-invariant optimizers)")
        if zero < 2:
            out.append("raise --zero_stage to 2")
    if dominant == "activations":
        execution = ""
        for row in (ledger or {}).get("rows", []):
            if row["name"] == "activations":
                execution = row.get("detail", "")
        if execution.startswith("sequential"):
            out.append("--execution remat (recompute activations in backward "
                       "instead of keeping every layer live)")
        elif execution.startswith("remat/") and not execution.startswith("remat/full"):
            out.append("weaken --remat_policy toward 'full' (save fewer "
                       "per-layer tensors)")
        # already at remat/full (or reversible): the remat lever is spent
        out.append(f"raise --ga_steps (e.g. {max(accum * 2, 2)}) to shrink the "
                   "microbatch the activations are priced at")
        out.append("--execution reversible (two residual streams, whatever the "
                   "depth)")
    if dominant == "kv_cache":
        out.append("shrink the generation --batch_size (the KV cache is linear "
                   "in it)")
        out.append("--quantize_weights int8 (the weights at a byte an element)")
    if dominant == "paged_kv_pool":
        out.append("shrink the serving pool (--num_blocks) or --block_size — "
                   "admission control will queue instead")
        out.append("--quantize_kv int8 (the pool at 1 + 2/dim_head bytes an element)")
    if dominant == "paged_gather":
        out.append("shrink --slots (the transient gather is linear in decode "
                   "slots)")
    out.append("shrink --batch_size (or shard it further with --mesh_dp/--mesh_fsdp)")
    return out


def format_ledger(ledger: Optional[Mapping[str, Any]]) -> str:
    """Human-readable ledger table (shared by the OOM report and
    tools/memory_report.py)."""
    if not ledger:
        return "  (no analytic ledger available)"
    lines = []
    total = ledger.get("total_bytes") or 0.0
    for row in ledger.get("rows", []):
        pct = 100.0 * row["bytes"] / total if total > 0 else 0.0
        mark = "  <-- dominant" if row["name"] == ledger.get("dominant") else ""
        lines.append(f"  {row['name']:<14} {row['bytes'] / 1e9:>9.3f} GB "
                     f"{pct:>5.1f}%  {row.get('detail', '')}{mark}")
    lines.append(f"  {'TOTAL':<14} {total / 1e9:>9.3f} GB")
    cap = ledger.get("capacity_bytes")
    if cap:
        verdict = "FITS" if ledger.get("fits") else "DOES NOT FIT"
        lines.append(f"  capacity       {cap / 1e9:>9.3f} GB per chip -> {verdict} "
                     f"(headroom {100.0 * (ledger.get('headroom_frac') or 0):.1f}%)")
    if ledger.get("lower_bound"):
        lines.append("  (activations not modeled for this architecture — "
                     "the total is a LOWER bound)")
    return "\n".join(lines)


def write_oom_report(dir: str, *, error: BaseException, phase: str,
                     ledger: Optional[Mapping[str, Any]] = None,
                     analysis: Optional[Mapping[str, float]] = None,
                     live_stats: Optional[Mapping[str, float]] = None,
                     context: Optional[Mapping[str, Any]] = None,
                     settings: Any = None,
                     process_index: int = 0) -> str:
    """Write `oom_report_<phase>[_pN]_<ts>.txt` under `dir`: what was
    resident (the ledger), what the measured step took (its analysis),
    what the allocator saw (`live_stats`, then `torch.cuda.memory_summary`
    where a card is in use), and what to change (ranked suggestions).
    Returns the path.  Never raises — forensics must not mask the OOM."""
    try:
        d = Path(dir)
        d.mkdir(parents=True, exist_ok=True)
        ptag = f"_p{process_index}" if process_index else ""
        path = d / f"oom_report_{phase}{ptag}_{int(time.time())}.txt"
        lines = [
            "=" * 72,
            f"OUT OF MEMORY during {phase}",
            "=" * 72,
            "",
            "error:",
            "  " + "\n  ".join(str(error).splitlines()[:12] or ["<empty>"]),
            "",
        ]
        if context:
            lines.append("context:")
            for k, v in context.items():
                lines.append(f"  {k}: {v}")
            lines.append("")
        lines.append("analytic HBM ledger (per chip):")
        lines.append(format_ledger(ledger))
        lines.append("")
        if analysis:
            lines.append("measured step (max_memory_allocated):")
            for k, v in analysis.items():
                lines.append(f"  {k:<22} {v / 1e9:>9.3f} GB")
            lines.append("")
        if live_stats:
            lines.append("live allocator stats (torch.cuda.memory_stats):")
            for k, v in sorted(live_stats.items()):
                lines.append(f"  {k:<28} {v / 1e9:>9.3f} GB" if k.endswith(("bytes", "_limit", "_free", "in_use"))
                             else f"  {k:<28} {v:>12.0f}")
            lines.append("")
        summary = _memory_summary()
        if summary:
            lines.append("torch.cuda.memory_summary():")
            lines.append(summary)
            lines.append("")
        axes = (ledger or {}).get("mesh")
        lines.append("suggestions (ranked by the dominant ledger row):")
        for i, s in enumerate(oom_suggestions(ledger, axes, settings), 1):
            lines.append(f"  {i}. {s}")
        lines.append("")
        path.write_text("\n".join(lines))
        metrics_mod.counter("oom_reports_written").inc()
        return str(path)
    except Exception:  # pragma: no cover - forensics must never mask the OOM
        return ""


def _memory_summary() -> str:
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return ""
    try:
        return torch.cuda.memory_summary(abbreviated=True)
    except Exception:  # noqa: BLE001 — forensics must never mask the OOM
        return ""


def provoke_oom(simulate_reason: str = "injected", device: Any = None) -> None:
    """Raise the allocator's out-of-memory error.  On a card it allocates
    blocks of an eighth of the card until the caching allocator itself
    raises `torch.OutOfMemoryError` (what it held is freed as the error
    propagates); on the CPU, where exhausting host memory would take the
    machine down, it raises an error of the same type and message shape,
    marked simulated."""
    if device is not None and torch.device(device).type == "cuda" or device is None and torch.cuda.is_available():
        cap = device_hbm_capacity(device) or 0.0
        chunk = max(int(cap // 8 // 4), 1)  # f32 elements
        hold = []
        try:
            for _ in range(64):
                hold.append(torch.empty(chunk, dtype=torch.float32, device=device or "cuda"))
        finally:
            del hold
    raise torch.OutOfMemoryError(
        f"CUDA out of memory. [chaos] {simulate_reason} OOM: simulated out-of-memory while allocating a "
        "device buffer")
