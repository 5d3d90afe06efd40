"""Analytic accounting of the bytes that cross between devices (counterpart
of `dalle_pytorch_tpu/observability/comms.py`): the training step's comms
ledger and the price of disaggregated prefill.

Per-rank wire bytes per optimizer step, for each active mesh axis of the
step in `parallel/train_step.py`:

  dp    one ring all-reduce of the gradients
  fsdp  ZeRO-0: the gradient all-reduce; ZeRO-1/2: the all-reduce and the
        all-gather of the updated shards; ZeRO-3: the parameters gathered
        in the forward and again in the backward, per micro-batch, and one
        reduce-scatter of the gradients
  tp    one activation all-reduce per residual branch and direction
        (Megatron's pattern: 2 branches x forward and backward per layer)
  sp    ring attention in every layer (`parallel/ring.ring_comm_bytes`)
  pp    the pipeline's stage hops (`parallel/pipeline.pipeline_comm_bytes`)

A ring all-reduce moves 2·(n-1)/n of its payload over each rank's link, an
all-gather or reduce-scatter (n-1)/n.  Everything here is host arithmetic
on shapes, with the JAX package's numbers for the same inputs (so the
parameter share a dp or fsdp collective moves is the JAX placement's,
1/(tp·pp) or the registry's, not the port's stage placement).
`CommsCrosscheck` comes with ROADMAP.md Queue 1 item 7.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional

import torch

from dalle_pytorch_tpu_torch.quantization import kv_bytes_per_elem


def ring_all_reduce_bytes(payload: float, n: int) -> float:
    """Per-rank wire bytes to all-reduce a `payload`-byte tensor over n
    ranks: a reduce-scatter and an all-gather, each (n-1)/n of it."""
    return 2.0 * payload * (n - 1) / n if n > 1 else 0.0


def all_gather_bytes(payload: float, n: int) -> float:
    """Per-rank wire bytes to all-gather a tensor of `payload` bytes in all
    from n shards."""
    return payload * (n - 1) / n if n > 1 else 0.0


def reduce_scatter_bytes(payload: float, n: int) -> float:
    return payload * (n - 1) / n if n > 1 else 0.0


def _leaves(tree: Any):
    if isinstance(tree, Mapping):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def tree_float_bytes(tree: Any, itemsize: Optional[int] = None) -> float:
    """Bytes of the floating leaves of `tree` (nested dicts and lists of
    tensors or numpy arrays), in their dtype or at `itemsize`."""
    total = 0.0
    for leaf in _leaves(tree):
        dtype = getattr(leaf, "dtype", None)
        if dtype is None:
            continue
        is_float = dtype.is_floating_point if hasattr(dtype, "is_floating_point") else dtype.kind == "f" or \
            dtype.name == "bfloat16"
        if not is_float:
            continue
        numel = leaf.numel() if hasattr(leaf, "numel") else leaf.size
        total += numel * (itemsize if itemsize is not None else dtype.itemsize)
    return total


def step_comms_ledger(
    axes: Mapping[str, int],
    *,
    param_bytes: float,
    grad_bytes: float,
    batch: int,
    seq_len: int,
    dim: int,
    depth: int,
    heads: int,
    dim_head: int,
    compute_itemsize: int = 4,
    zero_stage: int = 0,
    grad_accum: int = 1,
    pp_num_micro: Optional[int] = None,
    pp_interleave: int = 1,
    param_shard_fraction: Optional[float] = None,
) -> Dict[str, Any]:
    """Per-rank wire bytes per optimizer step for each active mesh axis.
    `axes`: {axis: size}; `batch`: the global batch (activations are split
    over dp·fsdp, so the tp, sp and pp rows are priced at the local batch).
    `param_shard_fraction` replaces the 1/(tp·pp) approximation of the
    share of the parameters each rank holds with the registry's exact one."""
    from dalle_pytorch_tpu_torch.parallel.pipeline import default_num_micro, pipeline_comm_bytes
    from dalle_pytorch_tpu_torch.parallel.ring import ring_comm_bytes

    d = int(axes.get("dp", 1))
    f = int(axes.get("fsdp", 1))
    t = int(axes.get("tp", 1))
    s = int(axes.get("sp", 1))
    p = int(axes.get("pp", 1))

    batch_local = max(batch // max(d * f, 1), 1)
    param_shard = param_shard_fraction if param_shard_fraction is not None else 1.0 / max(t * p, 1)
    grad_local = grad_bytes * param_shard
    param_local = param_bytes * param_shard
    per_axis: List[Dict[str, Any]] = []

    if d > 1:
        per_axis.append({"axis": "dp", "size": d, "op": "all_reduce",
                         "bytes_per_step": ring_all_reduce_bytes(grad_local, d), "payload_bytes": grad_local})
    if f > 1:
        if zero_stage >= 3:
            gathers = 2.0 * max(grad_accum, 1)
            per_axis.append({"axis": "fsdp", "size": f, "op": "all_gather+reduce_scatter", "zero_stage": zero_stage,
                             "bytes_per_step": (gathers * all_gather_bytes(param_local, f)
                                                + reduce_scatter_bytes(grad_local, f)),
                             "payload_bytes": param_local})
        elif zero_stage >= 1:
            per_axis.append({"axis": "fsdp", "size": f, "op": "all_reduce+all_gather", "zero_stage": zero_stage,
                             "bytes_per_step": (ring_all_reduce_bytes(grad_local, f)
                                                + all_gather_bytes(param_local, f)),
                             "payload_bytes": grad_local})
        else:
            per_axis.append({"axis": "fsdp", "size": f, "op": "all_reduce", "zero_stage": zero_stage,
                             "bytes_per_step": ring_all_reduce_bytes(grad_local, f), "payload_bytes": grad_local})
    if t > 1:
        act = 1.0 * batch_local * seq_len * dim * compute_itemsize
        per_axis.append({"axis": "tp", "size": t, "op": "all_reduce",
                         "bytes_per_step": depth * 2 * 2 * ring_all_reduce_bytes(act, t), "payload_bytes": act,
                         "collectives": depth * 4})
    if s > 1:
        per_layer = ring_comm_bytes(batch_local, heads, max(seq_len // s, 1), dim_head, s,
                                    itemsize=compute_itemsize)
        per_axis.append({"axis": "sp", "size": s, "op": "ppermute_ring", "bytes_per_step": depth * per_layer,
                         "payload_bytes": per_layer})
    if p > 1:
        num_micro = pp_num_micro or default_num_micro(batch_local, p)
        per_axis.append({"axis": "pp", "size": p, "op": "ppermute",
                         "bytes_per_step": pipeline_comm_bytes(batch_local, seq_len, dim, p, num_micro=num_micro,
                                                               itemsize=compute_itemsize,
                                                               interleave=max(pp_interleave, 1)),
                         "num_micro": num_micro})

    total = sum(row["bytes_per_step"] for row in per_axis)
    return {"mesh": dict(axes), "batch": batch, "batch_local": batch_local, "per_axis": per_axis,
            "total_bytes_per_step": total + 0.0}


def dalle_step_comms(mesh: Any, params: Mapping[str, Any], cfg: Any, batch: int, settings: Any = None,
                     registry: Any = None, paths: Optional[Mapping[str, Any]] = None) -> Optional[Dict[str, Any]]:
    """The ledger of a DALL-E training step: sizes from the mesh (a
    DeviceMesh or {axis: size}), payload bytes from `params` (name ->
    tensor, full size), dtypes and the ZeRO stage from the StepSettings,
    the geometry from the DALLEConfig.  None without a mesh.  With
    `registry`, the share of the parameters each dp/fsdp collective moves
    is the registry's exact one, the leaves matched under their JAX paths
    (`paths`, default `weights.dalle_param_paths(cfg)`)."""
    if mesh is None:
        return None
    from dalle_pytorch_tpu_torch.parallel.mesh import axis_sizes

    axes = axis_sizes(mesh)
    shard_fraction = None
    if registry is not None:
        if paths is None:
            from dalle_pytorch_tpu_torch.weights import dalle_param_paths

            paths = dalle_param_paths(cfg)
        # each leaf under its JAX path and shape (no storage)
        jax_tree = {paths[name].path: torch.empty(paths[name].shape, dtype=p.dtype, device="meta")
                    for name, p in params.items()}
        # zero_stage 0: the tp share alone; the fsdp row prices the fsdp sharding
        shard_fraction = registry.shard_fraction(jax_tree, axes, 0)
    param_bytes = tree_float_bytes(params)
    grad_dtype = getattr(settings, "grad_dtype", None) if settings is not None else None
    grad_bytes = tree_float_bytes(params, itemsize=grad_dtype.itemsize if grad_dtype is not None else 4)
    compute_dtype = getattr(settings, "compute_dtype", None) if settings is not None else None
    return step_comms_ledger(
        axes, param_bytes=param_bytes, grad_bytes=grad_bytes, batch=batch, seq_len=cfg.total_seq_len,
        dim=cfg.dim, depth=cfg.depth, heads=cfg.heads, dim_head=cfg.dim_head,
        compute_itemsize=compute_dtype.itemsize if compute_dtype is not None else 4,
        zero_stage=int(getattr(settings, "zero_stage", 0) or 0) if settings is not None else 0,
        grad_accum=int(getattr(settings, "grad_accum", 1) or 1) if settings is not None else 1,
        pp_num_micro=getattr(cfg, "pp_num_micro", None), pp_interleave=int(getattr(cfg, "pp_interleave", 1) or 1),
        param_shard_fraction=shard_fraction,
    )


def comms_roofline(total_bytes: float, step_flops: float, peak_flops: float, link_bytes_per_s: float,
                   n_chips: int = 1) -> Dict[str, Any]:
    """Comms against compute for one step: the time each side takes at its
    peak rate and which one bounds the step.  Both sides per rank:
    `total_bytes` is the ledger's per-rank wire bytes and `step_flops` (the
    whole step, all ranks) is divided by `n_chips`.  The link rate is an
    argument: the card's interconnect, measured or from its data sheet."""
    flops_per_chip = step_flops / max(n_chips, 1)
    compute_s = flops_per_chip / peak_flops if peak_flops else 0.0
    comms_s = total_bytes / link_bytes_per_s if link_bytes_per_s else 0.0
    return {
        "comms_s_at_peak": comms_s + 0.0,
        "compute_s_at_peak": compute_s + 0.0,
        "comms_over_compute": (comms_s / compute_s) if compute_s > 0 else None,
        "bound": "comms" if comms_s > compute_s else "compute",
        "n_chips": max(n_chips, 1),
        "link_bytes_per_s": link_bytes_per_s + 0.0,
        "peak_flops": peak_flops + 0.0,
    }


def prefill_handoff_bytes(tcfg: Any, n_pre: int, lanes: int = 1, itemsize: int = 4,
                          kv_quant: Optional[str] = None) -> float:
    """Bytes of one admission's prefill -> decode handoff: every layer's k
    and v prefix, `lanes` sequences (a guided request hands over its [cond]
    and [null] prefixes); an int8 handoff at `kv_bytes_per_elem`'s price."""
    return 2.0 * tcfg.depth * lanes * tcfg.heads * n_pre * tcfg.dim_head * kv_bytes_per_elem(
        kv_quant, itemsize, tcfg.dim_head)


def prefill_handoff_row(tcfg: Any, n_pre: int, lanes: int = 1, itemsize: int = 4, ring_bytes: float = 0.0,
                        admissions_per_step: float = 1.0, kv_quant: Optional[str] = None) -> Dict[str, Any]:
    """The comms row of disaggregation: the bytes a prefill worker hands a
    decode replica per admission, the KV prefix and the token-shift ring
    tails, in the shape of the step ledger's rows."""
    payload = prefill_handoff_bytes(tcfg, n_pre, lanes, itemsize, kv_quant=kv_quant)
    row = {"axis": "handoff", "size": 2, "op": "prefill_to_decode",
           "bytes_per_step": (payload + ring_bytes) * admissions_per_step, "payload_bytes": payload,
           "ring_bytes": ring_bytes, "n_pre": n_pre, "lanes": lanes}
    if kv_quant:
        row["kv_quant"] = kv_quant
    return row
