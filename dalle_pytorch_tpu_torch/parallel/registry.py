"""The partition registry (counterpart of `dalle_pytorch_tpu/parallel/registry.py`):
one ordered table of rules that maps a parameter's path to where it lives on
the mesh, at rest and in the step.

The rules, their order and their resolution are the JAX package's, copied
here (the port imports nothing of it), so that each leaf gets the spec JAX
gives it and `fingerprint()` is JAX's string.  A path is the JAX package's
'/'-joined parameter path (`transformer/shared_attn/0/qkv/w`); a shape is
the JAX package's (linear weights (in, out)).  The port's parameters are
matched under those paths through the weight bridge's name map
(`weights.dalle_param_paths`, `clip_param_paths`); the train step maps each
spec onto PyTorch's layout (`parallel/sharding.py`).

A spec is a tuple with one entry per dim: an axis name, a tuple of axis
names, or None (replicated).  Template entries of a rule:

  "tp"    the tensor-parallel axis (Megatron column / row placement)
  "data"  the at-rest data slot: the largest prefix of the active data
          axes (fsdp when ZeRO-3 shards parameters, pp whenever the mesh
          has stages) whose product divides this dim
  None    replicated

A rule whose spec is LARGEST shards the leaf's largest divisible dim over
the data axes.  Everything here is host arithmetic on paths and shapes.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import re
from typing import Any, Mapping, Optional, Sequence, Tuple, Union

from dalle_pytorch_tpu_torch.parallel.mesh import AXIS_FSDP, AXIS_PP, AXIS_TP, axis_sizes


class P(tuple):
    """A partition spec: one entry per dim (an axis, a tuple of axes, or
    None); P() replicates the whole leaf.  Equal to the tuple of its
    entries, as `jax.sharding.PartitionSpec` is."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


DATA = "data"
LARGEST = "largest"

# bumped when the resolution semantics change (the fingerprint hashes it)
_SEMANTICS_VERSION = 1

# leaves smaller than this stay replicated under the default rule
MIN_SHARD_SIZE = 2 ** 14


@dataclasses.dataclass(frozen=True)
class Rule:
    """One entry of the table: `pattern` is re.search'd against the path;
    `spec` is a per-dim template (it applies only to a leaf of its length)
    or LARGEST.  `tp_only` rules are skipped when tensor parallelism is
    off."""

    pattern: str
    spec: Union[Tuple[Optional[str], ...], str]
    tp_only: bool = False
    note: str = ""

    def __post_init__(self):
        object.__setattr__(self, "_rx", re.compile(self.pattern))

    def matches(self, path: str, ndim: int, tensor_parallel: bool) -> bool:
        if self.tp_only and not tensor_parallel:
            return False
        if self.spec != LARGEST and len(self.spec) != ndim:
            return False
        return self._rx.search(path) is not None


# the JAX package's DEFAULT_RULES, rule for rule
DEFAULT_RULES: Tuple[Rule, ...] = (
    Rule(r"qkv/w|w1/w|w1g/w", (DATA, AXIS_TP), tp_only=True,
         note="column parallel (qkv / ff-up projections)"),
    Rule(r"(?=.*shared_attn)(?=.*out/w)|w2/w", (AXIS_TP, DATA), tp_only=True,
         note="row parallel (attention out / ff-down projections)"),
    Rule(r"logits_linear/w", (DATA, AXIS_TP), tp_only=True,
         note="vocab-sharded output projection"),
    Rule(r"w1/b|w1g/b|logits_linear/b", (AXIS_TP,), tp_only=True,
         note="biases of column/vocab-parallel projections"),
    Rule(r"(qkv/w|w1/w|w1g/w|logits_linear/w)/scale", (AXIS_TP,),
         tp_only=True,
         note="quant scales of column/vocab-parallel weights (out axis "
              "shards with the qvalue blocks)"),
    Rule(r"(?=.*shared_attn)(?=.*out/w/scale)|w2/w/scale", (None,),
         tp_only=True,
         note="quant scales of row-parallel weights: every tp rank holds "
              "all output columns, so scales replicate"),
    Rule(r".*", LARGEST,
         note="default: largest divisible dim over the data axes"),
)


def _norm_axes(mesh_or_axes) -> dict:
    if mesh_or_axes is None:
        return {}
    return {k: int(v) for k, v in axis_sizes(mesh_or_axes).items()}


def _axes_prod(axes: Mapping[str, int], names: Sequence[str]) -> int:
    return math.prod(axes.get(a, 1) for a in names)


def _data_axes(axes: Mapping[str, int], include_fsdp: bool) -> Tuple[str, ...]:
    out = []
    if include_fsdp and axes.get(AXIS_FSDP, 1) > 1:
        out.append(AXIS_FSDP)
    if axes.get(AXIS_PP, 1) > 1:
        out.append(AXIS_PP)
    return tuple(out)


def _data_slot(dim_size: int, data_axes: Tuple[str, ...], axes: Mapping[str, int]):
    best = None
    for end in range(1, len(data_axes) + 1):
        cand = data_axes[:end]
        if dim_size % _axes_prod(axes, cand) == 0:
            best = cand
    if best is None:
        return None
    return best if len(best) > 1 else best[0]


def _shard_largest(shape: Tuple[int, ...], data_axes: Tuple[str, ...], axes: Mapping[str, int],
                   min_size: int = MIN_SHARD_SIZE) -> P:
    size = math.prod(shape) if shape else 0
    if not data_axes or not shape or size < min_size:
        return P()
    candidates = [data_axes] if len(data_axes) == 1 else [data_axes, *[(a,) for a in data_axes]]
    dims = list(shape)
    order = sorted(range(len(dims)), key=lambda i: -dims[i])
    for cand in candidates:
        n = _axes_prod(axes, cand)
        for i in order:
            if dims[i] % n == 0 and dims[i] >= n:
                spec = [None] * len(dims)
                spec[i] = cand if len(cand) > 1 else cand[0]
                return P(*spec)
    return P()


def spec_divisor(spec: Sequence, axes: Mapping[str, int]) -> int:
    """How many ways `spec` splits a leaf on a mesh of `axes` sizes."""
    div = 1
    for entry in spec:
        if entry is None:
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        div *= _axes_prod(axes, names)
    return div


@dataclasses.dataclass(frozen=True)
class PartitionRegistry:
    """The ordered rule table and its resolution: the first matching rule
    wins; a leaf no rule claims is replicated."""

    rules: Tuple[Rule, ...] = DEFAULT_RULES
    min_shard_size: int = MIN_SHARD_SIZE

    def resolve(self, path: str, shape: Tuple[int, ...], mesh_or_axes, *, zero_stage: int = 0,
                tensor_parallel: Optional[bool] = None, moments: bool = False) -> P:
        """The spec of one leaf.  `moments=True`: an optimizer moment, which
        ZeRO-1/2 shard over fsdp where the parameter rules left it
        replicated."""
        axes = _norm_axes(mesh_or_axes)
        if tensor_parallel is None:
            tensor_parallel = axes.get(AXIS_TP, 1) > 1
        params_sharded = zero_stage >= 3 and axes.get(AXIS_FSDP, 1) > 1
        data_axes = _data_axes(axes, include_fsdp=params_sharded)
        shape = tuple(int(s) for s in shape)

        spec = P()
        for rule in self.rules:
            if not rule.matches(path, len(shape), tensor_parallel):
                continue
            if rule.spec == LARGEST:
                spec = _shard_largest(shape, data_axes, axes, self.min_shard_size)
            else:
                spec = P(*[_data_slot(dim, data_axes, axes) if entry == DATA else entry
                           for dim, entry in zip(shape, rule.spec)])
            break

        if moments and spec == P():
            if zero_stage >= 1 and axes.get(AXIS_FSDP, 1) > 1:
                spec = _shard_largest(shape, _data_axes(axes, include_fsdp=True), axes, self.min_shard_size)
        return spec

    def tree_specs(self, tree: Mapping[str, Any], mesh_or_axes, zero_stage: int = 0,
                   tensor_parallel: Optional[bool] = None, moments: bool = False) -> dict:
        """{path: spec} of a flat {path: tensor or shape} mapping; a 0-d
        leaf is replicated."""
        out = {}
        for path, leaf in tree.items():
            shape = tuple(getattr(leaf, "shape", leaf))
            out[path] = P() if not shape else self.resolve(
                path, shape, mesh_or_axes, zero_stage=zero_stage, tensor_parallel=tensor_parallel,
                moments=moments)
        return out

    def shard_fraction(self, tree: Mapping[str, Any], mesh_or_axes, zero_stage: int = 0,
                       tensor_parallel: Optional[bool] = None, moments: bool = False,
                       itemsize: Optional[int] = None) -> float:
        """The fraction of the tree's floating bytes each rank holds at rest
        under these rules, weighted by leaf bytes (in their dtype, or at
        `itemsize`; int8 blocks at 1 byte).  `tree`: {path: tensor or numpy
        array}."""
        axes = _norm_axes(mesh_or_axes)
        total = held = 0.0
        for path, leaf in tree.items():
            nbytes = _float_bytes(leaf, itemsize)
            if nbytes is None:
                continue
            spec = self.resolve(path, tuple(leaf.shape), axes, zero_stage=zero_stage,
                                tensor_parallel=tensor_parallel, moments=moments)
            total += nbytes
            held += nbytes / spec_divisor(spec, axes)
        return held / total if total else 1.0

    def describe(self) -> list:
        """The JSON-ready rule listing (the fingerprint's preimage)."""
        return [{"pattern": r.pattern, "spec": r.spec if isinstance(r.spec, str) else list(r.spec),
                 "tp_only": r.tp_only, "note": r.note} for r in self.rules]

    def fingerprint(self) -> str:
        """The content hash of the rules and the resolution semantics (the
        notes left out), as the JAX package computes it."""
        preimage = json.dumps(
            {"semantics": _SEMANTICS_VERSION, "min_shard_size": self.min_shard_size,
             "rules": [{k: v for k, v in r.items() if k != "note"} for r in self.describe()]},
            sort_keys=True,
        )
        return hashlib.sha256(preimage.encode()).hexdigest()[:16]


def _float_bytes(leaf, itemsize: Optional[int]) -> Optional[float]:
    """Bytes of a floating leaf (at `itemsize` when given), of an int8 block
    at 1 byte, None for any other leaf."""
    dtype = getattr(leaf, "dtype", None)
    if dtype is None:
        return None
    numel = math.prod(leaf.shape)
    name = str(dtype).replace("torch.", "")
    if name in ("int8",):
        return numel * 1.0
    if not (name.startswith("float") or name.startswith("bfloat")):
        return None
    size = dtype.itemsize if hasattr(dtype, "itemsize") else None
    return numel * float(itemsize if itemsize is not None else size)


_DEFAULT_REGISTRY = PartitionRegistry()


def default_registry() -> PartitionRegistry:
    return _DEFAULT_REGISTRY


def normalize_mesh_axes(mesh_or_axes) -> dict:
    """{axis: size} with the size-1 axes dropped: the comparable identity
    of a topology."""
    return {k: v for k, v in _norm_axes(mesh_or_axes).items() if v > 1}


def meshes_equal(a, b) -> bool:
    return normalize_mesh_axes(a) == normalize_mesh_axes(b)


def topology_meta(mesh_or_axes, registry: Optional[PartitionRegistry] = None,
                  device_count: Optional[int] = None) -> dict:
    """The `topology` record of a checkpoint's meta: the mesh's axis sizes,
    the device count and the registry's fingerprint, as the JAX package
    writes it."""
    axes = _norm_axes(mesh_or_axes)
    if device_count is None:
        device_count = math.prod(axes.values()) if axes else 1
    reg = registry if registry is not None else default_registry()
    return {"mesh": axes, "device_count": int(device_count), "registry_fingerprint": reg.fingerprint()}
