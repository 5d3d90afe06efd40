"""Where each parameter and optimizer moment lives on the mesh
(counterpart of `dalle_pytorch_tpu/parallel/sharding.py`), and the sharded
train step's plan (`MeshPlan`).

ZeRO, as the JAX package maps it:
  zero_stage 0    parameters and moments replicated (plain data parallel)
  zero_stage 1/2  parameters replicated, moments sharded over fsdp: each
                  rank updates its shard and all-gathers the result (the
                  two coincide: gradients live only inside the step)
  zero_stage 3    parameters and moments sharded over fsdp; the step
                  gathers each layer's parameters around its use
                  (`Zero3Units`) and reduce-scatters their gradients
Tensor parallelism splits the qkv, w1 and w1g rows (column parallel), the
attention out and w2 columns (row parallel) and the logits rows (the
vocabulary) over tp, the registry's `tp` entries.

Sequence parallelism (sp, when the model's `seq_shard_axis` names it)
keeps every leaf replicated over sp and sums the gradients over it (each sp
rank's loss is its positions' part).  The pipeline (pp, when the model's
`pipeline_axis` names it) places by stage, not by the registry: a stage
holds its own layers whole (the JAX package's chunk map,
`pipeline.stage_chunks`) and no piece of the others' (an empty tensor
stands in), and every leaf outside the stack (the embeddings, the
positions, the final norm, the logits; and a layer's leaf that layers of
two stages share) is replicated over pp with its gradient summed over pp.
The JAX package folds pp into the registry's data slot instead, so that
each rank holds 1/P of every leaf that divides; the port's placement holds
the leaves outside the stack on every stage, (P - 1)/P of their bytes more
a rank.  Without those model knobs the sp or pp ranks are replicas of the
step (the JAX CLI's `--mesh_sp` on a model with no `seq_shard_axis`).

Which leaf gets which spec is `registry.DEFAULT_RULES`', on the leaf's JAX
path and shape on the (dp, fsdp, tp) axes; a spec's dims are mapped onto
PyTorch's layout here (a linear weight's dims swap).  A spec becomes one
placement per mesh axis (`placements`: `Shard(d)` or `Replicate()`), and a
rank's piece of a full tensor is its contiguous part along each sharded dim
(`local_piece`, which `shard_tree` and every piece `MeshPlan` takes go
through).  The tp split of the qkv rows is head-aligned: they are
head-major, so a contiguous part is whole heads, JAX's layout as it is.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, List, Mapping, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from dalle_pytorch_tpu_torch.core.shard import ShardContext, shard_context
from dalle_pytorch_tpu_torch.optim.grouped import Group, GroupedState
from dalle_pytorch_tpu_torch.parallel import tensor_parallel as tp
from dalle_pytorch_tpu_torch.parallel.mesh import (
    AXIS_DP,
    AXIS_FSDP,
    AXIS_PP,
    AXIS_SP,
    AXIS_TP,
    TORCH_MESH_AXES,
    axis_ranks,
    mesh_coordinate,
    mesh_groups,
    resolve_axes,
)
from dalle_pytorch_tpu_torch.parallel.registry import P, PartitionRegistry, default_registry


def param_specs(tree: Mapping[str, Any], mesh, zero_stage: int = 0, tensor_parallel: Optional[bool] = None,
                registry: Optional[PartitionRegistry] = None) -> dict:
    """{JAX path: spec} of a flat {JAX path: tensor or shape} mapping."""
    reg = registry if registry is not None else default_registry()
    return reg.tree_specs(tree, mesh, zero_stage, tensor_parallel=tensor_parallel)


def opt_state_specs(tree: Mapping[str, Any], mesh, zero_stage: int = 0, tensor_parallel: Optional[bool] = None,
                    registry: Optional[PartitionRegistry] = None) -> dict:
    """The specs of the optimizer moments of the leaves of `tree`: the
    parameters' rules, and under ZeRO-1/2 an fsdp shard where those leave
    a leaf replicated."""
    reg = registry if registry is not None else default_registry()
    return reg.tree_specs(tree, mesh, zero_stage, tensor_parallel=tensor_parallel, moments=True)


def _axes_of(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def placements(spec, mesh_axes=TORCH_MESH_AXES) -> list:
    """One `torch.distributed.tensor` placement per mesh axis: `Shard(d)`
    for the dim the spec splits over it, `Replicate()` otherwise."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for axis in mesh_axes:
        dims = [d for d, entry in enumerate(spec) if axis in _axes_of(entry)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def local_piece(x: torch.Tensor, spec, axes: Mapping[str, int], coord: Mapping[str, int]) -> torch.Tensor:
    """This rank's contiguous piece of the full tensor `x` under `spec` (in
    x's own layout), at mesh coordinate `coord`."""
    for d, entry in enumerate(spec):
        for axis in _axes_of(entry):
            x = x[(slice(None),) * d + (tp.local_slice(x.shape[d], coord[axis], axes[axis]),)]
    return x


def shard_tree(tree: Mapping[str, torch.Tensor], specs: Mapping[str, Any], mesh, rank: Optional[int] = None) -> dict:
    """{name: this rank's piece} of a flat tree of full tensors."""
    axes = resolve_axes(mesh)
    coord = mesh_coordinate(dist.get_rank() if rank is None else rank, axes)
    return {name: local_piece(x, specs[name], axes, coord) for name, x in tree.items()}


def torch_spec(spec, transposed: bool) -> P:
    """A spec of the JAX layout on the port's: a linear weight's two dims
    swap."""
    return P(*reversed(tuple(spec))) if transposed and len(spec) == 2 else P(*spec)


def _only(spec, axis: str) -> P:
    """`spec` with the entries of every other axis dropped."""
    return P(*[axis if axis in _axes_of(entry) else None for entry in spec])


def _dim_of(spec, axis: str) -> Optional[int]:
    """The dim `spec` splits over `axis` (its placement there), or None."""
    place = placements(spec)[TORCH_MESH_AXES.index(axis)]
    return place.dim if place.is_shard() else None


@dataclasses.dataclass(frozen=True)
class Layout:
    """One parameter on the mesh, in the port's layout: its full shape, its
    at-rest spec (tp, and under ZeRO-3 fsdp), its update spec (what the
    optimizer works on: the at-rest piece, or under ZeRO-1/2 the moments'
    fsdp shard of it) and `sub`, that shard's spec within the at-rest
    piece (empty when the two coincide)."""

    shape: Tuple[int, ...]
    rest: P
    update: P
    sub: P

    @property
    def tp_dim(self) -> Optional[int]:
        return _dim_of(self.rest, AXIS_TP)

    @property
    def rest_dim(self) -> Optional[int]:
        return _dim_of(self.rest, AXIS_FSDP)

    @property
    def upd_dim(self) -> Optional[int]:
        return _dim_of(self.update, AXIS_FSDP)


class _GatherShard(torch.autograd.Function):
    """A ZeRO-3 shard's tp piece: all-gathered over fsdp forward; backward,
    the gradient summed over fsdp (in f32) and scattered back to the
    shard."""

    @staticmethod
    def forward(ctx, shard, dim, group, parts):
        ctx.args = (dim, group, parts)
        return tp.gather_dim(shard, dim, group, parts)

    @staticmethod
    def backward(ctx, g):
        dim, group, parts = ctx.args
        return tp.scatter_dim(g.float(), dim, group, parts).to(g.dtype), None, None, None


class _Packed(NamedTuple):
    """A saved tensor that views a gathered parameter: what rebuilds it."""

    shard: torch.Tensor
    name: str
    size: Tuple[int, ...]
    stride: Tuple[int, ...]
    offset: int


class Zero3Units:
    """ZeRO-3's gathers around each use.  A unit is a child of an
    `nn.ModuleList` of the model (a transformer layer) that no other unit
    holds: while the step runs, a forward pre-hook swaps the unit's sharded
    parameters (the shards the loss's `functional_call` put there) for
    their gathers and its forward hook swaps the shards back, so a unit's
    full parameters live for its forward alone.  The tensors autograd saves
    of them are packed as the shard and rebuilt by a gather again when the
    backward unpacks them (`torch.autograd.graph.saved_tensors_hooks`); a
    layer that remat or reversible execution recomputes runs its hooks
    again.  The sharded parameters no unit holds alone (embeddings, the
    logits, the final norm) are gathered once for the step (`rest`)."""

    def __init__(self, plan: "MeshPlan", module: torch.nn.Module, sharded):
        self.plan, self.live = plan, False
        canon = {id(p): n for n, p in module.named_parameters()}
        units, covered = [], set()
        for m in module.modules():
            if isinstance(m, torch.nn.ModuleList) and id(m) not in covered:
                for child in m:
                    if id(child) not in covered:
                        units.append(child)
                        covered.update(id(x) for x in child.modules())
        outside = {canon[id(p)] for m in module.modules() if id(m) not in covered
                   for p in m._parameters.values() if p is not None}
        self.entries: Dict[int, list] = {}
        held = set()
        for unit in units:
            entry = [(owner, attr, canon[id(p)]) for owner in unit.modules() for attr, p in owner._parameters.items()
                     if p is not None and canon[id(p)] in sharded and canon[id(p)] not in outside]
            if entry:
                self.entries[id(unit)] = entry
                held.update(name for _, _, name in entry)
                unit.register_forward_pre_hook(self._pre)
                unit.register_forward_hook(self._post, always_call=True)
        self.rest = set(sharded) - held
        self._swapped: List[list] = []
        self._gathered: Dict[int, Tuple[torch.Tensor, str]] = {}

    def _pre(self, unit, args):
        if not self.live:
            return
        swapped = []
        for owner, attr, name in self.entries[id(unit)]:
            shard = owner._parameters[attr]
            full = self.plan.gather_shard(name, shard)
            key = full.untyped_storage().data_ptr()
            self._gathered[key] = (shard, name)
            owner._parameters[attr] = full
            swapped.append((owner, attr, shard, key))
        self._swapped.append(swapped)

    def _post(self, unit, args, output):
        if not self.live:
            return
        for owner, attr, shard, key in self._swapped.pop():
            owner._parameters[attr] = shard
            self._gathered.pop(key, None)

    def pack(self, t: torch.Tensor):
        hit = self._gathered.get(t.untyped_storage().data_ptr()) if self._gathered else None
        if hit is None:
            return t
        return _Packed(hit[0], hit[1], tuple(t.size()), tuple(t.stride()), t.storage_offset())

    def unpack(self, x):
        if not isinstance(x, _Packed):
            return x
        with torch.no_grad():
            full = self.plan.gather_shard(x.name, x.shard)
        return full.as_strided(x.size, x.stride, x.offset)


class Placement:
    """Where one rank of a mesh holds each parameter: its `Layout` (from
    the registry, on its JAX path), the rank's coordinate, what the model
    makes of sp and pp (`_model_axes`), with no process group: the memory
    ledger prices a rank's share with it (`held_fraction`) before the mesh
    runs, and `MeshPlan` builds the step on it.  `axes`: {axis: size} or a
    DeviceMesh; `elementwise`: the optimizer updates each element from its
    own statistics (Adam), so it runs on this rank's shards; otherwise
    (Adafactor, whose statistics span a leaf) it runs on the gathered
    leaves with replicated statistics.  `module`: the model the loss runs."""

    def __init__(self, axes, rank: int, params: Mapping[str, torch.Tensor], zero_stage: int,
                 paths: Optional[Mapping[str, Any]] = None, registry: Optional[PartitionRegistry] = None,
                 elementwise: bool = True, module: Optional[torch.nn.Module] = None):
        reg = registry if registry is not None else default_registry()
        self.full_update = not elementwise
        self.axes = resolve_axes(axes)
        self.world = math.prod(self.axes.values())
        self.rank = rank
        self.coord = mesh_coordinate(self.rank, self.axes)
        self.T, self.F = self.axes[AXIS_TP], self.axes[AXIS_FSDP]
        self.D = self.axes[AXIS_DP] * self.F
        self.data_coord = self.coord[AXIS_DP] * self.F + self.coord[AXIS_FSDP]
        self._model_axes(module, params)
        # the registry places over (dp, fsdp, tp); sp replicates and pp places by stage
        reg_axes = {**self.axes, AXIS_SP: 1, AXIS_PP: 1}
        self.layouts: Dict[str, Layout] = {}
        for name, p in params.items():
            path, shape, transposed = (paths[name] if paths is not None
                                       else (name.replace(".", "/"), tuple(p.shape), False))
            rest = torch_spec(reg.resolve(path, shape, reg_axes, zero_stage=zero_stage), transposed)
            update = torch_spec(reg.resolve(path, shape, reg_axes, zero_stage=zero_stage, moments=True), transposed)
            rest_dim, upd_dim, tp_dim = _dim_of(rest, AXIS_FSDP), _dim_of(update, AXIS_FSDP), _dim_of(rest, AXIS_TP)
            if rest_dim is not None and upd_dim != rest_dim:
                raise ValueError(f"{name}: ZeRO-3 moments {update} are not placed as its parameter {rest}")
            if _dim_of(update, AXIS_TP) != tp_dim:
                raise ValueError(f"{name}: its moments {update} are not split over tp as its parameter {rest}")
            if tp_dim is not None and tp_dim == (upd_dim if rest_dim is None else rest_dim):
                raise ValueError(f"{name}: tp and fsdp split the same dim {tp_dim} of {tuple(p.shape)}")
            if tp_dim is not None and p.shape[tp_dim] % self.T:
                raise ValueError(f"{name}: its dim {tp_dim} of {tuple(p.shape)} does not split over tp {self.T}")
            sub = _only(update, AXIS_FSDP) if rest_dim is None else P()
            self.layouts[name] = Layout(tuple(p.shape), rest, update, sub)

    def _model_axes(self, module: Optional[torch.nn.Module], params: Mapping[str, torch.Tensor]) -> None:
        """What the model makes of sp and pp: `seq` (the sequence sharded
        over sp, `seq_start` this rank's first position), `pipe` (the layers
        pipelined over pp, `chunks` this stage's), `stage_of` (name -> the
        stage that alone holds it; leaves absent are replicated over pp) and
        `elsewhere` (the names other stages hold)."""
        cfg = getattr(module, "cfg", None)
        self.S, self.Pp = self.axes[AXIS_SP], self.axes[AXIS_PP]
        self.seq = self.S > 1 and getattr(cfg, "seq_shard_axis", None) is not None
        self.pipe = self.Pp > 1 and getattr(cfg, "pipeline_axis", None) is not None
        self.seq_start, self.chunks, self.stage_of, self.elsewhere = 0, (), {}, set()
        self.sp_ranks = tuple(axis_ranks(self.rank, AXIS_SP, self.axes))
        self.pp_ranks = tuple(axis_ranks(self.rank, AXIS_PP, self.axes))
        if self.seq:
            if cfg.total_seq_len % self.S:
                raise ValueError(f"a sequence of {cfg.total_seq_len} does not split over sp {self.S}")
            self.seq_start = self.coord[AXIS_SP] * (cfg.total_seq_len // self.S)
        if not self.pipe:
            return
        from dalle_pytorch_tpu_torch.parallel.pipeline import check_split, stage_chunks

        if self.full_update:
            raise ValueError("the pipelined step takes an optimizer that updates each element from its own "
                             "statistics (optim.grouped.Adam): Adafactor's statistics span a leaf")
        depth, v = cfg.depth, cfg.pp_interleave
        check_split(depth, self.Pp, v)
        me = self.coord[AXIS_PP]
        self.chunks = stage_chunks(depth, self.Pp, me, v)
        size = depth // (self.Pp * v)
        by_id = {id(p): n for n, p in params.items()}
        stages: Dict[str, set] = {}
        for i, layer in enumerate(module.transformer.layers):
            for p in layer.parameters():
                stages.setdefault(by_id[id(p)], set()).add((i // size) % self.Pp)
        self.stage_of = {n: next(iter(st)) for n, st in stages.items() if len(st) == 1}
        self.elsewhere = {n for n, st in self.stage_of.items() if st != me}

    def _local(self, x: torch.Tensor, spec) -> torch.Tensor:
        return local_piece(x, spec, self.axes, self.coord)

    def piece(self, name: str, full: torch.Tensor, full_piece: bool = False, rest: bool = False) -> torch.Tensor:
        """This rank's piece of a full-shaped tensor of `name`: its update
        piece (what the optimizer sees; the whole of it when `full_piece`),
        or with `rest` its at-rest piece."""
        if full_piece:
            return full
        if name in self.elsewhere:  # another stage's
            return full.new_empty(0)
        lay = self.layouts[name]
        return self._local(full, lay.rest if rest else lay.update)

    def held_fraction(self, names, moments: bool = False) -> float:
        """The share of the elements of the parameters `names` this rank
        holds at rest (`moments`: the share of their optimizer statistics):
        its pieces under the layouts, nothing of another stage's leaves, the
        whole leaves where the optimizer runs on gathered ones."""
        full = held = 0
        for name in names:
            lay = self.layouts[name]
            n = math.prod(lay.shape)
            full += n
            if moments and self.full_update:
                held += n
            elif name not in self.elsewhere:
                spec = lay.update if moments else lay.rest
                held += local_piece(torch.empty(lay.shape, device="meta"), spec, self.axes, self.coord).numel()
        return held / full if full else 1.0


class MeshPlan(Placement):
    """The sharded step's view of the mesh: this rank's `Placement`, its
    groups, and the collectives of the step.  A rank's piece of a tensor is
    always `local_piece` of it under one of the layout's specs.  `module`:
    the model the loss runs, whose units ZeRO-3 gathers one at a time
    (`Zero3Units`)."""

    def __init__(self, mesh, params: Mapping[str, torch.Tensor], zero_stage: int,
                 paths: Optional[Mapping[str, Any]] = None, registry: Optional[PartitionRegistry] = None,
                 elementwise: bool = True, module: Optional[torch.nn.Module] = None):
        world = math.prod(resolve_axes(mesh).values())
        super().__init__(mesh, dist.get_rank() if world > 1 else 0, params, zero_stage, paths, registry,
                         elementwise, module)
        self.groups, self.data_group = mesh_groups(mesh) if self.world > 1 else ({a: None for a in self.axes}, None)
        sharded = {n for n, lay in self.layouts.items()
                   if lay.rest_dim is not None and self.F > 1 and n not in self.elsewhere}
        if sharded and module is None:
            raise ValueError("ZeRO-3 gathers each layer's parameters around its use: pass the model the loss runs "
                             "(make_train_step(module=...))")
        self.units = Zero3Units(self, module, sharded) if sharded else None

    # -- pieces ---------------------------------------------------------------

    def _sub(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """The update piece within the at-rest piece `x` (a view)."""
        return x if name in self.elsewhere else self._local(x, self.layouts[name].sub)

    def gather_shard(self, name: str, shard: torch.Tensor) -> torch.Tensor:
        """The tp piece of a ZeRO-3 shard, differentiable (`_GatherShard`)."""
        return _GatherShard.apply(shard, self.layouts[name].rest_dim, self.groups[AXIS_FSDP], self.F)

    def _gather(self, name: str, x: torch.Tensor, fsdp_dim: Optional[int], to_full: bool) -> torch.Tensor:
        x = x.detach()
        if name in self.elsewhere:
            return x
        if fsdp_dim is not None and self.F > 1:
            x = tp.gather_dim(x, fsdp_dim, self.groups[AXIS_FSDP], self.F)
        d = self.layouts[name].tp_dim
        if to_full and d is not None and self.T > 1:
            x = tp.gather_dim(x, d, self.groups[AXIS_TP], self.T)
        return x

    # -- placement ------------------------------------------------------------

    def place(self, params: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Keep this rank's at-rest pieces in the parameters (in place: the
        full storage is freed; another stage's leaf keeps an empty tensor)
        and return the tensors the optimizer's state is shaped on: the
        update pieces, or the full leaves."""
        shaped = {}
        with torch.no_grad():
            for name, p in params.items():
                if self.full_update:
                    shaped[name] = torch.empty(p.shape, dtype=torch.float32, device=p.device)
                p.data = self.piece(name, p.data, rest=True).contiguous().clone()
                if not self.full_update:
                    shaped[name] = self._sub(name, p.data)
        return shaped

    # -- the step -------------------------------------------------------------

    @contextlib.contextmanager
    def context(self, local_rows: int):
        """The forward and backward of one micro-batch: the shard context
        the model reads, and ZeRO-3's gathers around each unit."""
        seq = dict(sp_group=self.groups[AXIS_SP], sp_rank=self.coord[AXIS_SP], sp_size=self.S,
                   sp_ranks=self.sp_ranks, seq_start=self.seq_start) if self.seq else {}
        pipe = dict(pp_rank=self.coord[AXIS_PP], pp_size=self.Pp, pp_ranks=self.pp_ranks,
                    pp_chunks=self.chunks) if self.pipe else {}
        with shard_context(ShardContext(
                self.groups[AXIS_TP], self.coord[AXIS_TP], self.T, self.data_coord * local_rows, self.D * local_rows,
                self.data_group, self.D, **seq, **pipe)):
            if self.units is None:
                yield
                return
            self.units.live = True
            try:
                with torch.autograd.graph.saved_tensors_hooks(self.units.pack, self.units.unpack):
                    yield
            finally:
                self.units.live = False

    def loss_params(self, work: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """What the loss runs on: the working copies, the sharded ones no
        unit holds gathered for the step (inside `context`)."""
        if self.units is None:
            return dict(work)
        return {n: self.gather_shard(n, w) if n in self.units.rest else w for n, w in work.items()}

    def local_batch(self, batch: Mapping[str, torch.Tensor], grad_accum: int = 1) -> Dict[str, torch.Tensor]:
        """This rank's rows of a global batch: of each of the grad_accum
        micro-batches, the data rank's contiguous part, in order."""
        out = {}
        for key, x in batch.items():
            m, lm = x.shape[0] // grad_accum, x.shape[0] // (grad_accum * self.D)
            if x.shape[0] % (grad_accum * self.D):
                raise ValueError(f"batch of {x.shape[0]} rows does not split into {grad_accum} micro-batches over "
                                 f"{self.D} data ranks")
            start = self.data_coord * lm
            out[key] = torch.cat([x[k * m + start: k * m + start + lm] for k in range(grad_accum)])
        return out

    def mean_over_data(self, x: torch.Tensor) -> torch.Tensor:
        if self.D == 1:
            return x
        x = x.detach().clone()
        dist.all_reduce(x, group=self.data_group)
        return x / self.D

    def loss_of_model_axes(self, loss: torch.Tensor) -> torch.Tensor:
        """This data rank's loss from its pp and sp ranks' parts: the last
        stage's (the others hold 0), the sp ranks' parts summed."""
        for on, axis in ((self.pipe, AXIS_PP), (self.seq, AXIS_SP)):
            if on:
                loss = loss.detach().clone()
                dist.all_reduce(loss, group=self.groups[axis])
        return loss

    def reduce_model_axes(self, names: List[str], grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """The gradients of this data rank's loss: every leaf's summed over
        sp (each sp rank's loss is its positions' part), and every leaf that
        the stages share summed over pp (stage 0's embeddings and the last
        stage's logits parts of a tied table); in f32, in one bucket an
        axis."""
        for on, axis, keep in ((self.seq, AXIS_SP, lambda n: True),
                               (self.pipe, AXIS_PP, lambda n: n not in self.stage_of)):
            picked = [i for i, n in enumerate(names) if on and keep(n)]
            if not picked:
                continue
            flat = torch.cat([grads[i].float().reshape(-1) for i in picked])
            dist.all_reduce(flat, group=self.groups[axis])
            grads = list(grads)
            for i, part in zip(picked, flat.split([grads[i].numel() for i in picked])):
                grads[i] = part.view(grads[i].shape).to(grads[i].dtype)
        return grads

    def reduce_grads(self, names: List[str], grads: List[torch.Tensor], grad_dtype) -> List[torch.Tensor]:
        """The gradients of the global batch: each leaf's mean over the data
        ranks, in f32, cast to `grad_dtype`.  A ZeRO-3 shard's gradient
        comes out of the backward already summed over fsdp
        (`_GatherShard`) and is all-reduced over dp; the others are
        all-reduced over dp·fsdp in one bucket."""
        if self.D == 1:
            return grads
        out: List[Optional[torch.Tensor]] = [None] * len(grads)
        bucket = []
        for i, (name, g) in enumerate(zip(names, grads)):
            if self.layouts[name].rest_dim is not None and self.F > 1:
                g32 = g.float()
                if self.groups[AXIS_DP] is not None:
                    dist.all_reduce(g32, group=self.groups[AXIS_DP])
                out[i] = (g32 / self.D).to(grad_dtype)
            else:
                bucket.append(i)
        if bucket:
            flat = torch.cat([grads[i].float().reshape(-1) for i in bucket])
            dist.all_reduce(flat, group=self.data_group)
            flat /= self.D
            for i, part in zip(bucket, flat.split([grads[i].numel() for i in bucket])):
                out[i] = part.view(grads[i].shape).to(grad_dtype)
        return out

    def global_norm(self, names: List[str], grads: List[torch.Tensor]) -> torch.Tensor:
        """The f32 norm of the whole gradient: each piece's sum of squares
        divided by the number of ranks holding that same piece, summed over
        the world (a stage's own leaf is held by its stage's ranks alone)."""
        total = None
        for name, g in zip(names, grads):
            lay = self.layouts[name]
            pieces = (self.T if lay.tp_dim is not None else 1) * (self.F if lay.rest_dim is not None else 1)
            pieces *= self.Pp if name in self.stage_of else 1
            sq = torch.linalg.vector_norm(g, dtype=torch.float32).square() * (pieces / self.world)
            total = sq if total is None else total + sq
        if self.world > 1:
            dist.all_reduce(total)
        return total.sqrt()

    def update_targets(self, params: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """What the update writes into: the update pieces of the parameters
        (views), or full buffers when the optimizer runs on whole leaves."""
        if self.full_update:
            return {n: torch.empty(self.layouts[n].shape, dtype=p.dtype, device=p.device)
                    for n, p in params.items()}
        return {n: self._sub(n, p) for n, p in params.items()}

    def update_inputs(self, params, grads) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """(parameters, gradients) the optimizer sees: the update pieces, or
        the gathered whole leaves."""
        if self.full_update:
            return ({n: self._gather(n, p, self.layouts[n].rest_dim, True) for n, p in params.items()},
                    {n: self._gather(n, g, self.layouts[n].rest_dim, True) for n, g in grads.items()})
        return ({n: self._sub(n, p) for n, p in params.items()}, {n: self._sub(n, g) for n, g in grads.items()})

    def finish_update(self, params, targets) -> None:
        """Bring every parameter's at-rest piece up to date: all-gather the
        ZeRO-1/2 shards over fsdp, or take this rank's piece of the whole
        leaves."""
        for n, p in params.items():
            if self.full_update:
                p.copy_(self.piece(n, targets[n], rest=True))
                continue
            if n in self.elsewhere:
                continue
            lay = self.layouts[n]
            if lay.rest_dim is None and lay.upd_dim is not None and self.F > 1:
                p.copy_(tp.gather_dim(targets[n].contiguous(), lay.upd_dim, self.groups[AXIS_FSDP], self.F))

    # -- checkpoints and memory -------------------------------------------------

    def _assemble(self, name: str, x: torch.Tensor, spec, shape) -> Optional[torch.Tensor]:
        """The full tensor of every rank's piece `x` of `name` under `spec`,
        on rank 0 (None on the other ranks): gathered there alone; a
        stage's own leaf from that stage's ranks (the others send zeros)."""
        if self.world == 1:
            return x.detach()
        shape_of = local_piece(torch.empty(shape, device="meta"), spec, self.axes, self.coord).shape
        if name in self.elsewhere:
            x = torch.zeros(shape_of, dtype=x.dtype, device=x.device)
        pieces = [torch.empty_like(x) for _ in range(self.world)] if self.rank == 0 else None
        dist.gather(x.detach().contiguous(), pieces, dst=0)
        if self.rank != 0:
            return None
        full = x.new_empty(shape)
        owner = self.stage_of.get(name)
        for r, piece in enumerate(pieces):
            coord = mesh_coordinate(r, self.axes)
            if owner is None or coord[AXIS_PP] == owner:
                local_piece(full, spec, self.axes, coord).copy_(piece)
        return full

    def full_state(self, state):
        """The one-process TrainState of this sharded one on rank 0, None
        on the other ranks (collective: every rank calls it): full
        parameters, and the optimizer state over full leaves (one group a
        leaf), for the checkpoint writer."""
        params = {n: self._assemble(n, p, self.layouts[n].rest, self.layouts[n].shape)
                  for n, p in state.params.items()}
        opt = state.opt_state
        if not self.full_update:
            groups = []
            at = {name: (group, i) for group in opt.groups for i, name in enumerate(group.names)}
            for name in state.params:  # one order on every rank (the groups differ between stages)
                group, i = at[name]
                lay = self.layouts[name]
                stats = {k: self._assemble(name, v[i], lay.update, lay.shape) for k, v in group.stats.items()}
                if self.rank == 0:
                    groups.append(Group((name,), lay.shape, {k: v[None] for k, v in stats.items()}))
            opt = GroupedState(opt.count, groups)
        if self.rank != 0:
            return None
        return dataclasses.replace(state, params=params, opt_state=opt)

    def full_template(self, state):
        """A one-process TrainState of this sharded one's shapes, its
        statistics zero on the host (no collective), for the resume reader
        to fill before `load_opt_state` keeps this rank's pieces."""
        opt = state.opt_state
        if not self.full_update:
            opt = GroupedState(opt.count, [
                Group((name,), self.layouts[name].shape,
                      {k: torch.zeros((1, *self.layouts[name].shape), dtype=v.dtype) for k, v in group.stats.items()})
                for group in opt.groups for name in group.names])
        return dataclasses.replace(state, params={}, opt_state=opt)

    def load_opt_state(self, state, full) -> None:
        """Write the optimizer state of a full TrainState (`full_state`'s
        or `full_template`'s shape) into this rank's, in place."""
        src = full.opt_state
        state.opt_state.count = src.count
        if self.full_update:
            for dst, g in zip(state.opt_state.groups, src.groups):
                for k, v in dst.stats.items():
                    v.copy_(g.stats[k])
            return
        by_name = {}
        for group in src.groups:
            for i, name in enumerate(group.names):
                by_name[name] = {k: v[i] for k, v in group.stats.items()}
        for group in state.opt_state.groups:
            for k, v in group.stats.items():
                v.copy_(torch.stack([self.piece(n, by_name[n][k]) for n in group.names]))

    def resident_bytes(self, state) -> Dict[str, int]:
        """Bytes this rank holds at rest: its parameter pieces and its
        optimizer statistics."""
        params = sum(p.numel() * p.element_size() for p in state.params.values())
        moments = sum(v.numel() * v.element_size() for g in state.opt_state.groups for v in g.stats.values())
        return {"params": params, "moments": moments}
