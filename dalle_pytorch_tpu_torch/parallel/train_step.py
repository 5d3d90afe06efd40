"""The training step on one device (counterpart of the single-device branch
of `dalle_pytorch_tpu/parallel/train_step.py` `make_train_step`).

One call runs forward and backward (with gradient accumulation over
micro-batches, summed in f32), the global gradient norm, clipping, the
bad-step guard, optional loss scaling and the optimizer update, eagerly.

Two kinds of optimizer:
- a `torch.optim` factory (for example `functools.partial(torch.optim.Adam,
  lr=3e-4)`) over f32 masters.  With `compute_dtype=torch.bfloat16` the loss
  runs on a bf16 working copy cast from the masters inside the autograd
  graph, so the gradients land on the f32 masters, as `cast_floating` does
  in the JAX package.
- a grouped optimizer (`optim/grouped.py`: `optim.grouped.Adam`,
  `optim.adafactor.Adafactor`), which hands its update over as an f32
  tensor, as optax does.  The gradients are taken with respect to a
  compute-dtype copy of the parameters (an alias where the storage already
  has the compute dtype) and kept in `grad_dtype`.  This is the path of
  low-precision storage: with `param_dtype=torch.bfloat16` the parameters
  are stored in bf16 with no f32 master anywhere; the update runs on f32
  views of one group of leaves at a time and its sum with the parameter is
  rounded back stochastically (`stochastic_round`), so that updates below
  bf16's ulp survive in expectation.

`plateau` (`optim/plateau.ReduceOnPlateau`, with a grouped optimizer)
reads each step's loss and scales the update, as the JAX package chains
`optax.contrib.reduce_on_plateau` after its optimizer; a skipped step
leaves it as it was.

On a mesh (`parallel/mesh.py`, one process per device) the step is
sharded (`parallel/sharding.py` holds the placement): each rank runs the
loss on its rows of the global batch, the gradients are averaged over
dp·fsdp, ZeRO 1/2 shard the optimizer moments over fsdp and ZeRO-3 the
parameters too, and tp splits the attention heads, the feed-forward hidden
size and the vocabulary (Megatron's pattern, `parallel/tensor_parallel.py`).
When the model shards its sequence over sp (`seq_shard_axis`), each sp rank
runs its positions and the gradients and losses are summed over sp; when it
pipelines its layers over pp (`pipeline_axis`), each stage holds and
updates its own layers, the loss is read from the last stage and the
gradients of the leaves the stages share are summed over pp
(`parallel/pipeline.py`); the batch splits over dp·fsdp alone.
The numbers are those of the one-process step on the global batch: the
loss is its mean, the gradient norm is global (each replicated leaf counted
once, each stage's own leaf once), and dropout draws the one-process masks
at this rank's places.

The diagnostic `with_health` step raises `NotImplementedError`: it comes
with a later PR (`ROADMAP.md`).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple, Union

import torch

from dalle_pytorch_tpu_torch.optim.grouped import GroupedOptimizer, GroupedState
from dalle_pytorch_tpu_torch.optim.plateau import PlateauState, ReduceOnPlateau
from dalle_pytorch_tpu_torch.parallel import sharding
from dalle_pytorch_tpu_torch.parallel.mesh import active_mesh
from dalle_pytorch_tpu_torch.training.resilience import nonfinite_guard

Params = Dict[str, torch.Tensor]
LossFn = Callable[[Params, Dict[str, torch.Tensor], Optional[torch.Generator]], torch.Tensor]

LS_INIT_DYNAMIC = 2.0 ** 15
LS_GROWTH_INTERVAL = 2000  # clean steps before a dynamic scale doubles
LS_MAX = 2.0 ** 24  # the growth ceiling, as DeepSpeed/AMP cap it


@dataclasses.dataclass
class TrainState:
    step: int
    params: Params  # the model's parameters; the update writes them in place
    opt_state: Union[torch.optim.Optimizer, GroupedState]
    # {"loss_scale": float, "good_steps": int} when loss scaling is on
    loss_scale: Optional[Dict[str, Any]] = None
    # draws the stochastic rounding's bits (low-precision storage only)
    round_generator: Optional[torch.Generator] = None
    # the reduce-on-plateau state, when the step has one
    plateau: Optional[PlateauState] = None


@dataclasses.dataclass(frozen=True)
class StepSettings:
    grad_accum: int = 1
    compute_dtype: torch.dtype = torch.float32
    clip_grad_norm: Optional[float] = None
    zero_stage: int = 0
    # the dtype gradients are kept in between the backward and the update
    # (accumulation over micro-batches always runs in f32); bf16 takes a
    # grouped optimizer
    grad_dtype: torch.dtype = torch.float32
    # parameter storage: None or float32 keeps f32; bfloat16 stores bf16
    # with no f32 master (a grouped optimizer, stochastic rounding)
    param_dtype: Optional[torch.dtype] = None
    # None: stochastic rounding on exactly when the storage is low precision
    stochastic_round: Optional[bool] = None
    # None = off; a float = static scale; "dynamic" = start 2^15, halve and
    # skip on a nonfinite gradient, double after 2000 clean steps
    loss_scale: Optional[Union[float, str]] = None
    # None or True: skip the update when the gradient norm is not finite
    # (always on under loss scaling); False: the unguarded update
    skip_nonfinite: Optional[bool] = None


def _later(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: it comes with a later PR of the port (ROADMAP.md Queue 1)"
    )


def stochastic_round(x32: torch.Tensor, bits: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Round f32 to bf16 stochastically, as the JAX package's
    `_stochastic_round`: add 16 uniform random bits below bf16's mantissa to
    the f32 bit pattern, clear the low 16 bits and take the bf16 it now
    holds exactly.  P(round up) is the fractional distance to the next bf16,
    so the expected result is x.  `bits` (integers in [0, 65536), x32's
    shape) stands in for the draw, the counterpart of a fixed key; else 16
    bits an element come from `generator`.  Finite inputs only."""
    if bits is None:
        bits = torch.randint(0, 65536, x32.shape, generator=generator, dtype=torch.int32, device=x32.device)
    # int32 addition wraps as the JAX package's uint32 addition does, and
    # -65536 is 0xFFFF0000
    rounded = (x32.float().contiguous().view(torch.int32) + bits.to(torch.int32)) & -65536
    return rounded.view(torch.float32).to(torch.bfloat16)


def _micro_batches(batch: Dict[str, torch.Tensor], accum: int) -> List[Dict[str, torch.Tensor]]:
    if accum == 1:
        return [batch]
    sizes = {x.shape[0] for x in batch.values()}
    if len(sizes) != 1 or next(iter(sizes)) % accum:
        raise ValueError(f"batch leading sizes {sizes} must be one size divisible by grad_accum = {accum}")
    size = next(iter(sizes)) // accum
    split = {key: x.split(size) for key, x in batch.items()}
    return [{key: parts[i] for key, parts in split.items()} for i in range(accum)]


def _global_norm(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """The f32 norm over every gradient, without an f32 copy of one."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(grads), 2, dtype=torch.float32)))


def make_train_step(
    loss_fn: LossFn,
    optimizer: Union[Callable[[List[torch.Tensor]], torch.optim.Optimizer], GroupedOptimizer],
    settings: StepSettings = StepSettings(),
    mesh: Any = None,
    plateau: Optional[ReduceOnPlateau] = None,
    paths: Optional[Dict[str, Any]] = None,
    registry: Any = None,
    module: Optional[torch.nn.Module] = None,
) -> Tuple[Callable[..., TrainState], Callable[..., Tuple[TrainState, Dict[str, Any]]]]:
    """Build (init_fn, step_fn).

    loss_fn(params, batch, generator) -> scalar loss, where params maps the
    parameter names to tensors in the compute dtype (call the model through
    `torch.func.functional_call`) and the generator draws dropout.
    optimizer: a `torch.optim` factory, called with the list of f32 masters,
    or a `GroupedOptimizer` (needed for bf16 storage or gradients).

    init_fn(params, round_seed=0) -> TrainState.  params: name -> tensor;
    pass the model's own parameters (`dict(model.named_parameters())`) so
    that each update shows in the model.  With a low-precision
    `param_dtype` it casts them in place (the f32 storage is freed) and
    seeds the rounding generator with `round_seed`.
    step_fn(state, batch, generator=None, round_bits=None) -> (state,
    metrics).  batch: a dict of tensors with leading size grad_accum *
    micro-batch.  round_bits: name -> integers in [0, 65536) of the leaf's
    shape, the stochastic rounding's bits in place of the generator's.
    metrics: `loss` and `grad_norm` (0-d tensors, not synced), `skipped` (0
    or 1) when the step is guarded, and `loss_scale` when scaling is on.

    mesh: a (dp, fsdp, tp, sp, pp) DeviceMesh (`parallel/mesh.make_mesh`) over the
    initialised process group, by default the one `parallel/mesh.
    mesh_context` publishes (`active_mesh()`); the step is then sharded
    (`parallel/sharding.MeshPlan`), which takes a grouped optimizer.
    `paths` maps each parameter name to its JAX path (`weights.
    dalle_param_paths`), under which `registry` (default the default
    rules) places it; without it the names are the paths.  init_fn then
    takes every rank's same full parameters and keeps this rank's pieces;
    step_fn takes this rank's rows of the global batch
    (`step_fn.local_batch`), and `step_fn.full_state` (the one-process
    state, on rank 0 alone), `full_template`, `load_opt_state` and
    `resident_bytes` serve checkpoints and memory checks.  `module`: the
    model the loss runs; ZeRO-3 needs it, to gather one layer's
    parameters at a time (`sharding.Zero3Units`), and sp and pp read its
    config (`seq_shard_axis`, `pipeline_axis`) and a pipeline its
    layers.  Without a mesh the ZeRO stage changes nothing, as in the JAX
    package."""
    if settings.grad_accum < 1:
        raise ValueError("grad_accum must be >= 1")
    mesh = active_mesh() if mesh is None else mesh
    param_dtype = settings.param_dtype
    lowp = param_dtype is not None and param_dtype.itemsize < 4
    sr = settings.stochastic_round if settings.stochastic_round is not None else lowp
    if param_dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"param_dtype {param_dtype} not supported: float32, or bfloat16 for low-precision "
                         "storage (stochastic rounding)")
    if settings.stochastic_round and not lowp:
        raise ValueError(f"stochastic_round=True requires a low-precision param_dtype (got param_dtype={param_dtype})")
    if settings.grad_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"grad_dtype {settings.grad_dtype} not supported: float32 or bfloat16")
    grouped = isinstance(optimizer, GroupedOptimizer)
    if plateau is not None and not grouped:
        raise ValueError("reduce-on-plateau scales the optimizer's update, as optax's chain does: it takes a "
                         "grouped optimizer (optim.grouped.Adam), whose update comes back as a tensor")
    if not grouped and (lowp or settings.grad_dtype != torch.float32):
        raise ValueError("bf16 parameters or gradients take a grouped optimizer (optim.grouped.Adam, "
                         "optim.adafactor.Adafactor): torch.optim writes each parameter with its own rounding")

    if mesh is not None and not grouped:
        raise ValueError("the sharded step takes a grouped optimizer (optim.grouped.Adam, optim.adafactor."
                         "Adafactor): it updates this rank's pieces of the parameters")

    ls_enabled = settings.loss_scale is not None
    ls_dynamic = settings.loss_scale == "dynamic"
    guarded = ls_enabled or settings.skip_nonfinite is not False
    compute_dtype, grad_dtype = settings.compute_dtype, settings.grad_dtype
    plan: Optional[sharding.MeshPlan] = None

    def init_fn(params: Params, round_seed: int = 0) -> TrainState:
        for name, p in params.items():
            if not p.is_leaf or not p.is_floating_point():
                raise ValueError(f"parameter {name} must be a floating leaf tensor")
            if not grouped and p.dtype != torch.float32:
                raise ValueError(f"master parameter {name} must be f32, got {p.dtype}")
        ls = None
        if ls_enabled:
            ls = {"loss_scale": LS_INIT_DYNAMIC if ls_dynamic else float(settings.loss_scale),
                  "good_steps": 0}
        if not grouped:
            for p in params.values():
                p.requires_grad_(True)
            return TrainState(0, params, optimizer(list(params.values())), ls)
        nonlocal plan
        with torch.no_grad():
            for p in params.values():
                if param_dtype is not None and p.dtype != param_dtype:
                    p.data = p.data.to(param_dtype)
        gen = None
        device = next(iter(params.values())).device
        if lowp and sr:
            gen = torch.Generator(device=device).manual_seed(round_seed)
        if mesh is None:
            opt_state = optimizer.init(params)
        else:
            plan = sharding.MeshPlan(mesh, params, settings.zero_stage, paths, registry,
                                     elementwise=getattr(optimizer, "elementwise", False), module=module)
            opt_state = optimizer.init(plan.place(params))
        return TrainState(0, params, opt_state, ls, gen, None if plateau is None else plateau.init(device))

    def master_grads(state: TrainState, micro, scale, generator) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """torch.optim: the loss on a working copy cast inside the graph,
        the gradients accumulated on the f32 masters' `.grad`."""
        masters = list(state.params.values())
        for p in masters:
            p.grad = None
        loss_sum = None
        for mb in micro:
            work = state.params if compute_dtype == torch.float32 else {
                name: p.to(compute_dtype) for name, p in state.params.items()}
            loss = loss_fn(work, mb, generator)
            (loss if scale is None else loss * scale).backward()
            loss = loss.detach().float()
            loss_sum = loss if loss_sum is None else loss_sum + loss
        grads = []
        for p in masters:
            if p.grad is None:  # a parameter the loss does not reach: a zero gradient
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
        mean = (1.0 if scale is None else 1.0 / scale) / len(micro)
        if mean != 1.0:
            for g in grads:
                g.mul_(mean)
        return grads, loss_sum / len(micro)

    def leaf_grads(state: TrainState, micro, scale, generator) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """Grouped: the gradients with respect to a compute-dtype copy of
        the parameters (detached leaves; on a mesh, this rank's at-rest
        pieces, and the loss run under `MeshPlan.context`, which gathers
        ZeRO-3's shards around their use), cast to `grad_dtype`; more than
        one micro-batch accumulates in f32."""
        work = {name: p.detach().to(compute_dtype).requires_grad_(True) for name, p in state.params.items()}
        leaves = list(work.values())
        acc, loss_sum = None, None
        for mb in micro:
            # the backward too: remat and reversible execution run layers again in it
            with contextlib.nullcontext() if plan is None else plan.context(next(iter(mb.values())).shape[0]):
                loss = loss_fn(work if plan is None else plan.loss_params(work), mb, generator)
                (loss if scale is None else loss * scale).backward()
            loss = loss.detach().float()
            loss_sum = loss if loss_sum is None else loss_sum + loss
            grads = [torch.zeros_like(w) if w.grad is None else w.grad for w in leaves]
            for w in leaves:
                w.grad = None
            if len(micro) > 1:
                acc = [g.float() for g in grads] if acc is None else [a.add_(g) for a, g in zip(acc, grads)]
        inv = None if scale is None else 1.0 / scale
        if len(micro) == 1:
            if inv is not None:
                grads = [(g.float() * inv).to(g.dtype) for g in grads]
            return [g.to(grad_dtype) for g in grads], loss_sum
        mean = (1.0 if inv is None else inv) / len(micro)
        return [(a * mean).to(grad_dtype) for a in acc], loss_sum / len(micro)

    def grouped_update(state: TrainState, grads: List[torch.Tensor], round_bits=None,
                       loss: Optional[torch.Tensor] = None) -> None:
        """One group at a time (`GroupedOptimizer.step_groups`): the
        optimizer's f32 update (times the plateau's scale, which reads
        `loss` first) added to the f32 parameters, the sum rounded back to
        the storage dtype and written into the parameters."""
        if plateau is not None:
            plateau.update(state.plateau, loss)

        targets = state.params if plan is None else plan.update_targets(state.params)

        def write(names, p32, u32):
            params = [targets[n] for n in names]
            if plateau is not None:
                u32 = u32 * state.plateau.scale
            new = p32.add_(u32)
            if lowp and sr:
                bits = None if round_bits is None else torch.stack(
                    [(round_bits[n] if plan is None else plan.piece(n, round_bits[n], full_piece=plan.full_update))
                     .to(device=new.device, dtype=torch.int32) for n in names])
                new = stochastic_round(new, bits, state.round_generator)
            elif new.dtype != params[0].dtype:
                new = new.to(params[0].dtype)
            torch._foreach_copy_(params, list(new.unbind(0)))

        with torch.no_grad():
            if plan is None:
                optimizer.step_groups(state.opt_state, dict(zip(state.params, grads)), state.params, write)
            else:
                params, grads_in = plan.update_inputs(state.params, dict(zip(state.params, grads)))
                optimizer.step_groups(state.opt_state, grads_in, params, write)
                plan.finish_update(state.params, targets)

    def step_fn(state: TrainState, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None, with_health: bool = False,
                round_bits: Optional[Dict[str, torch.Tensor]] = None):
        if with_health:
            raise _later("the with_health diagnostic step")
        scale = state.loss_scale["loss_scale"] if ls_enabled else None
        micro = _micro_batches(batch, settings.grad_accum)
        grads, loss = (leaf_grads if grouped else master_grads)(state, micro, scale, generator)
        if plan is not None:
            # the global batch's mean loss and gradients (each data rank's
            # from its sp and pp ranks' parts); the norm over the pieces,
            # each replicated leaf counted once
            loss = plan.mean_over_data(plan.loss_of_model_axes(loss))
            grads = plan.reduce_grads(list(state.params), plan.reduce_model_axes(list(state.params), grads),
                                      grad_dtype)
            gnorm = plan.global_norm(list(state.params), grads)
        else:
            gnorm = _global_norm(grads)
        if settings.clip_grad_norm is not None:
            # NaN propagates through the factor, so a poisoned norm stays poisoned
            factor = torch.clamp(settings.clip_grad_norm / (gnorm + 1e-6), max=1.0)
            for g in grads:
                g.mul_(factor.to(g.dtype))
            gnorm = gnorm * factor  # the metric reports the applied norm

        if grouped:
            def update():
                grouped_update(state, grads, round_bits, loss)
        else:
            update = state.opt_state.step
        metrics: Dict[str, Any] = {"loss": loss, "grad_norm": gnorm}
        if guarded:
            finite = bool(torch.isfinite(gnorm))
            nonfinite_guard(update, finite)
            metrics["skipped"] = int(not finite)
        else:
            finite = True
            update()
        if not grouped:
            for p in state.params.values():
                p.grad = None

        new_ls = state.loss_scale
        if ls_dynamic:
            good = state.loss_scale["good_steps"] + 1 if finite else 0
            cur = state.loss_scale["loss_scale"]
            if not finite:
                cur = max(cur * 0.5, 1.0)
            elif good >= LS_GROWTH_INTERVAL:
                cur, good = min(cur * 2.0, LS_MAX), 0
            new_ls = {"loss_scale": cur, "good_steps": good}
        if ls_enabled:
            metrics["loss_scale"] = new_ls["loss_scale"]
        return dataclasses.replace(state, step=state.step + 1, loss_scale=new_ls), metrics

    if grouped and mesh is None:
        # the update alone, (state, gradients in parameter order, round_bits)
        # -> None, for a profile that separates it from the step
        step_fn.apply_update = grouped_update
    if mesh is not None:
        step_fn.plan = lambda: plan
        step_fn.local_batch = lambda batch: plan.local_batch(batch, settings.grad_accum)
        step_fn.full_state = lambda state: plan.full_state(state)
        step_fn.full_template = lambda state: plan.full_template(state)
        step_fn.load_opt_state = lambda state, full: plan.load_opt_state(state, full)
        step_fn.resident_bytes = lambda state: plan.resident_bytes(state)
    return init_fn, step_fn
