"""The training step on one device (counterpart of the single-device branch
of `dalle_pytorch_tpu/parallel/train_step.py` `make_train_step`).

One call runs forward and backward (with gradient accumulation over
micro-batches, summed in f32), the global gradient norm, clipping, the
bad-step guard, optional loss scaling and the optimizer update, eagerly.
Master parameters and the optimizer's moments stay f32.  With
`compute_dtype=torch.bfloat16` the loss runs on a bf16 working copy cast
from the masters inside the autograd graph, so the gradients land on the f32
masters, as `cast_floating` does in the JAX package.

Meshes, ZeRO, low-precision parameter storage (stochastic rounding) and the
diagnostic `with_health` step raise `NotImplementedError`: they come with
later PRs (`ROADMAP.md`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple, Union

import torch

from dalle_pytorch_tpu_torch.training.resilience import nonfinite_guard

Params = Dict[str, torch.Tensor]
LossFn = Callable[[Params, Dict[str, torch.Tensor], Optional[torch.Generator]], torch.Tensor]

LS_INIT_DYNAMIC = 2.0 ** 15
LS_GROWTH_INTERVAL = 2000  # clean steps before a dynamic scale doubles
LS_MAX = 2.0 ** 24  # the growth ceiling, as DeepSpeed/AMP cap it


@dataclasses.dataclass
class TrainState:
    step: int
    params: Params  # f32 masters; the optimizer updates them in place
    opt_state: torch.optim.Optimizer
    # {"loss_scale": float, "good_steps": int} when loss scaling is on
    loss_scale: Optional[Dict[str, Any]] = None


@dataclasses.dataclass(frozen=True)
class StepSettings:
    grad_accum: int = 1
    compute_dtype: torch.dtype = torch.float32
    clip_grad_norm: Optional[float] = None
    zero_stage: int = 0
    # None or float32: f32 masters.  Low-precision storage waits (ROADMAP)
    param_dtype: Optional[torch.dtype] = None
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
    return torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))


def make_train_step(
    loss_fn: LossFn,
    optimizer: Callable[[List[torch.Tensor]], torch.optim.Optimizer],
    settings: StepSettings = StepSettings(),
    mesh: Any = None,
) -> Tuple[Callable[[Params], TrainState], Callable[..., Tuple[TrainState, Dict[str, Any]]]]:
    """Build (init_fn, step_fn).

    loss_fn(params, batch, generator) -> scalar loss, where params maps the
    parameter names to tensors in the compute dtype (call the model through
    `torch.func.functional_call`) and the generator draws dropout.
    optimizer(list of master tensors) -> a `torch.optim.Optimizer`, e.g.
    `functools.partial(torch.optim.Adam, lr=3e-4)`.

    init_fn(params) -> TrainState.  params: name -> f32 tensor; pass the
    model's own parameters (`dict(model.named_parameters())`) so that each
    update shows in the model.
    step_fn(state, batch, generator=None) -> (state, metrics).  batch: a
    dict of tensors with leading size grad_accum * micro-batch.  metrics:
    `loss` and `grad_norm` (0-d tensors, not synced), `skipped` (0 or 1)
    when the step is guarded, and `loss_scale` when scaling is on."""
    if mesh is not None:
        raise _later("a mesh (data, tensor or pipeline parallel training)")
    if settings.zero_stage > 0:
        raise _later(f"zero_stage={settings.zero_stage}")
    if settings.param_dtype not in (None, torch.float32):
        raise _later(f"param_dtype={settings.param_dtype} (stochastic-rounded storage)")
    if settings.grad_accum < 1:
        raise ValueError("grad_accum must be >= 1")

    ls_enabled = settings.loss_scale is not None
    ls_dynamic = settings.loss_scale == "dynamic"
    guarded = ls_enabled or settings.skip_nonfinite is not False
    compute_dtype = settings.compute_dtype

    def init_fn(params: Params) -> TrainState:
        for name, p in params.items():
            if p.dtype != torch.float32 or not p.is_leaf:
                raise ValueError(f"master parameter {name} must be an f32 leaf tensor, got {p.dtype}")
            p.requires_grad_(True)
        ls = None
        if ls_enabled:
            ls = {"loss_scale": LS_INIT_DYNAMIC if ls_dynamic else float(settings.loss_scale),
                  "good_steps": 0}
        return TrainState(0, params, optimizer(list(params.values())), ls)

    def working_copy(params: Params) -> Params:
        if compute_dtype == torch.float32:
            return params
        return {name: p.to(compute_dtype) for name, p in params.items()}

    def step_fn(state: TrainState, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None, with_health: bool = False):
        if with_health:
            raise _later("the with_health diagnostic step")
        scale = state.loss_scale["loss_scale"] if ls_enabled else None
        masters = list(state.params.values())
        for p in masters:
            p.grad = None

        micro = _micro_batches(batch, settings.grad_accum)
        loss_sum = None
        for mb in micro:
            loss = loss_fn(working_copy(state.params), mb, generator)
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
        loss = loss_sum / len(micro)

        gnorm = _global_norm(grads)
        if settings.clip_grad_norm is not None:
            # NaN propagates through the factor, so a poisoned norm stays poisoned
            factor = torch.clamp(settings.clip_grad_norm / (gnorm + 1e-6), max=1.0)
            for g in grads:
                g.mul_(factor)
            gnorm = gnorm * factor  # the metric reports the applied norm

        metrics: Dict[str, Any] = {"loss": loss, "grad_norm": gnorm}
        if guarded:
            finite = bool(torch.isfinite(gnorm))
            nonfinite_guard(state.opt_state.step, finite)
            metrics["skipped"] = int(not finite)
        else:
            finite = True
            state.opt_state.step()
        for p in masters:
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
        return TrainState(state.step + 1, state.params, state.opt_state, new_ls), metrics

    return init_fn, step_fn
