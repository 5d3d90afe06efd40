"""The bad-step guard and the serving engine's fault drills (counterpart of
part of `dalle_pytorch_tpu/training/resilience.py`).

`nonfinite_guard`: a poisoned gradient skips the optimizer update instead
of writing NaN into the parameters and the optimizer's moments.  The JAX
package decides inside the compiled step with `lax.cond`; PyTorch runs
eagerly, so the guard reads the flag on the host, one device sync per step.

`parse_fault`, `FaultInjector`, `take_poison_fault`, `take_flood_fault`:
`--inject_fault poison-request@N` and `flood@N:COUNT` for the serving
engine.  The other kinds wait for the fleet (ROADMAP.md Queue 1 item 6) and
for the training loop's resilience (item 8).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import torch


def nonfinite_guard(update_fn: Callable[[], None], finite: Union[bool, torch.Tensor]) -> bool:
    """Run `update_fn()` (the optimizer update) only when `finite` holds,
    for example `isfinite(grad_norm)`; otherwise leave parameters and
    moments untouched.  Returns whether the update ran."""
    if not bool(finite):
        return False
    update_fn()
    return True


# ---------------------------------------------------------------------------
# fault injection: the serving engine's two drills
# ---------------------------------------------------------------------------

# the JAX package's fault kinds; the port runs the engine's two drills and
# names the ROADMAP.md item that brings each of the others
FAULT_KINDS = ("kill-process", "preempt", "corrupt-checkpoint", "truncate-checkpoint", "stall-data",
               "drop-remote-stream", "oom", "shrink", "grow", "flood", "kill-replica", "kill-fleet",
               "stall-replica", "poison-request")
ENGINE_FAULTS = ("flood", "poison-request")
_FLEET_FAULTS = ("kill-replica", "kill-fleet", "stall-replica")


@dataclasses.dataclass(frozen=True)
class Fault:
    """`kind` at engine iteration `step`; `count` is flood's burst size."""

    kind: str
    step: int
    count: int = 0


def parse_fault(spec: str) -> Fault:
    """`KIND@STEP`, STEP 0 when left out; `flood@STEP:COUNT` (COUNT 32 when
    left out).  An unknown kind raises ValueError; a kind the port does not
    run yet exits naming the ROADMAP.md item that brings it: item 6 for the
    fleet's, item 8 for the training loop's."""
    kind, _, at = spec.partition("@")
    if kind not in FAULT_KINDS:
        raise ValueError(f"unknown fault kind {kind!r}; choose from {', '.join(FAULT_KINDS)}")
    if kind not in ENGINE_FAULTS:
        item = 6 if kind in _FLEET_FAULTS else 8
        raise SystemExit(f"--inject_fault: the {kind} drill is not ported yet (ROADMAP.md Queue 1 item {item})")
    count = 32 if kind == "flood" else 0
    if ":" in at:
        at, _, number = at.partition(":")
        count = int(number)
    return Fault(kind, int(at or 0), count)


_ACTIVE_INJECTOR: Optional["FaultInjector"] = None


class FaultInjector:
    """The process's armed fault (`--inject_fault`); it fires at most once.
    The engine polls `take_flood_fault` and `take_poison_fault` with its
    iteration count."""

    def __init__(self, fault: Fault):
        self.fault = fault
        self.fired = False

    def install(self) -> "FaultInjector":
        global _ACTIVE_INJECTOR
        _ACTIVE_INJECTOR = self
        return self

    def uninstall(self) -> None:
        global _ACTIVE_INJECTOR
        if _ACTIVE_INJECTOR is self:
            _ACTIVE_INJECTOR = None


def _take(kind: str, step: int) -> Optional[Fault]:
    inj = _ACTIVE_INJECTOR
    if inj is not None and not inj.fired and inj.fault.kind == kind and step >= inj.fault.step:
        inj.fired = True
        return inj.fault
    return None


def take_poison_fault(step: int) -> bool:
    """True once, when a `poison-request` fault is armed and the engine's
    iteration count reaches its step: the engine then makes one in-flight
    request's logits NaN until it is quarantined."""
    return _take("poison-request", step) is not None


def take_flood_fault(step: int) -> int:
    """The burst size, once, when a `flood` fault is armed and the engine's
    iteration count reaches its step (0 otherwise): the engine submits that
    many synthetic requests, which it must queue or refuse."""
    fault = _take("flood", step)
    return 0 if fault is None else fault.count
