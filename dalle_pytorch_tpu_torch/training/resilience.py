"""The bad-step guard and the serving engine's fault drills (counterpart of
part of `dalle_pytorch_tpu/training/resilience.py`).

`nonfinite_guard`: a poisoned gradient skips the optimizer update instead
of writing NaN into the parameters and the optimizer's moments.  The JAX
package decides inside the compiled step with `lax.cond`; PyTorch runs
eagerly, so the guard reads the flag on the host, one device sync per step.

`parse_fault`, `FaultInjector` and the `take_*` functions: the serving
drills.  `poison-request@N` and `flood@N:COUNT` for the engine;
`kill-replica@N[:IDX]` (drain replica IDX and requeue its work),
`kill-fleet@N` (SIGKILL of the whole process, for the journal's replay)
and `stall-replica@N[:IDX]` (wedge replica IDX, alive) for the fleet, at
its iteration N.  The training kinds wait for the training loop's
resilience (ROADMAP.md Queue 1 item 8).  `EXIT_OOM`: the out-of-memory exit
of the training and generate CLIs.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import torch

# the exit code of a run the allocator refused (JAX `resilience.EXIT_OOM`):
# the one code a supervisor must not restart, since the same config runs out
# of memory again (`observability/memory.write_oom_report` says what to change)
EXIT_OOM = 77


def nonfinite_guard(update_fn: Callable[[], None], finite: Union[bool, torch.Tensor]) -> bool:
    """Run `update_fn()` (the optimizer update) only when `finite` holds,
    for example `isfinite(grad_norm)`; otherwise leave parameters and
    moments untouched.  Returns whether the update ran."""
    if not bool(finite):
        return False
    update_fn()
    return True


# ---------------------------------------------------------------------------
# fault injection: the serving drills
# ---------------------------------------------------------------------------

# the JAX package's fault kinds; the port runs the serving drills and names
# the ROADMAP.md item that brings the training loop's
FAULT_KINDS = ("kill-process", "preempt", "corrupt-checkpoint", "truncate-checkpoint", "stall-data",
               "drop-remote-stream", "oom", "shrink", "grow", "flood", "kill-replica", "kill-fleet",
               "stall-replica", "poison-request")
ENGINE_FAULTS = ("flood", "poison-request")
FLEET_FAULTS = ("kill-replica", "kill-fleet", "stall-replica")


@dataclasses.dataclass(frozen=True)
class Fault:
    """`kind` at engine (or fleet) iteration `step`; `count` is flood's
    burst size and the replica index of kill-replica and stall-replica."""

    kind: str
    step: int
    count: int = 0


def parse_fault(spec: str) -> Fault:
    """`KIND@STEP`, STEP 0 when left out; `flood@STEP:COUNT` (COUNT 32 when
    left out); `kill-replica@STEP:IDX` and `stall-replica@STEP:IDX` (IDX 0
    when left out).  An unknown kind raises ValueError; a training kind
    exits naming ROADMAP.md Queue 1 item 8, which brings it."""
    kind, _, at = spec.partition("@")
    if kind not in FAULT_KINDS:
        raise ValueError(f"unknown fault kind {kind!r}; choose from {', '.join(FAULT_KINDS)}")
    if kind not in ENGINE_FAULTS + FLEET_FAULTS:
        raise SystemExit(f"--inject_fault: the {kind} drill is not ported yet (ROADMAP.md Queue 1 item 8)")
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


def take_kill_replica_fault(step: int) -> Optional[int]:
    """The replica index to kill, once, when a `kill-replica` fault is
    armed and the fleet's iteration count reaches its step (None
    otherwise): the fleet drains it and requeues its work on the others."""
    fault = _take("kill-replica", step)
    return None if fault is None else fault.count


def take_kill_fleet_fault(step: int) -> bool:
    """True once, when a `kill-fleet` fault is armed and the iteration
    count reaches its step: the process kills itself with SIGKILL (no
    cleanup), and the journal must let the next one replay what it held."""
    return _take("kill-fleet", step) is not None


def take_stall_replica_fault(step: int) -> Optional[int]:
    """The replica index to wedge, once, when a `stall-replica` fault is
    armed and the fleet's iteration count reaches its step: it stays alive
    but makes no progress, and the router's breaker must open."""
    fault = _take("stall-replica", step)
    return None if fault is None else fault.count
