"""Request queue and admission control for the serving engine (counterpart
of `dalle_pytorch_tpu/serving/scheduler.py`).  Host logic only.

A bounded FIFO, and an `AdmissionController` that decides each engine
iteration whether the head of the queue may enter a decode slot.  Three
gates, in order:

  1. **slots**: a free lane (two for a guided request: its [cond] and
     [null] sequences have separate KV);
  2. **pool**: free blocks for the whole sequence of every lane;
  3. **headroom**: the device's memory in use, as a fraction of its
     capacity (`torch.cuda.mem_get_info`), below `headroom_frac`; above
     it, admissions wait while something is in flight.

`screen_submit` refuses outright a request that can never be admitted (the
pool is smaller than its lanes' sequences), and the queue refuses past its
depth: `AdmissionRefused` with `kind` "never_fits" or "queue_overflow".
Refusals, deferrals and backpressure episodes are counted in the
controller's `counts` (this engine's) and in the process's metrics
registry under the JAX package's names (`serving/refused_<kind>`,
`serving/admission_deferrals`, `serving_backpressure_alarms`), which the
serve report reads.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Deque, Dict, List, Optional

import numpy as np
import torch

from dalle_pytorch_tpu_torch.observability import metrics as obs_metrics


class AdmissionRefused(RuntimeError):
    """The service refused a request outright.  `kind` is the refusal's
    class: "queue_overflow" or "never_fits"."""

    def __init__(self, reason: str, kind: str = "other"):
        super().__init__(reason)
        self.reason = reason
        self.kind = kind


@dataclasses.dataclass
class Request:
    """One generation request.  `text`: (text_seq_len,) raw token ids.  Its
    randomness is its own: `seed` seeds the request's generator, which draws
    the gumbel noise exactly as a batch-1 `sample_image_codes` call with a
    generator of that seed draws it; `noise`, (image_seq_len, total_tokens)
    float32, replaces the draws as `noise_override` does there.

    `deadline_s` (seconds from arrival) makes a request on a stalled
    replica a candidate for the router's hedge; `retries_left` bounds its
    requeue hops.  The engine stamps `phases` (queue_wait, admission,
    prefill, decode, vae_decode, evict seconds) and sets `outcome` once:
    "completed", "shed" (refused at submit), "deferred" (queued or in
    flight when the engine closed or drained) or "poisoned" (its lanes
    produced nonfinite logits past `poison_retries` re-decodes).
    `poison_victim` marks the target of the poison-request drill;
    `spec_rounds` / `spec_accepted` count the speculative rounds the request
    sat through and the codes they gave it.  `synthetic` marks a flood
    drill's request; `journal_uid` / `trace_uid` its content uid (one for
    every hop of a logical request); `replica` the engine that made this
    hop; `hedged` / `hedge_uid` a hedged pair; `degrade_rung` the rung it
    was admitted under; `replayed` a resubmission from the journal."""

    id: int
    text: np.ndarray
    seed: int
    temperature: float = 1.0
    cond_scale: float = 1.0
    noise: Optional[torch.Tensor] = None
    arrival_t: float = dataclasses.field(default_factory=time.monotonic)
    deadline_s: Optional[float] = None
    retries_left: int = 3
    synthetic: bool = False
    # engine-owned
    lanes: Optional[List[int]] = None
    codes_done: int = 0
    admitted_t: Optional[float] = None
    ttft_s: Optional[float] = None
    latency_s: Optional[float] = None
    phases: Dict[str, float] = dataclasses.field(default_factory=dict)
    deferrals: int = 0
    outcome: Optional[str] = None
    poison_retries: int = 0
    poison_victim: bool = False
    spec_rounds: int = 0
    spec_accepted: int = 0
    # the fleet's and the journal's
    journal_uid: Optional[str] = None
    trace_uid: Optional[str] = None
    replica: Optional[int] = None
    hedged: bool = False
    hedge_uid: Optional[str] = None
    degrade_rung: int = 0
    replayed: bool = False
    # results
    codes: Optional[np.ndarray] = None
    images: Optional[torch.Tensor] = None

    @property
    def guided(self) -> bool:
        return self.cond_scale != 1.0

    @property
    def lanes_needed(self) -> int:
        return 2 if self.guided else 1

    @property
    def accepted_tokens_per_step(self) -> Optional[float]:
        """Codes a speculative round gave this request on average; None
        when it ran no round."""
        return self.spec_accepted / self.spec_rounds if self.spec_rounds else None

    def deadline_frac(self, now: Optional[float] = None) -> Optional[float]:
        """The share of the deadline spent (past 1 when late); None without
        a deadline."""
        if self.deadline_s is None or self.deadline_s <= 0:
            return None
        now = time.monotonic() if now is None else now
        return (now - self.arrival_t) / self.deadline_s


class RequestQueue:
    """Bounded FIFO; `push` raises AdmissionRefused ("queue_overflow") at
    the cap."""

    def __init__(self, max_depth: int = 64):
        self.max_depth = max_depth
        self._q: Deque[Request] = collections.deque()

    def __len__(self) -> int:
        return len(self._q)

    def push(self, req: Request) -> None:
        if len(self._q) >= self.max_depth:
            raise AdmissionRefused(f"queue full ({self.max_depth} requests waiting)", kind="queue_overflow")
        self._q.append(req)
        obs_metrics.gauge("serving/queue_depth").set(len(self._q))

    def requeue(self, req: Request) -> None:
        """Put back at the head a request the engine already held (a poison
        retry), past the depth cap: refusing an accepted request would drop
        it."""
        self._q.appendleft(req)
        obs_metrics.gauge("serving/queue_depth").set(len(self._q))

    def peek(self) -> Optional[Request]:
        return self._q[0] if self._q else None

    def pop(self) -> Request:
        req = self._q.popleft()
        obs_metrics.gauge("serving/queue_depth").set(len(self._q))
        return req

    def __iter__(self):
        return iter(self._q)


def _default_usage_fn(device: Optional[torch.device] = None) -> Callable[[], Optional[float]]:
    """The device's memory in use over its capacity
    (`torch.cuda.mem_get_info`); None on the CPU."""

    def usage() -> Optional[float]:
        if device is None or device.type != "cuda":
            return None
        free, total = torch.cuda.mem_get_info(device)
        return (total - free) / total if total else None

    return usage


class AdmissionController:
    """Decides whether the head of the queue may be admitted now.
    `usage_fn` returns the memory usage fraction, or None where the device
    has no such figure (the CPU); tests inject their own."""

    def __init__(self, pool, *, headroom_frac: float = 0.92,
                 usage_fn: Optional[Callable[[], Optional[float]]] = None,
                 device: Optional[torch.device] = None):
        self.pool = pool
        self.headroom_frac = headroom_frac
        self.usage_fn = usage_fn if usage_fn is not None else _default_usage_fn(device)
        self.counts: collections.Counter = collections.Counter()
        self._alarmed = False

    def screen_submit(self, req: Request) -> None:
        """Refuse a request that could never be admitted: queueing it would
        hang its client."""
        if not self.pool.fits_ever() or req.lanes_needed * self.pool.blocks_per_seq > self.pool.num_blocks:
            raise AdmissionRefused(
                f"request needs {req.lanes_needed} x {self.pool.blocks_per_seq} blocks but the pool only has "
                f"{self.pool.num_blocks}; grow --num_blocks or shrink --block_size", kind="never_fits")

    def may_admit_ex(self, req: Request, free_lanes: int, in_flight: int = 0) -> tuple:
        """(reason, kind), kind one of "slots", "pool", "headroom"; (None,
        None) when the request may enter now.  The headroom gate applies
        only while something is in flight: an idle engine's footprint is at
        its floor, and waiting would not lower it."""
        if free_lanes < req.lanes_needed:
            return f"no free slot ({free_lanes} free, {req.lanes_needed} needed)", "slots"
        need = req.lanes_needed * self.pool.blocks_per_seq
        if self.pool.free_blocks < need:
            return f"pool exhausted ({self.pool.free_blocks} blocks free, {need} needed)", "pool"
        usage = self.usage_fn()
        if usage is not None and usage >= self.headroom_frac:
            if in_flight > 0:
                return f"HBM headroom ({usage:.2f} >= {self.headroom_frac:.2f} usage fraction)", "headroom"
            self.counts["headroom_overrides"] += 1
            obs_metrics.counter("serving/headroom_overrides").inc()
        return None, None

    def _alarm_once(self) -> None:
        """Count one backpressure episode: the first deferral or refusal
        after free flow."""
        if not self._alarmed:
            self._alarmed = True
            self.counts["backpressure_alarms"] += 1
            obs_metrics.counter("serving_backpressure_alarms").inc()

    def note_deferral(self, reason: str) -> None:
        """A queued request waited this iteration."""
        self.counts["admission_deferrals"] += 1
        obs_metrics.counter("serving/admission_deferrals").inc()
        self._alarm_once()

    def note_refusal(self, reason: str, kind: str = "other") -> None:
        """A request was shed outright."""
        self.counts["refused"] += 1
        self.counts[f"refused_{kind}"] += 1
        obs_metrics.counter(f"serving/refused_{kind}").inc()
        self._alarm_once()

    def note_flow(self) -> None:
        """An admission went through: the backpressure episode is over."""
        self._alarmed = False
