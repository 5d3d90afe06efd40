"""The router in front of the fleet's replicas (counterpart of
`dalle_pytorch_tpu/serving/router.py`): placement by live load, a circuit
breaker a replica, hedging past a deadline, and bounded requeue when a
replica is lost.

Placement scores each live replica from what its engine holds on the host
(queue fraction, busy lanes, pool occupancy, device memory in use) and
tries them best first; a replica's own admission stays the authority, and
when every replica refuses the router sheds (`router/shed`).

The breaker: a replica that has work and whose iteration count stands
still for `stall_after_s` (the stall-replica drill wedges one) opens, with
one `replica_circuit_open` alarm an episode; an open replica takes no
placement, half-opens after `probe_after_s` (ranked behind the others at a
penalty, so that a placement there is a probe, `router/breaker_probes`),
and closes when its count moves again.

Hedging: a request with a deadline on a replica whose breaker is not
closed, past `hedge_frac` of its deadline, is placed again on another
replica with the same text, seed and settings, so the same codes; the
first completion wins and the other is suppressed
(`router/hedge_duplicates`).  `mark_lost` drains a lost replica and
requeues its requests on the others within `requeue_budget_s` and each
request's `retries_left`; past them a request ends `requeue_exhausted`,
acknowledged in the journal.  Host bookkeeping only.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

from dalle_pytorch_tpu_torch.observability import metrics as obs_metrics
from dalle_pytorch_tpu_torch.serving.journal import request_uid
from dalle_pytorch_tpu_torch.serving.scheduler import AdmissionRefused, Request


@dataclasses.dataclass
class Replica:
    """One engine behind the router."""

    id: int
    engine: Any
    alive: bool = True


class _JournalStub:
    """What `RequestJournal.ack` reads of a request, for a drained export."""

    def __init__(self, uid: str):
        self.journal_uid = uid


class Router:
    """N engine replicas behind one submit; `on_alarm` takes the router's
    alarms (`replica_circuit_open`, `replica_lost`, `requeue_exhausted`)."""

    def __init__(self, engines: List[Any], on_alarm=None, *, stall_after_s: float = 1.0, probe_after_s: float = 1.0,
                 hedge_frac: float = 0.5, requeue_budget_s: float = 30.0):
        if not engines:
            raise ValueError("a router needs at least one replica")
        self.replicas = [Replica(i, e) for i, e in enumerate(engines)]
        for r in self.replicas:
            r.engine.replica_id = r.id
            r.engine.number_requests(r.id, len(engines))  # fleet-unique ids, so unseeded seeds and uids
        self.on_alarm = on_alarm
        self.alarms: List[Dict[str, Any]] = []
        self.journal = None
        self.stall_after_s = stall_after_s
        self.probe_after_s = probe_after_s
        self.hedge_frac = hedge_frac
        self.requeue_budget_s = requeue_budget_s
        now = time.monotonic()
        self._breaker: Dict[int, Dict[str, Any]] = {
            r.id: {"state": "closed", "last_iter": r.engine._iter, "last_progress_t": now, "opened_t": 0.0}
            for r in self.replicas}
        self._breaker_alarmed: set = set()
        self._hedged: set = set()  # uids with a hedged copy
        self._hedge_done: set = set()  # uids delivered once
        self._pending: List[Request] = []  # completions made while mark_lost waited for room
        obs_metrics.gauge("fleet_serving/replicas_alive").set(len(self.replicas))

    # ----------------------------------------------------------- placement
    def alive(self) -> List[Replica]:
        return [r for r in self.replicas if r.alive]

    def replica_load(self, r: Replica) -> Dict[str, Any]:
        """The placement inputs: queue depth and fraction, free and busy
        lanes, pool occupancy and free blocks, device memory in use (None
        where the device has no such figure)."""
        eng = r.engine
        try:
            usage = eng.admission.usage_fn()
        except Exception:  # a memory reading never breaks placement
            usage = None
        slots = eng.ecfg.num_slots
        return {"replica": r.id, "queue_depth": len(eng.queue),
                "queue_frac": len(eng.queue) / max(eng.queue.max_depth, 1), "free_slots": eng.free_slots,
                "slots_busy_frac": (slots - eng.free_slots) / max(slots, 1),
                "pool_used_frac": eng.pool.occupancy_frac, "pool_free_blocks": eng.pool.free_blocks,
                "hbm_usage": usage}

    @staticmethod
    def score(load: Dict[str, Any]) -> float:
        """Lower is sooner: the queue weighs most (pure waiting), then busy
        lanes and pool pressure; memory in use breaks ties."""
        return (2.0 * load["queue_frac"] + load["slots_busy_frac"] + load["pool_used_frac"]
                + 0.5 * (load["hbm_usage"] or 0.0))

    def breaker_state(self, rid: int) -> str:
        return self._breaker[rid]["state"]

    def ranked(self, exclude: Optional[int] = None) -> List[Replica]:
        """Live replicas in placement order: an open breaker's replica left
        out, a half-open one behind at a penalty of 5."""
        out = []
        for r in self.alive():
            state = self._breaker[r.id]["state"]
            if r.id == exclude or state == "open":
                continue
            out.append((self.score(self.replica_load(r)) + (5.0 if state == "half_open" else 0.0), r))
        return [r for _, r in sorted(out, key=lambda t: t[0])]

    def _place(self, blocking: bool, text, seed, temperature, cond_scale, noise, deadline_s, retries_left,
               synthetic, replayed, exclude: Optional[int] = None) -> Request:
        last: Optional[AdmissionRefused] = None
        for r in self.ranked(exclude=exclude):
            fn = r.engine.submit_when_able if blocking else r.engine.submit
            try:
                req = fn(text, seed=seed, temperature=temperature, cond_scale=cond_scale, noise=noise,
                         deadline_s=deadline_s, retries_left=retries_left, synthetic=synthetic, replayed=replayed)
            except AdmissionRefused as e:
                last = e
                continue
            obs_metrics.counter(f"router/submitted_r{r.id}").inc()
            if self._breaker[r.id]["state"] == "half_open":
                obs_metrics.counter("router/breaker_probes").inc()
            return req
        obs_metrics.counter("router/shed").inc()
        if last is not None:
            raise last
        raise AdmissionRefused("no live replicas", kind="fleet_saturated")

    def submit(self, text, seed: Optional[int] = None, temperature: float = 1.0, cond_scale: float = 1.0,
               noise=None, deadline_s=None, retries_left=None, synthetic: bool = False,
               replayed: bool = False) -> Request:
        """Place one request on the best live replica, falling through the
        ranking on refusal; every replica refusing is the router's shed,
        raised as one AdmissionRefused."""
        return self._place(False, text, seed, temperature, cond_scale, noise, deadline_s, retries_left, synthetic,
                           replayed)

    def submit_when_able(self, text, seed: Optional[int] = None, temperature: float = 1.0, cond_scale: float = 1.0,
                         noise=None, deadline_s=None, retries_left=None, synthetic: bool = False,
                         replayed: bool = False) -> Request:
        """Placement for batch callers: the best replica that could ever
        serve the request waits for room."""
        return self._place(True, text, seed, temperature, cond_scale, noise, deadline_s, retries_left, synthetic,
                           replayed)

    # ------------------------------------------------------------- serving
    @property
    def busy(self) -> bool:
        return any(r.engine.busy for r in self.alive())

    def poll(self) -> List[Request]:
        """One poll of every live replica; returns its completions, after
        those that `mark_lost` made while it waited for room."""
        done: List[Request] = []
        for r in self.alive():
            done.extend(r.engine.poll())
        self._update_breakers()
        self._hedge_stalled()
        pending, self._pending = self._pending, []
        return pending + self._dedup_completions(done)

    def _update_breakers(self) -> None:
        """closed -> open when a busy replica's iteration count stands
        still for `stall_after_s`; open -> half_open after
        `probe_after_s`; any progress (or an idle replica) closes it and
        re-arms the episode's alarm."""
        now = time.monotonic()
        for r in self.alive():
            b = self._breaker[r.id]
            it = r.engine._iter
            if it != b["last_iter"] or not r.engine.busy:
                b["last_iter"] = it
                b["last_progress_t"] = now
                if b["state"] != "closed":
                    b["state"] = "closed"
                    obs_metrics.counter("router/breaker_closed").inc()
                    self._breaker_alarmed.discard(r.id)
                continue
            if b["state"] == "closed" and now - b["last_progress_t"] >= self.stall_after_s:
                b["state"] = "open"
                b["opened_t"] = now
                obs_metrics.counter("router/breaker_open").inc()
                if r.id not in self._breaker_alarmed:
                    self._breaker_alarmed.add(r.id)
                    self._alarm({"type": "replica_circuit_open", "replica": r.id,
                                 "stalled_s": round(now - b["last_progress_t"], 3),
                                 "inflight": len(r.engine._inflight), "queued": len(r.engine.queue)})
            elif b["state"] == "open" and now - b["opened_t"] >= self.probe_after_s:
                b["state"] = "half_open"
                obs_metrics.counter("router/breaker_half_open").inc()

    def _hedge_stalled(self) -> None:
        """Place again a request with a deadline that sits on a replica
        whose breaker is not closed, once it has spent `hedge_frac` of its
        deadline: the copy has the same payload, so the same codes and uid."""
        now = time.monotonic()
        for r in self.alive():
            if self._breaker[r.id]["state"] == "closed":
                continue
            for req in list(r.engine._inflight) + list(r.engine.queue):
                frac = req.deadline_frac(now)
                if frac is None or frac < self.hedge_frac or req.hedged:
                    continue
                uid = req.journal_uid or request_uid(req.text, req.seed, req.temperature, req.cond_scale)
                try:
                    copy = self._place(False, req.text, req.seed, req.temperature, req.cond_scale, req.noise,
                                       req.deadline_s, req.retries_left, req.synthetic, False, exclude=r.id)
                except AdmissionRefused:
                    continue  # the others are full: again next poll
                req.hedged = copy.hedged = True
                req.hedge_uid = copy.hedge_uid = uid
                self._hedged.add(uid)
                obs_metrics.counter("router/hedged").inc()

    def _dedup_completions(self, done: List[Request]) -> List[Request]:
        """The first completion of a hedged pair wins; the second is
        suppressed and counted."""
        if not self._hedged:
            return done
        out: List[Request] = []
        for req in done:
            uid = req.hedge_uid or req.journal_uid
            if uid is None or uid not in self._hedged:
                out.append(req)
            elif uid in self._hedge_done:
                obs_metrics.counter("router/hedge_duplicates").inc()
            else:
                self._hedge_done.add(uid)
                out.append(req)
        return out

    def publish_gauges(self) -> None:
        for r in self.alive():
            load = self.replica_load(r)
            for key in ("queue_depth", "free_slots", "pool_free_blocks"):
                obs_metrics.gauge(f"fleet_serving/r{r.id}_{key}").set(load[key])

    # ---------------------------------------------------------- preemption
    def mark_lost(self, idx: int, reason: str = "killed") -> List[Request]:
        """Replica `idx` is lost: drain it, alarm `replica_lost` once, and
        requeue each export on the others.  A requeue that finds no room
        within `requeue_budget_s`, or whose retry budget is spent, ends
        `requeue_exhausted` (counted, acknowledged, alarmed).  While it
        waits, it polls the survivors, and the next `poll` returns what they
        completed.  Returns the requeued requests."""
        r = self.replicas[idx]
        if not r.alive:
            return []
        r.alive = False
        exports = r.engine.drain()
        survivors = self.alive()
        obs_metrics.counter("router/replicas_lost").inc()
        obs_metrics.gauge("fleet_serving/replicas_alive").set(len(survivors))
        self._alarm({"type": "replica_lost", "replica": idx, "reason": reason, "requeued": len(exports),
                     "survivors": len(survivors)})
        requeued: List[Request] = []
        exhausted = 0
        deadline = time.monotonic() + self.requeue_budget_s
        for exp in exports:
            retries = exp.get("retries_left")
            if retries is not None and retries <= 0:
                self._shed_export(exp)
                exhausted += 1
                continue
            placed = None
            while placed is None:
                try:
                    placed = self.submit(exp["text"], seed=exp["seed"], temperature=exp["temperature"],
                                         cond_scale=exp["cond_scale"], noise=exp.get("noise"),
                                         deadline_s=exp.get("deadline_s"),
                                         retries_left=None if retries is None else retries - 1,
                                         synthetic=exp.get("synthetic", False))
                except AdmissionRefused:
                    if time.monotonic() >= deadline:
                        self._shed_export(exp)
                        exhausted += 1
                        break
                    made = self.poll()  # let the survivors make room (poll hands back what was pending)
                    self._pending.extend(made)
                    time.sleep(0.005)
            if placed is not None:
                requeued.append(placed)
                obs_metrics.counter("router/requeued").inc()
        if exhausted:
            self._alarm({"type": "requeue_exhausted", "replica": idx, "shed": exhausted,
                         "requeued": len(requeued), "budget_s": self.requeue_budget_s})
        return requeued

    def _shed_export(self, exp: Dict[str, Any]) -> None:
        """A drained request the fleet could not place again: counted, and
        acknowledged in the journal so that a restart does not replay it."""
        obs_metrics.counter("router/requeue_exhausted").inc()
        if self.journal is not None:
            uid = request_uid(exp["text"], exp["seed"], exp["temperature"], exp["cond_scale"])
            self.journal.ack(_JournalStub(uid), "requeue_exhausted")

    def _alarm(self, fields: Dict[str, Any]) -> None:
        self.alarms.append(dict(fields))
        if self.on_alarm is not None:
            self.on_alarm(dict(fields))
