"""The pool flight recorder's events as live gauges (counterpart of
`dalle_pytorch_tpu/observability/pool.py`).

`PoolGauges.observe` is the `on_event` tap of
`serving/kv_pool.PoolFlightRecorder`: it takes each block event when it is
recorded (so the gauges outlive the ring's drops) and keeps what an
overcommitting admission would be sized from: block lifetimes (alloc to
free), the blocks reserved but never written (a whole-sequence reservation
against what a drained or evicted lane wrote), each request's written
footprint, and `overcommit_safe_slots`, how many requests past the
worst-case count the pool could take at a target deferral probability
under a normal fit to the footprints.  Host arithmetic on the events'
fields only.
"""
from __future__ import annotations

import collections
from statistics import NormalDist
from typing import Any, Deque, Dict, List, Optional

from dalle_pytorch_tpu_torch.observability import metrics as obs_metrics


def _pct(sorted_vals: List[float], q: float) -> Optional[float]:
    """The interpolated q-th percentile of a sorted list."""
    if not sorted_vals:
        return None
    if len(sorted_vals) == 1:
        return sorted_vals[0]
    pos = (len(sorted_vals) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(sorted_vals) - 1)
    frac = pos - lo
    return sorted_vals[lo] * (1.0 - frac) + sorted_vals[hi] * frac


def overcommit_safe_slots(footprints: List[float], num_blocks: int, worst_demand: float,
                          target_defer_prob: float = 0.05) -> Optional[int]:
    """Requests past worst-case admission (`num_blocks // worst_demand`)
    that the pool could take with probability 1 - `target_defer_prob`: the
    largest S with S·mu + z·sqrt(S)·sigma <= num_blocks under a normal fit
    to the footprints, less the worst-case count (>= 0).  None with fewer
    than two samples."""
    if len(footprints) < 2 or num_blocks <= 0 or worst_demand <= 0:
        return None
    n = len(footprints)
    mu = sum(footprints) / n
    sigma = (sum((f - mu) ** 2 for f in footprints) / (n - 1)) ** 0.5
    if mu <= 0:
        return None
    z = NormalDist().inv_cdf(max(min(1.0 - target_defer_prob, 0.9999), 0.5))
    s = 0
    while s < num_blocks:  # a request's mean footprint is at least one block
        if (s + 1) * mu + z * ((s + 1) ** 0.5) * sigma > num_blocks:
            break
        s += 1
    return max(s - int(num_blocks // worst_demand), 0)


class PoolGauges:
    """Streaming summary of the recorder's events.  Lifetimes and
    footprints keep their last `max_samples`; the open allocations are
    bounded by the pool itself."""

    def __init__(self, num_blocks: int, block_size: int, blocks_per_seq: int, target_defer_prob: float = 0.05,
                 max_samples: int = 4096):
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.blocks_per_seq = blocks_per_seq
        self.target_defer_prob = target_defer_prob
        self._open: Dict[int, Dict[str, Any]] = {}  # owner -> its alloc event
        self._req_open: Dict[Any, Dict[str, Any]] = {}  # request -> its lanes' written blocks so far
        self._lifetimes: Deque[float] = collections.deque(maxlen=max_samples)
        self._footprints: Deque[float] = collections.deque(maxlen=max_samples)
        self.allocs = 0
        self.frees = 0
        self.truncates = 0
        self.defers: Dict[str, int] = {}
        self.reserved_unused_blocks = 0
        self._freed_reserved_blocks = 0
        self._lane_sum = 0
        self._req_count = 0

    def observe(self, ev: Dict[str, Any]) -> None:
        op = ev.get("op")
        if op == "alloc":
            self.allocs += 1
            owner = ev.get("owner")
            self._open[owner] = ev
            req = ev.get("req")
            if req is not None and (owner is None or (owner & 1) == 0):
                lanes = ev.get("lanes") or 1
                self._req_open[req] = {"lanes_left": lanes, "written": 0}
                self._lane_sum += lanes
                self._req_count += 1
        elif op == "free":
            self.frees += 1
            alloc = self._open.pop(ev.get("owner"), None)
            if alloc is None:
                return  # recorded from mid-run: no lifetime to close
            life = ev.get("mono", 0.0) - alloc.get("mono", 0.0)
            if life >= 0.0:
                self._lifetimes.append(life)
            reserved = ev.get("released") or alloc.get("reserved") or 0
            written = ev.get("written")
            wrote = reserved if written is None else -(-written // self.block_size)
            self.reserved_unused_blocks += max(reserved - wrote, 0)
            self._freed_reserved_blocks += reserved
            req = alloc.get("req")
            asm = self._req_open.get(req)
            if asm is not None:
                asm["written"] += min(wrote, reserved)
                asm["lanes_left"] -= 1
                if asm["lanes_left"] <= 0:
                    self._footprints.append(asm["written"])
                    del self._req_open[req]
        elif op == "truncate":
            self.truncates += 1
        elif op == "defer":
            kind = ev.get("defer_kind") or "other"
            self.defers[kind] = self.defers.get(kind, 0) + 1

    def summary(self) -> Dict[str, Any]:
        lifetimes = sorted(self._lifetimes)
        footprints = sorted(self._footprints)
        frac = (self.reserved_unused_blocks / self._freed_reserved_blocks if self._freed_reserved_blocks else None)
        mean_lanes = self._lane_sum / self._req_count if self._req_count else 1.0
        safe = overcommit_safe_slots(list(footprints), self.num_blocks, worst_demand=mean_lanes * self.blocks_per_seq,
                                     target_defer_prob=self.target_defer_prob)
        p50, p99 = _pct(lifetimes, 50.0), _pct(lifetimes, 99.0)
        f50, f99 = _pct(footprints, 50.0), _pct(footprints, 99.0)
        return {
            "allocs": self.allocs, "frees": self.frees, "truncates": self.truncates, "open_lanes": len(self._open),
            "defer_events": dict(self.defers),
            "block_lifetime_p50_s": None if p50 is None else round(p50, 6),
            "block_lifetime_p99_s": None if p99 is None else round(p99, 6),
            "reserved_unused_blocks": self.reserved_unused_blocks,
            "reserved_unused_frac": None if frac is None else round(frac, 4),
            "footprint_blocks_p50": None if f50 is None else round(f50, 2),
            "footprint_blocks_p99": None if f99 is None else round(f99, 2),
            "overcommit_safe_slots": safe,
        }

    def publish(self, dropped: int = 0) -> Dict[str, Any]:
        """The summary, mirrored into the metrics registry's `pool/*`
        gauges."""
        s = self.summary()
        obs_metrics.gauge("pool/reserved_unused_blocks").set(s["reserved_unused_blocks"])
        for key in ("reserved_unused_frac", "block_lifetime_p50_s", "block_lifetime_p99_s", "footprint_blocks_p99",
                    "overcommit_safe_slots"):
            if s[key] is not None:
                obs_metrics.gauge(f"pool/{key}").set(s[key])
        obs_metrics.gauge("pool/recorder_dropped").set(dropped)
        return s


def aggregate_events(events, num_blocks: int, block_size: int, blocks_per_seq: int, **kw) -> Dict[str, Any]:
    """A recorded event list through a fresh `PoolGauges`: its summary."""
    g = PoolGauges(num_blocks, block_size, blocks_per_seq, **kw)
    for ev in events:
        g.observe(ev)
    return g.summary()
