"""The serving engine's SLO monitor (counterpart of
`dalle_pytorch_tpu/observability/slo.py`).

Declared objectives (p99 TTFT, p99 latency, an images/s floor, a shed-rate
ceiling) are evaluated over windows of the metrics the engine already
publishes: each `observe()` closes a window, takes the TTFT and latency
histograms' window percentiles (`HistogramWindow`) and the completed,
refused and submitted counters' changes, and appends each objective's burn
rate (measured over target, inverted for the floor: above 1 is a breach)
to a short history.  An objective alarms when both the short window's burn
(the last `short_windows`) and the long one's (all `long_windows`) reach
`burn_threshold`; once an episode, re-armed when the short burn falls
below `rearm_frac` of the threshold.  `state_dict` carries the episodes
over a restart.  `write_status_json` is the atomic status file: tmp,
fsync, rename, then the directory's fsync.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import os
import time
from typing import Any, Callable, Deque, Dict, List, Optional

from dalle_pytorch_tpu_torch.observability import metrics as obs_metrics
from dalle_pytorch_tpu_torch.observability.metrics import HistogramWindow

# what the engine publishes
_TTFT_HIST = "serving/ttft_s"
_LATENCY_HIST = "serving/request_s"
_COMPLETED = "serving/completed"
_REFUSED = "serving/refused"
_SUBMITTED = "serving/submitted"


@dataclasses.dataclass(frozen=True)
class SloTargets:
    """The objectives; None leaves one out."""

    ttft_p99_s: Optional[float] = None
    latency_p99_s: Optional[float] = None
    images_per_sec_floor: Optional[float] = None
    shed_rate_ceiling: Optional[float] = None

    def declared(self) -> Dict[str, float]:
        return {k: v for k, v in dataclasses.asdict(self).items() if v is not None}

    def any(self) -> bool:
        return bool(self.declared())


class SloMonitor:
    """Burn rates of `targets` over windows, with episode alarms to
    `on_alarm`."""

    def __init__(self, targets: SloTargets, *, registry: Optional[obs_metrics.MetricsRegistry] = None,
                 on_alarm: Optional[Callable[[Dict[str, Any]], None]] = None, short_windows: int = 1,
                 long_windows: int = 6, burn_threshold: float = 1.0, rearm_frac: float = 0.9,
                 clock: Callable[[], float] = time.monotonic):
        if not 1 <= short_windows <= long_windows:
            raise ValueError(f"need 1 <= short_windows <= long_windows, got {short_windows}, {long_windows}")
        self.targets = targets
        self.registry = registry if registry is not None else obs_metrics.REGISTRY
        self.on_alarm = on_alarm
        self.short_windows = short_windows
        self.long_windows = long_windows
        self.burn_threshold = burn_threshold
        self.rearm_frac = rearm_frac
        self._clock = clock
        self._ttft_win = HistogramWindow(self.registry.histogram(_TTFT_HIST))
        self._lat_win = HistogramWindow(self.registry.histogram(_LATENCY_HIST))
        self._prev_counts = self._read_counts()
        self._last_t: Optional[float] = None
        self._history: Dict[str, Deque[float]] = {}
        self._alarmed: set = set()
        self.alarms_total = 0
        self.last_record: Optional[Dict[str, Any]] = None

    def _read_counts(self) -> Dict[str, float]:
        return {name: self.registry.counter(name).value for name in (_COMPLETED, _REFUSED, _SUBMITTED)}

    def _burn_history(self, name: str) -> Deque[float]:
        h = self._history.get(name)
        if h is None:
            h = self._history[name] = collections.deque(maxlen=self.long_windows)
        return h

    @property
    def burning(self) -> bool:
        """An objective's episode is open (the degrade ladder reads it)."""
        return bool(self._alarmed)

    def observe(self, iteration: int = 0) -> Dict[str, Any]:
        """Close one window: update the burn histories, fire and re-arm
        alarms.  Returns the window's record (kept as `last_record`)."""
        now = self._clock()
        elapsed = None if self._last_t is None else now - self._last_t
        self._last_t = now
        ttft = self._ttft_win.advance()
        lat = self._lat_win.advance()
        counts = self._read_counts()
        deltas = {k: counts[k] - self._prev_counts[k] for k in counts}
        self._prev_counts = counts
        arrivals = deltas[_SUBMITTED] + deltas[_REFUSED]

        # each objective's measured value; None: the window holds nothing for it
        measured: Dict[str, Optional[float]] = {}
        t = self.targets
        if t.ttft_p99_s is not None:
            measured["ttft_p99"] = ttft["p99"] if ttft["count"] else None
        if t.latency_p99_s is not None:
            measured["latency_p99"] = lat["p99"] if lat["count"] else None
        if t.images_per_sec_floor is not None:
            if elapsed and elapsed > 0 and (arrivals or deltas[_COMPLETED]):
                measured["images_per_sec"] = deltas[_COMPLETED] / elapsed
            else:
                measured["images_per_sec"] = None
        if t.shed_rate_ceiling is not None:
            measured["shed_rate"] = deltas[_REFUSED] / arrivals if arrivals else None
        target_of = {"ttft_p99": t.ttft_p99_s, "latency_p99": t.latency_p99_s,
                     "images_per_sec": t.images_per_sec_floor, "shed_rate": t.shed_rate_ceiling}
        burns: Dict[str, Dict[str, Any]] = {}
        fired: List[Dict[str, Any]] = []
        for name, m in measured.items():
            if m is None:
                continue  # an empty window neither burns nor heals
            tgt = target_of[name]
            burn = tgt / max(m, 1e-9) if name == "images_per_sec" else m / max(tgt, 1e-9)
            hist = self._burn_history(name)
            hist.append(burn)
            short = sum(list(hist)[-self.short_windows:]) / min(len(hist), self.short_windows)
            long = sum(hist) / len(hist)
            self.registry.gauge(f"slo/burn_{name}").set(burn)
            burns[name] = {"burn": burn, "short": short, "long": long, "target": tgt, "measured": m}
            if short >= self.burn_threshold and long >= self.burn_threshold:
                if name not in self._alarmed:
                    self._alarmed.add(name)
                    self.alarms_total += 1
                    self.registry.counter("slo/alarms").inc()
                    payload = {"type": "slo_burn_rate", "slo": name, "target": tgt, "measured": m,
                               "burn_short": short, "burn_long": long, "iter": iteration}
                    fired.append(payload)
                    if self.on_alarm is not None:
                        self.on_alarm(dict(payload))
            elif short < self.rearm_frac * self.burn_threshold:
                self._alarmed.discard(name)  # the episode is over
        rec = {"iter": iteration, "elapsed_s": elapsed, "ttft": ttft, "latency": lat,
               "completed": deltas[_COMPLETED], "refused": deltas[_REFUSED], "submitted": deltas[_SUBMITTED],
               "burns": burns, "active_alarms": sorted(self._alarmed), "fired": [f["slo"] for f in fired]}
        self.last_record = rec
        return rec

    def state_dict(self) -> Dict[str, Any]:
        return {"alarmed": sorted(self._alarmed), "history": {k: list(v) for k, v in self._history.items()},
                "alarms_total": self.alarms_total}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self._alarmed = set(state.get("alarmed", ()))
        self._history = {k: collections.deque(v, maxlen=self.long_windows)
                         for k, v in state.get("history", {}).items()}
        self.alarms_total = state.get("alarms_total", 0)

    def status(self) -> Dict[str, Any]:
        """The status file's payload: the targets, the cumulative
        percentiles, the last window's burns and the open episodes."""
        ttft_h = self.registry.histogram(_TTFT_HIST)
        lat_h = self.registry.histogram(_LATENCY_HIST)
        rec = self.last_record or {}
        return {
            "targets": self.targets.declared(),
            "live": {"ttft_p50_s": ttft_h.percentile(0.5), "ttft_p99_s": ttft_h.percentile(0.99),
                     "latency_p50_s": lat_h.percentile(0.5), "latency_p99_s": lat_h.percentile(0.99),
                     "completed": self.registry.counter(_COMPLETED).value,
                     "refused": self.registry.counter(_REFUSED).value,
                     "submitted": self.registry.counter(_SUBMITTED).value},
            "window": {k: rec.get(k) for k in ("iter", "elapsed_s", "completed", "refused", "submitted")},
            "burns": {k: {"short": v["short"], "long": v["long"]} for k, v in rec.get("burns", {}).items()},
            "active_alarms": sorted(self._alarmed),
            "alarms_total": self.alarms_total,
        }


def _fsync_dir(d: str) -> None:
    try:
        fd = os.open(d, os.O_RDONLY)
    except OSError:  # no directory descriptors here
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def write_status_json(path: str, payload: Dict[str, Any]) -> None:
    """Write `payload` atomically and durably: a tmp file in the same
    directory, fsynced before the rename, then the directory fsynced, so a
    reader never sees a torn or empty file."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    tmp = os.path.join(d, f".{os.path.basename(path)}.tmp")
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True, default=str)
        f.write("\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(d)
