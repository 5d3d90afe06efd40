"""The process's metrics registry (counterpart of
`dalle_pytorch_tpu/observability/metrics.py`): counters, gauges and
histograms under names, created on first use and read by the serve report,
the SLO monitor and the tests.

Serving code publishes through the module-level `counter`, `gauge` and
`histogram` under the JAX package's names (`serving/refused`,
`router/shed`, `journal/duplicate_acks`, ...).  One lock guards every
instrument; `MetricsRegistry.snapshot` holds it and reads the instruments
through their unlocked cores (a histogram's percentiles included), since
the lock does not re-enter.  The registry lives as long as the process:
tests reset it (`REGISTRY.reset()`) in a fixture.
"""
from __future__ import annotations

import math
import threading
from typing import Any, Dict, Optional


class Counter:
    """A running total; a snapshot gives it and the change since the last
    windowed snapshot."""

    __slots__ = ("name", "_value", "_last_flush", "_lock")

    def __init__(self, name: str, lock: threading.Lock):
        self.name = name
        self._value = 0.0
        self._last_flush = 0.0
        self._lock = lock

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value

    def _snapshot(self, reset_window: bool) -> Dict[str, float]:
        delta = self._value - self._last_flush
        if reset_window:
            self._last_flush = self._value
        return {"total": self._value, "delta": delta}


class Gauge:
    """A value at a point in time; a snapshot gives it and the window's
    largest."""

    __slots__ = ("name", "_value", "_max", "_lock")

    def __init__(self, name: str, lock: threading.Lock):
        self.name = name
        self._value = None
        self._max = None
        self._lock = lock

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)
            if self._max is None or v > self._max:
                self._max = float(v)

    @property
    def value(self):
        return self._value

    def _snapshot(self, reset_window: bool) -> Dict[str, Any]:
        out = {"last": self._value, "max": self._max}
        if reset_window:
            self._max = self._value
        return out


def bucket_percentile(buckets: Dict[int, int], count: float, q: float, lo_clamp: Optional[float] = None,
                      hi_clamp: Optional[float] = None) -> Optional[float]:
    """The q-quantile (q in [0, 1]) from log2 buckets (bucket i holds
    values in [2^(i-1), 2^i)): the bucket of the q·count-th sample,
    interpolated linearly inside its range and clamped to the observed
    extremes when given.  Off by at most the bucket's width, a factor 2."""
    if not count:
        return None
    target = q * count
    cum = 0
    for b, c in sorted(buckets.items()):
        if cum + c >= target:
            lo = 0.0 if b <= -1074 else 2.0 ** (b - 1)
            hi = 2.0 ** b
            val = lo + (hi - lo) * (target - cum) / c
            if lo_clamp is not None:
                val = max(val, lo_clamp)
            if hi_clamp is not None:
                val = min(val, hi_clamp)
            return val
        cum += c
    return hi_clamp


class Histogram:
    """A distribution kept as count, total, extremes and log2 bucket
    counts: enough for latency percentiles without keeping samples."""

    __slots__ = ("name", "count", "total", "min", "max", "_buckets", "_lock")

    def __init__(self, name: str, lock: threading.Lock):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.min = None
        self.max = None
        self._buckets: Dict[int, int] = {}
        self._lock = lock

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.total += v
            if self.min is None or v < self.min:
                self.min = v
            if self.max is None or v > self.max:
                self.max = v
            b = -1074 if v <= 0 else int(math.ceil(math.log2(v)))
            self._buckets[b] = self._buckets.get(b, 0) + 1

    @property
    def mean(self) -> Optional[float]:
        return self.total / self.count if self.count else None

    def percentile(self, q: float) -> Optional[float]:
        """The q-quantile over every observation so far."""
        with self._lock:
            return self._percentile(q)

    def _percentile(self, q: float) -> Optional[float]:
        return bucket_percentile(self._buckets, self.count, q, lo_clamp=self.min, hi_clamp=self.max)

    def state(self) -> Dict[str, Any]:
        """The cumulative state a `HistogramWindow` subtracts: count,
        total, extremes and a copy of the buckets."""
        with self._lock:
            return {"count": self.count, "total": self.total, "min": self.min, "max": self.max,
                    "buckets": dict(self._buckets)}

    def _snapshot(self, reset_window: bool) -> Dict[str, Any]:
        # the caller holds the lock: the unlocked core, never percentile()
        return {"count": self.count, "total": self.total, "mean": self.mean, "min": self.min, "max": self.max,
                "p50": self._percentile(0.5), "p95": self._percentile(0.95), "p99": self._percentile(0.99),
                "log2_buckets": {str(k): v for k, v in sorted(self._buckets.items())}}


class HistogramWindow:
    """Percentiles of the observations a histogram took since the previous
    `advance()`, kept apart from the registry's windows: each advance
    subtracts the previous cumulative buckets from the current ones (they
    only grow, so an observation lands in exactly one window)."""

    __slots__ = ("hist", "_prev")

    def __init__(self, hist: Histogram):
        self.hist = hist
        self._prev = hist.state()

    def advance(self) -> Dict[str, Any]:
        cur = self.hist.state()
        prev, self._prev = self._prev, cur
        count = cur["count"] - prev["count"]
        total = cur["total"] - prev["total"]
        buckets = {}
        for b, c in cur["buckets"].items():
            d = c - prev["buckets"].get(b, 0)
            if d > 0:
                buckets[b] = d
        # the cumulative extremes bound the window's, so they still clamp
        out = {"count": count, "total": total, "mean": total / count if count else None}
        for label, q in (("p50", 0.5), ("p95", 0.95), ("p99", 0.99)):
            out[label] = bucket_percentile(buckets, count, q, lo_clamp=cur["min"], hi_clamp=cur["max"])
        return out


class MetricsRegistry:
    """Named instruments, made on first use.  A name keeps its kind: asking
    for it as another kind raises TypeError."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: Dict[str, Any] = {}

    def _get(self, name: str, cls):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = self._instruments[name] = cls(name, self._lock)
            elif not isinstance(inst, cls):
                raise TypeError(f"metric {name!r} already registered as {type(inst).__name__}, "
                                f"requested {cls.__name__}")
            return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def snapshot(self, reset_window: bool = True) -> Dict[str, Dict[str, Any]]:
        """{name: {"kind", ...}} for every instrument, read under the lock
        (a window reset reads and writes, and an `inc` between would be
        lost)."""
        out = {}
        with self._lock:
            for name, inst in self._instruments.items():
                rec = inst._snapshot(reset_window)
                rec["kind"] = type(inst).__name__.lower()
                out[name] = rec
        return out

    def flush_to(self, logger, step: Optional[int] = None, reset_window: bool = True) -> Dict[str, Any]:
        """Push a snapshot through a `training.logging.MetricLogger` as one
        quiet record under the 'telemetry' key; returns the snapshot."""
        snap = self.snapshot(reset_window=reset_window)
        if logger is not None and snap:
            logger.log({"telemetry": snap}, step=step, quiet=True)
        return snap

    def reset(self) -> None:
        """Drop every instrument (tests)."""
        with self._lock:
            self._instruments.clear()


# the process's registry: instrumented code and the readers share it
REGISTRY = MetricsRegistry()


def counter(name: str) -> Counter:
    return REGISTRY.counter(name)


def gauge(name: str) -> Gauge:
    return REGISTRY.gauge(name)


def histogram(name: str) -> Histogram:
    return REGISTRY.histogram(name)
