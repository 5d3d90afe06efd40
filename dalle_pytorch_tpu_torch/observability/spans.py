"""Structured wall-clock spans (counterpart of
`dalle_pytorch_tpu/observability/spans.py`).

A nested span tracer for the training loop: `span("data_wait")` /
`span("dispatch")` record per-step wall-clock intervals to a JSONL file and
mirror into `torch.profiler.record_function`, so that a trace captured
around the run (`observability/capture.py`) carries the same names as rows.

Two recording modes per span:

* default — every completed span becomes its own JSONL record (the step
  loop's handful of spans per step);
* `aggregate=True` — only a (count, total_s) pair per name is kept and
  flushed with the step summary (per-sample work like image decode, which
  would otherwise write thousands of records per step).

Writes happen on step boundaries (`step(n)` context / `end_step`), never
inside a span, so the tracer adds two clock reads per span to the hot loop.
Span stacks are per-thread; the buffer is shared (lock-protected), so loader
worker threads contribute spans to the same per-step record.  The JSONL
schema is the JAX package's, so either package's report tools read either
package's files.
"""
from __future__ import annotations

import json
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

SCHEMA_VERSION = 1


class _SpanCtx:
    """Context manager for one span (re-created per entry; cheap)."""

    __slots__ = ("_rec", "name", "aggregate", "attrs", "_t0", "_ts", "_ta", "_path")

    def __init__(self, rec: "SpanRecorder", name: str, aggregate: bool, attrs: dict):
        self._rec = rec
        self.name = name
        self.aggregate = aggregate
        self.attrs = attrs

    def __enter__(self):
        stack = self._rec._stack()
        stack.append(self.name)
        self._path = "/".join(stack)
        if self._rec.mirror_profiler:
            self._ta = torch.profiler.record_function(self.name)
            self._ta.__enter__()
        else:
            self._ta = None
        self._ts = time.time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter() - self._t0
        if self._ta is not None:
            self._ta.__exit__(*exc)
        stack = self._rec._stack()
        if stack and stack[-1] == self.name:
            stack.pop()
        self._rec._record(self._path, self.name, self._ts, dur, self.aggregate, self.attrs)
        return False


class SpanRecorder:
    """Records nested spans; flushes one JSONL record per span plus one
    summary record per step.

    JSONL schema (one JSON object per line):
      {"kind": "span", "step": int|None, "name": str, "path": "step/dispatch",
       "ts": float unix, "dur_s": float, ...attrs}
      {"kind": "step", "step": int, "ts": float, "dur_s": float,
       "spans": {top-level-name: total seconds},
       "agg": {path: {"n": count, "total_s": seconds}}, ...extra}
      {"kind": "alarm" | "hang" | "meta", ...}
    """

    def __init__(self, path: Optional[str] = None, mirror_profiler: bool = True,
                 max_spans_per_step: int = 1024):
        self.path = str(path) if path is not None else None
        self.mirror_profiler = mirror_profiler
        self.max_spans_per_step = max_spans_per_step
        self._tls = threading.local()
        self._lock = threading.Lock()
        self._buffer: List[Dict[str, Any]] = []
        self._agg: Dict[str, List[float]] = {}
        self._dropped = 0
        self._step: Optional[int] = None
        self._step_ts: Optional[float] = None
        self._step_t0: Optional[float] = None
        self._last: List[Dict[str, Any]] = []  # ring of recent spans (hang dumps)
        self._file = None
        if self.path is not None:
            Path(self.path).parent.mkdir(parents=True, exist_ok=True)
            self._file = open(self.path, "a")
            self._write({"kind": "meta", "schema": SCHEMA_VERSION, "ts": time.time()})

    # -- recording ----------------------------------------------------------
    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def span(self, name: str, aggregate: bool = False, **attrs) -> _SpanCtx:
        return _SpanCtx(self, name, aggregate, attrs)

    def _record(self, path: str, name: str, ts: float, dur: float,
                aggregate: bool, attrs: dict):
        with self._lock:
            if aggregate:
                slot = self._agg.setdefault(path, [0, 0.0])
                slot[0] += 1
                slot[1] += dur
                return
            rec = {"kind": "span", "step": self._step, "name": name,
                   "path": path, "ts": ts, "dur_s": dur}
            if attrs:
                rec.update(attrs)
            if len(self._buffer) < self.max_spans_per_step:
                self._buffer.append(rec)
            else:
                self._dropped += 1
            self._last.append(rec)
            del self._last[:-32]

    # -- step boundaries ----------------------------------------------------
    def start_step(self, step: int):
        with self._lock:
            self._step = step
            self._step_ts = time.time()
            self._step_t0 = time.perf_counter()

    def end_step(self, extra: Optional[Dict[str, Any]] = None):
        """Flush buffered spans + the per-step summary record."""
        with self._lock:
            dur = (time.perf_counter() - self._step_t0) if self._step_t0 else 0.0
            buffer, self._buffer = self._buffer, []
            agg, self._agg = self._agg, {}
            dropped, self._dropped = self._dropped, 0
            step, ts = self._step, self._step_ts
            self._step = self._step_ts = self._step_t0 = None
        # top-level attribution: spans whose path has exactly one segment AND
        # that completed inside this step (spans finished before start_step —
        # e.g. the save-before-train checkpoint — carry step None and are
        # written as records but must not inflate this step's split)
        tops: Dict[str, float] = {}
        for rec in buffer:
            if "/" not in rec["path"] and rec["step"] == step:
                tops[rec["name"]] = tops.get(rec["name"], 0.0) + rec["dur_s"]
        summary: Dict[str, Any] = {
            "kind": "step", "step": step, "ts": ts, "dur_s": dur, "spans": tops,
            "agg": {k: {"n": int(n), "total_s": t} for k, (n, t) in agg.items()},
        }
        if dropped:
            summary["spans_dropped"] = dropped
        if extra:
            summary.update(extra)
        with self._lock:  # file writes serialize with write_event (heartbeat)
            for rec in buffer:
                self._write(rec)
            self._write(summary)
            if self._file is not None:
                self._file.flush()
        return summary

    def abort_step(self):
        """Drop the current step's buffered spans without writing (e.g. the
        epoch-end data_wait that only discovered the iterator was empty)."""
        with self._lock:
            self._buffer = []
            self._agg = {}
            self._dropped = 0
            self._step = self._step_ts = self._step_t0 = None

    def step(self, n: int):
        """`with recorder.step(i): ...` — start_step/end_step as a context."""
        rec = self

        class _StepCtx:
            def __enter__(self):
                rec.start_step(n)
                return rec

            def __exit__(self, *exc):
                rec.end_step()
                return False

        return _StepCtx()

    # -- out-of-band records (alarms, hang dumps) ---------------------------
    def write_event(self, kind: str, **fields):
        rec = {"kind": kind, "ts": time.time(), **fields}
        with self._lock:
            self._write(rec)
            if self._file is not None:
                self._file.flush()

    def last_spans(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._last)

    def _write(self, rec: Dict[str, Any]):
        if self._file is not None:
            self._file.write(json.dumps(rec) + "\n")

    def close(self):
        with self._lock:
            # flush spans completed after the last end_step (e.g. the final
            # checkpoint save) — closing must not drop them
            buffer, self._buffer = self._buffer, []
            for rec in buffer:
                self._write(rec)
            if self._file is not None:
                self._file.flush()
                self._file.close()
                self._file = None
