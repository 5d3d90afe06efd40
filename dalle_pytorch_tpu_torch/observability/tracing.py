"""A request's journey id and the process's wall clock (the part of
`dalle_pytorch_tpu/observability/tracing.py` the router needs).

A logical request may take several hops: a requeue after a replica is
lost, a hedged copy beside a stalled original, a poison retry, a replay
from the journal after a crash.  Every hop carries the same payload, so
the same content uid (`serving/journal.request_uid`), which stitches them
into one journey: the router suppresses a hedged pair's second completion
by it, and the loadgen's journey percentiles group by it.

The JAX module's `emit` writes trace events into the telemetry hub.  The
port's hub (`telemetry.py`) serves the training loops; serving telemetry,
`emit` and its calls with it, waits (ROADMAP.md Queue 1 item 8), so the
serving code makes no such calls, as the JAX package with telemetry off
makes none.
"""
from __future__ import annotations

import time
from typing import Any, Optional

# monotonic -> wall, taken once so that every time this process reports
# shares one clock
_MONO_OFFSET = time.time() - time.monotonic()


def wall(monotonic_t: Optional[float]) -> Optional[float]:
    """Wall-clock seconds for a `time.monotonic()` reading of this process
    (None passes through)."""
    if monotonic_t is None:
        return None
    return monotonic_t + _MONO_OFFSET


def journey_uid(req: Any) -> str:
    """The request's journey id: its journal uid when it was journaled,
    else the same hash computed here and kept as `trace_uid`."""
    uid = getattr(req, "journal_uid", None) or getattr(req, "trace_uid", None)
    if uid is None:
        from dalle_pytorch_tpu_torch.serving.journal import request_uid

        uid = request_uid(req.text, req.seed, req.temperature, req.cond_scale)
        try:
            req.trace_uid = uid
        except AttributeError:
            pass  # a frozen carrier: the uid still returns
    return uid
