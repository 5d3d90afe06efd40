"""Heartbeat / hang monitor (counterpart of
`dalle_pytorch_tpu/observability/heartbeat.py`).

A training process that stops making progress says nothing: blocked in a
collective another rank never entered, a wedged kernel build, a data
reader.  The monitor is a daemon thread the step loop stamps (`beat(step)`)
each completed step; if no stamp arrives within the deadline it dumps, once
per hang:

* every thread's current Python stack (where the process is actually stuck
  — a `torch.cuda.synchronize`, a queue.get, a socket read);
* the most recent completed spans (what the run was last doing);
* a metrics snapshot (queue depths, counters at time of death);
* the `torch.cuda` caching allocator's stats, where a card is in use

to a timestamped report in the telemetry directory AND to stderr, so a
hung-then-killed job leaves a post-mortem.  A later beat re-arms the
monitor (a hang that resolves produces exactly one report, not a stream)."""
from __future__ import annotations

import sys
import threading
import time
import traceback
from pathlib import Path
from typing import Any, Dict, Optional


def thread_stacks() -> str:
    """Formatted stacks of every live thread (the monitor's own excluded)."""
    me = threading.get_ident()
    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for tid, frame in sys._current_frames().items():
        if tid == me:
            continue
        out.append(f"--- thread {names.get(tid, '?')} (ident {tid}) ---")
        out.append("".join(traceback.format_stack(frame)))
    return "\n".join(out)


def allocator_stats() -> Dict[str, float]:
    """The caching allocator's headline numbers on the current card (bytes
    in use, peak, reserved, the count of failed allocations), or {} without
    one: a hang dump must not start the CUDA runtime."""
    import torch

    if not torch.cuda.is_initialized():
        return {}
    try:
        s = torch.cuda.memory_stats()
    except Exception:  # noqa: BLE001 — the dump must not fail on the allocator
        return {}
    keys = ("allocated_bytes.all.current", "allocated_bytes.all.peak", "reserved_bytes.all.current",
            "num_alloc_retries", "num_ooms")
    return {k: s[k] for k in keys if k in s}


class Heartbeat:
    def __init__(self, deadline_s: float, dir: Optional[str] = None,
                 recorder=None, registry=None, poll_s: Optional[float] = None,
                 on_hang=None, process_index: Optional[int] = None,
                 context_fn=None):
        """`recorder`: a SpanRecorder for last-span context + the JSONL hang
        event; `registry`: a MetricsRegistry for the state snapshot;
        `on_hang(report_text, info)`: optional extra callback;
        `process_index`: stamped into the dump filename and header so a
        multi-process run's hang reports triage from one shared directory
        (which hosts hung, and at which step each one stopped);
        `context_fn() -> dict`: optional live-state provider rendered into
        the dump — the serve loop wires the engine's request-phase state
        here so a wedged poll() shows which phase and which requests were
        in flight.  Assignable after construction (the engine usually
        exists only after telemetry is configured)."""
        self.deadline_s = float(deadline_s)
        self.dir = Path(dir) if dir is not None else None
        self.recorder = recorder
        self.registry = registry
        self.on_hang = on_hang
        self.process_index = process_index
        self.context_fn = context_fn
        self.hangs = 0
        self.last_report: Optional[str] = None
        self._last_beat = time.monotonic()
        self._last_step: Optional[int] = None
        self._dumped_for_current_gap = False
        self._stop = threading.Event()
        self._poll_s = poll_s if poll_s is not None else max(self.deadline_s / 4.0, 0.05)
        self._thread = threading.Thread(
            target=self._run, name="telemetry-heartbeat", daemon=True
        )

    def start(self) -> "Heartbeat":
        self._thread.start()
        return self

    def beat(self, step: Optional[int] = None):
        self._last_beat = time.monotonic()
        self._last_step = step
        self._dumped_for_current_gap = False

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=self._poll_s * 4 + 1.0)

    # -- monitor loop -------------------------------------------------------
    def _run(self):
        while not self._stop.wait(self._poll_s):
            gap = time.monotonic() - self._last_beat
            if gap > self.deadline_s and not self._dumped_for_current_gap:
                self._dumped_for_current_gap = True
                try:
                    self._dump(gap)
                except Exception:  # the monitor must never kill the process
                    traceback.print_exc()

    def _dump(self, gap: float):
        info: Dict[str, Any] = {
            "gap_s": round(gap, 3),
            "deadline_s": self.deadline_s,
            "last_step": self._last_step,
        }
        proc = ""
        if self.process_index is not None:
            info["process_index"] = self.process_index
            proc = f"; process {self.process_index}"
        lines = [
            f"=== HANG: no step completed in {gap:.1f}s "
            f"(deadline {self.deadline_s}s); last step {self._last_step}"
            f"{proc} ===",
            f"wall time: {time.strftime('%Y-%m-%d %H:%M:%S')}",
            "",
            "--- last completed spans ---",
        ]
        last = self.recorder.last_spans() if self.recorder is not None else []
        for s in last[-10:]:
            lines.append(f"  step={s.get('step')} {s.get('path')} "
                         f"dur={s.get('dur_s', 0):.4f}s")
        if not last:
            lines.append("  (none recorded)")
        if self.registry is not None:
            lines.append("")
            lines.append("--- metrics snapshot ---")
            for name, rec in sorted(self.registry.snapshot(reset_window=False).items()):
                brief = {k: v for k, v in rec.items() if k not in ("log2_buckets",)}
                lines.append(f"  {name}: {brief}")
        stats = allocator_stats()
        if stats:
            lines.append("")
            lines.append("--- torch.cuda allocator ---")
            for k, v in sorted(stats.items()):
                lines.append(f"  {k}: {v}")
        if self.context_fn is not None:
            lines.append("")
            lines.append("--- state context ---")
            try:
                ctx = self.context_fn() or {}
            except Exception as e:  # a broken provider must not eat the dump
                ctx = {"context_fn_error": repr(e)}
            for k, v in sorted(ctx.items()):
                lines.append(f"  {k}: {v}")
        lines.append("")
        lines.append("--- thread stacks ---")
        lines.append(thread_stacks())
        report = "\n".join(lines)
        self.last_report = report

        print(report, file=sys.stderr, flush=True)
        if self.dir is not None:
            self.dir.mkdir(parents=True, exist_ok=True)
            ptag = "" if self.process_index is None else f"_p{self.process_index}"
            fname = (self.dir / f"hang_{time.strftime('%Y%m%d_%H%M%S')}"
                     f"{ptag}_step{self._last_step}.txt")
            fname.write_text(report)
            info["report_path"] = str(fname)
        if self.recorder is not None:
            self.recorder.write_event("hang", **info)
        if self.on_hang is not None:
            self.on_hang(report, info)
        # incremented LAST: `hangs` is the completion signal consumers poll,
        # so the report file/JSONL event must already exist when it moves
        self.hangs += 1
