"""On-alarm profiler capture: a rate-limited `torch.profiler` window
(counterpart of `dalle_pytorch_tpu/observability/capture.py`).

A post-hoc alarm ("the allocator crossed 90 % of the card", "a kernel was
built mid-run") names the failure but not its mechanism — by the time a
human attaches a profiler the episode is usually over.  The TraceTrigger
closes that loop: any alarm on the telemetry stream *requests* a capture,
and the step loop then records the NEXT `window_steps` steps with
`torch.profiler.profile` (CPU and CUDA activities) into a Chrome trace
under `<telemetry dir>/traces/`, while the pathology is still happening.
The spans (`spans.py`) appear in it as `record_function` rows.

Three trigger paths, one mechanism:

* alarms — `Telemetry.add_alarm_listener(trigger.on_alarm)`: headroom,
  kernel builds after warm-up, FLOPs or memory drift, hang — anything routed
  through the alarm hub;
* `--profile_steps A:B` — a manual window on known step numbers (bypasses
  rate limits: the operator asked for exactly this);
* SIGUSR2 — `kill -USR2 <pid>` captures the next window on a live run.
  The handler is FLAG-ONLY (profiler state and the span file lock are not
  signal-safe), consumed by the step loop at the next step boundary.

Rate limiting is the point, not a detail: traces are tens of MB and alarms
can storm.  At most one capture per `cooldown_s` and `max_captures` per
run; requests beyond that are counted (`trace_captures_suppressed`), never
queued.

Capture start/stop happens ONLY in `on_step_start`/`on_step_end` on the
training thread — alarms fired from watcher threads just set the pending
request — so the profiler's start and stop never race the work it records.
A failed profiler start is counted and dropped, never raised into the step
loop.
"""
from __future__ import annotations

import signal
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

from dalle_pytorch_tpu_torch.observability import metrics as metrics_mod


def parse_profile_steps(spec: str) -> Tuple[int, int]:
    """`A:B` -> (A, B): capture steps A (inclusive) to B (exclusive).  A bare
    `A` captures exactly one step."""
    a, _, b = spec.partition(":")
    start = int(a)
    stop = int(b) if b else start + 1
    if stop <= start:
        raise ValueError(f"--profile_steps {spec!r}: end {stop} <= start {start}")
    return start, stop


class TraceTrigger:
    """Rate-limited profiler captures for the training loop.

    The loop calls `on_step_start(step)` before dispatch and
    `on_step_end(step)` after the step completes; alarms (any thread) call
    `request(reason)` / `on_alarm(type, fields)`; SIGUSR2 sets a flag via
    `install_sigusr2()`.  `start_fn`/`stop_fn`/`clock` are injectable for
    tests; defaults are `start_trace`/`stop_trace` below and
    `time.monotonic`."""

    def __init__(self, dir: str, window_steps: int = 3,
                 cooldown_s: float = 900.0, max_captures: int = 2,
                 manual_window: Optional[Tuple[int, int]] = None,
                 start_fn: Optional[Callable[[str], Any]] = None,
                 stop_fn: Optional[Callable[[], Any]] = None,
                 clock: Callable[[], float] = time.monotonic,
                 recorder=None, process_index: int = 0):
        self.dir = Path(dir)
        self.process_index = process_index
        self.window_steps = max(int(window_steps), 1)
        self.cooldown_s = float(cooldown_s)
        self.max_captures = int(max_captures)
        self.manual_window = manual_window
        self._start_fn = start_fn
        self._stop_fn = stop_fn
        self._clock = clock
        self._recorder = recorder
        self._lock = threading.Lock()
        self._pending: Optional[str] = None
        self._active_path: Optional[str] = None
        self._stop_after: Optional[int] = None
        self._last_capture_t: Optional[float] = None
        self._manual_done = False
        self._signal_flag = False
        self._prev_handler = None
        self._signal_installed = False
        self.captures = 0          # every capture performed (manual included)
        self.alarm_captures = 0    # the ones charged against max_captures
        self.suppressed = 0

    # -- requests (any thread; never starts the profiler itself) -------------
    def request(self, reason: str) -> bool:
        """Ask for a capture of the next window.  Returns True when armed;
        False when rate-limited (active capture, pending request, cooldown,
        or the per-run budget is spent)."""
        with self._lock:
            if self._active_path is not None or self._pending is not None:
                return self._suppress()
            if self.alarm_captures >= self.max_captures:
                return self._suppress()
            if (self._last_capture_t is not None
                    and self._clock() - self._last_capture_t < self.cooldown_s):
                return self._suppress()
            self._pending = str(reason)
            return True

    def _suppress(self) -> bool:
        self.suppressed += 1
        metrics_mod.counter("trace_captures_suppressed").inc()
        return False

    def on_alarm(self, type_: str, fields: Optional[Dict[str, Any]] = None):
        """Alarm-hub listener shape (Telemetry.add_alarm_listener)."""
        self.request(f"alarm_{type_}")

    # -- SIGUSR2 (flag-only; consumed at the next step boundary) -------------
    def install_sigusr2(self) -> "TraceTrigger":
        if threading.current_thread() is not threading.main_thread():
            return self  # signal.signal would raise; run without the hook
        if not hasattr(signal, "SIGUSR2"):  # pragma: no cover - non-POSIX
            return self

        def _on_signal(signum, frame):
            # flag-only: this can interrupt the training thread while it
            # holds the span-file or registry lock (resilience.ShutdownHandler
            # documents the same hazard) — the step loop consumes the flag
            self._signal_flag = True

        self._prev_handler = signal.signal(signal.SIGUSR2, _on_signal)
        self._signal_installed = True
        return self

    def uninstall_sigusr2(self) -> None:
        if self._signal_installed:
            signal.signal(signal.SIGUSR2, self._prev_handler)
            self._prev_handler = None
            self._signal_installed = False

    # -- step-loop hooks (training thread only) ------------------------------
    def on_step_start(self, step: int) -> None:
        if self._signal_flag:
            self._signal_flag = False
            self.request("sigusr2")
        with self._lock:
            if self._active_path is not None:
                return
            # the operator named this exact window: it bypasses the rate
            # limit and does not consume the alarm budget.  Matched as a
            # RANGE (not just the start step) so an overlapping alarm
            # capture or a resume landing mid-window still records the
            # remainder instead of silently dropping the request.
            manual = (self.manual_window is not None and not self._manual_done
                      and self.manual_window[0] <= step < self.manual_window[1])
            if manual:
                self._manual_done = True
                reason, stop_after, charge = "manual", self.manual_window[1] - 1, False
            elif self._pending is not None:
                reason, stop_after, charge = (
                    self._pending, step + self.window_steps - 1, True
                )
                self._pending = None
            else:
                return
            # process tag: co-located processes write into one directory,
            # so same-step captures of the same alarm would otherwise
            # clobber each other (the hang_*_pN / .pN.spans.jsonl discipline)
            ptag = f"_p{self.process_index}" if self.process_index else ""
            path = str(self.dir / f"trace_step{step}_{_slug(reason)}{ptag}.json")
        self._begin(path, step, reason, stop_after, charge)

    def on_step_end(self, step: int) -> None:
        with self._lock:
            if self._active_path is None or step < self._stop_after:
                return
            path, self._active_path = self._active_path, None
            self._stop_after = None
        self._finish(path, step)

    def close(self) -> None:
        """Stop an in-flight capture (end of run / preemption path)."""
        with self._lock:
            path, self._active_path = self._active_path, None
            self._stop_after = None
        if path is not None:
            self._finish(path, step=None)
        self.uninstall_sigusr2()

    # -- profiler plumbing ---------------------------------------------------
    def _begin(self, path: str, step: int, reason: str, stop_after: int,
               charge: bool = True) -> None:
        """`charge=False` (manual windows): the capture runs but neither
        spends the per-run alarm budget nor arms the cooldown — an operator
        asking for a known window must not mute the NEXT alarm's capture."""
        try:
            self.dir.mkdir(parents=True, exist_ok=True)
            (self._start_fn or start_trace)(path)
        except Exception:  # a wedged profiler must not kill training
            self._suppress()
            return
        with self._lock:
            self._active_path = path
            self._stop_after = stop_after
            self.captures += 1
            if charge:
                self._last_capture_t = self._clock()
                self.alarm_captures += 1
        metrics_mod.counter("trace_captures").inc()
        if self._recorder is not None:
            self._recorder.write_event(
                "trace_capture", action="start", step=step, reason=reason,
                path=path, window_steps=stop_after - step + 1,
            )

    def _finish(self, path: str, step: Optional[int]) -> None:
        try:
            (self._stop_fn or stop_trace)()
        except Exception:  # noqa: BLE001 — a failed export must not kill training
            pass
        if self._recorder is not None:
            self._recorder.write_event(
                "trace_capture", action="stop", step=step, path=path,
            )


_PROFILE: Dict[str, Any] = {}


def start_trace(path: str) -> None:
    """Start a `torch.profiler` window (CPU, and CUDA where a card is in
    use) whose Chrome trace `stop_trace` writes to `path`."""
    import torch

    if _PROFILE:
        raise RuntimeError(f"a profiler window is already open ({_PROFILE['path']})")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    _PROFILE.update(prof=prof, path=path)


def stop_trace() -> None:
    """Close the window `start_trace` opened and write its Chrome trace."""
    prof, path = _PROFILE.pop("prof"), _PROFILE.pop("path")
    prof.stop()
    prof.export_chrome_trace(path)


def _slug(reason: str) -> str:
    return "".join(c if c.isalnum() or c in "-_" else "_" for c in reason)[:48]
