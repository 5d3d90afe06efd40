"""Telemetry facade: one object wiring spans + metrics + the card's
introspection + heartbeat, and the module-level `span()` the instrumented
code calls (counterpart of `dalle_pytorch_tpu/observability/telemetry.py`).

Lifecycle (what the training CLIs do, through `RunTelemetry`, which also
builds the profiler trigger and the headroom monitor from their flags and
turns every call into a no-op under `--telemetry off`):

    run = RunTelemetry.from_args(args, output_name, ledger, device, rank)
    with run.oom_exit(where):            # an OOM: the report, then exit 77
        for step:
            run.begin(i)
            with telemetry.span("data_wait"): batch = next(it)
            # at the first step: the count, on the meta device
            _, ratio = run.tele.crosscheck_flops(meta_step, analytic)
            with telemetry.span("dispatch"): state, m = step_fn(...)
            run.block()          # synchronise the card under the block span
            run.end(i)           # stamps the heartbeat + flushes the step record
        run.flush(logger, step=i)   # at the logging cadence
    run.close()

The FLOPs crosscheck runs the step it is given under the measured count
(`cuda.step_cost_analysis`: a step on meta tensors, which allocates and
launches nothing) and the memory crosscheck runs a real step under the
allocator's peak (`memory.step_memory_analysis`) and hands back its result.

Everything degrades gracefully: with no directory the spans stay in memory,
with no active Telemetry the module-level `span()` is a reusable
nullcontext, and instrumented library code only ever touches `span()` and
the metrics registry — it keeps working unconfigured."""
from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from dalle_pytorch_tpu_torch.observability import capture as capture_mod
from dalle_pytorch_tpu_torch.observability import memory as memory_mod
from dalle_pytorch_tpu_torch.observability import metrics as metrics_mod
from dalle_pytorch_tpu_torch.observability.cuda import (
    CompileWatcher,
    FlopsCrosscheck,
    device_memory_stats,
    record_memory_gauges,
    step_cost_analysis,
)
from dalle_pytorch_tpu_torch.observability.heartbeat import Heartbeat
from dalle_pytorch_tpu_torch.observability.spans import SpanRecorder

_NULL = contextlib.nullcontext()
_ACTIVE: Optional["Telemetry"] = None


class Telemetry:
    def __init__(
        self,
        dir: Optional[str] = None,
        run_name: str = "run",
        mirror_profiler: bool = True,
        heartbeat_s: Optional[float] = None,
        watch_compiles: bool = True,
        process_index: int = 0,
        flops_rtol: float = 0.5,
    ):
        self.dir = Path(dir) if dir is not None else None
        self.run_name = run_name
        self.process_index = process_index
        suffix = "" if process_index == 0 else f".p{process_index}"
        spans_path = (
            str(self.dir / f"{run_name}{suffix}.spans.jsonl")
            if self.dir is not None else None
        )
        self.spans = SpanRecorder(spans_path, mirror_profiler=mirror_profiler)
        self.registry = metrics_mod.REGISTRY
        # the alarm hub: every alarm (a rebuild after warm-up, flops or
        # memory drift, headroom, hang) flows through alarm() — one JSONL
        # stream, and one place for reactive listeners (the on-alarm
        # TraceTrigger)
        self._alarm_listeners: list = []
        self.compile_watcher: Optional[CompileWatcher] = None
        if watch_compiles:
            self.compile_watcher = CompileWatcher(
                on_recompile=lambda ev: self.alarm(
                    "recompile", **{k: v for k, v in ev.items() if k != "ts"}
                )
            ).start()
        self.heartbeat: Optional[Heartbeat] = None
        if heartbeat_s is not None and heartbeat_s > 0:
            self.heartbeat = Heartbeat(
                heartbeat_s,
                dir=str(self.dir) if self.dir is not None else None,
                recorder=self.spans,
                registry=self.registry,
                process_index=process_index,
                # the hang event is already written by the monitor; notify
                # the listeners only (a resolved hang captures the next steps)
                on_hang=lambda report, info: self._notify_alarm("hang", info),
            ).start()
        self._flops_check = FlopsCrosscheck(
            1.0, rtol=flops_rtol,
            on_alarm=lambda ev: self.alarm("flops_divergence", **ev),
        )
        self._mem_check = None    # memory.MemoryCrosscheck, built on first use
        self.last_memory_analysis = None  # the latest measured step — kept
        # for the OOM forensic report
        # live HBM tracking (observability/memory.HbmMonitor): fed the
        # allocator maxes record_memory_gauges samples inside flush()
        self.memory = None
        self._steps_seen = 0
        self._closed = False

    # -- alarms --------------------------------------------------------------
    def alarm(self, type: str, **fields):
        """Write one `kind: "alarm"` record and notify listeners.  Every
        alarm source routes through here so reactive consumers (the
        TraceTrigger) see the same stream the JSONL keeps."""
        self.spans.write_event("alarm", type=type, **fields)
        self._notify_alarm(type, fields)

    def _notify_alarm(self, type: str, fields):
        for fn in self._alarm_listeners:
            try:
                fn(type, fields)
            except Exception:  # listeners must never break the alarm path
                pass

    def add_alarm_listener(self, fn):
        """`fn(type: str, fields: dict)` on every alarm (any thread)."""
        self._alarm_listeners.append(fn)

    def attach_fleet(self, aggregator):
        """The fleet's cross-rank aggregation (JAX `observability/fleet.py`'s
        `FleetAggregator`) is not ported: it comes with ROADMAP.md Queue 1
        item 7."""
        raise NotImplementedError("the fleet aggregator (FleetAggregator) is not ported yet: it comes with "
                                  "ROADMAP.md Queue 1 item 7")

    def attach_memory(self, monitor):
        """Wire a memory.HbmMonitor: flush() feeds it the live allocator
        maxes, and its headroom alarms join the alarm stream (and so the
        on-alarm TraceTrigger) unless the monitor has its own sink."""
        if monitor.on_alarm is None:
            monitor.on_alarm = lambda a: self.alarm(
                a.get("type", "hbm_headroom"),
                **{k: v for k, v in a.items() if k != "type"},
            )
        self.memory = monitor
        return monitor

    # -- spans --------------------------------------------------------------
    def span(self, name: str, aggregate: bool = False, **attrs):
        return self.spans.span(name, aggregate=aggregate, **attrs)

    def begin_step(self, n: int):
        self.spans.start_step(n)

    def finish_step(self, n: int):
        """Flush the step record, stamp the heartbeat, and arm the rebuild
        counter once the first step has completed (steady state)."""
        self.spans.end_step()
        self._steps_seen += 1
        if self.heartbeat is not None:
            self.heartbeat.beat(n)
        if self._steps_seen == 1 and self.compile_watcher is not None:
            # steady state: later builds are rebuilds
            self.compile_watcher.arm()

    def abort_step(self):
        """Discard a step begun but never executed (empty data iterator)."""
        self.spans.abort_step()

    def step(self, n: int):
        """Per-step context: groups this step's spans, stamps the heartbeat,
        arms the recompile counter once the first step has completed."""
        tele = self

        class _StepCtx:
            def __enter__(self):
                tele.begin_step(n)
                return tele

            def __exit__(self, exc_type, *exc):
                if exc_type is None:
                    tele.finish_step(n)
                else:
                    tele.spans.end_step()
                return False

        return _StepCtx()

    # -- metrics ------------------------------------------------------------
    def flush(self, logger=None, step: Optional[int] = None) -> Dict[str, Any]:
        """Sample the allocator's gauges (feeding the headroom monitor when
        one is attached), snapshot the registry, and push it through the
        MetricLogger (when given) + the telemetry JSONL."""
        mem_stats = record_memory_gauges()
        if self.memory is not None:
            try:
                rec = self.memory.observe(step, mem_stats)
            except Exception:  # noqa: BLE001 — live tracking must never kill training
                rec = None
            if rec:
                self.spans.write_event("mem_window", **rec)
        snap = self.registry.flush_to(logger, step=step)
        if snap:
            self.spans.write_event("metrics", step=step, metrics=snap)
        return snap

    # -- crosschecks -----------------------------------------------------------
    def crosscheck_flops(self, fn: Callable[[], Any], analytic_flops: float,
                         label: str = "train_step") -> Tuple[Any, Optional[float]]:
        """Run the step `fn()` under the measured count
        (`cuda.step_cost_analysis`: the aten products plus the flash
        kernels' tallied work; give it the step on meta tensors) and record
        it against the analytic FLOPs; feeds the persistent-drift alarm.
        Returns (the step's result, the measured/analytic ratio)."""
        suspend = (self.compile_watcher.suspended()
                   if self.compile_watcher is not None else contextlib.nullcontext())
        with suspend:  # the tally's tables are the crosscheck's, not a rebuild
            result, ca = step_cost_analysis(fn)
        self._flops_check.analytic_flops = float(analytic_flops)
        ratio = self._flops_check.check(ca["flops"])
        self.spans.write_event(
            "flops_crosscheck", label=label, analytic_flops=float(analytic_flops),
            compiled_flops=ca["flops"], ratio=ratio, aten_flops=ca["aten_flops"],
            flash_flops=ca["flash_flops"], flash_launches=ca["flash_launches"],
        )
        return result, ratio

    def crosscheck_memory(self, fn: Callable[[], Any], ledger, argument_bytes: float,
                          label: str = "train_step", expected_donation_bytes: Optional[float] = None,
                          device: Any = None) -> Tuple[Any, Optional[float]]:
        """Run the step `fn()` and read its peak on the card
        (`memory.step_memory_analysis`; `argument_bytes`: the state's bytes)
        against the ledger's total; feeds the persistent-drift alarm
        (memory.MemoryCrosscheck) and the in-place audit, which alarms
        `donation_dropped` when the step left a second copy of the state
        (`expected_donation_bytes`, default the state's bytes).  Returns
        (the step's result, the measured/analytic ratio; None on the CPU)."""
        result, analysis = memory_mod.step_memory_analysis(fn, argument_bytes, device)
        if analysis is None:
            return result, None
        self.last_memory_analysis = analysis
        analytic_total = (ledger or {}).get("total_bytes") or 0.0
        ratio = None
        if analytic_total > 0:
            if self._mem_check is None:
                self._mem_check = memory_mod.MemoryCrosscheck(
                    analytic_total, rtol=self._flops_check.rtol,
                    on_alarm=lambda ev: self.alarm("mem_divergence", **ev),
                )
            self._mem_check.analytic_flops = analytic_total
            ratio = self._mem_check.check(analysis["total_bytes"])
        event: Dict[str, Any] = {
            "label": label, "analytic_total_bytes": analytic_total,
            "ratio": ratio, **analysis,
        }
        audit = memory_mod.audit_donation(
            analysis, argument_bytes if expected_donation_bytes is None else expected_donation_bytes)
        event["donation"] = audit
        if not audit["ok"]:
            self.alarm("donation_dropped", label=label, **audit)
        self.spans.write_event("memory_crosscheck", **event)
        return result, ratio

    def summary(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"steps": self._steps_seen}
        if self.compile_watcher is not None:
            out.update(self.compile_watcher.summary())
        if self._flops_check.last_ratio is not None:
            out["flops_ratio"] = round(self._flops_check.last_ratio, 4)
        return out

    def close(self):
        if self._closed:
            return
        self._closed = True
        if self.heartbeat is not None:
            self.heartbeat.stop()
        if self.compile_watcher is not None:
            self.spans.write_event("compile_summary", **self.compile_watcher.summary())
            self.compile_watcher.stop()
        self.spans.write_event("run_end", ts_end=time.time())
        self.spans.close()
        global _ACTIVE
        if _ACTIVE is self:
            _ACTIVE = None


# --- module-level plumbing ---------------------------------------------------

def configure(dir: Optional[str] = None, run_name: str = "run", **kwargs) -> "Telemetry":
    """Create + install the process-wide Telemetry (closing any previous)."""
    global _ACTIVE
    if _ACTIVE is not None:
        _ACTIVE.close()
    _ACTIVE = Telemetry(dir=dir, run_name=run_name, **kwargs)
    return _ACTIVE


def active() -> Optional[Telemetry]:
    return _ACTIVE


def span(name: str, aggregate: bool = False, **attrs):
    """Span on the active Telemetry; a reusable no-op when none is
    configured — library code can instrument unconditionally."""
    tele = _ACTIVE
    if tele is None:
        return _NULL
    return tele.spans.span(name, aggregate=aggregate, **attrs)


# --- the training CLIs' wiring -------------------------------------------------

@contextlib.contextmanager
def oom_exit(dir: str, where: Dict[str, Any], device: Any = None, settings: Any = None,
             process_index: int = 0, analysis: Callable[[], Any] = lambda: None, advice: str = ""):
    """Around a CLI's work: an out-of-memory error anywhere in it writes
    `oom_report_<phase>_*.txt` under `dir` (`where`'s "ledger", "phase" and
    "context", which the body keeps current; the last measured step,
    `analysis()`; the allocator's stats and summary; ranked suggestions),
    then exits `resilience.EXIT_OOM`, the code a supervisor must not restart
    (the same config runs out of memory again).  Any other error passes."""
    from dalle_pytorch_tpu_torch.training.resilience import EXIT_OOM

    try:
        yield where
    except Exception as e:
        if not memory_mod.is_oom_error(e):
            raise
        phase = where.get("phase", "run")
        path = memory_mod.write_oom_report(
            dir, error=e, phase=phase, ledger=where.get("ledger"), analysis=analysis(),
            live_stats=device_memory_stats(device), context=where.get("context"), settings=settings,
            process_index=process_index)
        print(f"[memory] OUT OF MEMORY during {phase}: forensic report -> {path or '<unwritable>'}; exiting with "
              f"code {EXIT_OOM} ({advice or 'do not auto-restart this config'})", flush=True)
        e.__traceback__ = None  # the failed step's tensors go with its frames, not with the report
        raise SystemExit(EXIT_OOM)


class RunTelemetry:
    """A training CLI's telemetry, built from its flags (`from_args`): the
    hub (`Telemetry`), the profiler trigger (`--profile_on_alarm`,
    `--profile_steps`, SIGUSR2) and the headroom monitor
    (`--hbm_headroom_frac`), or none of them under `--telemetry off`, when
    each per-step call does nothing."""

    def __init__(self, dir: str, tele: Optional[Telemetry] = None, capture=None, monitor=None,
                 sync_device: Any = None, process_index: int = 0, device: Any = None):
        self.dir, self.tele, self.capture, self.monitor = dir, tele, capture, monitor
        self.sync_device, self.process_index, self.device = sync_device, process_index, device

    @classmethod
    def from_args(cls, args, output_name: str, ledger: Dict[str, Any], device: Any, process_index: int = 0,
                  memory_state: Optional[Dict[str, Any]] = None) -> "RunTelemetry":
        """The CLI flags' telemetry (`--telemetry`, `--telemetry_heartbeat_s`,
        `--telemetry_sync`, `--profile_on_alarm`, `--profile_steps`,
        `--hbm_headroom_frac`), with the run's HBM `ledger` published (the
        gauges and a `mem_ledger` event) and the headroom monitor's
        `memory_state` restored from a checkpoint.  The directory is
        `--telemetry DIR`, else `<output>.telemetry`, where `--telemetry
        off` writes only an OOM report."""
        dir = args.telemetry if args.telemetry not in (None, "off") else f"{output_name}.telemetry"
        if args.telemetry == "off":
            return cls(dir, process_index=process_index, device=device)
        tele = configure(dir=dir, run_name=Path(output_name).name, heartbeat_s=args.telemetry_heartbeat_s or None,
                         process_index=process_index)
        manual = capture_mod.parse_profile_steps(args.profile_steps) if args.profile_steps else None
        capture = None
        if args.profile_on_alarm or manual is not None:
            capture = capture_mod.TraceTrigger(dir=str(Path(dir) / "traces"), window_steps=args.profile_on_alarm or 1,
                                               manual_window=manual, recorder=tele.spans,
                                               process_index=process_index).install_sigusr2()
            if args.profile_on_alarm:
                tele.add_alarm_listener(capture.on_alarm)
        monitor = None
        if args.hbm_headroom_frac:
            monitor = tele.attach_memory(memory_mod.HbmMonitor(headroom_frac=args.hbm_headroom_frac, device=device))
            monitor.load_state_dict(memory_state)
        sync = device if args.telemetry_sync and torch.device(device).type == "cuda" else None
        run = cls(dir, tele, capture, monitor, sync, process_index, device)
        run.publish_ledger(ledger)
        return run

    def publish_ledger(self, ledger: Dict[str, Any]) -> None:
        """The ledger's gauges and a `mem_ledger` event."""
        if self.tele is not None:
            memory_mod.publish_gauges(ledger, metrics_mod.REGISTRY)
            self.tele.spans.write_event("mem_ledger", **ledger)

    def oom_exit(self, where: Dict[str, Any], settings: Any = None):
        """`oom_exit` into this run's directory, with its last measured step."""
        return oom_exit(self.dir, where, device=self.device, settings=settings, process_index=self.process_index,
                        analysis=lambda: getattr(self.tele, "last_memory_analysis", None))

    # -- the step loop ---------------------------------------------------------
    def begin(self, n: int) -> None:
        if self.tele is not None:
            self.tele.begin_step(n)
        if self.capture is not None:
            self.capture.on_step_start(n)

    def abort(self) -> None:
        """The step begun at a data wait that found the epoch's end."""
        if self.tele is not None:
            self.tele.abort_step()

    def block(self) -> None:
        """Under `--telemetry_sync 1`, wait for the card under the `block`
        span, so that a step's time splits into data_wait / dispatch /
        block."""
        if self.sync_device is not None:
            with span("block"):
                torch.cuda.synchronize(self.sync_device)

    def end(self, n: int) -> None:
        if self.capture is not None:
            self.capture.on_step_end(n)
        if self.tele is not None:
            self.tele.finish_step(n)

    def flush(self, logger, step: int) -> None:
        if self.tele is not None:
            self.tele.flush(logger, step=step)

    def close(self) -> None:
        """Stop an in-flight trace (restoring SIGUSR2) and close the hub."""
        if self.capture is not None:
            self.capture.close()
        if self.tele is not None:
            self.tele.close()

