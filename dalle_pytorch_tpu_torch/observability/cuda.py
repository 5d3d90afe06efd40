"""Device-level introspection: what the port builds after warm-up, the
card's memory, and a measured count of a step's FLOPs (counterpart of
`dalle_pytorch_tpu/observability/xla.py`).

Three answers a run on the card must be able to give:

* "is it still building?" — `CompileWatcher` counts what the port builds at
  run time: a kernel library through `kernels/build.py` and the tile tables
  of a pattern at a shape it has not seen.  Anything built after `arm()`
  (the first step done) is a rebuild, counted and alarmed as the JAX
  package alarms a recompile (a ragged last batch gives the tables a new
  shape; a library built mid-run costs seconds to minutes).
* "how much of the card is in use?" — `device_memory_stats()` reads the
  caching allocator (`torch.cuda.memory_stats`, `mem_get_info`) under the
  JAX package's keys (`bytes_in_use`, `peak_bytes_in_use`, `bytes_limit`,
  ...); None on the CPU.
* "is the analytic FLOPs accounting drifting?" — `step_cost_analysis()`
  runs one step on the meta device (`meta_module`: the model's code, its
  remat recompute included, with nothing allocated and nothing launched)
  under `AtenFlops` (`torch.utils.flop_counter`'s formulas for the aten
  products: the projections, the logits, the VAE's convolutions) plus the
  flash kernels' work from `kernels.flash_attention.tally_work` (a ctypes
  launch is invisible to the counter; the wrappers' meta route records what
  the card would launch), and `FlopsCrosscheck` alarms when the
  measured/analytic ratio drifts persistently.  Counting on meta, as the
  JAX package prices its compiled step without running it, leaves every
  step on the card a plain one: its memory is what an uncounted step
  takes.
"""
from __future__ import annotations

import copy
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from dalle_pytorch_tpu_torch.kernels import build as build_mod
from dalle_pytorch_tpu_torch.observability import metrics as metrics_mod


class CompileWatcher:
    """Counts what the port builds at run time; builds after `arm()` are
    rebuilds.  It listens on `kernels.build.LISTENERS`: a kernel library
    loaded in this process (with the seconds `nvcc` took, 0 when the
    library was on disk) and pattern tables built at a (length, head dim,
    heads, causal, grid) the run has not seen.  The summary keeps the JAX
    package's keys (`compiles`, `recompiles`, `compile_time_s`), so either
    package's report reads it."""

    def __init__(self, on_recompile: Optional[Callable[[Dict[str, Any]], None]] = None,
                 max_events: int = 64):
        self._on_recompile = on_recompile
        self._active = False
        self._armed = False
        self._lock = threading.Lock()
        self._events: List[Dict[str, Any]] = []
        self._max_events = max_events
        self._seen_tables: set = set()
        self.compiles = 0
        self.recompiles = 0
        self.compile_time_s = 0.0

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "CompileWatcher":
        if not self._active:
            self._active = True
            build_mod.LISTENERS.append(self._on_build)
        return self

    def stop(self) -> None:
        self._active = False
        if self._on_build in build_mod.LISTENERS:
            build_mod.LISTENERS.remove(self._on_build)

    def arm(self) -> None:
        """Call once steady state is reached (first step done): every build
        after this is a rebuild worth alarming on."""
        self._armed = True

    @property
    def armed(self) -> bool:
        return self._armed

    def suspended(self):
        """Context: ignore builds inside (telemetry's own work must not count
        as rebuilds)."""
        watcher = self

        class _Suspend:
            def __enter__(self):
                self._was = watcher._active
                watcher._active = False

            def __exit__(self, *exc):
                watcher._active = self._was
                return False

        return _Suspend()

    # -- event path ---------------------------------------------------------
    def _on_build(self, kind: str, name: str, seconds: float) -> None:
        if not self._active:
            return
        with self._lock:
            if kind == "tables":
                if name in self._seen_tables:
                    return
                self._seen_tables.add(name)
            self.compiles += 1
            self.compile_time_s += seconds
            armed = self._armed
            if armed:
                self.recompiles += 1
            event = {"ts": time.time(), "dur_s": seconds, "name": f"{kind}:{name}",
                     "recompile": armed, "n": self.compiles}
            self._events.append(event)
            del self._events[:-self._max_events]
        metrics_mod.counter("port_builds").inc()
        metrics_mod.counter("port_build_time_s").inc(seconds)
        if armed:
            metrics_mod.counter("port_rebuilds").inc()
            if self._on_recompile is not None:
                try:
                    self._on_recompile(event)
                except Exception:  # noqa: BLE001 — a listener must not break a build
                    pass

    @property
    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def summary(self) -> Dict[str, Any]:
        return {"compiles": self.compiles, "recompiles": self.recompiles,
                "compile_time_s": round(self.compile_time_s, 3)}


def _device_index(device=None) -> Optional[int]:
    """The card `device` names (the current one by default), or None where
    no card is in use: the stats must not start the CUDA runtime."""
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return None
    if device is None:
        return torch.cuda.current_device()
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return torch.cuda.current_device() if device.index is None else device.index


def device_memory_stats(device=None) -> Optional[Dict[str, float]]:
    """The caching allocator's stats for one card under the JAX package's
    keys — bytes_in_use, peak_bytes_in_use, bytes_reserved,
    peak_bytes_reserved, bytes_limit (the card's memory), bytes_free (what
    the CUDA driver has free), num_allocs, num_ooms, num_alloc_retries — or None
    on the CPU."""
    index = _device_index(device)
    if index is None:
        return None
    s = torch.cuda.memory_stats(index)
    free, total = torch.cuda.mem_get_info(index)
    out = {
        "bytes_in_use": s.get("allocated_bytes.all.current", 0),
        "peak_bytes_in_use": s.get("allocated_bytes.all.peak", 0),
        "bytes_reserved": s.get("reserved_bytes.all.current", 0),
        "peak_bytes_reserved": s.get("reserved_bytes.all.peak", 0),
        "bytes_limit": total,
        "bytes_free": free,
        "num_allocs": s.get("allocation.all.allocated", 0),
        "num_ooms": s.get("num_ooms", 0),
        "num_alloc_retries": s.get("num_alloc_retries", 0),
    }
    return {k: float(v) for k, v in out.items()}


_MEMORY_GAUGE_KEYS = ("bytes_in_use", "peak_bytes_in_use", "bytes_reserved")


def record_memory_gauges(devices=None) -> Optional[Dict[str, float]]:
    """Sample the allocator's stats into gauges for each card (`devices`: a
    list of devices or indices; the current card by default), one gauge
    per card (`device{i}/bytes_in_use`) plus the maximum over them
    (`device_bytes_in_use` and its `..._max_across_devices` alias).
    Returns {key: max over the cards} of every stat, or None on the CPU."""
    if devices is None:
        devices = [None]
    elif not isinstance(devices, (list, tuple)):
        devices = [devices]
    maxes: Dict[str, float] = {}
    for d in devices:
        stats = device_memory_stats(d)
        if stats is None:
            continue
        index = _device_index(d)
        for key, v in stats.items():
            if key in _MEMORY_GAUGE_KEYS:
                metrics_mod.gauge(f"device{index}/{key}").set(v)
            if key not in maxes or v > maxes[key]:
                maxes[key] = v
    if not maxes:
        return None
    for key in _MEMORY_GAUGE_KEYS:
        metrics_mod.gauge(f"device_{key}").set(maxes[key])
        metrics_mod.gauge(f"device_{key}_max_across_devices").set(maxes[key])
    return maxes


class AtenFlops:
    """Counts the FLOPs of the aten ops dispatched inside it with the
    formulas of `torch.utils.flop_counter.flop_registry` (the products and
    convolutions, forward and backward).  `FlopCounterMode` counts the same
    ops but also tracks the module hierarchy with gradient hooks, which an
    autograd Function that runs modules inside its forward (the pipeline's
    stages) refuses; this counts totals only."""

    def __init__(self):
        self.flops = 0

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry

        counter = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                formula = flop_registry.get(func.overloadpacket)
                if formula is not None:
                    counter.flops += formula(*args, **kwargs, out_val=out)
                return out

        self._mode = _Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)
        return False


def meta_module(module: torch.nn.Module) -> torch.nn.Module:
    """A copy of `module` whose parameters and buffers are meta tensors of
    the same shapes, dtypes and `requires_grad`: its code runs with nothing
    allocated, for counting what a step would do."""
    memo: Dict[int, Any] = {}
    for p in module.parameters():
        memo[id(p)] = torch.nn.Parameter(torch.empty_like(p, device="meta"), requires_grad=p.requires_grad)
    for b in module.buffers():
        memo[id(b)] = torch.empty_like(b, device="meta")
    return copy.deepcopy(module, memo)


def step_cost_analysis(fn: Callable[[], Any]) -> Tuple[Any, Dict[str, Any]]:
    """Run one step `fn()` under the measured count: (its result,
    {"flops": the step's FLOPs, "aten_flops": what `AtenFlops` saw,
    "flash_flops": the flash kernels' tallied work, "flash_launches":
    {kernel: calls}, "flash_records": the tally's `WorkRecord`s}).  Give it
    the step on meta tensors (`meta_module`, `train_dalle.dalle_meta_step`):
    the count is of the ops the code dispatches, it takes nothing on the
    card, and no step there runs under the counter.  On CPU tensors the
    flash calls run their plain versions and tally nothing."""
    from dalle_pytorch_tpu_torch.kernels import flash_attention as fa

    with fa.tally_work() as records, AtenFlops() as counter:
        result = fn()
    aten = float(counter.flops)
    flash = sum(r.flops for r in records)
    launches: Dict[str, int] = {}
    for r in records:
        launches[r.name] = launches.get(r.name, 0) + 1
    return result, {"flops": aten + flash, "aten_flops": aten, "flash_flops": flash,
                    "flash_launches": launches, "flash_records": list(records)}


class FlopsCrosscheck:
    """Tracks the measured/analytic FLOPs ratio; a divergence past `rtol`
    on `persistence` consecutive checks is an alarm (one-off noise is not).

    The two estimates measure different things (the measured count sees
    the VAE encode, remat recompute, and optimizer FLOPs the analytic model
    excludes), so the alarm triggers on DRIFT from the first observed ratio,
    not on distance from 1.0.

    Subclasses override the metric names to reuse the drift logic for other
    measured-vs-analytic pairs (`memory.MemoryCrosscheck`)."""

    RATIO_GAUGE = "flops_compiled_over_analytic"
    ALARM_COUNTER = "flops_divergence_alarms"

    def __init__(self, analytic_flops: float, rtol: float = 0.5,
                 persistence: int = 2,
                 on_alarm: Optional[Callable[[Dict[str, Any]], None]] = None):
        self.analytic_flops = float(analytic_flops)
        self.rtol = rtol
        self.persistence = persistence
        self.on_alarm = on_alarm
        self.baseline_ratio: Optional[float] = None
        self.last_ratio: Optional[float] = None
        self._diverged = 0
        self.alarmed = False

    def check(self, measured_flops: float) -> Optional[float]:
        if not measured_flops or self.analytic_flops <= 0:
            return None
        ratio = measured_flops / self.analytic_flops
        self.last_ratio = ratio
        metrics_mod.gauge(self.RATIO_GAUGE).set(ratio)
        if self.baseline_ratio is None:
            self.baseline_ratio = ratio
            return ratio
        drift = abs(ratio - self.baseline_ratio) / max(abs(self.baseline_ratio), 1e-12)
        if drift > self.rtol:
            self._diverged += 1
            if self._diverged >= self.persistence and not self.alarmed:
                self.alarmed = True
                event = {"baseline_ratio": self.baseline_ratio, "ratio": ratio,
                         "drift": drift, "analytic_flops": self.analytic_flops,
                         "measured_flops": measured_flops}
                metrics_mod.counter(self.ALARM_COUNTER).inc()
                if self.on_alarm is not None:
                    self.on_alarm(event)
        else:
            self._diverged = 0
            self.alarmed = False
        return ratio
