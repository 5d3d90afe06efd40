"""Telemetry of the port (counterpart of `dalle_pytorch_tpu/observability/`):
structured spans, the process's metrics registry, the card's introspection
(builds after warm-up, the allocator, a measured count of a step's FLOPs),
the HBM ledger, profiler capture and a heartbeat/hang monitor; the serving
fleet's SLO monitor, pool flight recorder and comms rows.

Instrumented code imports the cheap module-level helpers:

    from dalle_pytorch_tpu_torch.observability import span, counter, gauge, histogram

which are no-ops / registry updates until a CLI calls
`telemetry.configure(dir=...)`.  `tools/telemetry_report.py` and
`tools/memory_report.py` render a run's spans JSONL.  Serving telemetry,
the fleet aggregator and the health taps are not ported (ROADMAP.md Queue
1 items 7 and 8)."""
from dalle_pytorch_tpu_torch.observability.capture import TraceTrigger, parse_profile_steps
from dalle_pytorch_tpu_torch.observability.comms import comms_roofline, dalle_step_comms, step_comms_ledger
from dalle_pytorch_tpu_torch.observability.cuda import (
    CompileWatcher,
    FlopsCrosscheck,
    device_memory_stats,
    meta_module,
    record_memory_gauges,
    step_cost_analysis,
)
from dalle_pytorch_tpu_torch.observability.heartbeat import Heartbeat, thread_stacks
from dalle_pytorch_tpu_torch.observability.memory import (
    HbmMonitor,
    MemoryCrosscheck,
    audit_donation,
    dalle_step_memory,
    device_hbm_capacity,
    is_oom_error,
    oom_suggestions,
    sampling_memory_ledger,
    step_memory_analysis,
    step_memory_ledger,
    write_oom_report,
)
from dalle_pytorch_tpu_torch.observability.metrics import (
    REGISTRY,
    HistogramWindow,
    MetricsRegistry,
    counter,
    gauge,
    histogram,
)
from dalle_pytorch_tpu_torch.observability.slo import SloMonitor, SloTargets, write_status_json
from dalle_pytorch_tpu_torch.observability.spans import SpanRecorder
from dalle_pytorch_tpu_torch.observability.telemetry import RunTelemetry, Telemetry, active, configure, oom_exit, span

__all__ = [
    "REGISTRY",
    "CompileWatcher",
    "FlopsCrosscheck",
    "HbmMonitor",
    "Heartbeat",
    "HistogramWindow",
    "MemoryCrosscheck",
    "MetricsRegistry",
    "RunTelemetry",
    "SloMonitor",
    "SloTargets",
    "SpanRecorder",
    "Telemetry",
    "TraceTrigger",
    "active",
    "audit_donation",
    "comms_roofline",
    "configure",
    "counter",
    "dalle_step_comms",
    "dalle_step_memory",
    "device_hbm_capacity",
    "device_memory_stats",
    "gauge",
    "histogram",
    "is_oom_error",
    "meta_module",
    "oom_exit",
    "oom_suggestions",
    "parse_profile_steps",
    "record_memory_gauges",
    "sampling_memory_ledger",
    "span",
    "step_comms_ledger",
    "step_cost_analysis",
    "step_memory_analysis",
    "step_memory_ledger",
    "write_oom_report",
    "write_status_json",
    "thread_stacks",
]
