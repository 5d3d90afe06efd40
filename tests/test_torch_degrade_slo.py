"""The degrade ladder (`serving/degrade.py`), the degrade cap in the
engine's sampler, the metrics registry and the SLO monitor
(`observability/metrics.py`, `observability/slo.py`) on the CPU.

Fed the same inputs as the JAX package's, with equal results: the
ladder's rung trace over one queue-fraction series (an SLO episode open
part of the way) on one stubbed clock, its shaping of requests at every
rung, `HistogramWindow`'s window percentiles, and the SLO monitor's window
records, alarms and state over one series of counters and histograms.
The engine: a request admitted at cap_candidates samples from
`degraded_filter_thres`'s candidates (its codes are a batch-1 call's at
that threshold, its neighbour's at the engine's), speculation stops at
that rung and comes back below it, the shed rung refuses (counted), and
an unmeetable TTFT target fires one alarm while the status file parses."""
import json

import numpy as np
import pytest
import torch

from dalle_pytorch_tpu_torch.models import dalle as tdalle
from dalle_pytorch_tpu_torch.models import sampling as tsamp
from dalle_pytorch_tpu_torch.observability import metrics as obs_metrics
from dalle_pytorch_tpu_torch.observability import slo as port_slo
from dalle_pytorch_tpu_torch.observability.metrics import HistogramWindow, MetricsRegistry
from dalle_pytorch_tpu_torch.observability.slo import SloMonitor, SloTargets, write_status_json
from dalle_pytorch_tpu_torch.serving.degrade import RUNGS, DegradeConfig, DegradeLadder
from dalle_pytorch_tpu_torch.serving.engine import EngineConfig, GenerationEngine
from dalle_pytorch_tpu_torch.serving.scheduler import AdmissionRefused, Request

MODEL = dict(dim=64, depth=2, heads=2, dim_head=32, num_text_tokens=40, text_seq_len=6, num_image_tokens=32,
             image_fmap_size=4, shift_tokens=True, attn_types=("full", "axial_row"))
THRES, CAPPED = 0.5, 0.85


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def fresh_registry():
    obs_metrics.REGISTRY.reset()
    yield
    obs_metrics.REGISTRY.reset()


@pytest.fixture(scope="module")
def jax_mods():
    pytest.importorskip("jax")
    from dalle_pytorch_tpu.observability import metrics as jmetrics
    from dalle_pytorch_tpu.observability import slo as jslo
    from dalle_pytorch_tpu.serving import degrade as jdegrade
    from dalle_pytorch_tpu.serving import scheduler as jsched

    return jmetrics, jslo, jdegrade, jsched


class _Slo:
    """What the ladder reads of an SLO monitor: its open episodes."""

    def __init__(self):
        self._alarmed = set()


def test_ladder_rung_trace_equals_jax(jax_mods):
    _, _, jdegrade, _ = jax_mods
    rng = np.random.default_rng(3)
    fracs = np.concatenate([rng.uniform(0.7, 1.0, 30), rng.uniform(0.2, 0.8, 20), rng.uniform(0.0, 0.3, 60),
                            rng.uniform(0.0, 1.0, 40)])
    steps = rng.uniform(0.05, 0.4, fracs.size)
    cfg = dict(enter_after_s=0.5, exit_after_s=1.2, short_prompt_max=3)
    ladders = [DegradeLadder(DegradeConfig(**cfg), text_seq_len=8),
               jdegrade.DegradeLadder(jdegrade.DegradeConfig(**cfg), text_seq_len=8)]
    slo, t, traces = _Slo(), 50.0, ([], [])
    for i, (frac, dt) in enumerate(zip(fracs, steps)):
        t += dt
        slo._alarmed = {"ttft_p99"} if 60 <= i < 75 else set()  # an episode during the calm stretch
        for ladder, trace in zip(ladders, traces):
            trace.append((ladder.observe(float(frac), slo=slo, now=t), ladder.suppress_spec))
    assert traces[0] == traces[1] and max(r for r, _ in traces[0]) == 4
    assert ladders[0].state() == ladders[1].state()
    assert RUNGS == jdegrade.RUNGS


@pytest.mark.parametrize("rung", range(5))
def test_shaping_at_each_rung_equals_jax(jax_mods, rung):
    _, _, jdegrade, jsched = jax_mods
    ladder = DegradeLadder(DegradeConfig(short_prompt_max=3), text_seq_len=8)
    jladder = jdegrade.DegradeLadder(jdegrade.DegradeConfig(short_prompt_max=3), text_seq_len=8)
    ladder.rung = jladder.rung = rung
    for cond, n_tok in ((1.0, 8), (3.0, 2), (3.0, 6), (1.0, 3)):
        text = np.zeros(8, np.int64)
        text[:n_tok] = 1
        outcomes = []
        for lad, req in ((ladder, Request(id=0, text=text, seed=1, cond_scale=cond)),
                         (jladder, jsched.Request(id=0, text=text, key=np.zeros(2, np.uint32), cond_scale=cond))):
            try:
                lad.shape_request(req)
                outcomes.append((req.cond_scale, req.lanes_needed, req.degrade_rung))
            except (AdmissionRefused, jsched.AdmissionRefused) as e:
                outcomes.append((e.kind, str(e)))
        assert outcomes[0] == outcomes[1]


def test_histogram_windows_and_snapshots_equal_jax(jax_mods):
    jmetrics = jax_mods[0]
    rng = np.random.default_rng(5)
    regs = [MetricsRegistry(), jmetrics.MetricsRegistry()]
    windows = [HistogramWindow(r.histogram("serving/ttft_s")) for r in regs]
    for scale in (0.01, 1.0, 0.0, 0.2, 30.0):
        values = rng.lognormal(np.log(scale or 1.0), 0.7, 12) if scale else []
        for reg in regs:
            for v in values:
                reg.histogram("serving/ttft_s").observe(float(v))
            reg.counter("serving/completed").inc(len(values))
            reg.gauge("serving/queue_depth").set(len(values))
        got = [w.advance() for w in windows]
        assert got[0] == got[1]
        assert regs[0].snapshot() == regs[1].snapshot()
    with pytest.raises(TypeError, match="already registered as Counter"):
        regs[0].gauge("serving/completed")


def _slo_series(slo_mod, registry_cls, targets_kw, alarms):
    reg = registry_cls()
    clock = {"t": 0.0}
    mon = slo_mod.SloMonitor(slo_mod.SloTargets(**targets_kw), registry=reg, on_alarm=alarms.append,
                             short_windows=2, long_windows=4, clock=lambda: clock["t"])
    rng = np.random.default_rng(9)
    records = []
    for w in range(14):
        clock["t"] += float(rng.uniform(2.0, 12.0))
        slow = 4 <= w < 8 or w == 11
        for _ in range(int(rng.integers(0, 6))):
            reg.histogram("serving/ttft_s").observe(float(rng.uniform(0.5, 2.0) if slow else rng.uniform(0.01, 0.05)))
            reg.histogram("serving/request_s").observe(float(rng.uniform(1.0, 9.0)))
            reg.counter("serving/completed").inc()
            reg.counter("serving/submitted").inc()
        reg.counter("serving/refused").inc(int(rng.integers(0, 4)) if slow else 0)
        records.append(mon.observe(iteration=w))
    return mon, records


def test_slo_monitor_windows_and_alarms_equal_jax(jax_mods):
    _, jslo, _, _ = jax_mods
    jmetrics = jax_mods[0]
    targets = dict(ttft_p99_s=0.2, latency_p99_s=8.0, images_per_sec_floor=0.1, shed_rate_ceiling=0.3)
    alarms = ([], [])
    port, records = _slo_series(port_slo, MetricsRegistry, targets, alarms[0])
    ref, jrecords = _slo_series(jslo, jmetrics.MetricsRegistry, targets, alarms[1])
    assert records == jrecords and alarms[0] == alarms[1]
    assert {a["slo"] for a in alarms[0]} >= {"ttft_p99"} and port.state_dict() == ref.state_dict()
    again = SloMonitor(SloTargets(**targets))
    again.load_state_dict(port.state_dict())
    assert again.state_dict() == port.state_dict() and again.burning == bool(port.state_dict()["alarmed"])


def test_status_file_is_written_atomically(tmp_path):
    path = tmp_path / "sub" / "status.json"
    write_status_json(str(path), {"a": 1, "t": np.float32(2.5)})
    write_status_json(str(path), {"a": 2})
    assert json.loads(path.read_text()) == {"a": 2}
    assert [p.name for p in path.parent.iterdir()] == ["status.json"]


@pytest.fixture(scope="module")
def model():
    return tdalle.init_dalle(tdalle.DALLEConfig(**MODEL), torch.Generator().manual_seed(0), "cpu")


@pytest.fixture(scope="module")
def text():
    return np.random.default_rng(1).integers(1, 40, (4, 6))


def _batch1(model, text_row, seed, thres):
    return tsamp.sample_image_codes(model, torch.as_tensor(text_row)[None], torch.Generator().manual_seed(seed),
                                    filter_thres=thres).numpy()[0]


def _engine(model, **kw):
    return GenerationEngine(model, engine_cfg=EngineConfig(**dict(dict(
        num_slots=4, block_size=4, filter_thres=THRES, degraded_filter_thres=CAPPED), **kw)))


@pytest.mark.parametrize("spec_k", [0, 2], ids=["sequential", "speculative"])
def test_cap_candidates_samples_the_capped_set_and_stops_speculation(model, text, spec_k):
    """A request admitted at rung 2 (its guidance dropped at rung 1 and up)
    gives a batch-1 call's codes at `degraded_filter_thres`; one admitted
    at rung 0 beside it, the engine's threshold's.  At rung 2 a speculative
    engine runs the sequential step, and speculates again at rung 0."""
    engine = _engine(model, spec_k=spec_k)
    ladder = DegradeLadder(DegradeConfig(), text_seq_len=6)
    engine.attach_degrade(ladder, observe=False)
    plain = engine.submit(text[0], seed=11)
    ladder.rung = 2
    capped = engine.submit(text[1], seed=12, cond_scale=3.0)
    assert capped.cond_scale == 1.0 and capped.degrade_rung == 2
    for _ in range(5):
        engine.poll()
    assert engine.counts["spec_rounds"] == 0 and engine.decode_steps == 5
    ladder.rung = 0
    engine.run_until_idle()
    assert (engine.counts["spec_rounds"] > 0) == bool(spec_k)
    np.testing.assert_array_equal(plain.codes, _batch1(model, text[0], 11, THRES))
    np.testing.assert_array_equal(capped.codes, _batch1(model, text[1], 12, CAPPED))
    assert not np.array_equal(capped.codes, _batch1(model, text[1], 12, THRES))
    assert obs_metrics.counter("serving/degrade_cfg_disabled").value == 1


def test_the_shed_rung_refuses_and_counts(model, text):
    engine = _engine(model)
    ladder = DegradeLadder(DegradeConfig(), text_seq_len=6)
    engine.attach_degrade(ladder)
    ladder.rung = 4
    with pytest.raises(AdmissionRefused) as e:
        engine.submit(text[0], seed=1)
    assert e.value.kind == "degraded_shed" and engine.admission.counts["refused_degraded_shed"] == 1
    assert obs_metrics.counter("serving/refused_degraded_shed").value == obs_metrics.counter("serving/refused").value == 1
    ladder.rung = 0
    req = engine.submit(text[0], seed=1)
    engine.run_until_idle()
    np.testing.assert_array_equal(req.codes, _batch1(model, text[0], 1, THRES))


def test_an_unmeetable_ttft_target_fires_one_alarm_and_the_status_file_parses(model, text, tmp_path):
    engine = _engine(model, telemetry_every=4)
    alarms = []
    monitor = SloMonitor(SloTargets(ttft_p99_s=1e-9), on_alarm=alarms.append, long_windows=2)
    engine.attach_slo(monitor, status_path=str(tmp_path / "status.json"))
    for i in range(4):
        engine.submit(text[i], seed=i)
        for _ in range(6):
            engine.poll()
    engine.run_until_idle()
    engine.close()
    assert [a["type"] for a in alarms] == ["slo_burn_rate"] and alarms[0]["slo"] == "ttft_p99"
    status = json.loads((tmp_path / "status.json").read_text())
    assert status["active_alarms"] == ["ttft_p99"] and status["alarms_total"] == 1
    assert status["live"]["completed"] == 4 and status["serving"]["inflight"] == 0
    assert status["pool"]["allocs"] == 4 and status["quantization"]["kv_dtype"] == "float32"
