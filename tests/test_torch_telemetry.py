"""The port's telemetry hub against the JAX package's, on the CPU: the
spans JSONL schema (either package's report tools read either package's
files), the heartbeat's hang dump, the profiler capture's rate limits, the
hub's alarms and flush, what the port builds after warm-up, the report
tools rendering a port directory as the JAX tools do, and the training and
serving CLIs with telemetry on."""
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from dalle_pytorch_tpu.observability import capture as jcapture  # noqa: E402
from dalle_pytorch_tpu.observability import spans as jspans  # noqa: E402
from dalle_pytorch_tpu_torch.cli import train_dalle, train_vae  # noqa: E402
from dalle_pytorch_tpu_torch.kernels import build  # noqa: E402
from dalle_pytorch_tpu_torch.observability import capture as tcapture  # noqa: E402
from dalle_pytorch_tpu_torch.observability import heartbeat, telemetry  # noqa: E402
from dalle_pytorch_tpu_torch.observability import metrics as obs_metrics  # noqa: E402
from dalle_pytorch_tpu_torch.observability import spans as tspans  # noqa: E402
from dalle_pytorch_tpu_torch.tools import memory_report as tmemrep  # noqa: E402
from dalle_pytorch_tpu_torch.tools import telemetry_report as ttelrep  # noqa: E402
from dalle_pytorch_tpu_torch.training.logging import MetricLogger  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
TOOLS = str(REPO / "tools")


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def jax_tools(monkeypatch):
    """The JAX package's report scripts, imported from tools/."""
    monkeypatch.syspath_prepend(TOOLS)
    import memory_report
    import telemetry_report

    return telemetry_report, memory_report


def _records(path):
    return [json.loads(line) for line in Path(path).read_text().splitlines() if line.strip()]


def _drive(recorder):
    with recorder.span("checkpoint", path="x"):
        pass  # before any step: step None
    for i in range(2):
        recorder.start_step(i)
        with recorder.span("data_wait"):
            with recorder.span("decode", aggregate=True):
                pass
        with recorder.span("dispatch"):
            with recorder.span("inner", shape=[2]):
                pass
        recorder.end_step({"extra": i})
    recorder.start_step(2)
    with recorder.span("data_wait"):
        pass
    recorder.abort_step()
    recorder.write_event("alarm", type="hbm_headroom", step=1)
    recorder.close()


def _shape(rec):
    """A record with its clock readings dropped."""
    out = {k: v for k, v in rec.items() if k not in ("ts", "dur_s")}
    if "spans" in out:
        out["spans"] = sorted(out["spans"])
    if "agg" in out:
        out["agg"] = {k: v["n"] for k, v in out["agg"].items()}
    return out


def test_spans_jsonl_schema_equals_jax(tmp_path):
    _drive(tspans.SpanRecorder(str(tmp_path / "port.spans.jsonl")))
    _drive(jspans.SpanRecorder(str(tmp_path / "jax.spans.jsonl"), mirror_profiler=False))
    port, ref = _records(tmp_path / "port.spans.jsonl"), _records(tmp_path / "jax.spans.jsonl")
    assert [_shape(r) for r in port] == [_shape(r) for r in ref]
    assert {r["kind"] for r in port} == {"meta", "span", "step", "alarm"}


def test_spans_mirror_into_the_torch_profiler(tmp_path):
    rec = tspans.SpanRecorder(None)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with rec.span("dispatch"):
            torch.ones(8).sum()
    assert "dispatch" in {e.key for e in prof.key_averages()}


def test_heartbeat_dumps_a_hang_once(tmp_path):
    rec = tspans.SpanRecorder(str(tmp_path / "h.spans.jsonl"))
    with rec.span("data_wait"):
        pass
    hb = heartbeat.Heartbeat(0.05, dir=str(tmp_path), recorder=rec, registry=obs_metrics.MetricsRegistry(),
                             poll_s=0.01, process_index=2, context_fn=lambda: {"phase": "decode"}).start()
    try:
        deadline = time.monotonic() + 5
        while hb.hangs == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(0.1)
        assert hb.hangs == 1  # one report a gap
        hb.beat(3)
        while hb.hangs == 1 and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        hb.stop()
    dumps = sorted(tmp_path.glob("hang_*_p2_step*.txt"))
    assert len(dumps) >= 1
    text = dumps[0].read_text()
    assert "--- thread stacks ---" in text and "data_wait" in text and "phase: decode" in text
    assert "torch.cuda allocator" not in text  # the CPU: no card to read
    assert heartbeat.allocator_stats() == {}


def test_trace_trigger_rate_limits_like_jax(tmp_path):
    """One call sequence through both packages' triggers (injected start and
    stop, a frozen clock): the same captures, suppressions and windows."""
    def drive(mod):
        calls = []
        trig = mod.TraceTrigger(dir=str(tmp_path / mod.__name__), window_steps=2, max_captures=2,
                                manual_window=(6, 8), start_fn=lambda p: calls.append(("start", Path(p).stem)),
                                stop_fn=lambda: calls.append(("stop",)), clock=lambda: 0.0)
        trig.on_alarm("hbm_headroom", {})
        trig.request("again")  # pending: suppressed
        for step in range(10):
            trig.on_step_start(step)
            if step == 3:
                trig.on_alarm("recompile", {})  # cooldown: suppressed
            trig.on_step_end(step)
        trig.close()
        return calls, trig.captures, trig.alarm_captures, trig.suppressed

    port, ref = drive(tcapture), drive(jcapture)
    assert port == ref
    assert port[1:] == (2, 1, 2)


def test_default_capture_writes_a_chrome_trace(tmp_path):
    rec = tspans.SpanRecorder(str(tmp_path / "c.spans.jsonl"))
    trig = tcapture.TraceTrigger(dir=str(tmp_path / "traces"), manual_window=(1, 2), recorder=rec)
    for step in range(3):
        trig.on_step_start(step)
        with rec.span("dispatch"):
            torch.ones(8).sum()
        trig.on_step_end(step)
    trig.close()
    rec.close()
    traces = sorted((tmp_path / "traces").glob("*.json"))
    assert [t.name for t in traces] == ["trace_step1_manual.json"]
    assert "dispatch" in traces[0].read_text()
    assert [r["action"] for r in _records(tmp_path / "c.spans.jsonl") if r["kind"] == "trace_capture"] == \
        ["start", "stop"]
    assert tcapture.parse_profile_steps("2:5") == (2, 5) and tcapture.parse_profile_steps("3") == (3, 4)


def test_hub_alarms_flush_and_rebuilds(tmp_path):
    obs_metrics.REGISTRY.reset()
    tele = telemetry.configure(dir=str(tmp_path), run_name="hub")
    heard = []
    tele.add_alarm_listener(lambda kind, fields: heard.append(kind))
    try:
        assert telemetry.active() is tele
        with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 7"):
            tele.attach_fleet(object())
        tele.begin_step(0)
        with telemetry.span("dispatch"):
            build.notify("tables", "n128_d32", 0.01)  # before warm-up: a build, not an alarm
        tele.finish_step(0)
        build.notify("tables", "n128_d32", 0.01)  # a shape seen: nothing
        build.notify("tables", "n64_d32", 0.01)  # a new shape after warm-up: a rebuild
        build.notify("kernel", "flash_fwd", 12.0)
        out, ratio = tele.crosscheck_flops(lambda: 7, 1e9)
        assert out == 7 and ratio is None  # nothing counted: no ratio
        logger = MetricLogger(run_name="hub", log_dir=str(tmp_path))
        snap = tele.flush(logger, step=1)
        logger.finish()
        assert snap["port_builds"]["total"] == 3 and snap["port_rebuilds"]["total"] == 2
        assert tele.summary()["recompiles"] == 2
    finally:
        tele.close()
    assert telemetry.active() is None and telemetry.span("x") is telemetry.span("y")  # the shared no-op
    assert heard == ["recompile", "recompile"]
    records = _records(tmp_path / "hub.spans.jsonl")
    kinds = [r["kind"] for r in records]
    assert {"metrics", "flops_crosscheck", "compile_summary", "run_end"} <= set(kinds)
    logged = _records(tmp_path / "hub.metrics.jsonl")
    assert "port_builds" in logged[0]["telemetry"]
    assert not build.LISTENERS  # the watcher left with the hub


@pytest.fixture
def dummy_run(tmp_path_factory):
    """One CPU dummy run with telemetry on (its default), shared by the
    tests that read its directory."""
    out = tmp_path_factory.mktemp("tele") / "dalle"
    assert train_dalle.main(["--dummy_run", "4", "--device", "cpu", "--log_every_n_steps", "2",
                             "--profile_steps", "1:2", "--dalle_output_file_name", str(out)]) == 0
    return out


def test_train_dalle_writes_spans_ledger_and_a_capture(dummy_run):
    tele_dir = Path(f"{dummy_run}.telemetry")
    records = _records(tele_dir / "dalle.spans.jsonl")
    names = {r["name"] for r in records if r["kind"] == "span"}
    assert {"data_wait", "dispatch", "log", "checkpoint", "flops_crosscheck"} <= names
    assert "block" not in names  # the CPU: nothing to synchronise
    kinds = [r["kind"] for r in records]
    assert kinds.count("step") == 4 and kinds.count("mem_ledger") == 1 and kinds.count("flops_crosscheck") == 1
    check = next(r for r in records if r["kind"] == "flops_crosscheck")
    assert check["flash_launches"] == {"flash_fwd": 2, "flash_dq": 2, "flash_dkv": 2} and 1 / 3 < check["ratio"] < 3
    assert [p.name for p in (tele_dir / "traces").glob("*.json")] == ["trace_step1_manual.json"]
    assert kinds.count("metrics") == 3  # steps 0 and 2, and the run's end
    assert (tele_dir / "dalle.metrics.jsonl").exists()


def test_telemetry_off_writes_nothing(tmp_path):
    out = tmp_path / "dalle"
    assert train_dalle.main(["--dummy_run", "2", "--device", "cpu", "--telemetry", "off",
                             "--dalle_output_file_name", str(out)]) == 0
    assert sorted(p.name for p in tmp_path.iterdir()) == ["dalle.pt"]


def test_port_reports_render_a_port_directory_as_the_jax_tools_do(dummy_run, jax_tools):
    jtel, jmemrep = jax_tools
    tele_dir = f"{dummy_run}.telemetry"
    port_text = ttelrep.build_report(ttelrep.load_records(tele_dir))
    ref_text = jtel.build_report(jtel.load_records(tele_dir))

    def table(text):  # the per-step table and the aggregate attribution
        return text.split("\naggregated spans")[0].split("\nFLOPs cross-checks")[0]

    assert table(port_text) == table(ref_text) and "per-step time attribution" in port_text
    assert "measured: the aten products" in port_text and "builds: 0" in port_text
    port_mem = tmemrep.build_report(tmemrep.load_records(tele_dir))
    ref_mem = jmemrep.build_report(jmemrep.load_records(tele_dir))
    assert port_mem.split("\n\n")[0] == ref_mem.split("\n\n")[0]  # the ledger table
    assert "analytic HBM ledger" in port_mem and port_mem.endswith("memory alarms: none")
    with pytest.raises(SystemExit, match="item 7"):
        ttelrep.main([tele_dir, tele_dir])


def test_memory_report_renders_the_checks_and_alarms(tmp_path):
    path = tmp_path / "m.spans.jsonl"
    recs = [
        {"kind": "mem_ledger", "rows": [{"name": "params", "bytes": 2e9, "detail": "x"},
                                        {"name": "activations", "bytes": 6e9, "detail": "y"}],
         "total_bytes": 8e9, "dominant": "activations", "capacity_bytes": 85e9, "fits": True, "headroom_frac": 0.9},
        {"kind": "memory_crosscheck", "label": "train_step", "ratio": 1.5, "argument_bytes": 2e9,
         "temp_bytes": 9e9, "output_bytes": 1e3, "alias_bytes": 2e9, "total_bytes": 1.2e10,
         "donation": {"ok": True, "donated_bytes": 2e9, "expected_bytes": 2e9, "donated_frac": 1.0}},
        {"kind": "mem_window", "step": 3, "bytes_in_use": 3e9, "peak_bytes_in_use": 1.2e10,
         "peak_window_delta_bytes": 0.0, "usage_frac": 0.035},
        {"kind": "alarm", "type": "hbm_headroom", "step": 3},
    ]
    path.write_text("\n".join(json.dumps(r) for r in recs) + "\n{torn")
    text = tmemrep.build_report(tmemrep.load_records(str(path)))
    assert "<-- dominant" in text and "measured/analytic=1.5" in text and "in-place audit: OK" in text
    assert "live HBM peak timeline" in text and "[hbm_headroom]" in text


def test_train_vae_telemetry_works_and_health_waits(tmp_path, capsys):
    images = tmp_path / "imgs"
    images.mkdir()
    from dalle_pytorch_tpu_torch.cli.png import write_png

    rng = np.random.default_rng(0)
    for i in range(8):
        write_png(images / f"{i}.png", (rng.random((16, 16, 3)) * 255).astype(np.uint8))
    sizes = ["--image_size", "16", "--num_tokens", "32", "--num_layers", "2", "--emb_dim", "16", "--hidden_dim",
             "16", "--num_resnet_blocks", "0", "--epochs", "1", "--batch_size", "4", "--device", "cpu"]
    out = tmp_path / "vae"
    assert train_vae.main(["--image_folder", str(images), *sizes, "--telemetry", str(tmp_path / "tele"),
                           "--profile_steps", "1:2", "--vae_output_file_name", str(out)]) == 0
    records = _records(tmp_path / "tele" / "vae.spans.jsonl")
    assert [r["kind"] for r in records].count("step") == 2
    ledger = next(r for r in records if r["kind"] == "mem_ledger")
    assert ledger["lower_bound"] and [r["name"] for r in ledger["rows"]] == ["params", "grads", "opt_state"]
    assert len(list((tmp_path / "tele" / "traces").glob("*.json"))) == 1
    with pytest.raises(SystemExit, match=r"--health_every 1.*ROADMAP.md Queue 1 item 8"):
        train_vae.main(["--image_folder", str(images), *sizes, "--health_every", "1"])


def test_serve_prints_the_pool_ledger(capsys):
    from dalle_pytorch_tpu_torch.cli import serve

    obs_metrics.REGISTRY.reset()
    serve.main(["--synthetic", "--loadgen", "1", "--device", "cpu", "--quantize_kv", "int8"])
    out = capsys.readouterr().out
    ledger = out.split("[serving] paged-pool ledger:\n")[1].split("[serving] report")[0]
    names = [line.split()[0] for line in ledger.splitlines() if line.strip()]
    assert names[:4] == ["params", "paged_kv_pool", "paged_gather", "logits"] and "TOTAL" in names
    assert "int8 + per-token scales" in ledger
