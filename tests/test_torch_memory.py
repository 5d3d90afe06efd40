"""The port's HBM ledger, its crosschecks, the headroom monitor and the
out-of-memory forensics against the JAX package's, on the CPU.

The ledger's arithmetic is the JAX package's, so the port's rows equal
JAX's over a grid of meshes, executions, remat policies, accumulation and
pipeline micro-batches, to 1e-12 relative; the live-model ledger of one
process equals JAX's on the same weights (the v3 bridge); a pipelined
mesh differs from JAX's by exactly the bytes the port's placement
(`sharding.Placement`) holds more.  Then the drift alarms, the monitor's
episodes, `is_oom_error`'s chains, the report and the CLIs' exit 77."""
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from dalle_pytorch_tpu.models import dalle as jdalle  # noqa: E402
from dalle_pytorch_tpu.observability import memory as jmem  # noqa: E402
from dalle_pytorch_tpu.parallel import train_step as jts  # noqa: E402
from dalle_pytorch_tpu.parallel.registry import default_registry as jax_registry  # noqa: E402
from dalle_pytorch_tpu_torch import weights  # noqa: E402
from dalle_pytorch_tpu_torch.models import dalle as tdalle  # noqa: E402
from dalle_pytorch_tpu_torch.observability import memory as tmem  # noqa: E402
from dalle_pytorch_tpu_torch.observability import metrics as obs_metrics  # noqa: E402
from dalle_pytorch_tpu_torch.observability.cuda import FlopsCrosscheck  # noqa: E402
from dalle_pytorch_tpu_torch.optim.adafactor import Adafactor  # noqa: E402
from dalle_pytorch_tpu_torch.optim.grouped import Adam  # noqa: E402
from dalle_pytorch_tpu_torch.parallel import train_step as tts  # noqa: E402
from dalle_pytorch_tpu_torch.parallel.sharding import Placement  # noqa: E402
from dalle_pytorch_tpu_torch.training import resilience  # noqa: E402

REL = 1e-12  # the ledger is the same float arithmetic in both packages
GEO = dict(batch=16, seq_len=64, dim=32, depth=4, heads=4, dim_head=8)
CFG = dict(dim=32, depth=4, heads=4, dim_head=8, num_text_tokens=64, text_seq_len=8, num_image_tokens=32,
           image_fmap_size=4)
AXES = [{}, {"dp": 8}, {"dp": 2, "fsdp": 4}, {"dp": 4, "tp": 2}, {"fsdp": 2, "sp": 2, "tp": 2}, {"pp": 2},
        {"dp": 2, "pp": 4}]
RUNS = [("sequential", "full", False), ("remat", "full", True), ("remat", "flash", True),
        ("remat", "flash_qkv", True), ("remat", "flash_qkv_ff", False), ("reversible", "full", True)]


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(a, b):
    return a == b or abs(a - b) <= REL * max(abs(a), abs(b))


def _rows_equal(port, ref):
    assert [r["name"] for r in port["rows"]] == [r["name"] for r in ref["rows"]]
    for p, r in zip(port["rows"], ref["rows"]):
        assert _close(p["bytes"], r["bytes"]) and p["detail"] == r["detail"], (p, r)
    assert _close(port["total_bytes"], ref["total_bytes"]) and port["dominant"] == ref["dominant"]
    for key in ("fits", "capacity_bytes"):
        assert port[key] == ref[key]


@pytest.mark.parametrize("axes", AXES, ids=lambda a: "x".join(f"{k}{v}" for k, v in a.items()) or "one")
@pytest.mark.parametrize("zero_stage", [0, 1, 3])
def test_rest_shard_fraction_equals_jax(axes, zero_stage):
    for moments in (False, True):
        assert _close(tmem.rest_shard_fraction(axes, zero_stage, moments),
                      jmem.rest_shard_fraction(axes, zero_stage, moments))


@pytest.mark.parametrize("execution, policy, flash", RUNS)
@pytest.mark.parametrize("axes", AXES, ids=lambda a: "x".join(f"{k}{v}" for k, v in a.items()) or "one")
def test_activation_bytes_equal_jax(axes, execution, policy, flash):
    for grad_accum, micro, itemsize in ((1, None, 4), (2, None, 2), (4, 3, 4)):
        kw = dict(GEO, compute_itemsize=itemsize, grad_accum=grad_accum, execution=execution, remat_policy=policy,
                  flash_attention=flash, pp_num_micro=micro)
        port, ref = tmem.activation_bytes(axes, **kw), jmem.activation_bytes(axes, **kw)
        assert set(port) == set(ref)
        assert all(_close(port[k], ref[k]) for k in ref), (port, ref)


@pytest.mark.parametrize("execution, policy, flash", RUNS)
@pytest.mark.parametrize("axes", AXES, ids=lambda a: "x".join(f"{k}{v}" for k, v in a.items()) or "one")
def test_step_memory_ledger_suggestions_and_table_equal_jax(axes, execution, policy, flash):
    for zero_stage, grad_accum, capacity in ((0, 1, None), (1, 2, 4e6), (3, 4, 1e9)):
        kw = dict(param_bytes=1e6, grad_bytes=1e6, opt_bytes=2e6, **GEO, zero_stage=zero_stage,
                  grad_accum=grad_accum, accum_bytes=1e6, execution=execution, remat_policy=policy,
                  flash_attention=flash, input_bytes=3e4, capacity_bytes=capacity)
        port, ref = tmem.step_memory_ledger(axes, **kw), jmem.step_memory_ledger(axes, **kw)
        _rows_equal(port, ref)
        assert tmem.format_ledger(port) == jmem.format_ledger(ref)
        # the suggestions in the JAX order, each in the port's own flags
        for dominant in ("opt_state", "params", "grads", "activations", "kv_cache", "paged_kv_pool",
                         "paged_gather"):
            led = dict(port, dominant=dominant)
            settings = (tts.StepSettings(zero_stage=zero_stage), jts.StepSettings(zero_stage=zero_stage))
            s_port = tmem.oom_suggestions(led, axes, settings[0])
            s_ref = jmem.oom_suggestions(dict(ref, dominant=dominant), axes, settings[1])
            assert len(s_port) == len(s_ref), (dominant, s_port, s_ref)
            assert "batch_size" in s_port[-1]


def test_oom_suggestions_skip_what_is_in_effect():
    def ledger_with(dominant, detail=""):
        return {"dominant": dominant, "rows": [{"name": dominant, "bytes": 1.0, "detail": detail}]}

    assert "zero_stage" in tmem.oom_suggestions(ledger_with("opt_state"), settings=tts.StepSettings())[0]
    assert "--execution remat" in tmem.oom_suggestions(ledger_with("activations", "sequential/full"))[0]
    assert "--remat_policy" in tmem.oom_suggestions(ledger_with("activations", "remat/flash_qkv"))[0]
    assert "--ga_steps" in tmem.oom_suggestions(ledger_with("activations", "remat/full"))[0]
    lowp = tmem.oom_suggestions(ledger_with("params"),
                                settings=tts.StepSettings(param_dtype=torch.bfloat16, zero_stage=3))
    assert not any("param_dtype" in s or "zero_stage to 3" in s for s in lowp)
    grads = tmem.oom_suggestions(ledger_with("grads"), settings=tts.StepSettings(grad_dtype=torch.bfloat16))
    assert not any("grad_dtype" in s for s in grads)


def _models(seed=0, **kw):
    """The JAX package's seeded DALL-E and the port's on the same weights."""
    jcfg = jdalle.DALLEConfig(**{**CFG, **kw})
    params = jdalle.init_dalle(jax.random.PRNGKey(seed), jcfg)
    model = weights.load_dalle(jax.tree_util.tree_map(np.asarray, params), tdalle.DALLEConfig(**{**CFG, **kw}),
                               device="cpu")
    return jcfg, params, model.train().requires_grad_(True)


@pytest.mark.parametrize("store, recipe", [("f32", False), ("bf16", False), ("bf16", True)])
def test_dalle_step_memory_equals_jax_on_one_process(store, recipe):
    """Params, grads and optimizer rows from the live trees, equal to the JAX
    package's on the same weights: f32 masters with Adam; bf16 storage (no
    master copy, f32 moments); the recipe's bf16 gradients with Adafactor's
    factored statistics."""
    jcfg, params, model = _models(execution="remat", remat_policy="flash_qkv")
    lowp = store == "bf16"
    t_settings = tts.StepSettings(param_dtype=torch.bfloat16 if lowp else torch.float32,
                                  grad_dtype=torch.bfloat16 if recipe else torch.float32, grad_accum=2)
    j_settings = jts.StepSettings(param_dtype=jnp.bfloat16 if lowp else jnp.float32,
                                  grad_dtype=jnp.bfloat16 if recipe else None, grad_accum=2)
    opt = Adafactor(1e-3) if recipe else Adam(1e-3)
    init_fn, _ = tts.make_train_step(lambda p, b, g: None, opt, t_settings)
    state = init_fn(dict(model.named_parameters()))
    j_opt = optax.adafactor(1e-3) if recipe else optax.adam(1e-3)
    j_state = j_opt.init(jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), params))
    port = tmem.dalle_step_memory(None, state.params, state.opt_state, model.cfg, 8, settings=t_settings)
    ref = jmem.dalle_step_memory(None, params, j_state, jcfg, 8, settings=j_settings)
    for name in ("params", "grads", "grad_accum", "activations"):
        p, r = (next(x for x in led["rows"] if x["name"] == name) for led in (port, ref))
        assert _close(p["bytes"], r["bytes"]), (name, p, r)
    p_opt, r_opt = (next(x for x in led["rows"] if x["name"] == "opt_state")["bytes"] for led in (port, ref))
    if recipe:
        # Adafactor's statistics; optax also keeps (1,)-shaped placeholders for
        # the factored rows of an unfactored leaf and a step count, which
        # the port's groups do not: 528 bytes here, 0.18 %
        assert abs(p_opt - r_opt) / r_opt < 5e-3, (p_opt, r_opt)
    else:
        assert _close(p_opt, r_opt), (p_opt, r_opt)
    # priced before any state exists: Adam's two f32 moments
    est = tmem.dalle_step_memory(None, dict(model.named_parameters()), None, model.cfg, 8, settings=t_settings)
    if not recipe:
        assert _close(next(x for x in est["rows"] if x["name"] == "opt_state")["bytes"], r_opt)


def _full_piece_bytes(plan, params):
    """Bytes of this rank's at-rest pieces, cut from the full tensors."""
    return sum(plan.piece(n, p.detach(), rest=True).numel() * p.element_size() for n, p in params.items())


@pytest.mark.parametrize("pp, rank", [(2, 0), (2, 1), (4, 3)])
def test_pipelined_mesh_differs_from_jax_by_the_placement(pp, rank):
    """A stage holds its layers whole and the leaves outside the stack
    replicated; the JAX registry folds pp into the data slot.  The port's
    params row is the bytes its `Placement` holds, and differs from JAX's by
    exactly that less JAX's fraction of the tree (at this width the
    registry shards no leaf: each is under its 16 KiB floor)."""
    cfg = tdalle.DALLEConfig(**{**CFG, "depth": 8}, pipeline_axis="pp")
    jcfg = jdalle.DALLEConfig(**{**CFG, "depth": 8})
    params = jdalle.init_dalle(jax.random.PRNGKey(1), jcfg)
    model = weights.load_dalle(jax.tree_util.tree_map(np.asarray, params), cfg, device="cpu")
    named = dict(model.named_parameters())
    axes = {"pp": pp}
    plan = Placement(axes, rank, named, 0, paths=weights.dalle_param_paths(cfg), module=model)
    port = tmem.dalle_step_memory(axes, named, None, cfg, 8, plan=plan)
    ref = jmem.dalle_step_memory(axes, params, None, jcfg, 8, registry=jax_registry())
    p_row, r_row = (next(x for x in led["rows"] if x["name"] == "params")["bytes"] for led in (port, ref))
    held = _full_piece_bytes(plan, named)
    assert p_row == pytest.approx(held, rel=REL)
    total = sum(p.numel() * 4 for p in named.values())
    j_frac = jax_registry().shard_fraction(params, axes, 0)
    assert p_row - r_row == pytest.approx(held - j_frac * total, rel=1e-9)


def test_zero3_prices_one_gathered_layer():
    _, _, model = _models(dim=128, dim_head=32)  # wide enough that the registry shards its matrices
    named = dict(model.named_parameters())
    cfg = model.cfg
    plan = Placement({"fsdp": 4}, 1, named, 3, paths=weights.dalle_param_paths(cfg), module=model)
    led = tmem.dalle_step_memory({"fsdp": 4}, named, None, cfg, 8, settings=tts.StepSettings(zero_stage=3),
                                 plan=plan)
    row = next(x for x in led["rows"] if x["name"] == "zero3_gather")
    layer = [n for n in named if n.startswith("transformer.layers.0.")]
    sharded = [n for n in layer if plan.layouts[n].rest_dim is not None]
    gathered = sum(named[n].numel() * 4 * (1 - plan.held_fraction([n])) for n in sharded)
    outside = [n for n in named if not n.startswith("transformer.layers.") and plan.layouts[n].rest_dim is not None]
    gathered += sum(named[n].numel() * 4 * (1 - plan.held_fraction([n])) for n in outside)
    assert sharded and row["bytes"] == pytest.approx(gathered)
    assert plan.held_fraction(list(named)) < 0.5


def test_sampling_ledgers():
    _, _, model = _models()
    cfg = model.cfg
    dense = tmem.sampling_memory_ledger(cfg, 4, model)
    kv = next(r for r in dense["rows"] if r["name"] == "kv_cache")["bytes"]
    assert kv == 2 * cfg.depth * 4 * cfg.total_seq_len * cfg.heads * cfg.dim_head * 4
    assert next(r for r in dense["rows"] if r["name"] == "params")["bytes"] == sum(
        p.numel() * 4 for p in model.parameters())
    pool = dict(num_blocks=9, block_size=8, num_slots=4)
    paged = tmem.sampling_memory_ledger(cfg, 4, model, paged_pool=pool)
    int8 = tmem.sampling_memory_ledger(cfg, 4, model, paged_pool=dict(pool, kv_quant="int8"))
    row = {led_name: next(r for r in led["rows"] if r["name"] == "paged_kv_pool")["bytes"]
           for led_name, led in (("f32", paged), ("int8", int8))}
    assert row["int8"] / row["f32"] == pytest.approx((1 + 2 / cfg.dim_head) / 4)
    j_cfg = jdalle.DALLEConfig(**CFG)
    ref = jmem.sampling_memory_ledger(j_cfg, 4, itemsize=4, paged_pool=pool)
    assert [r["bytes"] for r in paged["rows"][1:]] == [r["bytes"] for r in ref["rows"]]


# --- the crosschecks, the monitor, the forensics ------------------------------

DRIFT = [1.0e9, 1.05e9, 1.8e9, 1.9e9, 1.0e9, 2.0e9, 2.1e9, 2.2e9]


@pytest.mark.parametrize("port_cls, ref_cls", [(FlopsCrosscheck, "xla.FlopsCrosscheck"),
                                               (tmem.MemoryCrosscheck, "memory.MemoryCrosscheck")])
def test_crosschecks_drift_like_jax(port_cls, ref_cls):
    import importlib

    mod, name = ref_cls.split(".")
    ref_cls = getattr(importlib.import_module(f"dalle_pytorch_tpu.observability.{mod}"), name)
    fired = {"port": [], "ref": []}
    port = port_cls(1e9, rtol=0.5, on_alarm=fired["port"].append)
    ref = ref_cls(1e9, rtol=0.5, on_alarm=fired["ref"].append)
    for v in DRIFT:
        assert port.check(v) == ref.check(v)
        assert port.alarmed == ref.alarmed
    assert fired["port"] == fired["ref"] and len(fired["port"]) == 2


def test_hbm_monitor_episodes_like_jax():
    """The sequence of tests/test_memory.py's monitor tests, both packages:
    one alarm an episode, re-armed below the hysteresis, the peak delta,
    the state round trip, no re-fire when restored mid-episode."""
    from dalle_pytorch_tpu.observability.metrics import MetricsRegistry as JReg

    seq = [{"bytes_in_use": 95.0, "peak_bytes_in_use": 96.0}, {"bytes_in_use": 95.0, "peak_bytes_in_use": 96.0},
           {"bytes_in_use": 10.0, "peak_bytes_in_use": 96.0}, {"bytes_in_use": 95.0, "peak_bytes_in_use": 97.0},
           {"peak_bytes_in_use": 160.0}, None]
    fired = {"port": [], "ref": []}
    port = tmem.HbmMonitor(capacity_bytes=100.0, headroom_frac=0.9, on_alarm=fired["port"].append,
                           registry=obs_metrics.MetricsRegistry())
    ref = jmem.HbmMonitor(capacity_bytes=100.0, headroom_frac=0.9, on_alarm=fired["ref"].append, registry=JReg())
    for step, stats in enumerate(seq):
        assert port.observe(step, stats) == ref.observe(step, stats)
    assert fired["port"] == fired["ref"] and port.alarms == ref.alarms == 2
    restored = tmem.HbmMonitor(capacity_bytes=100.0, registry=obs_metrics.MetricsRegistry())
    restored.load_state_dict(port.state_dict())
    again = []
    restored.on_alarm = again.append
    rec = restored.observe(9, {"bytes_in_use": 96.0, "peak_bytes_in_use": 170.0})
    assert not again and rec["peak_window_delta_bytes"] == pytest.approx(10.0)
    restored.load_state_dict(None)
    assert tmem.HbmMonitor(registry=obs_metrics.MetricsRegistry()).capacity_bytes is None  # the CPU: no card


def _chain(*messages, cls=RuntimeError):
    exc = None
    for msg in messages:
        try:
            try:
                if exc is not None:
                    raise exc
            finally:
                raise cls(msg) if msg is not None else ValueError("outer")
        except Exception as e:  # noqa: BLE001
            exc = e
    return exc


@pytest.mark.parametrize("messages", [
    ("CUDA out of memory. Tried to allocate 2.00 GiB",), ("RESOURCE_EXHAUSTED: 1GB",), ("shape mismatch",),
    ("CUDA out of memory. inner", None), ("Ran out of memory in region", None, None), ("fine", "also fine"),
])
def test_is_oom_error_chains_like_jax(messages):
    exc = _chain(*messages)
    assert tmem.is_oom_error(exc) == jmem.is_oom_error(exc)


def test_is_oom_error_takes_the_allocators_type():
    assert tmem.is_oom_error(torch.OutOfMemoryError("allocator"))
    with pytest.raises(torch.OutOfMemoryError) as ei:
        tmem.provoke_oom("unit test", device="cpu")
    assert tmem.is_oom_error(ei.value) and "simulated" in str(ei.value)
    try:
        try:
            tmem.provoke_oom(device="cpu")
        except torch.OutOfMemoryError as inner:
            raise ValueError("wrapped") from inner
    except ValueError as e:
        assert tmem.is_oom_error(e)


def test_write_oom_report_matches_jax_sections(tmp_path):
    led = tmem.step_memory_ledger({"dp": 2, "fsdp": 4}, param_bytes=1e6, grad_bytes=1e6, opt_bytes=2e6, **GEO,
                                  capacity_bytes=4e6)
    live = {"bytes_in_use": 3e6, "peak_bytes_in_use": 3.9e6, "num_ooms": 1.0}
    path = tmem.write_oom_report(str(tmp_path / "p"), error=torch.OutOfMemoryError("CUDA out of memory. x"),
                                 phase="compile", ledger=led, live_stats=live, context={"global_step": 7},
                                 process_index=1)
    ref = jmem.write_oom_report(str(tmp_path / "j"), error=RuntimeError("CUDA out of memory. x"), phase="compile",
                                ledger=led, live_stats=live, context={"global_step": 7}, process_index=1)
    assert Path(path).name.startswith("oom_report_compile_p1_")
    text, ref_text = Path(path).read_text(), Path(ref).read_text()
    table = tmem.format_ledger(led)
    assert table in text and table in ref_text and "DOES NOT FIT" in text
    for want in ("CUDA out of memory. x", "global_step: 7", "suggestions (ranked", "num_ooms", "bytes_in_use"):
        assert want in text


def test_audit_flags_a_second_copy_of_the_state():
    state = 1e9
    ok = tmem.audit_donation({"output_bytes": 32e6}, state)
    bad = tmem.audit_donation({"output_bytes": 0.9e9}, state)
    assert ok["ok"] and ok["donated_bytes"] == state - 32e6
    assert not bad["ok"] and bad["donated_frac"] == pytest.approx(0.1)
    result, analysis = tmem.step_memory_analysis(lambda: 5, 1e6, device="cpu")
    assert result == 5 and analysis is None  # no allocator to read on the CPU


# --- the CLIs ----------------------------------------------------------------

def test_train_dalle_oom_exits_77_with_a_report(tmp_path, monkeypatch, capsys):
    """An out-of-memory error inside a step (the CPU's `provoke_oom`, the
    allocator's type and message) ends the run with EXIT_OOM and
    `oom_report_train_step_*.txt` in the telemetry directory, with the
    ledger priced before the run; the telemetry is closed."""
    from dalle_pytorch_tpu_torch.cli import train_dalle
    from dalle_pytorch_tpu_torch.observability import telemetry

    real = train_dalle.dalle_loss_fn
    calls = []

    def failing(model, vae, dtype):
        loss_fn = real(model, vae, dtype)

        def wrapped(params, batch, generator):
            if batch["text"].device.type != "meta":  # not the FLOPs count's step on the meta device
                calls.append(1)
            if len(calls) == 2:
                tmem.provoke_oom("second step", device="cpu")
            return loss_fn(params, batch, generator)

        return wrapped

    monkeypatch.setattr(train_dalle, "dalle_loss_fn", failing)
    out = tmp_path / "dalle"
    with pytest.raises(SystemExit) as ei:
        train_dalle.main(["--dummy_run", "3", "--device", "cpu", "--dalle_output_file_name", str(out)])
    assert ei.value.code == resilience.EXIT_OOM == 77
    reports = list((tmp_path / "dalle.telemetry").glob("oom_report_train_step_*.txt"))
    assert len(reports) == 1
    text = reports[0].read_text()
    assert "CUDA out of memory" in text and "<-- dominant" in text and "global_step: 1" in text
    assert "activations" in text and ("remat" in text or "ga_steps" in text)
    assert "OUT OF MEMORY during train_step" in capsys.readouterr().out
    assert telemetry.active() is None
    kinds = [json.loads(line)["kind"] for line in (tmp_path / "dalle.telemetry" / "dalle.spans.jsonl").open()]
    assert "mem_ledger" in kinds and "run_end" in kinds


def test_generate_oom_exits_77_with_a_report(tmp_path, monkeypatch):
    from dalle_pytorch_tpu_torch.cli import generate, train_dalle

    out = tmp_path / "dalle"
    assert train_dalle.main(["--dummy_run", "1", "--device", "cpu", "--telemetry", "off",
                             "--dalle_output_file_name", str(out)]) == 0

    def failing(*args, **kwargs):
        tmem.provoke_oom("sampling", device="cpu")

    monkeypatch.setattr(generate, "generate_images", failing)
    with pytest.raises(SystemExit) as ei:
        generate.main(["--dalle_path", f"{out}.pt", "--text", "a b", "--num_images", "2", "--batch_size", "2",
                       "--cond_scale", "3", "--outputs_dir", str(tmp_path / "outs"), "--device", "cpu"])
    assert ei.value.code == 77
    reports = list((tmp_path / "outs").glob("oom_report_sampling_*.txt"))
    assert len(reports) == 1
    text = reports[0].read_text()
    assert "kv_cache" in text and "x b4 x" in text and "<-- dominant" in text
    assert not (tmp_path / "dalle.telemetry").exists()  # --telemetry off writes nothing


def test_dummy_ledger_arithmetic_matches_its_rows(tmp_path, capsys):
    """The printed ledger's rows are the `mem_ledger` event's, and the
    event's rows sum to its total."""
    from dalle_pytorch_tpu_torch.cli import train_dalle

    out = tmp_path / "dalle"
    assert train_dalle.main(["--dummy_run", "2", "--device", "cpu", "--dalle_output_file_name", str(out)]) == 0
    printed = next(ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[memory] analytic"))
    records = [json.loads(line) for line in (tmp_path / "dalle.telemetry" / "dalle.spans.jsonl").open()]
    ledger = next(r for r in records if r["kind"] == "mem_ledger")
    assert math.isclose(sum(r["bytes"] for r in ledger["rows"]), ledger["total_bytes"])
    for row in ledger["rows"]:
        assert f"{row['name']}={row['bytes'] / 1e9:.2f}GB" in printed
    assert ledger["capacity_bytes"] is None and "capacity unknown" in printed
