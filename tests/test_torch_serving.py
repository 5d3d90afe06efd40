"""The port's continuous-batching engine (`serving/engine.py`) on the CPU,
after the JAX package's `tests/test_serving.py`.

A request served through the engine (admitted into the shared pool,
decoded beside other requests at other positions, evicted, its blocks
reused) gives the codes of a batch-1 `sample_image_codes` call with the
same text and settings: (a) under the same injected noise, the port's and
the JAX package's; (b) under the same generator seed, the port's, alone or
beside other requests, in any lane.  Six requests on four lanes, two of
them guided (two lanes each), one at temperature 0.7, submitted so that
the later ones wait for evictions and take freed blocks.  Then the
admission paths: a pool too small for a request refuses it ("never_fits"),
a pool that fits one sequence holds the next one back ("pool") and
serialises the two, a full queue refuses ("queue_overflow"), memory
pressure holds admissions while work is in flight, and the port's loadgen
draws the JAX loadgen's arrivals and reports its keys."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from dalle_pytorch_tpu_torch import weights
from dalle_pytorch_tpu_torch.models import dalle as tdalle
from dalle_pytorch_tpu_torch.models import sampling as tsamp
from dalle_pytorch_tpu_torch.serving.engine import EngineConfig, GenerationEngine
from dalle_pytorch_tpu_torch.serving.scheduler import AdmissionRefused
from dalle_pytorch_tpu_torch.tools import loadgen

REPO = Path(__file__).resolve().parents[1]
# seq 22 = text 6 + a 4 x 4 map: a sequence spans 6 blocks of 4
MODEL = dict(dim=64, depth=2, heads=2, dim_head=32, num_text_tokens=40, text_seq_len=6, num_image_tokens=32,
             image_fmap_size=4, shift_tokens=True, attn_types=("full", "axial_row"))
THRES = 0.5
COND = [1.0, 3.0, 1.0, 3.0, 1.0, 1.0]
TEMP = [1.0, 1.0, 0.7, 1.0, 1.0, 1.0]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    from dalle_pytorch_tpu.models import dalle as jdalle

    jcfg = jdalle.DALLEConfig(**MODEL)
    params = jax.device_get(jdalle.init_dalle(jax.random.PRNGKey(0), jcfg))
    return jax, jcfg, params


@pytest.fixture(scope="module")
def model(jx):
    _, _, params = jx
    return weights.load_dalle(params, tdalle.DALLEConfig(**MODEL), device="cpu")


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(1)
    cfg = tdalle.DALLEConfig(**MODEL)
    text = rng.integers(1, cfg.num_text_tokens, (6, cfg.text_seq_len))
    text[4, 3:] = 0  # padding takes the per-position pad ids
    noise = rng.gumbel(size=(6, cfg.image_seq_len, cfg.total_tokens)).astype(np.float32)
    return text, noise


def _engine(model, **kw):
    return GenerationEngine(model, engine_cfg=EngineConfig(**dict(dict(num_slots=4, block_size=4, filter_thres=THRES),
                                                                  **kw)))


def _staggered(engine, text, **per_request):
    """Submit the six requests two at a time, polling 20 steps between, so
    that admissions happen mid-decode of the others; returns them."""
    reqs = []
    for i in range(6):
        reqs.append(engine.submit(text[i], temperature=TEMP[i], cond_scale=COND[i],
                                  **{k: v[i] for k, v in per_request.items()}))
        if i % 2:
            for _ in range(20):
                engine.poll()
    engine.run_until_idle()
    return reqs


def _tracked_tables(engine):
    seen = []
    alloc = engine.pool.alloc_table

    def tracking(owner):
        table = alloc(owner)
        seen.append(set(table.tolist()))
        return table

    engine.pool.alloc_table = tracking
    return seen


def _port_ref(model, text_row, temperature, cond_scale, **kw):
    return tsamp.sample_image_codes(model, torch.as_tensor(text_row)[None], filter_thres=THRES,
                                    temperature=temperature, cond_scale=cond_scale, **kw).numpy()[0]


def test_injected_noise_gives_both_packages_batch1_codes(jx, model, inputs):
    """Property (a): each request's codes equal the port's and the JAX
    package's batch-1 `sample_image_codes` under its noise, across staggered
    admission, block reuse, guided pairs and a temperature."""
    jax, jcfg, params = jx
    from dalle_pytorch_tpu.models import sampling as jsamp

    text, noise = inputs
    engine = _engine(model, noise_override=True)
    seen = _tracked_tables(engine)
    reqs = _staggered(engine, text, noise=list(noise))
    for i, req in enumerate(reqs):
        assert req.outcome == "completed" and req.ttft_s is not None and req.latency_s >= req.ttft_s
        port = _port_ref(model, text[i], TEMP[i], COND[i], noise_override=torch.from_numpy(noise[i][:, None]))
        ref = np.asarray(jsamp.sample_image_codes(
            params, jcfg, jax.numpy.asarray(text[i:i + 1]), jax.random.PRNGKey(0), filter_thres=THRES,
            temperature=TEMP[i], cond_scale=COND[i], noise_override=jax.numpy.asarray(noise[i][:, None])))[0]
        np.testing.assert_array_equal(port, ref)
        np.testing.assert_array_equal(req.codes, port)
    assert len({tuple(r.codes) for r in reqs}) == 6
    # eviction returned every block, later admissions reused freed ones, and
    # no table held the trash block
    assert engine.pool.free_blocks == engine.pool.num_blocks and engine.free_slots == 4
    assert len(seen) == 8 and set().union(*seen[:4]) & set().union(*seen[4:])
    assert 0 not in set().union(*seen)


def test_seeded_requests_give_the_batch1_codes_of_their_seed(model, inputs):
    """Property (b): a seeded request's codes equal the port's batch-1 call
    whose generator has that seed."""
    text, _ = inputs
    engine = _engine(model)
    reqs = _staggered(engine, text, seed=[100 + i for i in range(6)])
    for i, req in enumerate(reqs):
        want = _port_ref(model, text[i], TEMP[i], COND[i], generator=torch.Generator().manual_seed(100 + i))
        np.testing.assert_array_equal(req.codes, want)


def test_a_seeded_request_alone_and_beside_others_in_another_lane(model, inputs):
    text, _ = inputs
    alone = _engine(model)
    (req,) = alone.generate(text[2:3], seeds=[7], cond_scale=3.0)
    assert req.lanes == [0, 1]
    crowded = _engine(model, num_slots=5)
    crowded.submit(text[0], seed=1)
    crowded.submit(text[1], seed=2, cond_scale=3.0)
    for _ in range(5):
        crowded.poll()
    other = crowded.submit(text[2], seed=7, cond_scale=3.0)
    crowded.submit(text[3], seed=3)
    crowded.run_until_idle()
    assert other.lanes == [3, 4]
    np.testing.assert_array_equal(other.codes, req.codes)


def test_drain_exports_what_reproduces_the_request(model, inputs):
    text, _ = inputs
    engine = _engine(model, num_slots=2)
    engine.submit(text[0], seed=11)
    engine.submit(text[1], seed=12, cond_scale=3.0)  # waits: one lane is free, it needs two
    for _ in range(6):
        engine.poll()
    exports = engine.drain()
    # the queued request first, then the one in flight, as the JAX engine exports them
    assert [e["codes_done"] for e in exports] == [0, 7] and exports[0]["codes"] is None
    assert engine.free_slots == 2 and engine.pool.free_blocks == engine.pool.num_blocks and not engine.busy
    (again,) = _engine(model, num_slots=2).generate(text[:1], seeds=[exports[1]["seed"]])
    np.testing.assert_array_equal(again.codes[:7], exports[1]["codes"])


def test_a_tiny_pool_refuses_and_a_full_queue_sheds(model, inputs):
    text, _ = inputs
    engine = _engine(model, num_blocks=2)
    with pytest.raises(AdmissionRefused, match="pool only has 2") as e:
        engine.submit(text[0])
    assert e.value.kind == "never_fits" and engine.admission.counts["refused_never_fits"] == 1
    one_seq = _engine(model, num_blocks=engine.pool.blocks_per_seq)
    with pytest.raises(AdmissionRefused) as e:  # a guided request needs two sequences
        one_seq.submit(text[0], cond_scale=3.0)
    assert e.value.kind == "never_fits"
    queue = _engine(model, max_queue=2)
    queue.submit(text[0])
    queue.submit(text[1])
    with pytest.raises(AdmissionRefused, match="queue full") as e:
        queue.submit(text[2])
    assert e.value.kind == "queue_overflow" and queue.admission.counts["refused_queue_overflow"] == 1


def test_pool_exhaustion_serialises_admissions(model, inputs):
    """A pool of one sequence holds the second request back ("pool") until
    the first is evicted; both complete with their batch-1 codes."""
    text, _ = inputs
    engine = _engine(model, num_blocks=6)
    reqs = [engine.submit(text[i], seed=30 + i) for i in range(2)]
    engine.poll()
    reason, kind = engine.admission.may_admit_ex(reqs[1], engine.free_slots, in_flight=1)
    assert kind == "pool" and "pool exhausted" in reason
    engine.run_until_idle()
    assert engine.admission.counts["admission_deferrals"] > 0
    assert reqs[1].deferrals > 0 and reqs[1].admitted_t >= reqs[0].latency_s + reqs[0].arrival_t - 1e-3
    for i, req in enumerate(reqs):
        want = _port_ref(model, text[i], 1.0, 1.0, generator=torch.Generator().manual_seed(30 + i))
        np.testing.assert_array_equal(req.codes, want)


def test_memory_pressure_holds_admissions_while_work_is_in_flight(model, inputs):
    text, _ = inputs
    usage = {"v": 0.1}
    engine = GenerationEngine(model, engine_cfg=EngineConfig(num_slots=2, block_size=4, filter_thres=THRES),
                              usage_fn=lambda: usage["v"])
    engine.submit(text[0])
    engine.poll()
    usage["v"] = 0.99
    second = engine.submit(text[1])
    engine.poll()
    assert second.lanes is None and second.deferrals == 1
    usage["v"] = 0.1
    engine.poll()
    assert second.lanes is not None
    engine.run_until_idle()
    idle = GenerationEngine(model, engine_cfg=EngineConfig(num_slots=2, block_size=4), usage_fn=lambda: 0.99)
    idle.submit(text[0])
    idle.poll()  # an idle engine admits whatever the pressure
    assert idle.busy and idle.admission.counts["headroom_overrides"] == 1


def test_engine_config_refuses_what_is_not_ported(model):
    """What the engine cannot run: a KV dtype other than int8, a negative
    spec_k, a drafter depth without speculation, speculation the model
    refuses (`validate_spec`)."""
    for kw, what in ((dict(quantize_kv="fp8"), "kv quant must be one of"), (dict(spec_k=-1), "spec_k must be"),
                     (dict(spec_draft_layers=1), "spec_draft_layers needs speculation")):
        with pytest.raises(ValueError, match=what):
            EngineConfig(**kw)
    for kw, what in ((dict(spec_k=4), "too large for image_fmap_size"), (dict(spec_k=2, spec_draft_layers=2),
                                                                          "1 <= d < depth")):
        with pytest.raises(ValueError, match=what):
            _engine(model, **kw)
    with pytest.raises(ValueError, match="graphs=True needs the model on a CUDA device"):
        GenerationEngine(model, graphs=True)
    with pytest.raises(ValueError, match="noise_override=True"):
        _engine(model).submit(np.ones(6), noise=np.zeros((16, 78), np.float32))
    with pytest.raises(ValueError, match="noise must have shape"):
        _engine(model, noise_override=True).submit(np.ones(6), noise=np.zeros((16, 110), np.float32))


def _jax_loadgen():
    spec = importlib.util.spec_from_file_location("jax_tools_loadgen", REPO / "tools" / "loadgen.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("n,rate,streams,seed", [(7, 10.0, 2, 3), (16, 2.0, 3, 0), (1, 0.5, 1, 9)])
def test_loadgen_draws_the_jax_arrivals(n, rate, streams, seed):
    jgen = _jax_loadgen().PoissonLoadGen(n, rate, streams=streams, seed=seed)
    gen = loadgen.PoissonLoadGen(n, rate, streams=streams, seed=seed)
    assert gen.arrivals == jgen.arrivals


def test_loadgen_report_has_the_jax_keys(model, jx):
    _, jcfg, _ = jx
    jmod = _jax_loadgen()
    engine = _engine(model)
    make = loadgen.synthetic_request_maker(model.cfg, seed=4, zipf_s=1.1, prompt_pool=5)
    jmake = jmod.synthetic_request_maker(jcfg, seed=4, zipf_s=1.1, prompt_pool=5)
    for i in range(3):  # the same prompts as the JAX maker's
        np.testing.assert_array_equal(make(i)["text"], jmake(i)["text"])
    make = loadgen.synthetic_request_maker(model.cfg, seed=4, cond_scale=3.0)
    report = loadgen.PoissonLoadGen(4, 50.0, streams=2, seed=4).run(engine, make)

    class R:
        def __init__(self, t, lat):
            self.ttft_s, self.latency_s = t, lat

    want = jmod.PoissonLoadGen(4, 50.0, streams=2, seed=4).report([R(0.1, 0.5)], refused=0, elapsed_s=1.0)
    want["synthetic_completed"] = 0
    assert set(report) == set(want)
    assert report["requests_completed"] == 4 and report["requests_refused"] == 0
    assert 0 < report["ttft_p50_s"] <= report["latency_p50_s"] <= report["latency_p99_s"]
    assert report["images_per_sec_per_chip"] > 0


# ---------------------------------------------------------------------------
# a CPU stand-in for "capturable", and the card
# ---------------------------------------------------------------------------

# ops that wait for the device or read host data: none may run in a step
FORBIDDEN = ("_local_scalar_dense", "item", "nonzero", "is_nonzero", "equal", "masked_select", "unique",
             "lift_fresh", "lift_fresh_copy", "tolist")


def _describe(x):
    if isinstance(x, torch.Tensor):
        return ("tensor", tuple(x.shape), x.dtype, x.device.type)
    if isinstance(x, (list, tuple)):
        return tuple(_describe(v) for v in x)
    if isinstance(x, dict):
        return tuple((k, _describe(v)) for k, v in sorted(x.items()))
    if isinstance(x, torch.Generator):
        return "generator"
    return repr(x)


class StepRecorder(TorchDispatchMode):
    """The aten ops of each engine step, with their tensors' shapes and
    dtypes and every other argument's value."""

    def __init__(self):
        super().__init__()
        self.steps, self.current = [], None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self.current is not None:
            self.current.append((func.overloadpacket.__name__, str(func), _describe(args), _describe(kwargs or {})))
        return func(*args, **(kwargs or {}))


def test_every_engine_step_records_the_same_ops(monkeypatch, inputs):
    """The step a CUDA graph captures: one op sequence at every step, as
    lanes are admitted, decode at other positions and are evicted (the
    pattern model's lanes gather their keys), and no op that syncs with the
    host."""
    text, noise = inputs
    model = tdalle.init_dalle(tdalle.DALLEConfig(**dict(MODEL, attn_types=("full", "axial_row", "conv_like"),
                                                        depth=3)),
                              torch.Generator().manual_seed(0), "cpu")
    engine = _engine(model, noise_override=True)
    recorder = StepRecorder()
    step = engine._step

    def recorded():
        recorder.current = []
        step()
        recorder.steps.append(recorder.current)
        recorder.current = None

    monkeypatch.setattr(engine, "_step", recorded)
    with recorder:
        _staggered(engine, text, noise=[noise[i] if i % 2 else None for i in range(6)])
    steps = recorder.steps
    assert len(steps) == engine.decode_steps > 30 and len(steps[0]) > 50
    for i, ops in enumerate(steps[1:], 2):
        assert ops == steps[0], f"step {i} differs from step 1"
    names = {op[0] for op in steps[0]}
    assert not names & set(FORBIDDEN), names & set(FORBIDDEN)
    assert {"index", "index_put_", "gather", "argmax", "add_"} <= names


@pytest.fixture(scope="module")
def cuda_model():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return tdalle.init_dalle(tdalle.DALLEConfig(**MODEL), torch.Generator("cuda").manual_seed(0), "cuda")


@pytest.mark.cuda
def test_replayed_engine_equals_eager_and_batch1_on_card(cuda_model, inputs):
    """On the card: the replayed step's codes equal the eager step's and the
    batch-1 call's, under noise and under seeds (the lanes' registered
    generators reseeded between replays)."""
    text, noise = inputs
    runs = {}
    for graphs in (None, False):
        engine = GenerationEngine(cuda_model, engine_cfg=EngineConfig(num_slots=4, block_size=4, filter_thres=THRES,
                                                                      noise_override=True), graphs=graphs)
        assert (engine.graph is not None) == (graphs is None)
        runs[graphs] = ([r.codes for r in _staggered(engine, text, noise=[torch.from_numpy(n) for n in noise])],
                        [r.codes for r in _staggered(engine, text, seed=[40 + i for i in range(6)])])
    for a, b in zip(runs[None], runs[False]):
        np.testing.assert_array_equal(np.stack(a), np.stack(b))
    for i in range(6):
        want = tsamp.sample_image_codes(cuda_model, torch.as_tensor(text[i:i + 1]).cuda(),
                                        torch.Generator("cuda").manual_seed(40 + i), filter_thres=THRES,
                                        temperature=TEMP[i], cond_scale=COND[i]).cpu().numpy()[0]
        np.testing.assert_array_equal(runs[None][1][i], want)
