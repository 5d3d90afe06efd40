"""The port's serving fleet (`serving/fleet.py`, `serving/router.py`) on the
CPU, after the JAX package's `tests/test_fleet_serving.py` and
`tests/test_serving_durability.py`.

Held against the JAX package: under injected noise, a fleet of two
replicas, with prefill fused or disaggregated (the prefix handed from the
prefill worker to the decode replica), gives each request the codes of the
JAX package's batch-1 `sample_image_codes` (guided requests, a
temperature); with a replica killed mid-decode every request completes on
the survivor with those codes; an engine drained mid-decode, and one
drained mid-speculation, export exactly the codes accepted so far, and a
resubmission completes them.  The handoff's comms row equals the JAX
row and the handoff tensors' bytes, and the router's placement order and
breaker transitions equal the JAX router's over fake engines with the same
loads and one clock.  Port-only: the stall drill (breaker open, hedge,
duplicate suppressed), a spent retry budget, the last replica kept, and
what needs `parallel/reshard` refused."""
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu_torch import weights
from dalle_pytorch_tpu_torch.models import dalle as tdalle
from dalle_pytorch_tpu_torch.models import sampling as tsamp
from dalle_pytorch_tpu_torch.observability import metrics as obs_metrics
from dalle_pytorch_tpu_torch.serving import router as port_router
from dalle_pytorch_tpu_torch.serving.engine import EngineConfig, GenerationEngine
from dalle_pytorch_tpu_torch.serving.fleet import FleetConfig, PrefillWorker, ServingFleet
from dalle_pytorch_tpu_torch.serving.journal import RequestJournal
from dalle_pytorch_tpu_torch.serving.scheduler import AdmissionRefused, Request
from dalle_pytorch_tpu_torch.training import resilience

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


@pytest.fixture(autouse=True)
def fresh_registry():
    """The process's metrics outlive a test: each starts from none."""
    obs_metrics.REGISTRY.reset()
    yield
    obs_metrics.REGISTRY.reset()


@pytest.fixture
def fault():
    armed = []

    def arm(spec):
        armed.append(resilience.FaultInjector(resilience.parse_fault(spec)).install())

    yield arm
    for inj in armed:
        inj.uninstall()


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
    text[4, 3:] = 0
    noise = rng.gumbel(size=(6, cfg.image_seq_len, cfg.total_tokens)).astype(np.float32)
    return text, noise


@pytest.fixture(scope="module")
def jax_codes(jx, inputs):
    """Each request's codes from the JAX package's batch-1
    `sample_image_codes` under its noise, made once."""
    jax, jcfg, params = jx
    from dalle_pytorch_tpu.models import sampling as jsamp

    text, noise = inputs
    cache = {}

    def codes(i):
        if i not in cache:
            cache[i] = np.asarray(jsamp.sample_image_codes(
                params, jcfg, jax.numpy.asarray(text[i:i + 1]), jax.random.PRNGKey(0), filter_thres=THRES,
                temperature=TEMP[i], cond_scale=COND[i], noise_override=jax.numpy.asarray(noise[i][:, None])))[0]
        return cache[i]

    return codes


def _ecfg(**kw):
    return EngineConfig(**dict(dict(num_slots=4, block_size=4, filter_thres=THRES, noise_override=True), **kw))


def _submit_staggered(fleet, text, noise, polls=6):
    """The six requests, two at a time with `polls` fleet polls between;
    returns (requests, completions so far)."""
    reqs, done = [], []
    for i in range(6):
        reqs.append(fleet.submit(text[i], temperature=TEMP[i], cond_scale=COND[i], noise=noise[i]))
        if i % 2:
            for _ in range(polls):
                done.extend(fleet.poll())
    return reqs, done


@pytest.mark.parametrize("disaggregate", [False, True], ids=["fused", "disaggregated"])
def test_fleet_codes_equal_both_packages_batch1(model, inputs, jax_codes, disaggregate):
    text, noise = inputs
    fleet = ServingFleet(model, fleet_cfg=FleetConfig(replicas=2, disaggregate=disaggregate, engine=_ecfg()))
    assert all(e.prefill_backend is fleet.prefill_worker for e in fleet.engines)
    reqs, done = _submit_staggered(fleet, text, noise)
    done += fleet.run_until_idle()
    assert sorted(r.id for r in done) == sorted(r.id for r in reqs) or len(done) == 6
    for i, req in enumerate(reqs):
        port = tsamp.sample_image_codes(model, torch.as_tensor(text[i:i + 1]), filter_thres=THRES,
                                        temperature=TEMP[i], cond_scale=COND[i],
                                        noise_override=torch.from_numpy(noise[i][:, None])).numpy()[0]
        np.testing.assert_array_equal(port, jax_codes(i))
        np.testing.assert_array_equal(req.codes, port)
    # the router placed on both replicas, and each admission's handoff was counted once
    assert min(obs_metrics.counter(f"router/submitted_r{r}").value for r in (0, 1)) > 0
    assert obs_metrics.counter("serving/handoff_requests").value == (6 if disaggregate else 0)
    assert obs_metrics.counter("serving/admitted").value == 6


@pytest.mark.parametrize("disaggregate", [False, True], ids=["fused", "disaggregated"])
def test_kill_replica_mid_decode_requeues_and_completes(model, inputs, jax_codes, fault, disaggregate):
    """`kill-replica@8:0`: replica 0 is drained mid-decode, its requests
    requeue on replica 1, and every request completes once with the JAX
    package's batch-1 codes; one `replica_lost` alarm."""
    text, noise = inputs
    fault("kill-replica@8:0")
    fleet = ServingFleet(model, fleet_cfg=FleetConfig(replicas=2, disaggregate=disaggregate, engine=_ecfg()))
    reqs, done = _submit_staggered(fleet, text, noise, polls=3)
    done += fleet.run_until_idle()
    lost = [a for a in fleet.router.alarms if a["type"] == "replica_lost"]
    assert len(lost) == 1 and lost[0]["replica"] == 0 and lost[0]["requeued"] > 0
    assert fleet.engines[0].kv is None and fleet.engines[0].graph is None  # the lost replica's pool freed
    assert obs_metrics.counter("router/requeued").value == lost[0]["requeued"]
    by_uid = {r.trace_uid: r for r in done}
    assert len(done) == 6 and len(by_uid) == 6
    deferred = 0
    for i, req in enumerate(reqs):
        got = by_uid[req.trace_uid]
        deferred += req.outcome == "deferred"
        np.testing.assert_array_equal(got.codes, jax_codes(i))
    assert deferred == lost[0]["requeued"]


def test_drain_mid_decode_resubmit_exact(model, inputs, jax_codes):
    text, noise = inputs
    engine = GenerationEngine(model, engine_cfg=_ecfg(num_slots=2))
    req = engine.submit(text[1], temperature=TEMP[1], cond_scale=COND[1], noise=noise[1])
    for _ in range(6):
        engine.poll()
    (exp,) = engine.drain()
    assert 0 < exp["codes_done"] < 16 and req.outcome == "deferred" and not engine.busy
    np.testing.assert_array_equal(exp["codes"], jax_codes(1)[:exp["codes_done"]])
    fresh = GenerationEngine(model, engine_cfg=_ecfg(num_slots=2))
    again = fresh.submit(exp["text"], temperature=exp["temperature"], cond_scale=exp["cond_scale"], noise=exp["noise"])
    fresh.run_until_idle()
    np.testing.assert_array_equal(again.codes, jax_codes(1))


def test_drain_mid_speculation_exports_only_accepted_codes(model, inputs, jax_codes):
    """Drained between speculative rounds, an engine exports the verified
    codes alone; a sequential engine completes the request with them."""
    text, noise = inputs
    engine = GenerationEngine(model, engine_cfg=_ecfg(num_slots=2, spec_k=2, spec_draft_layers=1))
    req = engine.submit(text[0], temperature=TEMP[0], cond_scale=COND[0], noise=noise[0])
    engine.poll()
    engine.poll()
    assert 0 < req.codes_done < 16 and req.spec_rounds == 2
    (exp,) = engine.drain()
    assert exp["codes_done"] == len(exp["codes"]) == req.codes_done
    np.testing.assert_array_equal(exp["codes"], jax_codes(0)[:exp["codes_done"]])
    fresh = GenerationEngine(model, engine_cfg=_ecfg(num_slots=2))
    again = fresh.submit(exp["text"], temperature=exp["temperature"], cond_scale=exp["cond_scale"], noise=exp["noise"])
    fresh.run_until_idle()
    np.testing.assert_array_equal(again.codes, jax_codes(0))


@pytest.mark.parametrize("quantize_kv", [None, "int8"], ids=["f32", "int8"])
def test_handoff_row_equals_jax_and_the_handoff_bytes(model, jx, inputs, quantize_kv):
    """The worker's comms row equals the JAX worker's, and its payload and
    ring bytes are the handoff tensors' own, guided (two lanes) and not."""
    _, jcfg, params = jx
    from dalle_pytorch_tpu.serving.fleet import PrefillWorker as JaxWorker

    text, _ = inputs
    worker = PrefillWorker(model, THRES, quantize_kv=quantize_kv)
    jworker = JaxWorker(params, jcfg, THRES, quantize_kv=quantize_kv)
    for lanes, cond in ((1, 1.0), (2, 3.0)):
        req = Request(id=0, text=np.asarray(text[0]), seed=3, cond_scale=cond)
        handoff = worker.prefill(req)
        row = handoff["comms_row"]
        assert row == jworker.handoff_row(lanes)
        kv = sum(layer[n].nbytes for layer in handoff["layers"] for n in ("k", "v", "k_scale", "v_scale")
                 if n in layer)
        ring = sum(layer[n].nbytes for layer in handoff["layers"] for n in ("shift_attn", "shift_ff"))
        assert (kv, ring, handoff["lanes"]) == (row["payload_bytes"], row["ring_bytes"], lanes)
    assert obs_metrics.counter("serving/handoff_bytes").value == sum(
        worker.handoff_row(n)["bytes_per_step"] for n in (1, 2))


class _FakeQueue:
    def __init__(self, depth, max_depth=8):
        self._q = [None] * depth
        self.max_depth = max_depth

    def __len__(self):
        return len(self._q)

    def __iter__(self):
        return iter([])


class _FakeEngine:
    """What a router reads of an engine: loads, an iteration count."""

    def __init__(self, queue, free, slots, used, usage):
        self.queue = _FakeQueue(queue)
        self.free_slots = free
        self.ecfg = type("E", (), {"num_slots": slots})()
        self.pool = type("P", (), {"occupancy_frac": used, "free_blocks": int(64 * (1 - used))})()
        self.admission = type("A", (), {"usage_fn": staticmethod(lambda u=usage: u)})()
        self._iter = 0
        self._inflight = [object()]
        self.replica_id = None
        self.stalled = False

    @property
    def busy(self):
        return True

    def number_requests(self, first, step):
        pass

    def poll(self):
        if not self.stalled:
            self._iter += 1
        return []


def test_router_placement_and_breakers_equal_the_jax_router(monkeypatch):
    """Fake replicas with one set of loads and one clock: both routers rank
    them alike, and over a stall and its recovery their breakers pass
    through the same states with the same alarms."""
    from dalle_pytorch_tpu.serving import router as jax_router

    loads = [(2, 1, 4, 0.5, None), (0, 3, 4, 0.25, 0.5), (5, 0, 4, 0.9, 0.1), (0, 4, 4, 0.0, 0.95)]
    clock = {"t": 100.0}
    monkeypatch.setattr(port_router.time, "monotonic", lambda: clock["t"])
    routers, alarms = [], ([], [])
    for mod, got in zip((port_router, jax_router), alarms):
        routers.append(mod.Router([_FakeEngine(*l) for l in loads], on_alarm=got.append, stall_after_s=1.0,
                                  probe_after_s=2.0))
    assert [r.id for r in routers[0].ranked()] == [r.id for r in routers[1].ranked()] == [3, 1, 0, 2]
    assert [r.id for r in routers[0].ranked(exclude=1)] == [r.id for r in routers[1].ranked(exclude=1)]
    trace = ([], [])
    for step in range(14):
        clock["t"] += 0.5
        for router, seen in zip(routers, trace):
            router.replicas[2].engine.stalled = 3 <= step < 10
            for r in router.replicas:
                r.engine.poll()
            router._update_breakers()
            seen.append(([router.breaker_state(i) for i in range(4)], [r.id for r in router.ranked()]))
    assert trace[0] == trace[1]
    assert [s[0][2] for s in trace[0]].count("open") > 0 and "half_open" in [s[0][2] for s in trace[0]]
    assert trace[0][-1][0] == ["closed"] * 4
    assert alarms[0] == alarms[1] and [a["type"] for a in alarms[0]] == ["replica_circuit_open"]


def test_router_sheds_when_every_replica_refuses(model, inputs):
    text, _ = inputs
    fleet = ServingFleet(model, fleet_cfg=FleetConfig(replicas=2, engine=_ecfg(max_queue=1, noise_override=False)))
    fleet.submit(text[0], seed=1)
    fleet.submit(text[1], seed=2)
    with pytest.raises(AdmissionRefused, match="queue full"):
        fleet.submit(text[2], seed=3)
    assert obs_metrics.counter("router/shed").value == 1
    assert obs_metrics.counter("serving/refused_queue_overflow").value == 2
    assert len(fleet.run_until_idle()) == 2


def test_stall_replica_opens_the_breaker_and_the_hedge_wins_once(model, inputs, fault):
    """`stall-replica@3:1` wedges replica 1 for 1.5 s: its breaker opens
    (one alarm), its requests with a deadline are hedged on replica 0, the
    first completion of each pair is delivered and the second suppressed,
    and the breaker closes when the replica moves again.  Every delivered
    request has its batch-1 codes."""
    text, _ = inputs
    fault("stall-replica@3:1")
    fleet = ServingFleet(model, fleet_cfg=FleetConfig(replicas=2, engine=_ecfg(noise_override=False),
                                                      stall_wedge_s=1.5, stall_after_s=0.05, probe_after_s=0.05,
                                                      hedge_frac=0.01))
    reqs = [fleet.submit(text[i], seed=50 + i, deadline_s=10.0) for i in range(4)]
    done = fleet.run_until_idle()
    assert {r.replica for r in reqs} == {0, 1}
    hedged = obs_metrics.counter("router/hedged").value
    assert hedged >= 1 and obs_metrics.counter("router/hedge_duplicates").value == hedged
    assert obs_metrics.counter("router/breaker_open").value == 1
    assert obs_metrics.counter("router/breaker_closed").value >= 1
    assert [a["type"] for a in fleet.router.alarms] == ["replica_circuit_open"]
    assert sorted(r.trace_uid for r in done) == sorted(r.trace_uid for r in reqs)
    for i, req in enumerate(reqs):
        got = next(r for r in done if r.trace_uid == req.trace_uid)
        want = tsamp.sample_image_codes(model, torch.as_tensor(text[i:i + 1]), torch.Generator().manual_seed(50 + i),
                                        filter_thres=THRES).numpy()[0]
        np.testing.assert_array_equal(got.codes, want)


def test_a_spent_retry_budget_ends_requeue_exhausted(model, inputs, tmp_path):
    """A lost replica's request without retries left is not requeued: it
    ends `requeue_exhausted`, acknowledged in the journal, with one alarm."""
    text, _ = inputs
    fleet = ServingFleet(model, fleet_cfg=FleetConfig(replicas=2, engine=_ecfg(noise_override=False)))
    journal = RequestJournal(str(tmp_path))
    fleet.attach_journal(journal)
    reqs = [fleet.submit(text[i], seed=i, retries_left=0) for i in range(2)]
    fleet.poll()
    on_0 = [r for r in reqs if r.replica == 0]
    assert fleet.kill_replica(0) == []
    assert obs_metrics.counter("router/requeue_exhausted").value == len(on_0) == 1
    assert [a["type"] for a in fleet.router.alarms] == ["replica_lost", "requeue_exhausted"]
    fleet.run_until_idle()
    assert journal.stats() == {"accepted": 2, "acked": 2, "unacknowledged": 0}
    journal.close()


def test_the_last_replica_stays_and_reshard_names_its_item(model):
    fleet = ServingFleet(model, fleet_cfg=FleetConfig(replicas=2, engine=_ecfg()))
    wedged = fleet.engines[1]
    wedged.wedge(60.0)
    assert wedged.stalled and wedged.poll() == [] and wedged._iter == 0
    fleet.kill_replica(1)
    assert fleet.kill_replica(0) == [] and [r.id for r in fleet.router.alive()] == [0]
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 7"):
        FleetConfig(reshard_on_kill=True)
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 7"):
        PrefillWorker(model, mesh=object())


def test_completions_made_while_a_requeue_waits_are_returned(model, inputs, fault):
    """`kill-replica@2:0` while the survivor's one lane and its queue of one
    are full: the requeue polls the survivor until there is room, and the
    requests it completes meanwhile come back from the fleet's next poll,
    so every journey is returned once, with its batch-1 codes."""
    text, _ = inputs
    fault("kill-replica@2:0")
    fleet = ServingFleet(model, fleet_cfg=FleetConfig(replicas=2, engine=_ecfg(num_slots=1, max_queue=1,
                                                                               noise_override=False)))
    reqs = [fleet.submit(text[i], seed=20 + i) for i in range(2)]
    fleet.poll()
    reqs += [fleet.submit(text[i], seed=20 + i) for i in range(2, 4)]
    assert [r.replica for r in reqs] == [0, 1, 0, 1]
    done = fleet.run_until_idle()
    assert obs_metrics.counter("router/requeued").value == 2
    assert sorted(r.trace_uid for r in done) == sorted(r.trace_uid for r in reqs)
    for i, req in enumerate(reqs):
        got = next(r for r in done if r.trace_uid == req.trace_uid)
        want = tsamp.sample_image_codes(model, torch.as_tensor(text[i:i + 1]), torch.Generator().manual_seed(20 + i),
                                        filter_thres=THRES).numpy()[0]
        np.testing.assert_array_equal(got.codes, want)


def test_unseeded_requests_get_fleet_unique_seeds_and_uids(model, inputs, tmp_path):
    """One prompt, unseeded, on each replica: two seeds, two uids, both
    journaled and acknowledged once.  After a restart the journal's seeds
    are skipped, so a new unseeded request is journaled as well."""
    text, _ = inputs
    journal = RequestJournal(str(tmp_path))
    fleet = ServingFleet(model, fleet_cfg=FleetConfig(replicas=2, engine=_ecfg(noise_override=False)))
    fleet.attach_journal(journal)
    reqs = [fleet.submit(text[0]) for _ in range(2)]
    assert sorted(r.replica for r in reqs) == [0, 1]
    assert reqs[0].seed != reqs[1].seed and reqs[0].journal_uid != reqs[1].journal_uid
    assert journal.stats() == {"accepted": 2, "acked": 0, "unacknowledged": 2}
    fleet.run_until_idle()
    assert journal.stats() == {"accepted": 2, "acked": 2, "unacknowledged": 0}
    assert obs_metrics.counter("journal/duplicate_acks").value == 0
    journal.close()
    journal = RequestJournal(str(tmp_path))
    fleet = ServingFleet(model, fleet_cfg=FleetConfig(replicas=2, engine=_ecfg(noise_override=False)))
    fleet.attach_journal(journal)
    again = [fleet.submit(text[0]) for _ in range(2)]
    assert sorted(r.seed for r in again) == [2, 3]
    assert journal.stats() == {"accepted": 4, "acked": 2, "unacknowledged": 2}
    fleet.run_until_idle()
    journal.close()
