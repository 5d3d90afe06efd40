"""The engine's nonfinite screen, its poison quarantine and the two serving
drills (`serving/lanes.py`, `serving/engine.py`, `training/resilience.py`),
after the JAX package's `tests/test_serving_durability.py`, on the CPU.

`--inject_fault poison-request@N` makes one in-flight request's logits NaN
on every step of every retry: the screen flags its lanes, the eviction
re-decodes it `poison_max_retries` times and then ends it "poisoned",
while the request decoding beside it keeps its batch-1 codes, with the
sequential step and with speculative rounds.  A transient nonfinite flag
costs one retry and the request then completes with its batch-1 codes.
`flood@N:COUNT` submits a burst past the queue's depth: the engine queues
and refuses, and serves what it took.  The fleet's kinds parse (their
drills are in `tests/test_torch_fleet.py`); the training loop's exit
naming the ROADMAP.md item that brings them."""
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu_torch.models import dalle as tdalle
from dalle_pytorch_tpu_torch.models import sampling as tsamp
from dalle_pytorch_tpu_torch.serving.engine import EngineConfig, GenerationEngine
from dalle_pytorch_tpu_torch.serving.lanes import LaneState, sample_lanes
from dalle_pytorch_tpu_torch.training import resilience

THRES = 0.9
MODEL = dict(dim=64, depth=2, heads=2, dim_head=32, num_text_tokens=40, text_seq_len=6, num_image_tokens=32,
             image_fmap_size=4, shift_tokens=True, attn_types=("full", "axial_row"))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def model():
    cfg = tdalle.DALLEConfig(**MODEL)
    return tdalle.init_dalle(cfg, torch.Generator().manual_seed(0), "cpu")


@pytest.fixture
def fault():
    """Arm a fault for one test; disarmed after it."""
    armed = []

    def arm(spec):
        armed.append(resilience.FaultInjector(resilience.parse_fault(spec)).install())
        return armed[-1]

    yield arm
    for inj in armed:
        inj.uninstall()


def _text(n, seed=1):
    return np.random.default_rng(seed).integers(1, 40, (n, 6))


def _batch1(model, text_row, seed, cond_scale):
    return tsamp.sample_image_codes(model, torch.from_numpy(text_row)[None], torch.Generator().manual_seed(seed),
                                    filter_thres=THRES, cond_scale=cond_scale)[0].numpy()


@pytest.mark.parametrize("spec_k,victim_cond", [(0, 1.0), (0, 3.0), (3, 1.0)])
def test_poison_drill_quarantines_the_victim_and_spares_its_neighbour(model, fault, spec_k, victim_cond, capsys):
    inj = fault("poison-request@2")
    engine = GenerationEngine(model, engine_cfg=EngineConfig(num_slots=4, block_size=4, filter_thres=THRES,
                                                             poison_max_retries=2, spec_k=spec_k))
    text = _text(2)
    victim = engine.submit(text[0], seed=10, cond_scale=victim_cond)
    neighbour = engine.submit(text[1], seed=11, cond_scale=3.0)
    done = engine.run_until_idle()
    assert inj.fired and victim.poison_victim
    assert victim.outcome == "poisoned" and victim.poison_retries == 2 and victim.codes is None
    assert neighbour.outcome == "completed" and done == [neighbour]
    np.testing.assert_array_equal(neighbour.codes, _batch1(model, text[1], 11, 3.0))
    assert engine.counts["quarantined"] == 1 and engine.counts["poison_retries"] == 2
    assert engine.counts["poison_injected"] == 1
    assert not engine.busy and engine.free_slots == 4 and engine.pool.used_blocks == 0
    assert int(engine.lanes.poison_lane) == -1 and not engine.poisoned.any()
    assert f"poison-request: request {victim.id} poisoned" in capsys.readouterr().out


def test_a_transient_nonfinite_retries_once_then_completes_exactly(model):
    engine = GenerationEngine(model, engine_cfg=EngineConfig(num_slots=2, block_size=4, filter_thres=THRES))
    text = _text(1, seed=3)
    req = engine.submit(text[0], seed=7)
    for _ in range(4):
        engine.poll()
    engine.poisoned[req.lanes[0]] = True  # one step's NaN, not the request's
    engine.run_until_idle()
    assert req.outcome == "completed" and req.poison_retries == 1
    np.testing.assert_array_equal(req.codes, _batch1(model, text[0], 7, 1.0))


def test_the_screen_flags_live_lanes_and_keeps_their_codes_finite(model):
    cfg = model.cfg
    lanes = LaneState(4, cfg.total_tokens, torch.device("cpu"))
    lanes.arm([0, 1], 1.0, 3.0, 0, None)  # a guided pair
    lanes.arm([2], 1.0, 1.0, 0, None)
    logits = torch.randn(4, cfg.total_tokens, generator=torch.Generator().manual_seed(2))
    logits[3, 5] = float("inf")  # an idle lane: not flagged
    active = torch.tensor([True, True, True, False])
    noise = torch.zeros(4, cfg.total_tokens)
    code, bad = sample_lanes(model, logits, lanes.settings(), THRES, noise, active, torch.tensor(1))
    # lane 1 (the pair's null lane) poisoned: the guided [cond] lane's logits turn NaN too
    assert bad.tolist() == [True, True, False, False]
    assert code[0] == code[1] and 0 <= int(code.min()) and int(code.max()) < cfg.num_image_tokens
    clean, none = sample_lanes(model, logits, lanes.settings(), THRES, noise)
    assert none is None and clean[2] == code[2]


def test_flood_queues_and_refuses_without_crashing(model, fault, capsys):
    fault("flood@2:12")
    engine = GenerationEngine(model, engine_cfg=EngineConfig(num_slots=2, block_size=4, filter_thres=THRES,
                                                             max_queue=6))
    first = engine.submit(_text(1)[0], seed=1)
    done = engine.run_until_idle()
    assert engine.counts["flood_injected"] == 6 and engine.admission.counts["refused_queue_overflow"] == 6
    assert first.outcome == "completed" and len(done) == 7 and all(r.outcome == "completed" for r in done)
    assert "flood: injecting 12 synthetic requests" in capsys.readouterr().out


def test_parse_fault_runs_the_engine_drills_and_names_the_rest():
    assert resilience.parse_fault("flood@3") == resilience.Fault("flood", 3, 32)
    assert resilience.parse_fault("flood@3:0") == resilience.Fault("flood", 3, 0)
    assert resilience.parse_fault("poison-request") == resilience.Fault("poison-request", 0, 0)
    # the fleet's drills run (serving/fleet.py), with the JAX package's replica index
    assert resilience.parse_fault("kill-replica@2:1") == resilience.Fault("kill-replica", 2, 1)
    assert resilience.parse_fault("kill-fleet@3") == resilience.Fault("kill-fleet", 3, 0)
    assert resilience.parse_fault("stall-replica@1") == resilience.Fault("stall-replica", 1, 0)
    for kind in ("kill-process@2", "preempt@1", "corrupt-checkpoint@1", "oom@3", "stall-data@1:2", "shrink@1"):
        with pytest.raises(SystemExit, match="ROADMAP.md Queue 1 item 8"):
            resilience.parse_fault(kind)
    with pytest.raises(ValueError, match="unknown fault kind"):
        resilience.parse_fault("meteor@1")
    assert resilience.take_flood_fault(10) == 0 and not resilience.take_poison_fault(10)


def test_serve_cli_runs_both_drills(tmp_path):
    from dalle_pytorch_tpu_torch.cli import serve

    base = ["--synthetic", "--dim", "32", "--depth", "2", "--text_seq_len", "6", "--num_text_tokens", "40",
            "--num_image_tokens", "32", "--image_fmap_size", "4", "--slots", "2", "--block_size", "4", "--device",
            "cpu"]
    try:
        report = serve.main(base + ["--loadgen", "3", "--rate", "50", "--inject_fault", "poison-request@3"])
    finally:
        resilience._ACTIVE_INJECTOR = None
    assert report["quarantined"] == 1 and report["poison_retries"] == 2 and report["requests_completed"] == 2
    try:
        report = serve.main(base + ["--loadgen", "1", "--max_queue", "4", "--inject_fault", "flood@1:9"])
    finally:
        resilience._ACTIVE_INJECTOR = None
    # the burst fills the queue past the loadgen's own request and the rest is refused
    assert report["flood_injected"] == 3 and report["refused_total"] == 6
    # the flood's synthetic requests are reported apart, as the JAX loadgen reports them
    assert report["requests_completed"] == 1 and report["synthetic_completed"] == 3
