"""The pool's flight recorder and its gauges (`serving/kv_pool.py`,
`observability/pool.py`) and the engine's pool and prefix accounting on the
CPU, after the JAX package's `tests/test_pool_obs.py`.

Fed the same inputs as the JAX package's, with equal results:
`overcommit_safe_slots` over footprint lists, and `aggregate_events` (and
the live `PoolGauges`) over one event list, recorded from an engine run
with guided requests, a drain mid-decode, deferrals and a speculative
engine's truncations.  Port-only: the recorder's ring bound and drop
count, a pool without a recorder recording nothing, the hand-computed
reserved-but-unused blocks, and the engine's `pool_observability` and
`prefix_redundancy`."""
import time

import numpy as np
import pytest
import torch

from dalle_pytorch_tpu_torch.models import dalle as tdalle
from dalle_pytorch_tpu_torch.models.transformer import TransformerConfig
from dalle_pytorch_tpu_torch.observability import metrics as obs_metrics
from dalle_pytorch_tpu_torch.observability.pool import PoolGauges, aggregate_events, overcommit_safe_slots
from dalle_pytorch_tpu_torch.serving.engine import EngineConfig, GenerationEngine
from dalle_pytorch_tpu_torch.serving.kv_pool import BlockPool, PoolFlightRecorder

MODEL = dict(dim=64, depth=2, heads=2, dim_head=32, num_text_tokens=40, text_seq_len=6, num_image_tokens=32,
             image_fmap_size=4, shift_tokens=True, attn_types=("full", "axial_row"))


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
def jpool():
    pytest.importorskip("jax")
    from dalle_pytorch_tpu.observability import pool

    return pool


def _tiny_pool(num_blocks=12):
    # seq 24 in blocks of 4: six blocks a sequence
    cfg = TransformerConfig(dim=16, depth=1, seq_len=24, heads=1, dim_head=16, image_fmap_size=4)
    return BlockPool(cfg, num_blocks, 4)


@pytest.mark.parametrize("footprints,num_blocks,worst", [
    ([4.0, 4.0, 4.0, 4.0], 24, 6.0), ([4.0], 24, 6.0), ([], 24, 6.0), ([3.0, 5.0, 6.0, 2.0, 6.0], 160, 12.0),
    ([6.0] * 7 + [1.0], 40, 6.0), ([0.0, 0.0], 10, 2.0),
])
@pytest.mark.parametrize("p", [0.05, 0.3])
def test_overcommit_safe_slots_equals_jax(jpool, footprints, num_blocks, worst, p):
    assert overcommit_safe_slots(footprints, num_blocks, worst, p) == jpool.overcommit_safe_slots(
        footprints, num_blocks, worst, p)


@pytest.fixture(scope="module")
def engine_events():
    """The recorder's events of a sequential and a speculative engine:
    guided and plain requests, a pool small enough to defer, a drain
    mid-decode."""
    model = tdalle.init_dalle(tdalle.DALLEConfig(**MODEL), torch.Generator().manual_seed(0), "cpu")
    text = np.random.default_rng(1).integers(1, 40, (6, 6))
    runs = []
    for spec_k in (0, 2):
        engine = GenerationEngine(model, engine_cfg=EngineConfig(num_slots=4, block_size=4, num_blocks=18,
                                                                 filter_thres=0.5, spec_k=spec_k))
        for i in range(6):
            engine.submit(text[i], seed=i, cond_scale=3.0 if i % 3 == 1 else 1.0)
            engine.poll()
        for _ in range(4):
            engine.poll()
        engine.drain()
        engine.submit(text[0], seed=0)
        engine.run_until_idle()
        runs.append(engine)
    return runs


@pytest.mark.parametrize("run", [0, 1], ids=["sequential", "speculative"])
def test_aggregate_events_equals_jax_over_an_engine_trace(jpool, engine_events, run):
    engine = engine_events[run]
    events = engine.pool.recorder.events()
    ops = {ev["op"] for ev in events}
    assert {"alloc", "free", "defer"} <= ops and ("truncate" in ops) == bool(run)
    pool = engine.pool
    geometry = (pool.num_blocks, pool.block_size, pool.blocks_per_seq)
    got = aggregate_events(events, *geometry)
    assert got == jpool.aggregate_events(events, *geometry)
    assert got == engine._pool_gauges.summary()  # the live gauges saw the same
    assert got["allocs"] == got["frees"] and got["open_lanes"] == 0 and got["reserved_unused_blocks"] > 0


def test_the_ring_is_bounded_and_counts_its_drops():
    rec = PoolFlightRecorder(capacity=8)
    for i in range(20):
        rec.record("alloc", owner=i, reserved=1)
    assert len(rec) == 8 and rec.dropped == 12
    assert [ev["owner"] for ev in rec.events()] == list(range(12, 20))  # the oldest went first
    with pytest.raises(ValueError, match="capacity must be positive"):
        PoolFlightRecorder(capacity=0)


def test_a_pool_without_a_recorder_records_nothing(monkeypatch):
    monkeypatch.setattr(PoolFlightRecorder, "record", lambda *a, **k: (_ for _ in ()).throw(AssertionError("rec")))
    pool = _tiny_pool()
    assert pool.recorder is None
    assert len(pool.alloc_table(0)) == pool.blocks_per_seq
    assert pool.truncate_slot(0, 10) == 3
    pool.free_table(0, written_tokens=10)
    assert pool.free_blocks == pool.num_blocks
    with pytest.raises(KeyError):
        pool.truncate_slot(0, 1)


def test_reserved_but_unused_blocks_by_hand():
    """Owner 0 writes its whole 24 tokens (6 blocks), owner 2 is evicted
    after 13 (4 blocks written of 6): 2 of 12 freed blocks were never
    written; the footprints are 6 and 4."""
    pool = _tiny_pool(num_blocks=24)
    pool.recorder = rec = PoolFlightRecorder()
    gauges = PoolGauges(pool.num_blocks, pool.block_size, pool.blocks_per_seq)
    rec.on_event = gauges.observe
    for req, owner in ((0, 0), (1, 2)):
        rec.ctx = {"req": req, "lanes": 1, "guided": False}
        pool.alloc_table(owner)
    rec.ctx = None
    time.sleep(0.002)
    pool.free_table(0, written_tokens=24)
    pool.free_table(2, written_tokens=13)
    s = gauges.publish(dropped=rec.dropped)
    assert (s["allocs"], s["frees"], s["open_lanes"], s["reserved_unused_blocks"]) == (2, 2, 0, 2)
    assert s["reserved_unused_frac"] == round(2 / 12, 4) and s["footprint_blocks_p50"] == 5.0
    assert s["block_lifetime_p50_s"] > 0 and obs_metrics.gauge("pool/reserved_unused_blocks").value == 2


def test_the_engines_pool_section_and_prefix_accounting(engine_events):
    engine = engine_events[0]
    obs = engine.pool_observability()
    assert obs["free_blocks"] == obs["num_blocks"] == 18 and obs["recorder_dropped"] == 0
    assert obs["high_water"] <= 18 and obs["defer_events"]
    prefix = engine.prefix_redundancy()
    per_lane = engine.pool.prefix_bytes(engine.n_pre)
    assert per_lane == 2 * 2 * 2 * 7 * 32 * 4  # k and v, 2 layers, 2 heads, n_pre 7, dim_head 32, f32
    # every admitted lane's prefix, a guided request's null lane a duplicate, the re-admitted seed-0 prompt a repeat
    allocs = [ev for ev in engine.pool.recorder.events() if ev["op"] == "alloc"]
    guided = sum(1 for ev in allocs if ev["guided"] and ev["owner"] % 2 == 0)
    assert prefix["admissions"] == len({ev["req"] for ev in allocs}) and guided > 0
    assert prefix["prefill_bytes"] == len(allocs) * per_lane and prefix["null_lane_bytes"] == guided * per_lane
    assert prefix["repeat_hits"] == 1 and prefix["duplicate_bytes"] == (guided + 1) * per_lane
    state = engine.phase_state()
    assert state["phase"] == "idle" and state["inflight"] == [] and state["free_lanes"] == 4
    off = GenerationEngine(engine.model, engine_cfg=EngineConfig(num_slots=2, block_size=4, pool_recorder=False))
    assert off.pool.recorder is None and "recorder_dropped" not in off.pool_observability()
