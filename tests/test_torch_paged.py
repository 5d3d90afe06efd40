"""The port's paged KV state (`models/paged.py`) and the serving pool's host
half (`serving/kv_pool.py`, `serving/scheduler.py`) against the JAX
package's, on the CPU.

`paged_decode_step` takes the same weights, pool contents, block tables
(non-contiguous, one slot idle on the trash block), staggered per-slot
offsets and rings as JAX `paged_decode_step`, for the full model with and
without token shift and for a pattern model gathering its keys
(`sparse_decode`) or masking its rows.  Its output, the written pool
column and the rings agree within 1e-5 relative in f32 (the frameworks'
products sum in other orders); every pool position the step does not
write is bit-equal.  `write_prefill_to_pool` is pure data movement:
bit-equal.  `BlockPool` and `AdmissionController` follow the JAX ones over
random traces: the same block ids, refusals and decisions."""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from dalle_pytorch_tpu.models import dalle as jdalle  # noqa: E402
from dalle_pytorch_tpu.models import transformer as jtr  # noqa: E402
from dalle_pytorch_tpu.serving import kv_pool as jpool  # noqa: E402
from dalle_pytorch_tpu.serving import scheduler as jsched  # noqa: E402
from dalle_pytorch_tpu_torch import weights  # noqa: E402
from dalle_pytorch_tpu_torch.models import dalle as tdalle  # noqa: E402
from dalle_pytorch_tpu_torch.models import paged  # noqa: E402
from dalle_pytorch_tpu_torch.serving import kv_pool as tpool  # noqa: E402
from dalle_pytorch_tpu_torch.serving import scheduler as tsched  # noqa: E402

RTOL = 1e-5
# seq 22 = text 6 + a 4 x 4 map; text_len 7: the image region is 7..21
FULL = dict(dim=64, depth=2, heads=2, dim_head=32, num_text_tokens=40, text_seq_len=6, num_image_tokens=32,
            image_fmap_size=4, shift_tokens=True)
PATTERN = dict(FULL, depth=3, attn_types=("axial_row", "axial_col", "conv_like"))
MODELS = {"full": FULL, "full_no_shift": dict(FULL, shift_tokens=False), "pattern": PATTERN,
          "pattern_masked": dict(PATTERN, sparse_decode=False)}
BLOCK = 4
NUM_BLOCKS = 30  # the trash block included


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_loaded = {}


def _load(name):
    if name not in _loaded:
        jcfg = jdalle.DALLEConfig(**MODELS[name])
        params = jax.device_get(jdalle.init_dalle(jax.random.PRNGKey(0), jcfg))
        _loaded[name] = params, jcfg, weights.load_dalle(params, tdalle.DALLEConfig(**MODELS[name]), device="cpu")
    return _loaded[name]


def _state(jcfg, rng, slots=4):
    """Pool contents, block tables, offsets, rings and x of a slot batch:
    every slot's table a random draw of distinct blocks (blocks shared
    between slots' tables), slot 1 idle on the trash block at offset 0."""
    tcfg = jcfg.transformer_config()
    mb = -(-tcfg.seq_len // BLOCK)
    shape = (NUM_BLOCKS, tcfg.heads, BLOCK, tcfg.dim_head)
    pool = [{"k": rng.standard_normal(shape).astype(np.float32), "v": rng.standard_normal(shape).astype(np.float32)}
            for _ in range(tcfg.depth)]
    tables = np.stack([rng.permutation(np.arange(1, NUM_BLOCKS))[:mb] for _ in range(slots)]).astype(np.int32)
    tables[1] = 0
    offsets = np.array([tcfg.text_len, 0, 15, tcfg.seq_len - 1], np.int32)[:slots]
    q = tcfg.dim // 4
    rings = [{k: rng.standard_normal((slots, tcfg.image_fmap_size, 2, q)).astype(np.float32)
              for k in ("shift_attn", "shift_ff")} for _ in range(tcfg.depth)] if tcfg.shift_tokens else None
    x = rng.standard_normal((slots, 1, tcfg.dim)).astype(np.float32)
    return pool, tables, offsets, rings, x


def _close(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= RTOL * np.abs(want).max(), np.abs(got - want).max()


@pytest.mark.parametrize("name", list(MODELS))
def test_paged_decode_step_matches_jax(name):
    params, jcfg, model = _load(name)
    tcfg = jcfg.transformer_config()
    pool, tables, offsets, rings, x = _state(jcfg, np.random.default_rng(3))
    out_j, pool_j, rings_j = jtr.paged_decode_step(
        params["transformer"], tcfg, jnp.asarray(x),
        {"layers": [{k: jnp.asarray(v) for k, v in lp.items()} for lp in pool]}, jnp.asarray(tables),
        jnp.asarray(offsets), None if rings is None else {"layers": [{k: jnp.asarray(v) for k, v in r.items()}
                                                                    for r in rings]}, BLOCK)

    tpool_ = {"layers": [{k: torch.from_numpy(v.copy()) for k, v in lp.items()} for lp in pool]}
    trings = None if rings is None else {"layers": [{k: torch.from_numpy(v.copy()) for k, v in r.items()}
                                                    for r in rings]}
    out = paged.paged_decode_step(model.transformer, torch.from_numpy(x), tpool_, torch.from_numpy(tables).long(),
                                  torch.from_numpy(offsets).long(), trings, BLOCK)
    _close(out.numpy(), out_j)

    written = np.zeros((NUM_BLOCKS, BLOCK), bool)
    for s, off in enumerate(offsets):
        written[tables[s, off // BLOCK], off % BLOCK] = True
    for got, want, before in zip(tpool_["layers"], pool_j["layers"], pool):
        for key in ("k", "v"):
            g, w = got[key].numpy(), np.asarray(want[key])
            cols = written[:, None, :, None].repeat(tcfg.heads, 1).repeat(tcfg.dim_head, 3)
            _close(g[cols], w[cols])
            np.testing.assert_array_equal(g[~cols], w[~cols])
            np.testing.assert_array_equal(g[~cols], before[key][~cols])
    if rings is not None:
        for got, want in zip(trings["layers"], rings_j["layers"]):
            for key in ("shift_attn", "shift_ff"):
                _close(got[key].numpy(), want[key])


def test_paged_decode_step_refuses_a_layer_range():
    """An empty or out-of-range layer range, and a partial one under
    reversible execution (the JAX `_resolve_layer_range`'s refusals); short
    block tables; a KV dtype other than int8."""
    params, _, model = _load("full")
    for start, stop in ((1, 1), (0, 3), (2, None)):
        with pytest.raises(ValueError, match="invalid for depth"):
            paged.paged_decode_step(model.transformer, torch.zeros(1, 1, 64), {}, torch.zeros(1, 6).long(),
                                    torch.zeros(1).long(), None, BLOCK, layer_start=start, layer_stop=stop)
    rev = weights.load_dalle(params, tdalle.DALLEConfig(**dict(FULL, reversible=True)), device="cpu")
    with pytest.raises(ValueError, match="require sequential execution"):
        paged.paged_decode_step(rev.transformer, torch.zeros(1, 1, 64), {}, torch.zeros(1, 6).long(),
                                torch.zeros(1).long(), None, BLOCK, layer_stop=1)
    with pytest.raises(ValueError, match="cover a full sequence"):
        paged.paged_decode_step(model.transformer, torch.zeros(1, 1, 64), {}, torch.zeros(1, 2).long(),
                                torch.zeros(1).long(), None, BLOCK)
    with pytest.raises(ValueError, match="kv quant must be one of"):
        paged.init_paged_pool(model.transformer.cfg, 4, BLOCK, quantize="fp8")


@pytest.mark.parametrize("n_pre,block_size", [(7, 4), (8, 4), (7, 3)])
def test_write_prefill_to_pool_is_bit_equal(n_pre, block_size):
    jcfg = jdalle.DALLEConfig(**FULL)
    tcfg = jcfg.transformer_config()
    rng = np.random.default_rng(5)
    mb = -(-tcfg.seq_len // block_size)
    pool = [{k: rng.standard_normal((NUM_BLOCKS, 2, block_size, 32)).astype(np.float32) for k in ("k", "v")}
            for _ in range(tcfg.depth)]
    cache = [{k: rng.standard_normal((2, 2, tcfg.seq_len, 32)).astype(np.float32) for k in ("k", "v")}
             for _ in range(tcfg.depth)]
    tables = np.stack([rng.permutation(np.arange(1, NUM_BLOCKS))[:mb] for _ in range(2)]).astype(np.int32)
    want = jtr.write_prefill_to_pool(tcfg, {"layers": [{k: jnp.asarray(v) for k, v in lp.items()} for lp in pool]},
                                     jnp.asarray(tables), [{k: jnp.asarray(v) for k, v in c.items()} for c in cache],
                                     n_pre, block_size)
    got = {"layers": [{k: torch.from_numpy(v.copy()) for k, v in lp.items()} for lp in pool]}
    paged.write_prefill_to_pool(tdalle.DALLEConfig(**FULL).transformer_config(), got,
                                torch.from_numpy(tables).long(), [{k: torch.from_numpy(v) for k, v in c.items()}
                                                                  for c in cache], n_pre, block_size)
    for g, w in zip(got["layers"], want["layers"]):
        for key in ("k", "v"):
            np.testing.assert_array_equal(g[key].numpy(), np.asarray(w[key]))


def test_pool_geometry_matches_jax():
    jcfg = jdalle.DALLEConfig(**FULL).transformer_config()
    tcfg = tdalle.DALLEConfig(**FULL).transformer_config()
    for bs in (3, 4, 22, 64):
        assert paged.paged_blocks_per_seq(tcfg, bs) == jtr.paged_blocks_per_seq(jcfg, bs)
        assert tpool.blocks_within_bytes(tcfg, 1e6, bs, 4) == jpool.blocks_within_bytes(jcfg, 1e6, bs, 4)
    jp = jpool.BlockPool(jcfg, 12, 4, dtype=jnp.float32)
    tp = tpool.BlockPool(tcfg, 12, 4)
    assert tp.bytes() == jp.bytes(4) and tp.summary()["bytes"] == jp.bytes(4)
    pool = tp.device_pool()
    assert len(pool["layers"]) == 2 and pool["layers"][0]["k"].shape == (13, 2, 4, 32)
    rings = paged.init_slot_rings(tcfg, 3)
    assert rings["layers"][1]["shift_ff"].shape == (3, 4, 2, 16)
    assert paged.init_slot_rings(tdalle.DALLEConfig(**dict(FULL, shift_tokens=False)).transformer_config(), 3) is None


@settings(max_examples=60, deadline=None)
@given(st.lists(st.tuples(st.sampled_from(["alloc", "free", "can_admit"]), st.integers(0, 7)), max_size=40),
       st.integers(6, 20), st.sampled_from([3, 4, 8]))
def test_block_pool_follows_jax(trace, num_blocks, block_size):
    jcfg = jdalle.DALLEConfig(**FULL).transformer_config()
    tcfg = tdalle.DALLEConfig(**FULL).transformer_config()
    jp, tp = jpool.BlockPool(jcfg, num_blocks, block_size), tpool.BlockPool(tcfg, num_blocks, block_size)
    assert tp.fits_ever() == jp.fits_ever()
    for op, owner in trace:
        if op == "alloc":
            if owner in jp.owners():
                continue
            try:
                want = jp.alloc_table(owner)
            except jpool.PoolExhausted:
                with pytest.raises(tpool.PoolExhausted):
                    tp.alloc_table(owner)
            else:
                np.testing.assert_array_equal(tp.alloc_table(owner), want)
        elif op == "free":
            jp.free_table(owner)
            tp.free_table(owner)
        else:
            assert tp.can_admit() == jp.can_admit()
        assert (tp.free_blocks, tp.used_blocks, tp.high_water, tp.owners()) == (
            jp.free_blocks, jp.used_blocks, jp.high_water, jp.owners())
        assert tp.occupancy_frac == jp.occupancy_frac and tp.fragmentation_frac == jp.fragmentation_frac


def _requests(cond_scale):
    text = np.ones(6, np.int64)
    return (jsched.Request(id=0, text=text, key=np.zeros(2, np.uint32), cond_scale=cond_scale),
            tsched.Request(id=0, text=text, seed=0, cond_scale=cond_scale))


@settings(max_examples=60, deadline=None)
@given(st.lists(st.tuples(st.sampled_from([1.0, 3.0]), st.integers(0, 4), st.integers(0, 3),
                          st.sampled_from([None, 0.5, 0.95]), st.integers(0, 1)), min_size=1, max_size=30),
       st.integers(4, 30))
def test_admission_controller_follows_jax(trace, num_blocks):
    jcfg = jdalle.DALLEConfig(**FULL).transformer_config()
    tcfg = tdalle.DALLEConfig(**FULL).transformer_config()
    jp, tp = jpool.BlockPool(jcfg, num_blocks, 4), tpool.BlockPool(tcfg, num_blocks, 4)
    usage = {"v": None}
    jc = jsched.AdmissionController(jp, headroom_frac=0.9, usage_fn=lambda: usage["v"])
    tc = tsched.AdmissionController(tp, headroom_frac=0.9, usage_fn=lambda: usage["v"])
    owner = 0
    for cond_scale, free_lanes, in_flight, use, take in trace:
        usage["v"] = use
        jreq, treq = _requests(cond_scale)
        try:
            jc.screen_submit(jreq)
        except jsched.AdmissionRefused as e:
            with pytest.raises(tsched.AdmissionRefused) as got:
                tc.screen_submit(treq)
            assert got.value.kind == e.kind == "never_fits"
            continue
        tc.screen_submit(treq)
        want = jc.may_admit_ex(jreq, free_lanes, in_flight)
        assert tc.may_admit_ex(treq, free_lanes, in_flight) == want
        if want[0] is None and take:  # admit: its lanes take their blocks
            for _ in range(treq.lanes_needed):
                np.testing.assert_array_equal(tp.alloc_table(owner), jp.alloc_table(owner))
                owner += 1


def test_queue_refuses_past_its_depth():
    q = tsched.RequestQueue(max_depth=2)
    for i in range(2):
        q.push(_requests(1.0)[1])
    with pytest.raises(tsched.AdmissionRefused) as e:
        q.push(_requests(1.0)[1])
    assert e.value.kind == "queue_overflow"
    assert len(q) == 2 and q.pop() is not None and len(q) == 1
