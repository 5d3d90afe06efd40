"""The port's self-speculative decoding (`models/speculative.py`, the spec
modes of `models/sampling.py` and `serving/engine.py`) against the JAX
package's, on the CPU.

Exactness: under injected noise the fused sampler's speculative codes equal
the JAX package's *sequential* `sample_image_codes(noise_override=)`
(JAX's own `fused_spec_decode` takes no injected noise), guided and not,
for the full model, a pattern model gathering its keys, without token
shift, at two draft depths; under a generator they equal the port's
sequential codes of the same seed.  The engine's rounds give each request
its batch-1 codes, also over the int8 pool (against the int8 engine's
sequential steps).  The rollbacks, the layer range of both decode steps
and `validate_spec`'s refusals equal JAX's.  The stochastic mode holds the
sequential distribution (total variation < 0.25 at b 64, JAX's bar)."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from dalle_pytorch_tpu.models import dalle as jdalle  # noqa: E402
from dalle_pytorch_tpu.models import sampling as jsamp  # noqa: E402
from dalle_pytorch_tpu.models import speculative as jspec  # noqa: E402
from dalle_pytorch_tpu.models import transformer as jtr  # noqa: E402
from dalle_pytorch_tpu_torch import weights  # noqa: E402
from dalle_pytorch_tpu_torch.models import dalle as tdalle  # noqa: E402
from dalle_pytorch_tpu_torch.models import paged  # noqa: E402
from dalle_pytorch_tpu_torch.models import sampling as tsamp  # noqa: E402
from dalle_pytorch_tpu_torch.models import speculative as tspec  # noqa: E402
from dalle_pytorch_tpu_torch.models import transformer as ttr  # noqa: E402
from dalle_pytorch_tpu_torch.serving.engine import EngineConfig, GenerationEngine  # noqa: E402

THRES = 0.9
# seq 22 = text 6 + a 4 x 4 map: k + 1 <= 4 under token shift
BASE = dict(dim=64, depth=4, heads=2, dim_head=32, num_text_tokens=40, text_seq_len=6, num_image_tokens=32,
            image_fmap_size=4, shift_tokens=True)
MODELS = {"full": BASE, "pattern": dict(BASE, attn_types=("full", "axial_row", "axial_col", "conv_like")),
          "no_shift": dict(BASE, shift_tokens=False), "tied_learned": dict(BASE, share_input_output_emb=True,
                                                                           rotary_emb=False)}


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


def _text(b, seed=1):
    return np.random.default_rng(seed).integers(1, 40, (b, 6))


@pytest.mark.parametrize("name,k,d,cond_scale,temperature", [
    ("full", 3, None, 1.0, 1.0), ("full", 2, 1, 3.0, 0.7), ("full", 3, 3, 3.0, 1.0), ("pattern", 3, None, 3.0, 1.0),
    ("no_shift", 5, 1, 1.0, 1.0), ("tied_learned", 2, None, 2.0, 1.0),
])
def test_fused_spec_codes_equal_jax_sequential_under_noise(name, k, d, cond_scale, temperature):
    params, jcfg, model = _load(name)
    text = _text(3)
    noise = np.random.default_rng(2).gumbel(size=(16, 3, jcfg.total_tokens)).astype(np.float32)
    want = np.asarray(jsamp.sample_image_codes(params, jcfg, jnp.asarray(text), jax.random.PRNGKey(0),
                                               filter_thres=THRES, temperature=temperature, cond_scale=cond_scale,
                                               noise_override=jnp.asarray(noise)))
    timings = {}
    got = tsamp.sample_image_codes(model, torch.from_numpy(text), filter_thres=THRES, temperature=temperature,
                                   cond_scale=cond_scale, noise_override=torch.from_numpy(noise), spec_k=k,
                                   spec_draft_layers=d, timings=timings)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 1 <= timings["spec_rounds"] < 15  # a round advances 1 to k + 1 codes


def test_fused_spec_equals_sequential_under_a_generator_and_primed():
    _, jcfg, model = _load("pattern")
    text = torch.from_numpy(_text(2))
    primer = torch.from_numpy(np.random.default_rng(3).integers(0, 32, (2, 5)))
    for kw in (dict(cond_scale=3.0), dict(primer_codes=primer, prime_len=5)):
        seq = tsamp.sample_image_codes(model, text, torch.Generator().manual_seed(9), filter_thres=THRES, **kw)
        gen = torch.Generator().manual_seed(9)
        spec = tsamp.sample_image_codes(model, text, gen, filter_thres=THRES, spec_k=3, **kw)
        assert torch.equal(spec, seq)
    # the generator advanced as the sequential loop's did
    seq_gen = torch.Generator().manual_seed(9)
    tsamp.sample_image_codes(model, text, seq_gen, filter_thres=THRES, primer_codes=primer, prime_len=5)
    assert torch.equal(gen.get_state(), seq_gen.get_state())


def _pooled_hist(codes, vocab):
    return np.bincount(codes.ravel(), minlength=vocab) / codes.size


def test_stochastic_mode_holds_the_sequential_distribution():
    """Rejection sampling: another stream, the same marginals (pooled token
    histograms of 64 rows, total variation under JAX's 0.25), with more
    than one code a round on average."""
    _, jcfg, model = _load("full")
    text = torch.from_numpy(np.tile(_text(1), (64, 1)))
    seq = tsamp.sample_image_codes(model, text, torch.Generator().manual_seed(31), filter_thres=THRES).numpy()
    timings = {}
    spec = tsamp.sample_image_codes(model, text, torch.Generator().manual_seed(32), filter_thres=THRES, spec_k=2,
                                    spec_stochastic=True, timings=timings).numpy()
    assert 1 <= timings["spec_rounds"] < 15
    tv = 0.5 * np.abs(_pooled_hist(seq, 32) - _pooled_hist(spec, 32)).sum()
    assert tv < 0.25, tv
    with pytest.raises(ValueError, match="noise_override"):
        tsamp.sample_image_codes(model, text[:1], spec_k=2, spec_stochastic=True,
                                 noise_override=torch.zeros(16, 1, jcfg.total_tokens))


def test_validate_spec_raises_jax_errors():
    _, jcfg, model = _load("full")
    cases = [(BASE, 0, None), (BASE, 4, None), (BASE, 2, 4), (BASE, 2, 0), (dict(BASE, reversible=True), 2, None),
             (dict(BASE, depth=1), 2, None)]
    for kw, k, d in cases:
        with pytest.raises(ValueError) as want:
            jspec.validate_spec(jdalle.DALLEConfig(**kw).transformer_config(), k, d)
        with pytest.raises(ValueError) as got:
            tspec.validate_spec(tdalle.DALLEConfig(**kw).transformer_config(), k, d)
        assert str(got.value) == str(want.value)
    assert tspec.validate_spec(model.transformer.cfg, 3, None) == jspec.validate_spec(jcfg.transformer_config(), 3,
                                                                                      None) == (3, 2)
    with pytest.raises(ValueError, match="reversible"):
        tsamp.sample_image_codes(weights.load_dalle(_load("full")[0], tdalle.DALLEConfig(**BASE, reversible=True),
                                                    device="cpu"), torch.ones(1, 6).long(), spec_k=2)


def _rings(rng, rows, depth=2):
    return [{k: rng.standard_normal((rows, 4, 2, 16)).astype(np.float32) for k in ("shift_attn", "shift_ff")}
            for _ in range(depth)]


def test_rollbacks_equal_jax():
    """Per-lane slots (with the clamped duplicates past the end of the
    sequence) and advances, and the fused rollback's shared ones."""
    tcfg = jdalle.DALLEConfig(**BASE).transformer_config()
    rng = np.random.default_rng(4)
    new, old = _rings(rng, 4), _rings(rng, 4)
    offsets = np.array([7, 19, 20, 21])
    slots = np.stack([(np.minimum(o + np.arange(4), tcfg.seq_len - 1) - tcfg.text_len) % 4 for o in offsets])
    a = np.array([1, 2, 4, 0])
    want = jspec.rollback_slot_rings({"layers": [{k: jnp.asarray(v) for k, v in r.items()} for r in new]},
                                     {"layers": [{k: jnp.asarray(v) for k, v in r.items()} for r in old]},
                                     jnp.asarray(slots), jnp.asarray(a), tcfg)
    got = tspec.rollback_slot_rings({"layers": [{k: torch.from_numpy(v) for k, v in r.items()} for r in new]},
                                    {"layers": [{k: torch.from_numpy(v) for k, v in r.items()} for r in old]},
                                    torch.from_numpy(slots), torch.from_numpy(a), tcfg)
    for g, w in zip(got["layers"], want["layers"]):
        for key in g:
            np.testing.assert_array_equal(g[key].numpy(), np.asarray(w[key]))
    for off, adv in ((19, 2), (20, 1), (8, 3)):
        shared = (np.minimum(off + np.arange(4), tcfg.seq_len - 1) - tcfg.text_len) % 4
        want = jspec.rollback_cache_rings([{k: jnp.asarray(v) for k, v in r.items()} for r in new],
                                          [{k: jnp.asarray(v) for k, v in r.items()} for r in old],
                                          jnp.asarray(shared), jnp.asarray(adv), tcfg)
        got = tspec.rollback_cache_rings([{k: torch.from_numpy(v) for k, v in r.items()} for r in new],
                                         [{k: torch.from_numpy(v) for k, v in r.items()} for r in old],
                                         torch.from_numpy(shared), torch.tensor(adv), tcfg)
        for g, w in zip(got, want):
            for key in g:
                np.testing.assert_array_equal(g[key].numpy(), np.asarray(w[key]))


@pytest.mark.parametrize("name", ["full", "pattern"])
def test_layer_ranges_equal_jax_and_compose_to_the_full_step(name):
    """`paged_decode_step` and `decode_step` over [0, d) then [d, depth)
    against JAX's, within 1e-5 of their largest; the two halves write what
    one full step writes."""
    params, jcfg, model = _load(name)
    tcfg, pcfg = jcfg.transformer_config(), model.transformer.cfg
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 1, tcfg.dim)).astype(np.float32)
    shape = (20, tcfg.heads, 4, tcfg.dim_head)
    pool = [{k: rng.standard_normal(shape).astype(np.float32) for k in ("k", "v")} for _ in range(tcfg.depth)]
    tables = rng.permutation(np.arange(1, 20))[:18].reshape(3, 6).astype(np.int32)  # the engine's: disjoint
    offsets = np.array([7, 12, 21], np.int32)
    rings = _rings(rng, 3, tcfg.depth)

    def jstate():
        return ({"layers": [{k: jnp.asarray(v) for k, v in lp.items()} for lp in pool]},
                {"layers": [{k: jnp.asarray(v) for k, v in r.items()} for r in rings]})

    def tstate():
        return ({"layers": [{k: torch.from_numpy(v.copy()) for k, v in lp.items()} for lp in pool]},
                {"layers": [{k: torch.from_numpy(v.copy()) for k, v in r.items()} for r in rings]})

    step = jax.jit(jtr.paged_decode_step, static_argnums=(1, 7, 8, 9))
    jp, jr = jstate()
    h_j, jp, jr = step(params["transformer"], tcfg, jnp.asarray(x), jp, jnp.asarray(tables), jnp.asarray(offsets),
                       jr, 4, 0, 2)
    out_j, jp, jr = step(params["transformer"], tcfg, h_j, jp, jnp.asarray(tables), jnp.asarray(offsets), jr, 4, 2,
                         None)
    tp, tr = tstate()
    args = (torch.from_numpy(tables).long(), torch.from_numpy(offsets).long())
    h = paged.paged_decode_step(model.transformer, torch.from_numpy(x), tp, args[0], args[1], tr, 4, layer_stop=2)
    out = paged.paged_decode_step(model.transformer, h, tp, args[0], args[1], tr, 4, layer_start=2)
    scale = np.abs(np.asarray(out_j)).max()
    assert np.abs(h.numpy() - np.asarray(h_j)).max() <= 1e-5 * np.abs(np.asarray(h_j)).max()
    assert np.abs(out.numpy() - np.asarray(out_j)).max() <= 1e-5 * scale
    fp, fr = tstate()
    full = paged.paged_decode_step(model.transformer, torch.from_numpy(x), fp, args[0], args[1], fr, 4)
    assert torch.equal(full, out)
    for a, b in zip(tp["layers"] + tr["layers"], fp["layers"] + fr["layers"]):
        for key in a:
            assert torch.equal(a[key], b[key])

    # the dense cache: the two halves at offset 12 give the full step's output and cache
    cache = ttr.init_cache(pcfg, 1)
    for layer in cache["layers"]:
        for t in layer.values():
            t.copy_(torch.from_numpy(rng.standard_normal(tuple(t.shape)).astype(np.float32)))
    twin = {"offset": torch.tensor(12), "layers": [{k: v.clone() for k, v in lc.items()} for lc in cache["layers"]]}
    cache["offset"].fill_(12)
    h, _ = ttr.decode_step(model.transformer, torch.from_numpy(x[:1]), cache, layer_stop=1)
    cache["offset"].fill_(12)
    out, _ = ttr.decode_step(model.transformer, h, cache, layer_start=1)
    full, _ = ttr.decode_step(model.transformer, torch.from_numpy(x[:1]), twin)
    assert torch.equal(out, full) and int(cache["offset"]) == int(twin["offset"]) == 13
    for a, b in zip(cache["layers"], twin["layers"]):
        for key in a:
            assert torch.equal(a[key], b[key])
    with pytest.raises(ValueError, match="invalid for depth"):
        ttr.resolve_layer_range(pcfg, 2, 2)


COND = [1.0, 3.0, 1.0, 2.0, 1.0]


@pytest.mark.parametrize("name,quantize_kv", [("full", None), ("pattern", None), ("tied_learned", "int8")])
def test_engine_spec_codes_equal_batch1(name, quantize_kv):
    """Five requests (two guided) on four lanes, staggered: every request's
    codes equal its batch-1 sequential codes under its seed, or, over the
    int8 pool, the sequential int8 engine's; rounds took more than one code
    and rejected some (the rollback ran)."""
    params, jcfg, model = _load(name)
    text = _text(5, seed=6)

    def serve(spec_k):
        engine = GenerationEngine(model, engine_cfg=EngineConfig(num_slots=4, block_size=4, filter_thres=THRES,
                                                                 quantize_kv=quantize_kv, spec_k=spec_k))
        reqs = []
        for i in range(5):
            reqs.append(engine.submit(text[i], seed=50 + i, cond_scale=COND[i]))
            if i == 2:
                for _ in range(3):
                    engine.poll()
        engine.run_until_idle()
        assert all(r.outcome == "completed" for r in reqs)
        return engine, reqs

    engine, reqs = serve(3)
    if quantize_kv is None:
        want = [tsamp.sample_image_codes(model, torch.from_numpy(text[i:i + 1]), torch.Generator().manual_seed(50 + i),
                                         filter_thres=THRES, cond_scale=COND[i])[0].numpy() for i in range(5)]
    else:
        want = [r.codes for r in serve(0)[1]]
    for i, req in enumerate(reqs):
        np.testing.assert_array_equal(req.codes, want[i])
        assert 1.0 <= req.accepted_tokens_per_step <= 4.0
    state = engine.spec_state()
    assert state["rounds"] == engine.decode_steps and state["rejected_tokens"] > 0
    assert 1.0 < state["accepted_tokens_per_round"] <= 4.0 and 0 < state["draft_time_frac"] < 1


def test_engine_spec_under_noise_equals_jax_sequential():
    params, jcfg, model = _load("pattern")
    text = _text(2, seed=7)
    noise = np.random.default_rng(8).gumbel(size=(2, 16, jcfg.total_tokens)).astype(np.float32)
    engine = GenerationEngine(model, engine_cfg=EngineConfig(num_slots=4, block_size=4, filter_thres=THRES,
                                                             spec_k=2, spec_draft_layers=1, noise_override=True))
    reqs = [engine.submit(text[i], cond_scale=COND[i], noise=noise[i]) for i in range(2)]
    engine.run_until_idle()
    for i, req in enumerate(reqs):
        want = jsamp.sample_image_codes(params, jcfg, jnp.asarray(text[i:i + 1]), jax.random.PRNGKey(0),
                                        filter_thres=THRES, cond_scale=COND[i],
                                        noise_override=jnp.asarray(noise[i][:, None]))
        np.testing.assert_array_equal(req.codes, np.asarray(want)[0])


def test_engine_spec_off_is_the_sequential_step():
    _, _, model = _load("full")
    engine = GenerationEngine(model, engine_cfg=EngineConfig(num_slots=2, block_size=4))
    assert engine.spec is None and engine.spec_graphs is None and engine.lanes.noise is None
    req = engine.submit(_text(1)[0], seed=3)
    engine.run_until_idle()
    assert engine.decode_steps == 15 and req.spec_rounds == 0 and req.accepted_tokens_per_step is None
    with pytest.raises(ValueError, match="spec_k=4 too large"):
        GenerationEngine(model, engine_cfg=EngineConfig(spec_k=4))
