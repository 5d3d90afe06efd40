"""Reversible execution in the port (`models/reversible.py`, the twin stream
of `models/transformer.py` and `models/paged.py`) against the JAX package's
`execution="reversible"`, on the CPU.

- The output of `apply_transformer` and its `jax.grad` gradients at depth 3
  with token shift, a pattern cycle and `attn_vfa`: 1e-5 and 2e-4
  absolute, the tolerances of the JAX package's own reversible test.
- `Reversible` (each layer's input rebuilt in the backward) against plain
  autograd through the same twin-stream loop, with dropout drawn from a
  generator (so both runs draw the same masks): 1e-5 of each leaf's
  largest element, and the masks change the output.
- The bf16 working copy of `make_train_step`: the Function takes the
  copy's tensors, and the loss and gradient norm equal the plain twin
  stream's within 2e-2 relative (bf16 rebuilds its inputs to bf16's
  rounding); its gradients land on the f32 masters.
- `prefill` then `decode_step` across the text/image boundary: outputs,
  KV caches and token-shift rings against JAX's twin-stream caches, 1e-4.
- `paged_decode_step` against JAX's, 1e-5 relative, untouched pool
  positions bit-equal.
- `sample_image_codes` under `noise_override`, plain and guided:
  `array_equal` to the JAX sampler's codes."""
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from dalle_pytorch_tpu.models import dalle as jdalle  # noqa: E402
from dalle_pytorch_tpu.models import sampling as jsamp  # noqa: E402
from dalle_pytorch_tpu.models import transformer as jtr  # noqa: E402
from dalle_pytorch_tpu_torch import weights  # noqa: E402
from dalle_pytorch_tpu_torch.models import dalle as tdalle  # noqa: E402
from dalle_pytorch_tpu_torch.models import paged  # noqa: E402
from dalle_pytorch_tpu_torch.models import reversible as trev  # noqa: E402
from dalle_pytorch_tpu_torch.models import sampling as tsamp  # noqa: E402
from dalle_pytorch_tpu_torch.models import transformer as ttr  # noqa: E402
from dalle_pytorch_tpu_torch.optim.grouped import Adam  # noqa: E402
from dalle_pytorch_tpu_torch.parallel import train_step as tts  # noqa: E402

OUT_ATOL, GRAD_ATOL = 1e-5, 2e-4  # the JAX package's test_reversible_grads_match_naive
ATOL = 1e-4  # cached modes, as tests/test_torch_transformer.py
# seq 22 = text 6 + a 4 x 4 map (text_len 7)
MODEL = dict(dim=32, depth=3, heads=2, dim_head=16, num_text_tokens=40, text_seq_len=6, num_image_tokens=32,
             image_fmap_size=4, shift_tokens=True, attn_types=("full", "axial_row", "axial_col"),
             attn_vfa=True, reversible=True)
BLOCK = 4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def rev():
    jcfg = jdalle.DALLEConfig(**MODEL)
    params = jax.device_get(jax.jit(jdalle.init_dalle, static_argnums=1)(jax.random.PRNGKey(0), jcfg))
    model = weights.load_dalle(params, tdalle.DALLEConfig(**MODEL), device="cpu")
    assert jcfg.transformer_config().execution == model.transformer.cfg.execution == "reversible"
    return params, jcfg, model


def _x(n, b=2, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal((b, n, MODEL["dim"])) * scale).astype(np.float32)


def _grads_by_name(model: torch.nn.Module, loss: torch.Tensor) -> dict:
    params = dict(model.named_parameters())
    return dict(zip(params, torch.autograd.grad(loss, list(params.values()))))


def test_apply_transformer_and_its_gradients_match_jax(rev):
    """Output to 1e-5, every gradient leaf of the transformer tree to 2e-4
    (the port's gradients mapped into the JAX tree by the weight bridge)."""
    params, jcfg, model = rev
    tcfg = jcfg.transformer_config()
    x = _x(22, scale=0.1)
    tp = jax.tree_util.tree_map(jnp.asarray, params["transformer"])

    @jax.jit
    def reference(p):
        def run(q):
            return jtr.apply_transformer(q, tcfg, jnp.asarray(x))
        return run(p), jax.grad(lambda q: jnp.sum(run(q) ** 2))(p)

    ref, ref_grads = reference(tp)
    tr = model.transformer.requires_grad_(True)
    try:
        out = ttr.apply_transformer(tr, torch.from_numpy(x))
        grads = _grads_by_name(tr, (out ** 2).sum())
    finally:
        tr.requires_grad_(False)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=OUT_ATOL, rtol=0)
    port = weights._transformer_tree({f"t.{k}": v for k, v in grads.items()}, "t", tr.cfg)
    flat_port, tree_port = jax.tree_util.tree_flatten(port)
    flat_ref, tree_ref = jax.tree_util.tree_flatten(jax.device_get(ref_grads))
    assert tree_port == tree_ref
    for p, r in zip(flat_port, flat_ref):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), atol=GRAD_ATOL, rtol=0)


def test_rebuilt_inputs_give_the_naive_twin_streams_gradient_with_dropout():
    """`Reversible` against autograd through the same loop (rebuild=False),
    dropout on both branches from one generator seed: the output and the
    input's and every parameter's gradient within 1e-5 of the leaf's
    largest element; without the generator the output differs (the masks
    were drawn)."""
    cfg = ttr.TransformerConfig(dim=32, depth=4, seq_len=22, heads=2, dim_head=16, image_fmap_size=4,
                                attn_types=("full", "axial_row"), shift_tokens=True, attn_dropout=0.2,
                                ff_dropout=0.2, execution="reversible")
    model = ttr.Transformer(cfg)
    ttr.init_transformer_(model, torch.Generator().manual_seed(0))
    x = torch.from_numpy(_x(22)).requires_grad_(True)

    def run(rebuild):
        out = ttr.apply_transformer(model, x, generator=torch.Generator().manual_seed(5), rebuild=rebuild)
        leaves = [x] + list(model.parameters())
        return out.detach(), torch.autograd.grad((out ** 2).sum(), leaves)

    got_out, got = run(True)
    want_out, want = run(False)
    torch.testing.assert_close(got_out, want_out, atol=1e-5 * want_out.abs().max().item(), rtol=0)
    assert len(got) == len(want) == 1 + len(list(model.parameters()))
    for g, w in zip(got, want):
        assert (g - w).abs().max() <= 1e-5 * w.abs().max(), (g - w).abs().max()
    with torch.no_grad():
        plain = ttr.apply_transformer(model, x)
    assert (plain - got_out).abs().max() > 1e-3


def test_shared_tensors_are_one_input_of_the_function(monkeypatch):
    """`reversible` hands a tensor that several layers use to the Function
    once, and each layer's plan names it."""
    seen = {}

    def fake(branch, plan, x, *params):
        seen.update(plan=plan, n=len(params))
        return x, x

    w, v = torch.ones(2), torch.zeros(2)
    monkeypatch.setattr(trev.Reversible, "apply", fake)
    trev.reversible(None, [{"a": w, "b": v}, {"a": w}, {"c": v}], torch.ones(1))
    assert seen == {"plan": [{"a": 0, "b": 1}, {"a": 0}, {"c": 1}], "n": 2}


@pytest.mark.parametrize("optimizer", ["torch_adam", "grouped_adam"])
def test_bf16_working_copy_through_make_train_step(rev, optimizer):
    """bf16 compute on f32 masters: the Function takes the working copy's
    bf16 tensors (the train step's `functional_call`), and the step's loss
    and gradient norm equal those of plain autograd through the twin
    stream within 2e-2 relative; the masters move."""
    params, jcfg, _ = rev
    rng = np.random.default_rng(2)
    batch = {"text": torch.from_numpy(rng.integers(1, 40, (2, 6))),
             "codes": torch.from_numpy(rng.integers(0, 32, (2, 16)))}
    results = {}
    for rebuild in (True, False):
        model = weights.load_dalle(params, tdalle.DALLEConfig(**MODEL), device="cpu").requires_grad_(True)
        dtypes = []
        forward = functools.partial(ttr.apply_transformer, rebuild=rebuild)

        def loss_fn(p, b, generator, model=model, dtypes=dtypes):
            dtypes.append(p["transformer.layers.0.attn.qkv.weight"].dtype)
            return torch.func.functional_call(model, p, (b["text"], b["codes"]), {"return_loss": True})

        opt = (functools.partial(torch.optim.Adam, lr=1e-3) if optimizer == "torch_adam" else Adam(1e-3))
        settings = tts.StepSettings(compute_dtype=torch.bfloat16,
                                    grad_dtype=torch.float32 if optimizer == "torch_adam" else torch.bfloat16)
        init_fn, step_fn = tts.make_train_step(loss_fn, opt, settings)
        state = init_fn(dict(model.named_parameters()))
        before = {n: p.detach().clone() for n, p in state.params.items()}
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tdalle, "apply_transformer", forward)
            state, metrics = step_fn(state, batch)
        assert dtypes == [torch.bfloat16]
        assert all(p.dtype == torch.float32 for p in state.params.values())
        assert all(not torch.equal(before[n], p) for n, p in state.params.items())
        results[rebuild] = metrics
    for key in ("loss", "grad_norm"):
        got, want = float(results[True][key]), float(results[False][key])
        assert abs(got - want) <= 2e-2 * abs(want), (key, got, want)


@pytest.mark.parametrize("n_pre", [13, 21])
def test_prefill_then_decode_match_jax_twin_stream_caches(rev, n_pre):
    """The twin stream over the caches: prefill, then decode steps to at
    most five or the end of the sequence (text-only in the text region)."""
    params, jcfg, model = rev
    tcfg = jcfg.transformer_config()
    tp, port = params["transformer"], model.transformer
    x = _x(min(n_pre + 5, tcfg.seq_len), seed=1)
    jcache = jtr.init_cache(tcfg, 2)
    pcache = ttr.init_cache(port.cfg, 2)
    jstep = {t: jax.jit(functools.partial(jtr.decode_step, cfg=tcfg, text_only=t)) for t in (False, True)}
    jout, jcache = jax.jit(functools.partial(jtr.prefill, cfg=tcfg))(tp, x=jnp.asarray(x[:, :n_pre]), cache=jcache)
    pout, pcache = ttr.prefill(port, torch.from_numpy(x[:, :n_pre]), pcache)
    np.testing.assert_allclose(pout.numpy(), np.asarray(jout), atol=ATOL, rtol=0)
    for pos in range(n_pre, x.shape[1]):
        text_only = pos < tcfg.text_len
        step = x[:, pos:pos + 1]
        jout, jcache = jstep[text_only](tp, x=jnp.asarray(step), cache=jcache)
        pout, pcache = ttr.decode_step(port, torch.from_numpy(step), pcache, text_only=text_only)
        np.testing.assert_allclose(pout.numpy(), np.asarray(jout), atol=ATOL, rtol=0)
    assert int(pcache["offset"]) == int(jcache["offset"]) == x.shape[1]
    for pl, jl in zip(pcache["layers"], jcache["layers"]):
        assert set(pl) == set(jl)
        for key in jl:
            np.testing.assert_allclose(pl[key].numpy(), np.asarray(jl[key]), atol=ATOL, rtol=0)


def test_paged_decode_step_matches_jax_twin_stream(rev):
    """Four slots (one idle on the trash block) on blocks of their own, at
    staggered offsets: the
    output, the written KV columns and the rings within 1e-5 relative;
    every other pool position bit-equal."""
    params, jcfg, model = rev
    tcfg = jcfg.transformer_config()
    rng = np.random.default_rng(3)
    num_blocks, slots, mb = 30, 4, -(-tcfg.seq_len // BLOCK)
    shape = (num_blocks, tcfg.heads, BLOCK, tcfg.dim_head)
    pool = [{k: rng.standard_normal(shape).astype(np.float32) for k in ("k", "v")} for _ in range(tcfg.depth)]
    # each slot its own blocks, as the engine's pool hands them out
    tables = rng.permutation(np.arange(1, num_blocks))[:slots * mb].reshape(slots, mb).astype(np.int32)
    tables[1] = 0
    offsets = np.array([tcfg.text_len, 0, 15, tcfg.seq_len - 1], np.int32)
    rings = [{k: rng.standard_normal((slots, tcfg.image_fmap_size, 2, tcfg.dim // 4)).astype(np.float32)
              for k in ("shift_attn", "shift_ff")} for _ in range(tcfg.depth)]
    x = rng.standard_normal((slots, 1, tcfg.dim)).astype(np.float32)
    out_j, pool_j, rings_j = jax.jit(functools.partial(jtr.paged_decode_step, cfg=tcfg, block_size=BLOCK))(
        params["transformer"], x=jnp.asarray(x), pool= {"layers": [jax.tree_util.tree_map(jnp.asarray, lp)
                                                                  for lp in pool]},
        block_tables=jnp.asarray(tables), offsets=jnp.asarray(offsets),
        rings={"layers": [jax.tree_util.tree_map(jnp.asarray, r) for r in rings]})
    tpool = {"layers": [{k: torch.from_numpy(v.copy()) for k, v in lp.items()} for lp in pool]}
    trings = {"layers": [{k: torch.from_numpy(v.copy()) for k, v in r.items()} for r in rings]}
    out = paged.paged_decode_step(model.transformer, torch.from_numpy(x), tpool, torch.from_numpy(tables).long(),
                                  torch.from_numpy(offsets).long(), trings, BLOCK)

    def close(got, want):
        want = np.asarray(want)
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()

    close(out.numpy(), out_j)
    written = np.zeros((num_blocks, BLOCK), bool)
    for s, off in enumerate(offsets):
        written[tables[s, off // BLOCK], off % BLOCK] = True
    cols = written[:, None, :, None].repeat(tcfg.heads, 1).repeat(tcfg.dim_head, 3)
    for got, want, before in zip(tpool["layers"], pool_j["layers"], pool):
        for key in ("k", "v"):
            g, w = got[key].numpy(), np.asarray(want[key])
            close(g[cols], w[cols])
            np.testing.assert_array_equal(g[~cols], before[key][~cols])
    for got, want in zip(trings["layers"], rings_j["layers"]):
        for key in ("shift_attn", "shift_ff"):
            close(got[key].numpy(), want[key])


@pytest.mark.parametrize("cond_scale", [1.0, 3.0])
def test_sampled_codes_equal_jax_under_shared_noise(rev, cond_scale):
    params, jcfg, model = rev
    rng = np.random.default_rng(6)
    text = rng.integers(1, MODEL["num_text_tokens"], (2, MODEL["text_seq_len"])).astype(np.int32)
    text[1, 3:] = 0
    noise = rng.gumbel(size=(jcfg.image_seq_len, 2, jcfg.total_tokens)).astype(np.float32)
    ref = jsamp.sample_image_codes(params, jcfg, jnp.asarray(text), jax.random.PRNGKey(0), cond_scale=cond_scale,
                                   noise_override=jnp.asarray(noise))
    port = tsamp.sample_image_codes(model, torch.from_numpy(text).long(), cond_scale=cond_scale,
                                    noise_override=torch.from_numpy(noise))
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
    assert len(np.unique(port.numpy())) > 3
