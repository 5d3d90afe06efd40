"""Shared layers (`shared_attn_ids`, `shared_ff_ids`), the `stable` model
and the sandwich norm (`sandwich_norm`) in the port against the JAX
package, on the CPU.

- `derive_layer_specs`: the ids cycle over depth as JAX's do, and a shared
  attention id reused under another attention type raises JAX's text.
- The v3 weight bridge both ways: a JAX tree with shared ids and sandwich
  norms loads into a model whose layers of one id hold one module, and the
  writer gives the JAX tree back, its key set and leaves equal.
- The DALL-E loss and its gradients against `jax.grad` under `stable`
  (the embeddings' 0.1 blend shows in their gradients, `divide_max` on the
  output), `sandwich_norm` and shared ids: loss 1e-5 relative, gradients
  1e-4.
- Three `make_train_step` steps with the port's grouped Adam against JAX's
  with `optax.adam`, clip 0.5: loss and gradient norm 1e-4 relative each
  step, final parameters 1e-4; each shared leaf has one Adam state.
- `--resume` of a JAX-CLI run trained with `--stable_softmax --reversible
  --shared_attn_ids 0,0 --shared_ff_ids 0,0`: the port restores its Adam
  moments (one per shared leaf) and its next loss is the JAX CLI's within
  1e-5 relative.
- Codes under `noise_override` with these settings, plain and guided,
  `array_equal` to the JAX sampler's; the paged decode step against
  JAX's, 1e-5 relative; the serving engine's codes equal batch-1
  sampling's."""
import functools
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from dalle_pytorch_tpu.cli import train_dalle as jcli  # noqa: E402
from dalle_pytorch_tpu.models import dalle as jdalle  # noqa: E402
from dalle_pytorch_tpu.models import sampling as jsamp  # noqa: E402
from dalle_pytorch_tpu.models import transformer as jtr  # noqa: E402
from dalle_pytorch_tpu.parallel import train_step as jts  # noqa: E402
from dalle_pytorch_tpu_torch import weights  # noqa: E402
from dalle_pytorch_tpu_torch.cli import train_dalle as tcli  # noqa: E402
from dalle_pytorch_tpu_torch.models import dalle as tdalle  # noqa: E402
from dalle_pytorch_tpu_torch.models import paged  # noqa: E402
from dalle_pytorch_tpu_torch.models import sampling as tsamp  # noqa: E402
from dalle_pytorch_tpu_torch.models import transformer as ttr  # noqa: E402
from dalle_pytorch_tpu_torch.optim.grouped import Adam  # noqa: E402
from dalle_pytorch_tpu_torch.parallel import train_step as tts  # noqa: E402
from dalle_pytorch_tpu_torch.serving.engine import EngineConfig, GenerationEngine  # noqa: E402

ATOL = 1e-4
# seq 22 = text 6 + a 4 x 4 map; layers 0 and 2 share an attention (full),
# 1 and 3 another (axial_row); feed-forward ids 0, 0, 1, 0
MODEL = dict(dim=32, depth=4, heads=2, dim_head=16, num_text_tokens=40, text_seq_len=6, num_image_tokens=32,
             image_fmap_size=4, shift_tokens=True, attn_types=("full", "axial_row"), stable=True,
             sandwich_norm=True, shared_attn_ids=(0, 1, 0, 1), shared_ff_ids=(0, 0, 1))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _load(cfg, seed=0):
    jcfg = jdalle.DALLEConfig(**cfg)
    params = jax.device_get(jax.jit(jdalle.init_dalle, static_argnums=1)(jax.random.PRNGKey(seed), jcfg))
    return params, jcfg, weights.load_dalle(params, tdalle.DALLEConfig(**cfg), device="cpu")


@pytest.fixture(scope="module")
def shared():
    return _load(MODEL)


def _data(seed, b=2):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, MODEL["num_text_tokens"], (b, MODEL["text_seq_len"])).astype(np.int32),
            rng.integers(0, MODEL["num_image_tokens"], (b, 16)).astype(np.int32))


@pytest.mark.parametrize("kw", [
    dict(depth=4, attn_types=("full", "axial_row"), shared_attn_ids=(0, 1, 0, 1), shared_ff_ids=(0, 0, 1)),
    dict(depth=5, attn_types=("full",), shared_attn_ids=(3, 7), shared_ff_ids=None),
    dict(depth=3, attn_types=("axial_row", "axial_col", "conv_like"), shared_attn_ids=None, shared_ff_ids=(2,)),
    dict(depth=6, attn_types=("sparse", "full"), shared_attn_ids=(0, 1, 2, 3), shared_ff_ids=(0, 1)),
])
def test_layer_specs_cycle_the_ids_as_jax(kw):
    common = dict(dim=16, seq_len=22, image_fmap_size=4, **kw)
    got = [tuple(vars(s).values()) for s in ttr.derive_layer_specs(ttr.TransformerConfig(**common))]
    want = [(s.index, s.attn_type, s.attn_id, s.ff_id) for s in jtr.derive_layer_specs(jtr.TransformerConfig(**common))]
    assert got == want


def test_a_shared_id_under_two_attention_types_raises_the_jax_text():
    common = dict(dim=16, depth=3, seq_len=22, image_fmap_size=4, attn_types=("full", "axial_row"),
                  shared_attn_ids=(0, 0))
    with pytest.raises(ValueError) as want:
        jtr.derive_layer_specs(jtr.TransformerConfig(**common))
    with pytest.raises(ValueError) as got:
        ttr.derive_layer_specs(ttr.TransformerConfig(**common))
    assert str(got.value) == str(want.value) and "attn_types do not match shared_attn_ids" in str(got.value)


def test_v3_bridge_carries_shared_ids_and_sandwich_norms_both_ways(shared):
    """Layers of one id hold one module; the writer's tree (from the state
    dict, and from `named_parameters` alone, where a shared tensor has one
    name) has the JAX tree's key paths and equal leaves."""
    params, _, model = shared
    layers = model.transformer.layers
    assert layers[0].attn is layers[2].attn and layers[1].attn is layers[3].attn
    assert layers[0].ff is layers[1].ff is layers[3].ff and layers[2].ff is not layers[0].ff
    assert hasattr(layers[3], "attn_norm_out") and hasattr(layers[3], "ff_norm_out")
    named = dict(model.named_parameters())
    assert len(named) == len(jax.tree_util.tree_leaves(params))
    for sd in (model.state_dict(), named):
        tree = weights.dalle_tree(sd, model.cfg)
        got, got_def = jax.tree_util.tree_flatten_with_path(tree)
        want, want_def = jax.tree_util.tree_flatten_with_path(params)
        assert [p for p, _ in got] == [p for p, _ in want]
        for (_, g), (_, w) in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_loss_and_gradients_match_jax(shared):
    """Loss 1e-5 relative, every leaf of the gradient tree 1e-4; the image
    embedding's gradient is 0.1 of what reaches the transformer's input at
    the image positions (the stable blend)."""
    params, jcfg, model = shared
    text, codes = _data(1)
    ref_loss, ref = jax.jit(jax.value_and_grad(
        lambda p: jdalle.forward(p, jcfg, jnp.asarray(text), jnp.asarray(codes), return_loss=True)))(params)
    seen = {}
    real = tdalle.apply_transformer

    def keep_input(tr, x, **kw):
        x.retain_grad()
        seen["x"] = x
        return real(tr, x, **kw)

    named = dict(model.requires_grad_(True).named_parameters())
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tdalle, "apply_transformer", keep_input)
            loss = tdalle.forward(model, torch.from_numpy(text).long(), torch.from_numpy(codes).long(),
                                  return_loss=True)
            loss.backward()
        grads = {n: p.grad for n, p in named.items()}
    finally:
        model.zero_grad()
        model.requires_grad_(False)
    assert abs(loss.item() - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
    got = jax.tree_util.tree_flatten_with_path(weights.dalle_tree(grads, model.cfg))[0]
    want = jax.tree_util.tree_flatten_with_path(jax.device_get(ref))[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0)
    text_len = MODEL["text_seq_len"] + 1
    n_img = seen["x"].shape[1] - text_len  # the last code has nothing left to predict
    dx = seen["x"].grad[:, text_len:].reshape(-1, MODEL["dim"])
    blend = torch.zeros_like(grads["image_emb.weight"]).index_add_(
        0, torch.from_numpy(codes[:, :n_img]).long().flatten(), dx) * 0.1
    assert blend.abs().max() > 0
    torch.testing.assert_close(grads["image_emb.weight"], blend, atol=1e-6, rtol=1e-5)


def test_train_steps_match_jax_with_one_state_per_shared_leaf():
    """Grouped Adam 3e-4 against `optax.adam(3e-4)`, clip 0.5, three steps."""
    params, jcfg, model = _load(MODEL, seed=7)
    rng = np.random.default_rng(8)
    batches = [{"text": rng.integers(0, MODEL["num_text_tokens"], (4, MODEL["text_seq_len"])).astype(np.int32),
                "codes": rng.integers(0, MODEL["num_image_tokens"], (4, 16)).astype(np.int32)} for _ in range(3)]

    def jloss(p, batch, key):
        return jdalle.forward(p, jcfg, batch["text"], batch["codes"], return_loss=True)

    init_fn, step_fn = jts.make_train_step(jloss, optax.adam(3e-4), mesh=None,
                                           settings=jts.StepSettings(clip_grad_norm=0.5))
    state = init_fn(jax.tree_util.tree_map(jnp.asarray, params))
    step_fn = jax.jit(step_fn)
    ref = []
    for batch in batches:
        state, m = step_fn(state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
        ref.append(jax.device_get(m))
    ref_params = jax.device_get(state.params)

    model.requires_grad_(True)

    def loss_fn(p, batch, generator):
        return torch.func.functional_call(model, p, (batch["text"], batch["codes"]), {"return_loss": True})

    tinit, tstep = tts.make_train_step(loss_fn, Adam(3e-4), tts.StepSettings(clip_grad_norm=0.5))
    tstate = tinit(dict(model.named_parameters()))
    names = [n for g in tstate.opt_state.groups for n in g.names]
    assert sorted(names) == sorted(tstate.params) and len(names) == len(jax.tree_util.tree_leaves(params))
    for batch, r in zip(batches, ref):
        tstate, m = tstep(tstate, {k: torch.from_numpy(v).long() for k, v in batch.items()})
        for key in ("loss", "grad_norm"):
            assert abs(float(m[key]) - float(r[key])) <= 1e-4 * abs(float(r[key])), key
    got = jax.tree_util.tree_leaves(weights.dalle_tree(model.state_dict(), model.cfg))
    want = jax.tree_util.tree_leaves(ref_params)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0)


def test_port_resumes_a_jax_cli_run_with_these_settings(tmp_path, capsys):
    """The JAX CLI's dummy run with the four settings, a checkpoint a step;
    the port resumes its step-1 file and its next loss is the JAX CLI's at
    that step within 1e-5 relative, the optimizer state restored."""
    flags = ["--stable_softmax", "--reversible", "--shared_attn_ids", "0,0", "--shared_ff_ids", "0,0"]
    out = tmp_path / "J"
    jcli.main(["--dummy_run", "3", "--telemetry", "off", "--log_every_n_steps", "1", "--save_every_n_steps", "1",
               "--async_checkpoint", "0", "--dalle_output_file_name", str(out), *flags])
    logged = [json.loads(x) for x in open(f"{out}.metrics.jsonl")]
    jax_losses = {r["step"]: r["loss"] for r in logged if "loss" in r}
    capsys.readouterr()
    assert tcli.main(["--dummy_run", "3", "--batch_size", str(int(jax.device_count()) * 2), "--device", "cpu", "--telemetry", "off",
                      "--resume", f"{out}_step1.npz", "--dalle_output_file_name", str(tmp_path / "P")]) == 0
    printed = capsys.readouterr().out
    assert "optimizer state not restored" not in printed
    lines = [json.loads(x) for x in printed.splitlines() if x.startswith("{")]
    config = lines[0]["config"]
    assert config["stable"] and config["reversible"] and config["shared_attn_ids"] == [0, 0]
    records = [r for r in lines if "loss" in r]
    assert len(records) == 1 and records[0]["step"] == 3
    assert abs(records[0]["loss"] - jax_losses[2]) <= 1e-5 * abs(jax_losses[2])


@pytest.mark.parametrize("cond_scale", [1.0, 3.0])
def test_sampled_codes_equal_jax_under_shared_noise(shared, cond_scale):
    params, jcfg, model = shared
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


def test_paged_decode_step_matches_jax(shared):
    """Three slots on blocks of their own at staggered offsets: the output
    within 1e-5 relative (the stable softmax, the sandwich norms and the
    shared modules in the paged branch)."""
    params, jcfg, model = shared
    tcfg = jcfg.transformer_config()
    rng = np.random.default_rng(3)
    block, slots = 4, 3
    mb = -(-tcfg.seq_len // block)
    num_blocks = 1 + slots * mb
    shape = (num_blocks, tcfg.heads, block, tcfg.dim_head)
    pool = [{k: rng.standard_normal(shape).astype(np.float32) for k in ("k", "v")} for _ in range(tcfg.depth)]
    tables = (1 + np.arange(slots * mb)).reshape(slots, mb).astype(np.int32)
    offsets = np.array([tcfg.text_len, 12, tcfg.seq_len - 1], np.int32)
    rings = [{k: rng.standard_normal((slots, tcfg.image_fmap_size, 2, tcfg.dim // 4)).astype(np.float32)
              for k in ("shift_attn", "shift_ff")} for _ in range(tcfg.depth)]
    x = rng.standard_normal((slots, 1, tcfg.dim)).astype(np.float32)
    want, _, _ = jax.jit(functools.partial(jtr.paged_decode_step, cfg=tcfg, block_size=block))(
        params["transformer"], x=jnp.asarray(x), pool={"layers": [jax.tree_util.tree_map(jnp.asarray, p)
                                                                   for p in pool]},
        block_tables=jnp.asarray(tables), offsets=jnp.asarray(offsets),
        rings={"layers": [jax.tree_util.tree_map(jnp.asarray, r) for r in rings]})
    got = paged.paged_decode_step(
        model.transformer, torch.from_numpy(x), {"layers": [{k: torch.from_numpy(v.copy()) for k, v in p.items()}
                                                             for p in pool]},
        torch.from_numpy(tables).long(), torch.from_numpy(offsets).long(),
        {"layers": [{k: torch.from_numpy(v.copy()) for k, v in r.items()} for r in rings]}, block)
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_engine_codes_equal_batch1_sampling_with_every_setting():
    """A reversible model with the other three settings served by the
    engine: each request's codes equal the port's and the JAX package's
    batch-1 `sample_image_codes` under its noise, guided and not."""
    cfg = dict(MODEL, reversible=True)
    params, jcfg, model = _load(cfg, seed=2)
    rng = np.random.default_rng(4)
    text = rng.integers(1, MODEL["num_text_tokens"], (2, MODEL["text_seq_len"]))
    noise = rng.gumbel(size=(2, jcfg.image_seq_len, jcfg.total_tokens)).astype(np.float32)
    conds = (1.0, 3.0)
    engine = GenerationEngine(model, engine_cfg=EngineConfig(num_slots=4, block_size=4, filter_thres=0.5,
                                                             noise_override=True))
    reqs = [engine.submit(text[i], cond_scale=conds[i], noise=noise[i]) for i in range(2)]
    engine.run_until_idle()
    for i, req in enumerate(reqs):
        assert req.outcome == "completed"
        port = tsamp.sample_image_codes(model, torch.as_tensor(text[i])[None], cond_scale=conds[i],
                                        noise_override=torch.from_numpy(noise[i][:, None])).numpy()[0]
        ref = np.asarray(jsamp.sample_image_codes(
            params, jcfg, jnp.asarray(text[i:i + 1]), jax.random.PRNGKey(0), cond_scale=conds[i],
            noise_override=jnp.asarray(noise[i][:, None])))[0]
        np.testing.assert_array_equal(port, ref)
        np.testing.assert_array_equal(req.codes, port)
