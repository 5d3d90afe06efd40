"""A pattern-attention model in the port against the JAX package's, on the
CPU: the transformer (output, gradients, prefill then cached decode with
sparse decode on and off, a per-head layout), the DALL-E model (sampled
codes under shared noise, loss gradients, three train steps), the config's
pattern knobs and the training CLI, with
`attn_types=("full", "axial_row", "axial_col", "conv_like")`."""
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from dalle_pytorch_tpu.models import dalle as jdalle  # noqa: E402
from dalle_pytorch_tpu.models import sampling as jsamp  # noqa: E402
from dalle_pytorch_tpu.models import transformer as jtr  # noqa: E402
from dalle_pytorch_tpu.parallel import train_step as jts  # noqa: E402
from dalle_pytorch_tpu_torch import weights  # noqa: E402
from dalle_pytorch_tpu_torch.cli import train_dalle as tcli  # noqa: E402
from dalle_pytorch_tpu_torch.models import dalle as tdalle  # noqa: E402
from dalle_pytorch_tpu_torch.models import sampling as tsamp  # noqa: E402
from dalle_pytorch_tpu_torch.models import transformer as ttr  # noqa: E402
from dalle_pytorch_tpu_torch.parallel import train_step as tts  # noqa: E402

ATOL = 1e-4  # f32 through a depth-4 stack: the frameworks sum in other orders
PATTERN_TYPES = ("full", "axial_row", "axial_col", "conv_like")
# seq 51 = text 15 + a 6 x 6 map: image rows of 6 cross many prefix lengths
MODEL = dict(dim=64, depth=4, heads=2, dim_head=32, num_text_tokens=50, text_seq_len=15,
             num_image_tokens=32, image_fmap_size=6, shift_tokens=True, rotary_emb=True,
             attn_types=PATTERN_TYPES)
# seq 16 = text 7 + a 3 x 3 map: the JAX train step jits quickly
STEP = dict(dim=32, depth=4, heads=2, dim_head=16, num_text_tokens=30, text_seq_len=7,
            num_image_tokens=16, image_fmap_size=3, shift_tokens=True, attn_types=PATTERN_TYPES)


# ---------------------------------------------------------------------------
# the transformer
# ---------------------------------------------------------------------------


def _models(**extra):
    cfg = dict(MODEL, **extra)
    jcfg = jdalle.DALLEConfig(**cfg)
    params = jax.device_get(jdalle.init_dalle(jax.random.PRNGKey(0), jcfg))
    model = weights.load_dalle(params, tdalle.DALLEConfig(**cfg), device="cpu")
    return params, jcfg, model


@pytest.fixture(scope="module")
def pattern_model():
    return _models()


def _close(port, ref):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_apply_transformer_and_its_gradient_match(pattern_model):
    """Output and d sum(out * g) / dx of the pattern stack (full, axial_row,
    axial_col, conv_like) at n = 51."""
    params, jcfg, model = pattern_model
    tparams, tcfg = params["transformer"], jcfg.transformer_config()
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 51, MODEL["dim"])).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    tx = torch.from_numpy(x).requires_grad_(True)
    out = ttr.apply_transformer(model.transformer, tx)
    (out * torch.from_numpy(g)).sum().backward()
    ref_out, vjp = jax.vjp(lambda a: jtr.apply_transformer(tparams, tcfg, a), jnp.asarray(x))
    _close(out, ref_out)
    _close(tx.grad, vjp(jnp.asarray(g))[0])


def test_dalle_loss_gradients_match_jax(pattern_model):
    """Every parameter's gradient of the pattern model's weighted CE against
    jax.grad, to 1e-5 of the leaf's largest value."""
    params, jcfg, model = pattern_model
    rng = np.random.default_rng(4)
    text = rng.integers(0, MODEL["num_text_tokens"], (2, MODEL["text_seq_len"]))
    codes = rng.integers(0, MODEL["num_image_tokens"], (2, MODEL["image_fmap_size"] ** 2))
    model.requires_grad_(True)
    model.zero_grad()
    loss = tdalle.forward(model, torch.from_numpy(text), torch.from_numpy(codes), return_loss=True)
    loss.backward()
    grads = weights.dalle_tree({n: p.grad for n, p in model.named_parameters()}, model.cfg)
    model.requires_grad_(False)
    ref_loss, ref = jax.value_and_grad(
        lambda p: jdalle.forward(p, jcfg, jnp.asarray(text), jnp.asarray(codes), return_loss=True))(params)
    assert abs(loss.item() - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
    flat, ref_flat = jax.tree_util.tree_leaves(grads), jax.tree_util.tree_leaves(ref)
    assert len(flat) == len(ref_flat) == 15 * MODEL["depth"] + 6
    for port, r in zip(flat, ref_flat):
        r = np.asarray(r)
        assert np.abs(np.asarray(port) - r).max() <= 1e-5 * max(np.abs(r).max(), 1e-30)


@pytest.mark.parametrize("extra", [{}, {"sparse_decode": False},
                                   {"attn_types": ("sparse", "axial_row"), "sparse_per_head": True,
                                    "sparse_block_size": 4}],
                         ids=["sparse_decode", "full_cache_rows", "sparse_per_head"])
def test_prefill_then_decode_match(extra):
    """A primed prefix (bos + text 15 + 20 image codes: three image rows and
    a part) then 5 cached decode steps: outputs and KV caches agree."""
    params, jcfg, model = _models(**extra)
    tparams, tcfg = params["transformer"], jcfg.transformer_config()
    n_pre = 16 + 20
    x = np.random.default_rng(5).standard_normal((2, n_pre + 5, MODEL["dim"])).astype(np.float32)
    jcache, pcache = jtr.init_cache(tcfg, 2), ttr.init_cache(model.transformer.cfg, 2)
    jout, jcache = jtr.prefill(tparams, tcfg, jnp.asarray(x[:, :n_pre]), jcache)
    pout, pcache = ttr.prefill(model.transformer, torch.from_numpy(x[:, :n_pre]), pcache)
    _close(pout, jout)
    gathers = ttr.decode_step.gathers
    jstep = jax.jit(lambda s, c: jtr.decode_step(tparams, tcfg, s, c))
    for pos in range(n_pre, n_pre + 5):
        step = x[:, pos:pos + 1]
        jout, jcache = jstep(jnp.asarray(step), jcache)
        pout, pcache = ttr.decode_step(model.transformer, torch.from_numpy(step), pcache)
        _close(pout, jout)
    for pl, rl in zip(pcache["layers"], jcache["layers"]):
        for key in rl:
            _close(pl[key], rl[key])
    pattern_layers = sum(t != "full" for t in model.cfg.attn_types) * model.cfg.depth // len(model.cfg.attn_types)
    want = 5 * pattern_layers if model.cfg.sparse_decode else 0
    assert ttr.decode_step.gathers - gathers == want


def test_patterns_follow_the_config():
    """The transformer builds one mask per pattern key, as the JAX
    package's `spec_patterns`; sparse layers draw distinct layouts."""
    cfg = dict(MODEL, attn_types=("sparse", "conv_like"), sparse_block_size=4)
    jcfg = jdalle.DALLEConfig(**cfg, conv_kernel_size=3).transformer_config()
    port = tdalle.DALLEConfig(**cfg, conv_kernel_size=3).transformer_config()
    ref = jtr.spec_patterns(jcfg, jtr.derive_layer_specs(jcfg))
    got = ttr.spec_patterns(port, ttr.derive_layer_specs(port))
    assert list(got) == list(ref) == [("sparse", 0), ("conv_like", 0), ("sparse", 2)]
    for key in ref:
        np.testing.assert_array_equal(got[key], ref[key])
    assert not np.array_equal(got[("sparse", 0)], got[("sparse", 2)])


# ---------------------------------------------------------------------------
# the DALL-E model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cond_scale,prime_len", [(1.0, 0), (3.0, 0), (3.0, 14)], ids=["plain", "cfg", "primed"])
def test_sampled_codes_equal_under_shared_noise(pattern_model, cond_scale, prime_len):
    params, jcfg, model = pattern_model
    rng = np.random.default_rng(6)
    text = rng.integers(1, MODEL["num_text_tokens"], (2, MODEL["text_seq_len"])).astype(np.int32)
    text[1, 9:] = 0
    primer = rng.integers(0, MODEL["num_image_tokens"], (2, prime_len)).astype(np.int32) if prime_len else None
    noise = rng.gumbel(size=(jcfg.image_seq_len - prime_len, 2, jcfg.total_tokens)).astype(np.float32)
    ref = jsamp.sample_image_codes(
        params, jcfg, jnp.asarray(text), jax.random.PRNGKey(0), cond_scale=cond_scale,
        primer_codes=None if primer is None else jnp.asarray(primer), prime_len=prime_len,
        noise_override=jnp.asarray(noise))
    port = tsamp.sample_image_codes(
        model, torch.from_numpy(text).long(), cond_scale=cond_scale,
        primer_codes=None if primer is None else torch.from_numpy(primer).long(), prime_len=prime_len,
        noise_override=torch.from_numpy(noise))
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
    assert len(np.unique(port.numpy())) > 3


def test_train_steps_match_jax():
    """Three steps of Adam 3e-4 with clip 0.5 on the pattern model: loss and
    grad norm to 1e-5 relative each step, final parameters to 2e-6."""
    jcfg = jdalle.DALLEConfig(**STEP)
    params = jax.device_get(jdalle.init_dalle(jax.random.PRNGKey(7), jcfg))
    rng = np.random.default_rng(8)
    batches = [{"text": rng.integers(0, STEP["num_text_tokens"], (4, STEP["text_seq_len"])).astype(np.int32),
                "codes": rng.integers(0, STEP["num_image_tokens"], (4, 9)).astype(np.int32)} for _ in range(3)]

    def jloss(p, batch, key):
        return jdalle.forward(p, jcfg, batch["text"], batch["codes"], return_loss=True)

    init_fn, step_fn = jts.make_train_step(jloss, optax.adam(3e-4), mesh=None,
                                           settings=jts.StepSettings(clip_grad_norm=0.5))
    state = init_fn(jax.tree_util.tree_map(jnp.asarray, params))
    ref = []
    for batch in batches:
        state, m = step_fn(state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
        ref.append(jax.device_get(m))
    ref_params = jax.device_get(state.params)

    model = weights.load_dalle(params, tdalle.DALLEConfig(**STEP), device="cpu").requires_grad_(True)

    def loss_fn(p, batch, generator):
        return torch.func.functional_call(model, p, (batch["text"], batch["codes"]), {"return_loss": True})

    tinit, tstep = tts.make_train_step(loss_fn, functools.partial(torch.optim.Adam, lr=3e-4),
                                       tts.StepSettings(clip_grad_norm=0.5))
    tstate = tinit(dict(model.named_parameters()))
    for batch, r in zip(batches, ref):
        tstate, m = tstep(tstate, {k: torch.from_numpy(v).long() for k, v in batch.items()})
        for key in ("loss", "grad_norm"):
            assert abs(float(m[key]) - float(r[key])) <= 1e-5 * abs(float(r[key])), key
    port = jax.tree_util.tree_leaves(weights.dalle_tree(model.state_dict(), model.cfg))
    for p, r in zip(port, jax.tree_util.tree_leaves(ref_params)):
        np.testing.assert_allclose(np.asarray(p), np.asarray(r), atol=2e-6, rtol=0)


def test_from_dict_keeps_the_pattern_knobs():
    """A JAX config with conv_kernel_size 3 (and the other pattern knobs)
    rebuilds in the port with the same patterns; the execution-only knobs
    are dropped; attn_vfa raises naming the later slice."""
    jcfg = jdalle.DALLEConfig(**dict(MODEL, attn_types=("conv_like", "sparse")), conv_kernel_size=3,
                              conv_dilation=2, sparse_block_size=4, sparse_per_head=True,
                              scan_layers=False, attn_kernel="xla", attn_grid="dense", sparse_decode=False)
    port = tdalle.DALLEConfig.from_dict(jcfg.to_dict())
    assert (port.conv_kernel_size, port.conv_dilation, port.sparse_block_size, port.sparse_per_head,
            port.attn_grid, port.sparse_decode) == (3, 2, 4, True, "dense", False)
    ref = jtr.spec_patterns(jcfg.transformer_config(), jtr.derive_layer_specs(jcfg.transformer_config()))
    got = ttr.spec_patterns(port.transformer_config(), ttr.derive_layer_specs(port.transformer_config()))
    assert list(got) == list(ref)
    for key in ref:
        np.testing.assert_array_equal(got[key], ref[key])
    with pytest.raises(NotImplementedError, match="VFA.*later slice"):
        tdalle.DALLEConfig.from_dict(dict(jcfg.to_dict(), attn_vfa=True))


def test_api_takes_the_pattern_keywords():
    """`DALLE(...)` passes the pattern keywords to its config: the README's
    attention cycle with a 3 x 3 conv and per-head sparse layouts scores a
    batch on the CPU."""
    from dalle_pytorch_tpu_torch import api

    vae = api.DiscreteVAE(seed=0, device="cpu", image_size=32, num_tokens=16, num_layers=2)
    dalle = api.DALLE(vae=vae, device="cpu", dim=32, depth=5, heads=2, dim_head=16, num_text_tokens=30,
                      text_seq_len=9, attn_types=PATTERN_TYPES + ("sparse",), conv_kernel_size=3,
                      sparse_block_size=4, sparse_per_head=True, sparse_decode=False)
    cfg = dalle.module.transformer.cfg
    assert (cfg.conv_kernel_size, cfg.sparse_block_size, cfg.sparse_per_head, cfg.sparse_decode) == (3, 4, True, False)
    assert dalle.module.transformer.patterns[("sparse", 4)].shape == (2, 73, 73)
    text = torch.randint(1, 30, (2, 9), generator=torch.Generator().manual_seed(0))
    codes = torch.randint(0, 16, (2, 64), generator=torch.Generator().manual_seed(1))
    assert torch.isfinite(dalle(text, codes, return_loss=True))


def test_cli_trains_a_pattern_model(tmp_path):
    out = str(tmp_path / "sparse")
    assert tcli.main(["--dummy_run", "2", "--device", "cpu", "--shift_tokens", "--attn_types",
                      "full,axial_row,sparse", "--sparse_per_head", "--depth", "3",
                      "--dalle_output_file_name", out]) == 0
    model, _ = weights.load_dalle_checkpoint(out + ".pt", device="cpu")
    assert model.cfg.attn_types == ("full", "axial_row", "sparse") and model.cfg.sparse_per_head
