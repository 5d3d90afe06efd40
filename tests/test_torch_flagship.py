"""A small model with the flagship's features in the port against the JAX
package's, on the CPU: tied input/output embeddings
(`share_input_output_emb`), the four-type attention cycle and the VFA
forward (`attn_vfa`).  Weights come from the JAX `init_dalle` through
`weights.load_dalle`.  Held: logits, the gradient of the tied logits weight
(the sum of its text lookup, image lookup and logits uses), three train
steps, sampled codes under shared noise (plain and primed), tied v3
checkpoints read both ways, and the training CLI's
`--share_input_output_emb`.

At n 151 (text 7 + a 12 x 12 map) axial_row kills tiles at the kernels' 64
x 64 tile, so the port's CPU path takes the plain VFA pair there, as the
card takes the kernels; the JAX package attends densely on the CPU."""
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from dalle_pytorch_tpu.models import dalle as jdalle  # noqa: E402
from dalle_pytorch_tpu.models import sampling as jsamp  # noqa: E402
from dalle_pytorch_tpu.parallel import train_step as jts  # noqa: E402
from dalle_pytorch_tpu_torch import weights  # noqa: E402
from dalle_pytorch_tpu_torch.cli import train_dalle as tcli  # noqa: E402
from dalle_pytorch_tpu_torch.kernels import flash_attention as tfa  # noqa: E402
from dalle_pytorch_tpu_torch.models import dalle as tdalle  # noqa: E402
from dalle_pytorch_tpu_torch.models import sampling as tsamp  # noqa: E402
from dalle_pytorch_tpu_torch.parallel import train_step as tts  # noqa: E402

ATOL = 1e-4  # f32 through a depth-4 stack: the frameworks sum in other orders
FLAGSHIP_TYPES = ("full", "axial_row", "axial_col", "conv_like")
MODEL = dict(dim=64, depth=4, heads=2, dim_head=32, num_text_tokens=50, text_seq_len=7,
             num_image_tokens=32, image_fmap_size=12, shift_tokens=True, rotary_emb=True,
             attn_types=FLAGSHIP_TYPES, share_input_output_emb=True, attn_vfa=True)
# seq 16 = text 7 + a 3 x 3 map, so the JAX train step jits quickly; the
# forced compacted grid sends every layer through the VFA pair
STEP = dict(dim=32, depth=4, heads=2, dim_head=16, num_text_tokens=30, text_seq_len=7,
            num_image_tokens=16, image_fmap_size=3, shift_tokens=True, attn_types=FLAGSHIP_TYPES,
            share_input_output_emb=True, attn_vfa=True, attn_grid="compact")
VAE = dict(image_size=32, num_tokens=32, codebook_dim=16, num_layers=2, hidden_dim=8)


def _load(cfg, seed=0):
    jcfg = jdalle.DALLEConfig(**cfg)
    params = jax.device_get(jdalle.init_dalle(jax.random.PRNGKey(seed), jcfg))
    return params, jcfg, weights.load_dalle(params, tdalle.DALLEConfig(**cfg), device="cpu")


@pytest.fixture(scope="module")
def flagship():
    return _load(MODEL)


def _vfa_launches():
    return tfa.flash_fwd_compact.max_launches + tfa.flash_fwd_compact.vfa_launches


def test_tied_model_has_no_embedding_tables(flagship):
    params, _, model = flagship
    assert "text_emb" not in params and "image_emb" not in params
    names = [name for name, _ in model.named_parameters()]
    assert not any("_emb" in name for name in names) and names.count("logits_linear.weight") == 1
    init = tdalle.init_dalle(model.cfg, torch.Generator().manual_seed(0), device="cpu")
    assert set(init.state_dict()) == set(model.state_dict())
    assert tdalle.embed_image_codes(model, torch.tensor([[0, 99]])).shape == (1, 2, MODEL["dim"])


def test_logits_match_and_take_the_vfa_path(flagship):
    """Logits at n 151 to 1e-4; the pattern layers that compact at the
    kernels' tile ran the plain VFA pair on the CPU."""
    params, jcfg, model = flagship
    rng = np.random.default_rng(0)
    text = rng.integers(0, MODEL["num_text_tokens"], (2, MODEL["text_seq_len"]))
    codes = rng.integers(0, MODEL["num_image_tokens"], (2, 144))
    vfa_calls = []
    real = tfa.vfa_fwd_reference
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tfa, "vfa_fwd_reference", lambda *a, **k: vfa_calls.append(1) or real(*a, **k))
        with torch.no_grad():
            port = tdalle.forward(model, torch.from_numpy(text), torch.from_numpy(codes))
    assert len(vfa_calls) >= 1
    ref = jdalle.forward(params, jcfg, jnp.asarray(text), jnp.asarray(codes))
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_tied_weight_gradient_matches_jax(flagship):
    """d loss / d logits_linear.w: the logits' own gradient plus the text
    and image lookups' scattered rows, against jax.grad (the (in, out)
    layout), to 1e-4; the lookups alone give a nonzero part."""
    params, jcfg, model = flagship
    rng = np.random.default_rng(1)
    text = rng.integers(0, MODEL["num_text_tokens"], (2, MODEL["text_seq_len"]))
    codes = rng.integers(0, MODEL["num_image_tokens"], (2, 144))
    model.requires_grad_(True)
    model.zero_grad()
    loss = tdalle.forward(model, torch.from_numpy(text), torch.from_numpy(codes), return_loss=True)
    loss.backward()
    grad = model.logits_linear.weight.grad.clone()
    model.zero_grad()
    emb = tdalle.embed_image_codes(model, torch.from_numpy(codes))
    emb.sum().backward()
    lookup_rows = model.logits_linear.weight.grad[jcfg.num_text_tokens_padded:]
    model.requires_grad_(False)
    assert lookup_rows.abs().sum() > 0
    ref_loss, ref = jax.value_and_grad(
        lambda p: jdalle.forward(p, jcfg, jnp.asarray(text), jnp.asarray(codes), return_loss=True))(params)
    assert abs(loss.item() - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
    np.testing.assert_allclose(grad.t().numpy(), np.asarray(ref["logits_linear"]["w"]), atol=ATOL, rtol=0)


def test_train_steps_match_jax():
    """Three steps of Adam 3e-4 with clip 0.5: loss and grad norm to 1e-4
    relative each step, final parameters to 1e-4.  The tied weight is one
    master, one optimizer entry and one working-copy entry."""
    params, jcfg, model = _load(STEP, seed=7)
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

    model.requires_grad_(True)
    seen = []

    def loss_fn(p, batch, generator):
        seen.append(list(p))
        return torch.func.functional_call(model, p, (batch["text"], batch["codes"]), {"return_loss": True})

    tinit, tstep = tts.make_train_step(loss_fn, functools.partial(torch.optim.Adam, lr=3e-4),
                                       tts.StepSettings(clip_grad_norm=0.5))
    tstate = tinit(dict(model.named_parameters()))
    before = _vfa_launches()
    for batch, r in zip(batches, ref):
        tstate, m = tstep(tstate, {k: torch.from_numpy(v).long() for k, v in batch.items()})
        for key in ("loss", "grad_norm"):
            assert abs(float(m[key]) - float(r[key])) <= 1e-4 * abs(float(r[key])), key
    assert _vfa_launches() == before  # the CPU takes the plain versions
    masters = list(tstate.params)
    assert masters.count("logits_linear.weight") == 1 and not any("_emb" in n for n in masters)
    assert len(tstate.opt_state.state) == len(masters) and seen[-1] == masters
    port = jax.tree_util.tree_leaves(weights.dalle_tree(model.state_dict(), model.cfg))
    ref_leaves = jax.tree_util.tree_leaves(ref_params)
    assert len(port) == len(ref_leaves)
    for p, r in zip(port, ref_leaves):
        np.testing.assert_allclose(np.asarray(p), np.asarray(r), atol=ATOL, rtol=0)


def test_bf16_working_copy_looks_up_the_tied_rows():
    """With bf16 compute the lookups read the bf16 working copy's rows of
    the one tied weight, and the f32 master's text and image rows move."""
    _, _, model = _load(STEP, seed=3)
    model.requires_grad_(True)
    seen = {}

    def loss_fn(p, batch, generator):
        seen.update(p)
        return torch.func.functional_call(model, p, (batch["text"], batch["codes"]), {"return_loss": True})

    init_fn, step_fn = tts.make_train_step(loss_fn, functools.partial(torch.optim.Adam, lr=1e-2),
                                           tts.StepSettings(compute_dtype=torch.bfloat16))
    state = init_fn(dict(model.named_parameters()))
    w0 = state.params["logits_linear.weight"].detach().clone()
    batch = {"text": torch.randint(1, 30, (2, 7), generator=torch.Generator().manual_seed(0)),
             "codes": torch.randint(0, 16, (2, 9), generator=torch.Generator().manual_seed(1))}
    state, metrics = step_fn(state, batch)
    assert torch.isfinite(metrics["loss"]) and seen["logits_linear.weight"].dtype == torch.bfloat16
    assert set(seen) == set(state.params)
    moved = (state.params["logits_linear.weight"] - w0).abs().sum(dim=1) > 0
    ntp = model.cfg.num_text_tokens_padded
    assert moved[:ntp].any() and moved[ntp:].all()


@pytest.mark.parametrize("cond_scale,prime_len", [(1.0, 0), (3.0, 130)], ids=["plain", "primed"])
def test_sampled_codes_equal_under_shared_noise(flagship, cond_scale, prime_len):
    """Codes array_equal to the JAX sampler's; the primed prefill (n 138)
    compacts, so it runs the VFA pair's plain versions."""
    params, jcfg, model = flagship
    rng = np.random.default_rng(6)
    text = rng.integers(1, MODEL["num_text_tokens"], (2, MODEL["text_seq_len"])).astype(np.int32)
    text[1, 4:] = 0
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
    if prime_len:
        assert tfa.pattern_tables(model.transformer.patterns[("axial_row", 0)][:138, :138], 138, 32).compact


def test_jax_tied_checkpoint_loads_in_the_port(flagship, tmp_path):
    """A tied v3 checkpoint written by the JAX package's save_checkpoint
    loads through `weights.load_dalle_checkpoint`: logits to 1e-4."""
    from dalle_pytorch_tpu.models import vae as jvae
    from dalle_pytorch_tpu.training.checkpoint import save_checkpoint

    params, jcfg, _ = flagship
    vcfg = jvae.DiscreteVAEConfig(**VAE)
    vparams = jax.device_get(jvae.init_discrete_vae(jax.random.PRNGKey(1), vcfg))
    path = str(tmp_path / "tied.npz")
    meta = {"hparams": jcfg.to_dict(), "vae_params": vcfg.to_dict(), "vae_class_name": "DiscreteVAE"}
    save_checkpoint(path, {"weights": params, "vae_weights": vparams}, meta)
    model, _ = weights.load_dalle_checkpoint(path, device="cpu")
    assert model.cfg.share_input_output_emb and model.cfg.attn_vfa
    text = np.random.default_rng(3).integers(0, MODEL["num_text_tokens"], (2, MODEL["text_seq_len"]))
    with torch.no_grad():
        port = tdalle.forward(model, torch.from_numpy(text)).numpy()
    np.testing.assert_allclose(port, np.asarray(jdalle.forward(params, jcfg, jnp.asarray(text))), atol=ATOL, rtol=0)


def test_cli_trains_a_tied_model_that_jax_reads(tmp_path):
    """`--dummy_run 2 --device cpu --share_input_output_emb` trains, and its
    checkpoint has no embedding tables: the JAX package's load_checkpoint
    reads it and its forward gives the port's logits to 1e-5; Adam's
    moments, restored through optax's template, have the tied tree's
    structure."""
    import optax
    from dalle_pytorch_tpu.training.checkpoint import load_checkpoint, unflatten_like

    out = str(tmp_path / "tied")
    assert tcli.main(["--dummy_run", "2", "--device", "cpu", "--telemetry", "off", "--shift_tokens", "--share_input_output_emb",
                      "--dalle_output_file_name", out]) == 0
    trees, meta = load_checkpoint(out + ".pt")
    assert meta["hparams"]["share_input_output_emb"] and "text_emb" not in trees["weights"]
    jcfg = jdalle.DALLEConfig.from_dict(meta["hparams"])
    model, _ = weights.load_dalle_checkpoint(out + ".pt", device="cpu")
    rng = np.random.default_rng(7)
    text = rng.integers(0, jcfg.num_text_tokens, (2, jcfg.text_seq_len))
    codes = rng.integers(0, jcfg.num_image_tokens, (2, jcfg.image_seq_len))
    with torch.no_grad():
        port = tdalle.forward(model, torch.from_numpy(text), torch.from_numpy(codes)).numpy()
    ref = np.asarray(jdalle.forward(trees["weights"], jcfg, jnp.asarray(text), jnp.asarray(codes)))
    np.testing.assert_allclose(port, ref, atol=1e-5, rtol=0)
    opt = unflatten_like(optax.adam(3e-4).init(trees["weights"]), trees["opt_state"])[0]
    assert jax.tree_util.tree_structure(opt.mu) == jax.tree_util.tree_structure(trees["weights"])


def test_facade_takes_the_flagship_keywords():
    from dalle_pytorch_tpu_torch import api

    vae = api.DiscreteVAE(seed=0, device="cpu", image_size=32, num_tokens=16, num_layers=2)
    dalle = api.DALLE(vae=vae, device="cpu", dim=32, depth=4, heads=2, dim_head=16, num_text_tokens=30,
                      text_seq_len=9, attn_types=FLAGSHIP_TYPES, share_input_output_emb=True, attn_vfa=True)
    assert dalle.cfg.share_input_output_emb and dalle.module.transformer.cfg.attn_vfa
    text = torch.randint(1, 30, (2, 9), generator=torch.Generator().manual_seed(0))
    codes = torch.randint(0, 16, (2, 64), generator=torch.Generator().manual_seed(1))
    assert torch.isfinite(dalle(text, codes, return_loss=True))
