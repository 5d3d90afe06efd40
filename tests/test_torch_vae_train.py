"""The port's DiscreteVAE training (`models/vae.forward`, the VAE CLI's
step) against the JAX package's, on the CPU.

- The forward, its loss and every parameter's gradient equal JAX's
  `forward` (`jax.value_and_grad`) with the same weights (`weights.load_vae`)
  and the same gumbel draw: the uniform array `jax.random.uniform(key,
  logits.shape, float32, 1e-20, 1.0)` that JAX's `forward` draws from its
  key, passed to the port as `uniform`.  Plain, straight-through, ReinMax,
  smooth-L1, KL weight 1.0, resnet blocks and 4 channels; the temperature
  a 0-d tensor.  Loss within 1e-5 relative, each gradient leaf within 1e-5
  of its largest value, the reconstruction within 1e-5.
- `codebook_health_from_logits` equals JAX's.
- Three steps of the VAE CLI's step (`cli/train_vae.make_vae_step`) with a
  decaying lr and temperature equal the JAX CLI's `train_step`, built here
  from optax's `chain(scale_by_adam(), scale(-1))` times the lr.
- The facade's `__call__` and `channels`; a forward without a generator or
  a draw is refused; the port's own draw stays finite."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
optax = pytest.importorskip("optax")
import jax.numpy as jnp  # noqa: E402

from dalle_pytorch_tpu.models import vae as jvae  # noqa: E402
from dalle_pytorch_tpu_torch import weights  # noqa: E402
from dalle_pytorch_tpu_torch.api import DiscreteVAE  # noqa: E402
from dalle_pytorch_tpu_torch.cli import train_vae as tcli  # noqa: E402
from dalle_pytorch_tpu_torch.models import vae as tvae  # noqa: E402

BASE = dict(image_size=16, num_tokens=32, codebook_dim=16, num_layers=2, hidden_dim=8)
CASES = {
    "plain": {},
    "straight_through": dict(straight_through=True),
    "reinmax": dict(straight_through=True, reinmax=True),
    "smooth_l1": dict(smooth_l1_loss=True),
    "kl": dict(kl_div_loss_weight=1.0),
    "resnet": dict(num_resnet_blocks=2),
    "channels4": dict(channels=4),
}
REL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _models(kw, seed=0):
    jcfg = jvae.DiscreteVAEConfig(**kw)
    params = jax.device_get(jvae.init_discrete_vae(jax.random.PRNGKey(seed), jcfg))
    vae = weights.load_vae(params, tvae.DiscreteVAEConfig(**kw), device="cpu")
    return jcfg, params, vae.train().requires_grad_(True)


def _images(b, channels, seed=1):
    return np.random.default_rng(seed).random((b, 16, 16, channels)).astype(np.float32)


def _draw(key, jcfg, b):
    """The uniform array JAX's `forward` draws from `key`."""
    shape = (b, jcfg.fmap_size, jcfg.fmap_size, jcfg.num_tokens)
    return np.array(jax.random.uniform(key, shape, jnp.float32, 1e-20, 1.0))


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _grads(vae):
    return _leaves(weights.vae_tree({n: p.grad for n, p in vae.named_parameters()}, vae.cfg))


@pytest.mark.parametrize("case", list(CASES))
def test_forward_loss_and_gradients_match_jax(case):
    kw = dict(BASE, **CASES[case])
    jcfg, params, vae = _models(kw)
    x = _images(3, jcfg.channels)
    key = jax.random.PRNGKey(5)
    temp = 0.7

    def jloss(p):
        return jvae.forward(p, jcfg, jnp.asarray(x), key=key, return_loss=True, return_recons=True,
                            temp=jnp.asarray(temp))

    (ref_loss, ref_out), ref_grads = jax.value_and_grad(jloss, has_aux=True)(params)
    loss, out = tvae.forward(vae, torch.from_numpy(x), uniform=torch.from_numpy(_draw(key, jcfg, 3)),
                             return_loss=True, return_recons=True, temp=torch.tensor(temp))
    loss.backward()
    assert abs(loss.item() - float(ref_loss)) <= REL * abs(float(ref_loss))
    assert out.shape == (3, 16, 16, jcfg.channels)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out), atol=1e-5, rtol=0)
    port, ref = _grads(vae), _leaves(ref_grads)
    blocks = kw.get("num_resnet_blocks", 0)  # 2 stacks x 3 convs of w, b; dec_in's w, b with any block
    assert len(port) == len(ref) == 13 + 12 * blocks + 2 * (blocks > 0)
    for i, (p, r) in enumerate(zip(port, ref)):
        assert p.shape == r.shape
        assert np.abs(p - r).max() <= REL * np.abs(r).max(), (case, i)


def test_reconstruction_without_loss_matches_jax():
    """`forward` without `return_loss` gives the reconstruction alone, at
    the config's own temperature."""
    jcfg, params, vae = _models(dict(BASE, straight_through=True))
    x = _images(2, 3, seed=3)
    key = jax.random.PRNGKey(9)
    ref = jvae.forward(params, jcfg, jnp.asarray(x), key=key)
    with torch.no_grad():
        out = tvae.forward(vae, torch.from_numpy(x), uniform=torch.from_numpy(_draw(key, jcfg, 2)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_codebook_health_matches_jax():
    logits = np.random.default_rng(4).standard_normal((3, 4, 4, 32)).astype(np.float32) * 3
    logits[0, 0, 0, 5] = 40.0  # one cell sure of its code
    ref = jax.device_get(jvae.codebook_health_from_logits(jnp.asarray(logits), 32))
    port = tvae.codebook_health_from_logits(torch.from_numpy(logits), 32)
    assert sorted(port) == sorted(ref)
    np.testing.assert_array_equal(port["code_hist"].numpy(), np.asarray(ref["code_hist"]))
    for name in ("codebook_usage", "codebook_perplexity", "codebook_entropy"):
        assert abs(port[name].item() - float(ref[name])) <= 1e-5 * abs(float(ref[name])), name


def test_train_steps_match_the_optax_chain():
    """The JAX CLI's `train_step` (value_and_grad, then
    `chain(scale_by_adam(), scale(-1))`, then updates * lr) against the
    port's step over three steps whose lr and temperature change in place
    between steps, as the CLI's decay and annealing change them.  Loss each
    step within 1e-5 relative; the parameters within 2e-6 absolute (Adam
    moves each element by about the lr, 1e-2 here, and f32 values near 2 lie
    2.4e-7 apart)."""
    kw = dict(BASE, num_resnet_blocks=1, kl_div_loss_weight=0.5, straight_through=True)
    jcfg, params, vae = _models(kw, seed=2)
    opt = optax.chain(optax.scale_by_adam(), optax.scale(-1.0))

    @jax.jit
    def jstep(p, opt_state, images, key, temp, lr):
        loss, grads = jax.value_and_grad(
            lambda q: jvae.forward(q, jcfg, images, key=key, return_loss=True, temp=temp))(p)
        updates, opt_state = opt.update(grads, opt_state)
        updates = jax.tree_util.tree_map(lambda u: u * lr, updates)
        return optax.apply_updates(p, updates), opt_state, loss

    lr, temp = 1e-2, 1.0
    lr_t, temp_t = torch.tensor(lr), torch.tensor(temp)
    init_fn, step_fn = tcli.make_vae_step(vae, lr_t)
    state = init_fn(dict(vae.named_parameters()))
    jparams, jopt = jax.tree_util.tree_map(jnp.asarray, params), opt.init(params)
    key = jax.random.PRNGKey(11)
    for i in range(3):
        x = _images(4, 3, seed=20 + i)
        key, sk = jax.random.split(key)
        jparams, jopt, ref_loss = jstep(jparams, jopt, jnp.asarray(x), sk, jnp.asarray(temp), jnp.asarray(lr))
        state, metrics = step_fn(state, {"images": torch.from_numpy(x), "temp": temp_t,
                                         "uniform": torch.from_numpy(_draw(sk, jcfg, 4))})
        assert abs(float(metrics["loss"]) - float(ref_loss)) <= REL * abs(float(ref_loss)), i
        lr *= 0.5
        temp = max(temp * 0.8, 0.5)
        lr_t.fill_(lr)
        temp_t.fill_(temp)
    assert state.opt_state.count == 3
    port = _leaves(weights.vae_tree(vae.state_dict(), vae.cfg))
    for i, (p, r) in enumerate(zip(port, _leaves(jparams))):
        np.testing.assert_allclose(p, r, atol=2e-6, rtol=0, err_msg=str(i))


def test_facade_call_and_channels():
    """`DiscreteVAE(...)(images, generator, return_loss=True)` is the
    module's `forward` with a generator of that seed; `channels` reads the
    config."""
    facade = DiscreteVAE(seed=3, device="cpu", **dict(BASE, channels=4))
    assert facade.channels == 4
    x = torch.from_numpy(_images(2, 4))
    loss = facade(x, generator=7, return_loss=True)
    again = tvae.forward(facade.module, x, torch.Generator().manual_seed(7), return_loss=True)
    assert torch.equal(loss, again)
    recons = facade.forward(x, generator=torch.Generator().manual_seed(7))
    assert recons.shape == (2, 16, 16, 4) and bool(torch.isfinite(recons).all())


def test_forward_needs_a_generator_or_a_draw():
    _, _, vae = _models(BASE)
    with pytest.raises(ValueError, match="generator"):
        tvae.forward(vae, torch.from_numpy(_images(1, 3)), return_loss=True)
    with pytest.raises(ValueError, match="image size"):
        tvae.forward(vae, torch.zeros(1, 8, 8, 3), torch.Generator())


def test_gumbel_draw_stays_finite_at_the_ends_of_its_range():
    """The port's draw lifts torch's zeros to 1e-20, JAX's lower bound, so
    the noise's double log is finite at both ends."""
    u = tvae.gumbel_uniform((4096,), torch.Generator().manual_seed(0))
    assert float(u.min()) >= 1e-20 and float(u.max()) < 1.0
    ends = torch.tensor([0.0, 1e-20, 1.0 - 2 ** -24]).clamp_min(1e-20)
    logits = torch.zeros(3, 1)
    assert bool(torch.isfinite(tvae.gumbel_softmax(logits, 1.0, False, ends[:, None])).all())
