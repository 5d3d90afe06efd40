"""The slice as a whole on the CPU, for each VAE family (a small DiscreteVAE,
a small taming VQGAN here; OpenAI's dVAE at its fixed geometry in
`tests/test_torch_openai_slice.py`, which takes as long): a small DALL-E
on the family's codes takes one train step through the train CLI's loss
(pixels through the frozen VAE, `cli/train_dalle.dalle_loss_fn`) and the
JAX package's, loss within 1e-5 relative and parameters within 2e-6; then,
from the stepped weights, an image primed from pixels is completed under
injected gumbel noise: codes `array_equal` to the JAX package's, pixels
within 1e-4."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
optax = pytest.importorskip("optax")
import jax.numpy as jnp  # noqa: E402

from dalle_pytorch_tpu.models import dalle as jdalle  # noqa: E402
from dalle_pytorch_tpu.models import openai_vae as jovae  # noqa: E402
from dalle_pytorch_tpu.models import sampling as jsamp  # noqa: E402
from dalle_pytorch_tpu.models import vae as jvae  # noqa: E402
from dalle_pytorch_tpu.models import vae_registry as jregistry  # noqa: E402
from dalle_pytorch_tpu.models import vqgan as jvqgan  # noqa: E402
from dalle_pytorch_tpu.parallel import train_step as jts  # noqa: E402
from dalle_pytorch_tpu_torch import weights  # noqa: E402
from dalle_pytorch_tpu_torch.cli import train_dalle as tcli  # noqa: E402
from dalle_pytorch_tpu_torch.models import dalle as tdalle  # noqa: E402
from dalle_pytorch_tpu_torch.models import sampling as tsamp  # noqa: E402
from dalle_pytorch_tpu_torch.models import vae_registry as tregistry  # noqa: E402
from dalle_pytorch_tpu_torch.optim.grouped import Adam  # noqa: E402
from dalle_pytorch_tpu_torch.parallel import train_step as tts  # noqa: E402
from taming_fixture import make_taming_state_dict  # noqa: E402

MODEL = dict(dim=32, depth=2, heads=2, dim_head=16, num_text_tokens=30, text_seq_len=7, shift_tokens=True,
             attn_types=("full", "axial_row"))
TAMING = dict(ch=8, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,), resolution=16, z_channels=8,
              n_embed=32, embed_dim=8)
LEFT = 3  # codes sampled after the primer


def _jax_vae(family):
    if family == "discrete":
        cfg = jvae.DiscreteVAEConfig(image_size=16, num_tokens=32, codebook_dim=16, num_layers=2, hidden_dim=8)
        return cfg, jax.device_get(jvae.init_discrete_vae(jax.random.PRNGKey(1), cfg))
    if family == "vqgan":
        cfg = jvqgan.VQGANConfig(**TAMING)
        return cfg, jvqgan.convert_taming_state_dict(make_taming_state_dict(cfg, np.random.RandomState(2)), cfg)
    return jovae.OpenAIVAEConfig(), jovae.init_random_like(jax.random.PRNGKey(3))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("family", ["discrete", "vqgan"])
def test_one_step_then_primed_codes_equal_jax(family):
    one_step_then_primed_codes(family)


def one_step_then_primed_codes(family):
    """The body of the test, for `tests/test_torch_openai_slice.py` too."""
    jvcfg, vparams = _jax_vae(family)
    tvcfg = tregistry.config_from_meta(*jregistry.config_to_meta(jvcfg))
    vae = weights.load_vae(vparams, tvcfg, "cpu")
    jcfg = jdalle.DALLEConfig.from_vae(jvcfg, **MODEL)
    tcfg = tdalle.DALLEConfig.from_vae(tvcfg, **MODEL)
    params = jax.device_get(jdalle.init_dalle(jax.random.PRNGKey(4), jcfg))
    batch = 1 if family == "openai" else 2
    rng = np.random.default_rng(5)
    text = rng.integers(1, 30, (batch, 7)).astype(np.int32)
    image = rng.random((batch, jvcfg.image_size, jvcfg.image_size, 3)).astype(np.float32)

    def loss_fn(p, b, key):
        codes = jregistry.get_codebook_indices(vparams, jvcfg, b["image"])
        return jdalle.forward(p, jcfg, b["text"], jax.lax.stop_gradient(codes), return_loss=True, key=key)

    init_fn, step_fn = jts.make_train_step(loss_fn, optax.adam(3e-4), mesh=None,
                                           settings=jts.StepSettings(clip_grad_norm=0.5))
    jstate, jm = step_fn(init_fn(jax.tree_util.tree_map(jnp.asarray, params)),
                         {"text": jnp.asarray(text), "image": jnp.asarray(image)}, jax.random.PRNGKey(0))
    stepped = jax.device_get(jstate.params)

    model = weights.load_dalle(params, tcfg, "cpu").requires_grad_(True)
    tinit, tstep = tts.make_train_step(tcli.dalle_loss_fn(model, vae, torch.float32), Adam(3e-4),
                                       tts.StepSettings(clip_grad_norm=0.5))
    _, m = tstep(tinit(dict(model.named_parameters())),
                 {"text": torch.from_numpy(text).long(), "image": torch.from_numpy(image)})
    assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-5 * abs(float(jm["loss"]))
    port_tree = weights.dalle_tree(model.state_dict(), tcfg)
    for got, want in zip(jax.tree_util.tree_leaves(port_tree), jax.tree_util.tree_leaves(stepped)):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=2e-6, rtol=0)

    model.requires_grad_(False)
    prime_len = jcfg.image_seq_len - LEFT
    noise = np.random.default_rng(6).gumbel(size=(LEFT, batch, jcfg.total_tokens)).astype(np.float32)
    primer = jregistry.get_codebook_indices(vparams, jvcfg, jnp.asarray(image))[:, :prime_len]
    want_codes = jsamp.sample_image_codes(stepped, jcfg, jnp.asarray(text), jax.random.PRNGKey(0), cond_scale=3.0,
                                          primer_codes=primer, prime_len=prime_len, noise_override=jnp.asarray(noise))
    port_primer = tregistry.get_codebook_indices(vae, torch.from_numpy(image))[:, :prime_len]
    np.testing.assert_array_equal(port_primer.numpy(), np.asarray(primer))
    codes = tsamp.sample_image_codes(model, torch.from_numpy(text).long(), cond_scale=3.0, primer_codes=port_primer,
                                     prime_len=prime_len, noise_override=torch.from_numpy(noise))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want_codes))
    images = tsamp.generate_images(model, vae, torch.from_numpy(text).long(), cond_scale=3.0,
                                   img=torch.from_numpy(image), num_init_img_tokens=prime_len,
                                   noise_override=torch.from_numpy(noise))
    want = jregistry.to_display(jvcfg, jregistry.decode_indices(vparams, jvcfg, want_codes))
    np.testing.assert_allclose(tregistry.to_display(tvcfg, images).numpy(), np.asarray(want), atol=1e-4, rtol=0)
