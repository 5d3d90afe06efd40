"""The port's CLIP against the JAX package's, on the CPU, and CLIP reranking
in `generate_images`.

Both encoders are non-causal transformers without rotary positions; the
text encoder takes the text mask as the attention's key mask.  Scores and
the contrastive loss agree within 1e-5 relative (f32).  The JAX `CLIPConfig`
has no head width: its heads are 64 wide."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from dalle_pytorch_tpu.models import clip as jclip  # noqa: E402
from dalle_pytorch_tpu_torch import weights  # noqa: E402
from dalle_pytorch_tpu_torch.api import CLIP  # noqa: E402
from dalle_pytorch_tpu_torch.models import clip as tclip  # noqa: E402
from dalle_pytorch_tpu_torch.models import dalle as tdalle  # noqa: E402
from dalle_pytorch_tpu_torch.models import sampling as tsamp  # noqa: E402
from dalle_pytorch_tpu_torch.models import vae as tvae  # noqa: E402

SMALL = dict(dim_text=32, dim_image=32, dim_latent=24, num_text_tokens=60, text_enc_depth=2, text_seq_len=16,
             text_heads=2, visual_enc_depth=2, visual_heads=2, visual_image_size=32, visual_patch_size=8)
RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def clips():
    jcfg = jclip.CLIPConfig(**SMALL)
    params = jax.device_get(jclip.init_clip(jax.random.PRNGKey(0), jcfg))
    params["temperature"] = np.asarray(0.7, np.float32)  # not the trivial exp(1) scale
    return jcfg, params, weights.load_clip(params, tclip.CLIPConfig(**SMALL), device="cpu")


def inputs(b=4, seed=0):
    rng = np.random.default_rng(seed)
    text = rng.integers(1, SMALL["num_text_tokens"] + 8, (b, SMALL["text_seq_len"]))  # some ids past the vocab
    text[1, 9:] = 0
    text[-1, 3:] = 0
    images = rng.random((b, 32, 32, 3), dtype=np.float32)
    return text, text != 0, images


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("return_loss", [False, True])
def test_scores_and_loss_match_jax(clips, masked, return_loss):
    jcfg, params, model = clips
    text, mask, images = inputs()
    ref = np.asarray(jclip.forward(params, jcfg, jnp.asarray(text.astype(np.int32)), jnp.asarray(images),
                                   text_mask=jnp.asarray(mask) if masked else None, return_loss=return_loss))
    port = tclip.forward(model, torch.from_numpy(text), torch.from_numpy(images),
                         text_mask=torch.from_numpy(mask) if masked else None, return_loss=return_loss)
    np.testing.assert_allclose(port.numpy(), ref, rtol=RTOL, atol=0)
    assert port.shape == (() if return_loss else (4,))


def test_the_mask_changes_the_text_latent(clips):
    """The masked mean and the key mask reach the text latent: masking the
    pad positions moves it, and the masked latent ignores what the pads
    hold."""
    _, _, model = clips
    text, mask, _ = inputs()
    t, m = torch.from_numpy(text), torch.from_numpy(mask)
    masked = tclip.encode_text(model, t, m)
    assert not torch.allclose(masked[1], tclip.encode_text(model, t)[1])
    other = t.clone()
    other[~m] = 7
    torch.testing.assert_close(tclip.encode_text(model, other, m), masked, rtol=1e-6, atol=1e-6)


def test_encoders_match_jax(clips):
    jcfg, params, model = clips
    text, mask, images = inputs(seed=1)
    np.testing.assert_allclose(
        tclip.encode_image(model, torch.from_numpy(images)).numpy(),
        np.asarray(jclip.encode_image(params, jcfg, jnp.asarray(images))), rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(
        tclip.encode_text(model, torch.from_numpy(text), torch.from_numpy(mask)).numpy(),
        np.asarray(jclip.encode_text(params, jcfg, jnp.asarray(text.astype(np.int32)), jnp.asarray(mask))),
        rtol=RTOL, atol=1e-6)
    np.testing.assert_array_equal(tclip._patchify(model.cfg, torch.from_numpy(images)).numpy(),
                                  np.asarray(jclip._patchify(jcfg, jnp.asarray(images))))


def test_weight_bridge_round_trips_exactly(clips):
    jcfg, params, model = clips
    sd = weights.clip_state_dict(params, model.cfg)
    assert set(sd) == set(model.state_dict())
    for name, value in model.state_dict().items():
        assert torch.equal(value, sd[name]), name
    back = weights.clip_tree(model.state_dict(), model.cfg)
    ref_leaves, ref_def = jax.tree_util.tree_flatten(params)
    leaves, treedef = jax.tree_util.tree_flatten(jax.tree_util.tree_map(lambda t: t.numpy(), back))
    assert treedef == ref_def
    for got, want in zip(leaves, ref_leaves):
        assert got.dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(got, np.asarray(want))


def test_seeded_init_has_the_jax_layout(clips):
    jcfg, params, _ = clips
    model = tclip.init_clip(tclip.CLIPConfig(**SMALL), torch.Generator().manual_seed(0), "cpu")
    tree = weights.clip_tree(model.state_dict(), model.cfg)
    shapes = jax.tree_util.tree_map(lambda t: tuple(t.shape), tree)
    assert shapes == jax.tree_util.tree_map(lambda a: tuple(np.shape(a)), params)
    assert float(model.temperature) == 1.0 and not model.training
    facade = CLIP(params=params, device="cpu", **SMALL)
    text, mask, images = inputs()
    t, m, im = torch.from_numpy(text), torch.from_numpy(mask), torch.from_numpy(images)
    assert torch.equal(facade(t, im, text_mask=m), tclip.forward(clips[2], t, im, m))


def test_generate_images_reranks_with_clip(clips):
    """`generate_images(clip=...)` returns the images and CLIP's score of each
    against its text, as JAX's `_finish_generate` does; the scores are the
    JAX CLIP's on the same images."""
    jcfg, params, model = clips
    dcfg = dict(dim=32, depth=1, heads=2, dim_head=16, num_text_tokens=60, text_seq_len=16, num_image_tokens=32,
                image_fmap_size=4)
    vcfg = dict(image_size=32, num_tokens=32, codebook_dim=16, num_layers=3, hidden_dim=8)
    dalle = tdalle.init_dalle(tdalle.DALLEConfig(**dcfg), torch.Generator().manual_seed(1), "cpu")
    vae = tvae.init_discrete_vae(tvae.DiscreteVAEConfig(**vcfg), torch.Generator().manual_seed(2), "cpu")
    text, _, _ = inputs(b=2, seed=3)
    t = torch.from_numpy(text)
    images, scores = tsamp.generate_images(dalle, vae, t, torch.Generator().manual_seed(4), clip=model)
    assert images.shape == (2, 32, 32, 3) and scores.shape == (2,)
    assert torch.equal(scores, tclip.forward(model, t, images))
    ref = jclip.forward(params, jcfg, jnp.asarray(text.astype(np.int32)), jnp.asarray(images.numpy()))
    np.testing.assert_allclose(scores.numpy(), np.asarray(ref), rtol=RTOL, atol=0)
    alone = tsamp.generate_images(dalle, vae, t, torch.Generator().manual_seed(4))
    assert torch.equal(alone, images)
