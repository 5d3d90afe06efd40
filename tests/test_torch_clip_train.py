"""The port's CLIP training (`models/clip.forward(..., return_loss=True)`
through the flash kernels' autograd path, the CLIP CLI's loss and step)
against the JAX package's, on the CPU.

- The contrastive loss and every parameter's gradient, with and without
  the text key mask, equal `jax.value_and_grad` of JAX's `forward` on the
  same weights: the loss within 1e-5 relative, each gradient leaf within
  1e-5 of its largest value.  The port's attention runs `FlashAttention`
  (here its plain versions), non-causal, the mask as its key mask; JAX's
  runs XLA attention at these lengths.  The functions are equal.
- Two steps of `make_train_step` with the CLI's loss (`cli/train_clip.
  clip_loss_fn`: key mask text != 0), optax's Adam 1e-3 and global-norm
  clipping at 0.5 equal the JAX `make_train_step` with `optax.adam`: loss
  and grad norm within 1e-5 relative, the parameters within 1 % of one
  Adam step (the lr): an element whose gradient g lies near Adam's eps
  moves by lr * g / (|g| + eps), so a gradient error of 1e-11 there moves
  it by 1e-6 of the lr's 1e-3, while one step the wrong way is 2e-3."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
optax = pytest.importorskip("optax")
import jax.numpy as jnp  # noqa: E402

from dalle_pytorch_tpu.models import clip as jclip  # noqa: E402
from dalle_pytorch_tpu.parallel import train_step as jts  # noqa: E402
from dalle_pytorch_tpu_torch import weights  # noqa: E402
from dalle_pytorch_tpu_torch.cli import train_clip as tcli  # noqa: E402
from dalle_pytorch_tpu_torch.models import clip as tclip  # noqa: E402
from dalle_pytorch_tpu_torch.optim.grouped import Adam  # noqa: E402
from dalle_pytorch_tpu_torch.parallel import train_step as tts  # noqa: E402

SMALL = dict(dim_text=32, dim_image=32, dim_latent=24, num_text_tokens=60, text_enc_depth=2, text_seq_len=16,
             text_heads=2, visual_enc_depth=2, visual_heads=2, visual_image_size=32, visual_patch_size=8)
REL = 1e-5
LR = 1e-3  # the CLI's default


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _models(seed=0):
    jcfg = jclip.CLIPConfig(**SMALL)
    params = jax.device_get(jclip.init_clip(jax.random.PRNGKey(seed), jcfg))
    params["temperature"] = np.asarray(0.7, np.float32)
    model = weights.load_clip(params, tclip.CLIPConfig(**SMALL), device="cpu")
    return jcfg, params, model.train().requires_grad_(True)


def _batch(b=4, seed=0):
    """Captions of several lengths padded with 0 (one of a single token),
    and images."""
    rng = np.random.default_rng(seed)
    text = rng.integers(1, SMALL["num_text_tokens"], (b, SMALL["text_seq_len"]))
    for i, n in enumerate((16, 9, 3, 1)[:b]):
        text[i, n:] = 0
    return text, rng.random((b, 32, 32, 3), dtype=np.float32)


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize("masked", [True, False], ids=["key_mask", "no_mask"])
def test_loss_and_gradients_match_jax(masked):
    jcfg, params, model = _models()
    text, images = _batch()
    mask = text != 0

    def jloss(p):
        return jclip.forward(p, jcfg, jnp.asarray(text.astype(np.int32)), jnp.asarray(images),
                             text_mask=jnp.asarray(mask) if masked else None, return_loss=True)

    ref_loss, ref_grads = jax.value_and_grad(jloss)(params)
    loss = tclip.forward(model, torch.from_numpy(text), torch.from_numpy(images),
                         text_mask=torch.from_numpy(mask) if masked else None, return_loss=True)
    loss.backward()
    assert abs(loss.item() - float(ref_loss)) <= REL * abs(float(ref_loss))
    port = _leaves(weights.clip_tree({n: p.grad for n, p in model.named_parameters()}, model.cfg))
    ref = _leaves(ref_grads)
    assert len(port) == len(ref) == 2 * 15 * 2 + 8  # 15 leaves a layer, 2 + 2 layers; embeddings, heads, temp
    for i, (p, r) in enumerate(zip(port, ref)):
        assert p.shape == r.shape
        assert np.abs(p - r).max() <= REL * np.abs(r).max(), i


def test_the_key_mask_reaches_the_gradient():
    """Under the key mask the pad positions move no gradient: written as an
    id no caption uses, that id's embedding row gets exactly none, while a
    caption token's row gets some."""
    _, _, model = _models()
    text, images = _batch()
    pad = SMALL["num_text_tokens"] - 1
    text[text == pad] = 1
    text[text == 0] = pad
    tclip.forward(model, torch.from_numpy(text), torch.from_numpy(images), text_mask=torch.from_numpy(text != pad),
                  return_loss=True).backward()
    grad = model.text_emb.weight.grad
    assert float(grad[pad].abs().max()) == 0.0
    assert float(grad[int(text[0, 0])].abs().max()) > 0.0


def test_two_clipped_adam_steps_match_jax():
    jcfg, params, model = _models(seed=1)
    batches = [_batch(seed=10 + i) for i in range(2)]

    def jloss(p, batch, key):
        return jclip.forward(p, jcfg, batch["text"], batch["image"], text_mask=batch["text"] != 0,
                             return_loss=True)

    init_fn, step_fn = jts.make_train_step(jloss, optax.adam(LR), mesh=None,
                                           settings=jts.StepSettings(clip_grad_norm=0.5))
    jstate = init_fn(jax.tree_util.tree_map(jnp.asarray, params))
    ref_metrics = []
    for text, images in batches:
        jstate, m = step_fn(jstate, {"text": jnp.asarray(text.astype(np.int32)), "image": jnp.asarray(images)},
                            jax.random.PRNGKey(0))
        ref_metrics.append(jax.device_get(m))

    init, step = tts.make_train_step(tcli.clip_loss_fn(model), Adam(LR), tts.StepSettings(clip_grad_norm=0.5))
    state = init(dict(model.named_parameters()))
    for (text, images), ref in zip(batches, ref_metrics):
        state, m = step(state, {"text": torch.from_numpy(text), "image": torch.from_numpy(images)})
        assert m["skipped"] == int(ref["skipped"]) == 0
        for key in ("loss", "grad_norm"):
            assert abs(float(m[key]) - float(ref[key])) <= REL * abs(float(ref[key])), key
    port = _leaves(weights.clip_tree(model.state_dict(), model.cfg))
    for i, (p, r) in enumerate(zip(port, _leaves(jax.device_get(jstate.params)))):
        np.testing.assert_allclose(p, r, atol=1e-2 * LR, rtol=0, err_msg=str(i))
