"""The port's text completion (`generate_texts`) against the JAX package's,
on the CPU.

torch cannot reproduce JAX's threefry streams, so the port is fed the gumbel
noise that JAX's own key chain gives: one `jax.random.split` per generated
token, `ops.sampling.gumbel_noise` of each subkey.  Under it the ids must be
equal, not close, on the cached (prefill + decode steps) and the uncached
(a whole-window forward per token) path."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from dalle_pytorch_tpu.data.tokenizer import SimpleTokenizer as JaxTokenizer  # noqa: E402
from dalle_pytorch_tpu.models import dalle as jdalle  # noqa: E402
from dalle_pytorch_tpu.models import sampling as jsamp  # noqa: E402
from dalle_pytorch_tpu.ops.sampling import gumbel_noise  # noqa: E402
from dalle_pytorch_tpu_torch import weights  # noqa: E402
from dalle_pytorch_tpu_torch.api import DALLE, DiscreteVAE  # noqa: E402
from dalle_pytorch_tpu_torch.data.tokenizer import SimpleTokenizer  # noqa: E402
from dalle_pytorch_tpu_torch.models import dalle as tdalle  # noqa: E402
from dalle_pytorch_tpu_torch.models import sampling as tsamp  # noqa: E402

# a text vocab (50 + 15 pad ids) much smaller than the image vocab: at
# filter_thres 0.5 top-k keeps 160 of 321 logits, so the kept set takes
# masked (finfo.min) image logits, where torch.topk and lax.top_k keep
# different tied entries
SMALL = dict(dim=64, depth=2, heads=2, dim_head=32, num_text_tokens=50, text_seq_len=15,
             num_image_tokens=256, image_fmap_size=4, shift_tokens=True, rotary_emb=True)
TIED = dict(SMALL, share_input_output_emb=True)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=[SMALL, TIED], ids=["untied", "tied"])
def models(request):
    jcfg = jdalle.DALLEConfig(**request.param)
    params = jax.device_get(jdalle.init_dalle(jax.random.PRNGKey(0), jcfg))
    return jcfg, params, weights.load_dalle(params, tdalle.DALLEConfig(**request.param), device="cpu")


def jax_noise(key, n_gen, b, total_tokens):
    """The gumbel noise of JAX `generate_texts`' key chain, per token."""
    rows = []
    for _ in range(n_gen):
        key, sk = jax.random.split(key)
        rows.append(np.asarray(gumbel_noise(sk, (b, total_tokens), jnp.float32)))
    return np.stack(rows)


@pytest.mark.parametrize("n0,filter_thres,temperature", [(1, 0.5, 1.0), (4, 0.5, 1.0), (6, 0.9, 0.7), (14, 0.5, 1.0)])
def test_ids_equal_jax_under_its_key_chain(models, n0, filter_thres, temperature):
    jcfg, params, model = models
    prompt = np.random.default_rng(n0).integers(1, SMALL["num_text_tokens"], (2, n0)).astype(np.int32)
    key = jax.random.PRNGKey(7 + n0)
    noise = torch.from_numpy(jax_noise(key, jcfg.text_seq_len - n0, 2, jcfg.total_tokens))
    for use_cache in (True, False):
        ref = np.asarray(jsamp.generate_texts(params, jcfg, key, text=jnp.asarray(prompt), filter_thres=filter_thres,
                                              temperature=temperature, use_cache=use_cache))
        port = tsamp.generate_texts(model, torch.from_numpy(prompt), filter_thres=filter_thres,
                                    temperature=temperature, use_cache=use_cache, noise_override=noise)
        np.testing.assert_array_equal(port.numpy(), ref)
    assert port.shape == (2, jcfg.text_seq_len)
    np.testing.assert_array_equal(port[:, :n0].numpy(), prompt)
    assert (port < jcfg.num_text_tokens_padded).all()


def test_default_prompt_and_a_full_prompt(models):
    jcfg, params, model = models
    key = jax.random.PRNGKey(3)
    noise = torch.from_numpy(jax_noise(key, jcfg.text_seq_len - 1, 1, jcfg.total_tokens))
    ref = np.asarray(jsamp.generate_texts(params, jcfg, key))
    np.testing.assert_array_equal(tsamp.generate_texts(model, noise_override=noise).numpy(), ref)
    full = torch.randint(1, 50, (2, jcfg.text_seq_len + 3))
    assert torch.equal(tsamp.generate_texts(model, full), full[:, : jcfg.text_seq_len])


def test_cached_and_uncached_draw_the_same_noise(models):
    """Without an override both paths draw one noise row per token from the
    generator, in the same order, so one seed gives the same ids."""
    _, _, model = models
    prompt = torch.randint(1, 50, (3, 2), generator=torch.Generator().manual_seed(1))
    ids = [tsamp.generate_texts(model, prompt, torch.Generator().manual_seed(5), use_cache=use_cache)
           for use_cache in (True, False)]
    assert torch.equal(ids[0], ids[1])
    assert len(torch.unique(ids[0][:, 2:])) > 3  # the noise really drives the samples


def test_facade_decodes_with_the_pad_ids_dropped():
    """`DALLE.generate_texts` takes a string prompt through the tokenizer and
    decodes each completion without the per-position pad ids, as JAX does."""
    vae = DiscreteVAE(image_size=16, num_tokens=32, codebook_dim=16, num_layers=2, hidden_dim=8, device="cpu")
    dalle = DALLE(vae=vae, dim=32, depth=1, heads=2, dim_head=16, num_text_tokens=49408, text_seq_len=12,
                  device="cpu")
    tok = SimpleTokenizer()
    ids, texts = dalle.generate_texts(tok, "a photo of", generator=3)
    assert ids.shape == (1, 12)
    assert ids[0, :3].tolist() == tok.encode("a photo of")
    cfg = dalle.cfg
    pads = set(range(cfg.num_text_tokens_padded - cfg.text_seq_len, cfg.num_text_tokens_padded))
    assert texts == [JaxTokenizer(use_native=False).decode(ids[0].numpy(), pad_tokens=pads)]
    assert texts[0].startswith("a photo of ")
    same, _ = dalle.generate_texts(None, ids[:, :3], generator=3)
    assert torch.equal(same, ids)
