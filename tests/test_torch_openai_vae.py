"""The port's OpenAI dVAE (`models/openai_vae.py`) against the JAX package's
and against the torch statement of the published `dall_e` encoder and
decoder (`tests/torch_vae_refs.py`), on the CPU at the fixed geometry (256
px, 8,192 tokens, fmap 32), batch 1: the converter's tree equal to JAX
`convert_openai_state_dicts`'s, codes `array_equal`, pixels within 1e-5, and
the decoder's gathered input against the JAX one-hot form."""
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from dalle_pytorch_tpu.models import openai_vae as jovae  # noqa: E402
from dalle_pytorch_tpu.models import vae_registry as jregistry  # noqa: E402
from dalle_pytorch_tpu_torch import weights  # noqa: E402
from dalle_pytorch_tpu_torch.models import openai_vae as tovae  # noqa: E402
from dalle_pytorch_tpu_torch.models import vae_registry as tregistry  # noqa: E402
from torch_vae_refs import DalleDecoderRef, DalleEncoderRef  # noqa: E402

PIXELS = 1e-5


def _leaves_equal(port, ref):
    if isinstance(ref, dict):
        assert set(port) == set(ref)
        for k in ref:
            _leaves_equal(port[k], ref[k])
    elif isinstance(ref, (list, tuple)):
        assert len(port) == len(ref)
        for p, r in zip(port, ref):
            _leaves_equal(p, r)
    else:
        np.testing.assert_array_equal(np.asarray(port), np.asarray(ref))


@pytest.fixture(scope="module")
def refs():
    """The published modules' torch statement, seeded, their state dicts
    through both converters, the port's module and the JAX tree."""
    torch.manual_seed(0)
    enc, dec = DalleEncoderRef().eval(), DalleDecoderRef().eval()
    tree = tovae.convert_openai_state_dicts(enc.state_dict(), dec.state_dict())
    params = jovae.convert_openai_state_dicts(enc.state_dict(), dec.state_dict())
    _leaves_equal(tree, params)
    return enc, dec, params, weights.load_vae(tree, tovae.OpenAIVAEConfig(), "cpu")


def test_state_dict_bridge_round_trips(refs):
    _, _, params, vae = refs
    sd = weights.openai_vae_state_dict(params)
    assert set(sd) == set(vae.state_dict())
    _leaves_equal(weights.openai_vae_tree(vae.state_dict()), params)
    want = jax.tree_util.tree_structure(jovae.init_random_like(jax.random.PRNGKey(0)))
    seeded = tovae.init_random(torch.Generator().manual_seed(0), "cpu")
    assert jax.tree_util.tree_structure(weights.vae_tree(seeded.state_dict(), seeded.cfg)) == want


def test_codebook_indices_match(refs):
    enc, _, params, vae = refs
    img = np.random.default_rng(1).random((1, 256, 256, 3)).astype(np.float32)
    port = tregistry.get_codebook_indices(vae, torch.from_numpy(img))
    with torch.no_grad():
        logits = enc(tovae.map_pixels(torch.from_numpy(img)).permute(0, 3, 1, 2))
    top2 = logits.topk(2, dim=1).values
    margin = float((top2[:, 0] - top2[:, 1]).min())  # the nearest tie a reordered sum could flip
    assert margin > 0
    np.testing.assert_array_equal(port.numpy(), logits.argmax(dim=1).reshape(1, -1).numpy())
    ref = jregistry.get_codebook_indices(params, jovae.OpenAIVAEConfig(), jnp.asarray(img))
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
    assert port.shape == (1, 1024) and len(np.unique(port.numpy())) > 3


def test_decode_indices_match(refs):
    _, dec, params, vae = refs
    codes = torch.from_numpy(np.random.default_rng(2).integers(0, 8192, (1, 1024)))
    gathered, one_hot = tovae.gathered_input(vae, codes), tovae.one_hot_input(vae, codes)
    np.testing.assert_allclose(gathered.numpy(), one_hot.numpy(), atol=1e-6, rtol=0)
    port = tregistry.decode_indices(vae, codes)
    assert port.shape == (1, 256, 256, 3)
    with torch.no_grad():
        z = torch.nn.functional.one_hot(codes, 8192).float().reshape(1, 32, 32, 8192).permute(0, 3, 1, 2)
        want = tovae.unmap_pixels(torch.sigmoid(dec(z)[:, :3])).permute(0, 2, 3, 1)
    np.testing.assert_allclose(port.numpy(), want.numpy(), atol=PIXELS, rtol=0)
    ref = jregistry.decode_indices(params, jovae.OpenAIVAEConfig(), jnp.asarray(codes.numpy().astype(np.int32)))
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=PIXELS, rtol=0)
    np.testing.assert_array_equal(tregistry.to_display(vae.cfg, port).numpy(), port.numpy())


def test_pixel_maps_and_config_match():
    x = np.linspace(-0.5, 1.5, 41, dtype=np.float32)
    np.testing.assert_allclose(tovae.map_pixels(torch.from_numpy(x)).numpy(),
                               np.asarray(jovae.map_pixels(jnp.asarray(x))), atol=1e-7)
    np.testing.assert_allclose(tovae.unmap_pixels(torch.from_numpy(x)).numpy(),
                               np.asarray(jovae.unmap_pixels(jnp.asarray(x))), atol=1e-7)
    tcfg, jcfg = tovae.OpenAIVAEConfig(), jovae.OpenAIVAEConfig()
    for attr in ("image_size", "num_layers", "num_tokens", "channels", "fmap_size", "image_seq_len"):
        assert getattr(tcfg, attr) == getattr(jcfg, attr)
    name, meta = tregistry.config_to_meta(tcfg)
    assert (name, meta) == jregistry.config_to_meta(jcfg)
    assert tregistry.config_from_meta(name, json.loads(json.dumps(meta))) == tcfg
