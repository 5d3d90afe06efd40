"""The port's taming VQGAN (`models/vqgan.py`) against the JAX package's and
against the torch statement of taming's VQModel / GumbelVQ
(`tests/torch_vae_refs.py`), on the CPU at a small config: the converter's
tree equal to JAX `convert_taming_state_dict`'s leaf for leaf, the port's
state dict holding every key of it, codes `array_equal`, pixels within
1e-5."""
import dataclasses
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from dalle_pytorch_tpu.models import vae_registry as jregistry  # noqa: E402
from dalle_pytorch_tpu.models import vqgan as jvqgan  # noqa: E402
from dalle_pytorch_tpu_torch import weights  # noqa: E402
from dalle_pytorch_tpu_torch.models import vae_registry as tregistry  # noqa: E402
from dalle_pytorch_tpu_torch.models import vqgan as tvqgan  # noqa: E402
from taming_fixture import make_taming_state_dict  # noqa: E402
from torch_vae_refs import GumbelVQRef, VQModelRef  # noqa: E402

SMALL = dict(ch=8, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,), resolution=16, z_channels=8,
             n_embed=32, embed_dim=8)
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
    elif ref is None:
        assert port is None
    else:
        np.testing.assert_array_equal(np.asarray(port), np.asarray(ref))


def _configs(gumbel):
    kw = dict(SMALL, is_gumbel=gumbel)
    return jvqgan.VQGANConfig(**kw), tvqgan.VQGANConfig(**kw)


@pytest.fixture(scope="module", params=[False, True], ids=["euclidean", "gumbel"])
def fixture_vae(request):
    jcfg, tcfg = _configs(request.param)
    state = make_taming_state_dict(jcfg, np.random.RandomState(3))
    params = jvqgan.convert_taming_state_dict(state, jcfg)
    return state, params, jcfg, tcfg, weights.load_vae(tvqgan.convert_taming_state_dict(state, tcfg), tcfg, "cpu")


def test_converter_matches_jax_and_round_trips(fixture_vae):
    state, params, jcfg, tcfg, vae = fixture_vae
    tree = tvqgan.convert_taming_state_dict(state, tcfg)
    _leaves_equal(tree, params)
    sd = weights.vqgan_state_dict(tree, tcfg)
    assert set(sd) == set(vae.state_dict()) == set(state)  # the port's names are taming's
    for key, value in state.items():
        np.testing.assert_array_equal(sd[key].numpy(), value)
    _leaves_equal(weights.vqgan_tree(vae.state_dict(), tcfg), params)
    assert tvqgan.config_from_taming_dict({"params": {"n_embed": 32, "embed_dim": 8, "ddconfig": {
        k: list(v) if isinstance(v, tuple) else v for k, v in SMALL.items() if k not in ("n_embed", "embed_dim")}}},
        state) == tcfg


def test_codebook_indices_match_jax(fixture_vae):
    _, params, jcfg, _, vae = fixture_vae
    img = np.random.default_rng(1).random((3, 16, 16, 3)).astype(np.float32)
    port = tregistry.get_codebook_indices(vae, torch.from_numpy(img))
    ref = jregistry.get_codebook_indices(params, jcfg, jnp.asarray(img))
    assert port.shape == (3, 64)
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
    assert len(np.unique(port.numpy())) > 3


def test_decode_indices_match_jax(fixture_vae):
    _, params, jcfg, tcfg, vae = fixture_vae
    codes = np.random.default_rng(2).integers(0, 32, (2, 64))
    port = tregistry.decode_indices(vae, torch.from_numpy(codes))
    ref = jregistry.decode_indices(params, jcfg, jnp.asarray(codes.astype(np.int32)))
    assert port.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=PIXELS, rtol=0)
    np.testing.assert_array_equal(tregistry.to_display(tcfg, port).numpy(), port.clamp(0, 1).numpy())


def test_encode_and_decode_z_match_jax(fixture_vae):
    _, params, jcfg, _, vae = fixture_vae
    x = np.random.default_rng(4).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    z = tvqgan.encode(vae, torch.from_numpy(x))
    np.testing.assert_allclose(z.numpy(), np.asarray(jvqgan.encode(params, jcfg, jnp.asarray(x))), atol=1e-5, rtol=0)
    zq = np.random.default_rng(5).standard_normal((2, 8, 8, 8)).astype(np.float32)
    np.testing.assert_allclose(tvqgan.decode_z(vae, torch.from_numpy(zq)).numpy(),
                               np.asarray(jvqgan.decode_z(params, jcfg, jnp.asarray(zq))), atol=1e-5, rtol=0)


@pytest.mark.parametrize("gumbel", [False, True], ids=["vqmodel", "gumbelvq"])
def test_matches_the_taming_reference_with_decoder_attention(gumbel):
    """taming's own layout, its decoder's attention blocks included: the
    reference module's state dict through both converters, then codes and
    pixels against the reference module and the JAX package."""
    jcfg, tcfg = _configs(gumbel)
    torch.manual_seed(6)
    ref = (GumbelVQRef if gumbel else VQModelRef)(jcfg).eval()
    state = ref.state_dict()
    assert any(k.startswith("decoder.up.") and ".attn." in k for k in state)
    tree = tvqgan.convert_taming_state_dict(state, tcfg)
    params = jvqgan.convert_taming_state_dict(state, jcfg)
    _leaves_equal(tree, params)
    vae = weights.load_vae(tree, tcfg, "cpu")
    assert vae.decoder_attn and set(vae.state_dict()) == set(state)

    img = np.random.default_rng(7).random((2, 16, 16, 3)).astype(np.float32)
    x = torch.from_numpy(img)
    with torch.no_grad():
        _, _, (_, _, want) = ref.encode((2 * x - 1).permute(0, 3, 1, 2))
    port = tregistry.get_codebook_indices(vae, x)
    np.testing.assert_array_equal(port.numpy(), want.reshape(2, -1).numpy())
    np.testing.assert_array_equal(port.numpy(), np.asarray(jregistry.get_codebook_indices(params, jcfg,
                                                                                           jnp.asarray(img))))
    codes = torch.from_numpy(np.random.default_rng(8).integers(0, 32, (2, 64)))
    with torch.no_grad():
        zq = ref.quantize.embed(codes) if gumbel else ref.quantize.embedding(codes)
        want = (ref.decode(zq.reshape(2, 8, 8, -1).permute(0, 3, 1, 2)).clamp(-1, 1) + 1) / 2
    got = tregistry.decode_indices(vae, codes)
    np.testing.assert_allclose(got.numpy(), want.permute(0, 2, 3, 1).numpy(), atol=PIXELS, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(jregistry.decode_indices(
        params, jcfg, jnp.asarray(codes.numpy().astype(np.int32)))), atol=PIXELS, rtol=0)


def test_random_init_has_the_jax_layout():
    jcfg, tcfg = _configs(True)
    want = jax.tree_util.tree_structure(jvqgan.init_random_like(jax.random.PRNGKey(0), jcfg))
    vae = tvqgan.init_random_like(tcfg, torch.Generator().manual_seed(0), "cpu")
    got = jax.tree_util.tree_structure(weights.vqgan_tree(vae.state_dict(), tcfg))
    assert got == want
    assert all(not p.requires_grad for p in vae.parameters()) and not vae.training
    with_attn = tvqgan.init_random_like(tcfg, torch.Generator().manual_seed(0), "cpu", decoder_attn=True)
    assert tvqgan.has_decoder_attn(weights.vqgan_tree(with_attn.state_dict(), tcfg))


def test_config_geometry_and_meta_round_trip():
    jcfg, tcfg = _configs(False)
    published = tvqgan.VQGANConfig(n_embed=16384)
    assert (published.num_layers, published.fmap_size, published.num_tokens) == (4, 16, 16384)
    assert (tcfg.num_layers, tcfg.fmap_size, tcfg.image_size, tcfg.channels) == \
        (jcfg.num_layers, jcfg.fmap_size, jcfg.image_size, jcfg.channels)
    name, meta = tregistry.config_to_meta(tcfg)
    assert (name, meta) == jregistry.config_to_meta(jcfg)
    back = tregistry.config_from_meta(name, json.loads(json.dumps(meta)))
    assert back == tcfg and dataclasses.asdict(back) == dataclasses.asdict(jcfg)
    assert jregistry.config_from_meta(name, json.loads(json.dumps(meta))) == jcfg


def test_the_facade_takes_the_vqgan(tmp_path):
    """`api.VQGanVAE` from a taming checkpoint and its config (JAX
    `api.VQGanVAE`'s contract), and `DALLE(vae=...)` on it: codes and
    images at the VQGAN's geometry."""
    import dalle_pytorch_tpu_torch as port

    jcfg, tcfg = _configs(False)
    state = make_taming_state_dict(jcfg, np.random.RandomState(9))
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in state.items()}}, tmp_path / "m.ckpt")
    config = {"params": {"n_embed": 32, "embed_dim": 8, "ddconfig": {
        k: list(v) if isinstance(v, tuple) else v for k, v in SMALL.items() if k not in ("n_embed", "embed_dim")}}}
    with pytest.raises(ValueError, match="requires its vqgan_model_path"):
        port.VQGanVAE(vqgan_config=config, device="cpu")
    with pytest.raises(ValueError, match="both encoder_path and decoder_path"):
        port.OpenAIDiscreteVAE(encoder_path="e.pkl", device="cpu")
    vae = port.VQGanVAE(str(tmp_path / "m.ckpt"), config, device="cpu")
    assert (vae.image_size, vae.num_tokens, vae.num_layers, vae.channels, vae.is_gumbel) == (16, 32, 1, 3, False)
    img = torch.from_numpy(np.random.default_rng(3).random((2, 16, 16, 3)).astype(np.float32))
    np.testing.assert_array_equal(vae.get_codebook_indices(img).numpy(), np.asarray(
        jvqgan.get_codebook_indices(jvqgan.convert_taming_state_dict(state, jcfg), jcfg, jnp.asarray(img.numpy()))))
    dalle = port.DALLE(vae=vae, dim=32, depth=1, heads=2, dim_head=16, num_text_tokens=20, text_seq_len=5,
                       device="cpu")
    assert (dalle.cfg.image_fmap_size, dalle.cfg.num_image_tokens) == (8, 32)
    images = dalle.generate_images(torch.ones(1, 5, dtype=torch.long), img=img[:1], num_init_img_tokens=60)
    assert images.shape == (1, 16, 16, 3) and float(images.min()) >= 0 and float(images.max()) <= 1
    seeded = port.VQGanVAE(cfg=tcfg, seed=1, decoder_attn=True, device="cpu")
    assert seeded.module.decoder_attn and seeded.decode(torch.zeros(1, 64, dtype=torch.long)).shape == (1, 16, 16, 3)
