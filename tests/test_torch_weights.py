"""Carrying weights from the JAX package into the port: parameter trees
(`weights.py`) and v3 checkpoints (`checkpoint.py`, numpy only)."""
import json

import numpy as np
import pytest
import torch

from dalle_pytorch_tpu_torch import checkpoint as tckpt

SMALL = dict(dim=64, depth=2, heads=2, dim_head=32, num_text_tokens=50, text_seq_len=15,
             num_image_tokens=32, image_fmap_size=4)
VAE = dict(image_size=16, num_tokens=32, codebook_dim=16, num_layers=2, hidden_dim=8)


@pytest.fixture(scope="module")
def jax_trees():
    jax = pytest.importorskip("jax")
    from dalle_pytorch_tpu.models import dalle as jdalle
    from dalle_pytorch_tpu.models import vae as jvae

    jcfg, vcfg = jdalle.DALLEConfig(**SMALL), jvae.DiscreteVAEConfig(**VAE)
    params = jax.device_get(jdalle.init_dalle(jax.random.PRNGKey(0), jcfg))
    vparams = jax.device_get(jvae.init_discrete_vae(jax.random.PRNGKey(1), vcfg))
    return params, jcfg, vparams, vcfg


def test_dalle_tree_carries_over(jax_trees):
    """Every port parameter is filled (strict load) and the carried weights
    compute what the JAX package computes: embeddings and the logits head
    exactly or at atol 1e-5, a linear layer as x @ w."""
    import jax.numpy as jnp
    from dalle_pytorch_tpu.models import dalle as jdalle
    from dalle_pytorch_tpu_torch import weights
    from dalle_pytorch_tpu_torch.models import dalle as tdalle

    params, jcfg, _, _ = jax_trees
    model = weights.load_dalle(params, tdalle.DALLEConfig(**SMALL), device="cpu")
    ids = np.random.default_rng(0).integers(0, jcfg.num_text_tokens_padded, (2, 16))
    np.testing.assert_array_equal(tdalle.embed_text_ids(model, torch.from_numpy(ids)).numpy(),
                                  np.asarray(jdalle.embed_text_ids(params, jcfg, jnp.asarray(ids))))
    x = np.random.default_rng(1).standard_normal((2, 5, SMALL["dim"])).astype(np.float32)
    np.testing.assert_allclose(tdalle.to_logits(model, torch.from_numpy(x)).numpy(),
                               np.asarray(jdalle.to_logits(params, jcfg, jnp.asarray(x))), atol=1e-5, rtol=0)
    qkv = params["transformer"]["shared_attn"]["1"]["qkv"]["w"]
    np.testing.assert_allclose(model.transformer.layers[1].attn.qkv(torch.from_numpy(x)).numpy(),
                               x @ qkv, atol=1e-5, rtol=0)


def test_vae_tree_carries_over(jax_trees):
    import jax.numpy as jnp
    from dalle_pytorch_tpu.models import vae as jvae
    from dalle_pytorch_tpu_torch import weights
    from dalle_pytorch_tpu_torch.models import vae as tvae

    _, _, vparams, vcfg = jax_trees
    vae = weights.load_vae(vparams, tvae.DiscreteVAEConfig(**VAE), device="cpu")
    z = np.random.default_rng(2).standard_normal((2, 4, 4, VAE["codebook_dim"])).astype(np.float32)
    np.testing.assert_allclose(tvae.decode_embeddings(vae, torch.from_numpy(z)).numpy(),
                               np.asarray(jvae.decode_embeddings(vparams, vcfg, jnp.asarray(z))),
                               atol=1e-5, rtol=0)


def _meta(jcfg, vcfg):
    return {"hparams": jcfg.to_dict(), "vae_params": vcfg.to_dict(), "vae_class_name": "DiscreteVAE"}


def test_v3_checkpoint_reads_back_bit_identical(jax_trees, tmp_path):
    """One f32 tree and one bf16 tree written by the JAX package's
    save_checkpoint; bf16 leaves come back through torch, with no ml_dtypes."""
    import jax
    import jax.numpy as jnp
    from dalle_pytorch_tpu.training.checkpoint import save_checkpoint

    params, jcfg, vparams, vcfg = jax_trees
    vbf16 = jax.device_get(jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), vparams))
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, {"weights": params, "vae_weights": vbf16}, _meta(jcfg, vcfg))
    trees, meta = tckpt.load_checkpoint(path)
    assert meta["hparams"]["dim"] == SMALL["dim"] and meta["vae_class_name"] == "DiscreteVAE"

    def pairs(port, ref):
        if isinstance(ref, dict):
            assert set(port) == set(ref)
            for key in ref:
                yield from pairs(port[key], ref[key])
        elif isinstance(ref, (list, tuple)):
            assert len(port) == len(ref)
            for p, r in zip(port, ref):
                yield from pairs(p, r)
        else:
            yield port, np.asarray(ref)

    n = 0
    for port, ref in pairs(trees["weights"], params):
        assert port.dtype == torch.float32
        np.testing.assert_array_equal(port.numpy(), ref)
        n += 1
    for port, ref in pairs(trees["vae_weights"], vbf16):
        assert port.dtype == torch.bfloat16 and port.shape == ref.shape
        np.testing.assert_array_equal(port.view(torch.int16).numpy(), ref.view(np.int16))
        n += 1
    assert n > 20


def test_checkpoint_loads_models_that_match(jax_trees, tmp_path):
    import jax.numpy as jnp
    from dalle_pytorch_tpu.models import dalle as jdalle
    from dalle_pytorch_tpu.models import vae as jvae
    from dalle_pytorch_tpu.training.checkpoint import save_checkpoint
    from dalle_pytorch_tpu_torch import weights
    from dalle_pytorch_tpu_torch.models import dalle as tdalle
    from dalle_pytorch_tpu_torch.models import vae as tvae

    params, jcfg, vparams, vcfg = jax_trees
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, {"weights": params, "vae_weights": vparams}, _meta(jcfg, vcfg))
    model, vae = weights.load_dalle_checkpoint(path, device="cpu")
    text = np.random.default_rng(3).integers(0, SMALL["num_text_tokens"], (2, SMALL["text_seq_len"]))
    np.testing.assert_allclose(
        tdalle.forward(model, torch.from_numpy(text)).numpy(),
        np.asarray(jdalle.forward(params, jcfg, jnp.asarray(text))), atol=1e-4, rtol=0)
    codes = np.random.default_rng(4).integers(0, VAE["num_tokens"], (1, 16))
    np.testing.assert_allclose(tvae.decode_indices(vae, torch.from_numpy(codes)).numpy(),
                               np.asarray(jvae.decode_indices(vparams, vcfg, jnp.asarray(codes))),
                               atol=1e-4, rtol=0)


def test_facades_keep_the_trees_dtype(jax_trees, tmp_path):
    """`params=` trees load in their own dtype, as the JAX facade keeps them:
    a bf16 checkpoint gives bf16 modules; seeded init gives float32."""
    import jax
    import jax.numpy as jnp
    from dalle_pytorch_tpu.training.checkpoint import save_checkpoint
    from dalle_pytorch_tpu_torch import api

    params, jcfg, vparams, vcfg = jax_trees
    bf16 = lambda t: jax.device_get(jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), t))
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, {"weights": bf16(params), "vae_weights": bf16(vparams)}, _meta(jcfg, vcfg))
    trees, _ = tckpt.load_checkpoint(path)
    vae = api.DiscreteVAE(params=trees["vae_weights"], device="cpu", **VAE)
    model = api.DALLE(vae=vae, params=trees["weights"], device="cpu",
                      **{k: v for k, v in SMALL.items() if k not in ("num_image_tokens", "image_fmap_size")})
    assert {p.dtype for p in vae.module.parameters()} == {torch.bfloat16}
    assert {p.dtype for p in model.module.parameters()} == {torch.bfloat16}
    seeded = api.DiscreteVAE(seed=0, device="cpu", **VAE)
    assert {p.dtype for p in seeded.module.parameters()} == {torch.float32}


@pytest.mark.parametrize("fmt", [None, 1, 2])
def test_older_formats_are_refused(tmp_path, fmt):
    """v1/v2 files keep their tree structure as a pickle: never read."""
    payload = {"__meta": np.frombuffer(json.dumps({}).encode(), dtype=np.uint8),
               "weights:0": np.zeros(3, np.float32)}
    if fmt is not None:
        payload["__format"] = np.array(fmt, dtype=np.int64)
    path = tmp_path / "old.npz"
    np.savez(path, **payload)
    with pytest.raises(ValueError, match="format version"):
        tckpt.load_checkpoint(str(path))


def test_quantized_tree_maps_to_quant_modules_keys(jax_trees):
    """A quantized tree's `{"qvalue", "scale"}` leaves become the state dict
    of `QuantLinear` / `QuantEmbedding` (values transposed to (out, in),
    fp8 as its uint8 bits), and `dalle_tree` gives the tree back."""
    import jax
    import jax.numpy as jnp
    from dalle_pytorch_tpu import quantization as jq
    from dalle_pytorch_tpu_torch import weights
    from dalle_pytorch_tpu_torch.models import dalle as tdalle

    params, jcfg, _, _ = jax_trees
    for kind in ("int8", "fp8"):
        quant = jq.quantize_tree(jax.tree_util.tree_map(jnp.asarray, params), kind)
        sd = weights.dalle_state_dict(quant, tdalle.DALLEConfig(**SMALL))
        w = np.asarray(quant["logits_linear"]["w"]["qvalue"])
        q = sd["logits_linear.qvalue"]
        assert q.dtype == (torch.int8 if kind == "int8" else torch.uint8) and "logits_linear.weight" not in sd
        np.testing.assert_array_equal(q.t().numpy(), w if kind == "int8" else w.view(np.uint8))
        assert sd["text_emb.scale"].shape == (jcfg.num_text_tokens_padded, 1)
        back = weights.dalle_tree(sd, tdalle.DALLEConfig(**SMALL))
        got = back["logits_linear"]["w"]["qvalue"]  # torch leaves: fp8 as torch's own dtype
        assert got.dtype == (torch.int8 if kind == "int8" else torch.float8_e4m3fn)
        np.testing.assert_array_equal(got.view(torch.uint8 if kind == "fp8" else torch.int8).numpy(),
                                      w if kind == "int8" else w.view(np.uint8))
