"""The port's transformer against the JAX package's, on the CPU: the
full-sequence forward, and prefill followed by cached decode steps that cross
from text into image positions, with token shift and rotary on.  Weights come
from the JAX package's init, carried over by `weights.py`.  Outputs, KV caches
and token-shift rings agree at atol 1e-4 (f32; a depth-2 stack compounds the
frameworks' different summation orders)."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from dalle_pytorch_tpu.models import dalle as jdalle  # noqa: E402
from dalle_pytorch_tpu.models import transformer as jtr  # noqa: E402
from dalle_pytorch_tpu_torch import weights  # noqa: E402
from dalle_pytorch_tpu_torch.models import dalle as tdalle  # noqa: E402
from dalle_pytorch_tpu_torch.models import transformer as ttr  # noqa: E402

ATOL = 1e-4
SMALL = dict(dim=64, depth=2, heads=2, dim_head=32, num_text_tokens=50, text_seq_len=15,
             num_image_tokens=32, image_fmap_size=4, shift_tokens=True, rotary_emb=True)


@pytest.fixture(scope="module")
def models():
    jcfg = jdalle.DALLEConfig(**SMALL)
    params = jax.device_get(jdalle.init_dalle(jax.random.PRNGKey(0), jcfg))
    model = weights.load_dalle(params, tdalle.DALLEConfig(**SMALL), device="cpu")
    return params["transformer"], jcfg.transformer_config(), model.transformer


def _x(n, b=2, seed=0):
    return np.random.default_rng(seed).standard_normal((b, n, SMALL["dim"])).astype(np.float32)


def _close(port, ref):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def _close_cache(port_cache, ref_cache):
    assert int(port_cache["offset"]) == int(ref_cache["offset"])
    for pl, rl in zip(port_cache["layers"], ref_cache["layers"]):
        assert set(pl) == set(rl)
        for key in rl:
            _close(pl[key], rl[key])


@pytest.mark.parametrize("n", [31, 9])
def test_apply_transformer_matches(models, n):
    tparams, tcfg, port = models
    x = _x(n)
    _close(ttr.apply_transformer(port, torch.from_numpy(x)), jtr.apply_transformer(tparams, tcfg, jnp.asarray(x)))


@pytest.mark.parametrize("n_pre", [13, 21])
def test_prefill_then_decode_matches(models, n_pre):
    """n_pre = 13: three text-region steps (no shift), then image positions
    0 and 1 from an empty ring.  n_pre = 21: the ring is filled by the
    prefill and decode continues at image position 5."""
    tparams, tcfg, port = models
    text_len = tcfg.text_len
    x = _x(n_pre + 5, seed=1)
    jcache = jtr.init_cache(tcfg, 2)
    pcache = ttr.init_cache(port.cfg, 2)
    jout, jcache = jtr.prefill(tparams, tcfg, jnp.asarray(x[:, :n_pre]), jcache)
    pout, pcache = ttr.prefill(port, torch.from_numpy(x[:, :n_pre]), pcache)
    _close(pout, jout)
    _close_cache(pcache, jcache)
    for pos in range(n_pre, n_pre + 5):
        text_only = pos < text_len
        step = x[:, pos:pos + 1]
        jout, jcache = jtr.decode_step(tparams, tcfg, jnp.asarray(step), jcache, text_only=text_only)
        pout, pcache = ttr.decode_step(port, torch.from_numpy(step), pcache, text_only=text_only)
        _close(pout, jout)
        _close_cache(pcache, jcache)


def test_unsupported_settings_raise():
    """Pattern layers, the VFA forward and shared layers build; a shared
    attention id reused under another attention type raises."""
    ttr.TransformerConfig(dim=8, depth=1, seq_len=8, image_fmap_size=2, attn_types=("axial_row",))
    ttr.TransformerConfig(dim=8, depth=1, seq_len=8, image_fmap_size=2, attn_types=("axial_row",),
                          attn_vfa=True)
    shared = ttr.Transformer(ttr.TransformerConfig(dim=8, depth=2, seq_len=8, heads=1, dim_head=8,
                                                   shared_attn_ids=(0, 0)))
    assert shared.layers[0].attn is shared.layers[1].attn and shared.layers[0].ff is not shared.layers[1].ff
    with pytest.raises(ValueError, match="attn_types do not match shared_attn_ids"):
        ttr.Transformer(ttr.TransformerConfig(dim=8, depth=2, seq_len=8, image_fmap_size=2,
                                              attn_types=("full", "axial_row"), shared_attn_ids=(0, 0)))
