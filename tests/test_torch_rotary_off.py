"""The DALL-E without rotary (`rotary_emb=False`: learned text positions and
the image's axial table, the JAX train CLI's default model) against the JAX
package, on the CPU.

Logits agree at atol 1e-4, dense and with a pattern, tied and untied; the
loss at rtol 1e-5 and every gradient leaf within 1e-4 of its largest
value.  Codes are compared under shared gumbel noise and must be equal:
the prefill and the eager decode loop, the engine's paged step against
batch-1 sampling, and text completion under JAX's own key chain.  The
weight bridge carries `text_pos` and `image_pos_*` both ways, and a JAX
v3 checkpoint of such a model loads through `load_dalle_checkpoint`."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from dalle_pytorch_tpu.models import dalle as jdalle  # noqa: E402
from dalle_pytorch_tpu.models import sampling as jsamp  # noqa: E402
from dalle_pytorch_tpu.ops.sampling import gumbel_noise  # noqa: E402
from dalle_pytorch_tpu_torch import weights  # noqa: E402
from dalle_pytorch_tpu_torch.api import DALLE, DiscreteVAE  # noqa: E402
from dalle_pytorch_tpu_torch.models import dalle as tdalle  # noqa: E402
from dalle_pytorch_tpu_torch.models import sampling as tsamp  # noqa: E402
from dalle_pytorch_tpu_torch.serving.engine import EngineConfig, GenerationEngine  # noqa: E402

# seq 31 = text 6 + a 5 x 5 map: rows of 5 cross the shift rings
BASE = dict(dim=32, depth=2, heads=2, dim_head=16, num_text_tokens=40, text_seq_len=6,
            num_image_tokens=32, image_fmap_size=5, shift_tokens=True, rotary_emb=False)
MODELS = {
    "dense": BASE,
    "dense_tied": dict(BASE, share_input_output_emb=True),
    "pattern": dict(BASE, depth=4, attn_types=("full", "axial_row", "axial_col", "conv_like")),
    "pattern_tied": dict(BASE, depth=4, attn_types=("full", "axial_row", "axial_col", "conv_like"),
                         share_input_output_emb=True),
}
# seq 128 = text 64 + an 8 x 8 map: the JAX side runs its Pallas flash kernels (interpret mode)
FLASH = dict(BASE, dim=64, dim_head=32, text_seq_len=64, image_fmap_size=8)
LOGIT_ATOL = 1e-4
GRAD_REL = 1e-4
THRES = 0.5
_loaded = {}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _load(name):
    if name not in _loaded:
        kw = FLASH if name == "flash" else MODELS[name]
        jcfg = jdalle.DALLEConfig(**kw)
        params = jax.device_get(jdalle.init_dalle(jax.random.PRNGKey(0), jcfg))
        _loaded[name] = jcfg, params, weights.load_dalle(params, tdalle.DALLEConfig(**kw), device="cpu")
    return _loaded[name]


def _text(cfg, b, seed):
    text = np.random.default_rng(seed).integers(1, cfg.num_text_tokens, (b, cfg.text_seq_len)).astype(np.int32)
    text[-1, cfg.text_seq_len // 2:] = 0  # padding takes the per-position pad ids
    return text


def _pairs(port, ref):
    if isinstance(ref, dict):
        assert set(port) == set(ref)
        for key in ref:
            yield from _pairs(port[key], ref[key])
    elif isinstance(ref, (list, tuple)):
        assert len(port) == len(ref)
        for p, r in zip(port, ref):
            yield from _pairs(p, r)
    else:
        yield np.asarray(port), np.asarray(ref)


@pytest.mark.parametrize("name", list(MODELS))
def test_logits_and_loss_match_jax(name):
    jcfg, params, model = _load(name)
    text = _text(jcfg, 2, 1)
    codes = np.random.default_rng(2).integers(0, jcfg.num_image_tokens, (2, jcfg.image_seq_len)).astype(np.int32)
    tt, tc = torch.from_numpy(text).long(), torch.from_numpy(codes).long()
    with torch.no_grad():
        port = tdalle.forward(model, tt, tc).numpy()
        loss = tdalle.forward(model, tt, tc, return_loss=True).item()
    ref = np.asarray(jdalle.forward(params, jcfg, jnp.asarray(text), jnp.asarray(codes)))
    np.testing.assert_allclose(port, ref, atol=LOGIT_ATOL, rtol=0)
    ref_loss = float(jdalle.forward(params, jcfg, jnp.asarray(text), jnp.asarray(codes), return_loss=True))
    assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss)


@pytest.mark.parametrize("name", ["flash", "pattern_tied"])
def test_loss_gradients_match_jax(name):
    """Every gradient leaf, the position tables included, through the
    inverse weight map against jax.grad, to 1e-4 of the leaf's largest
    value.  `flash` is long enough for the JAX side's Pallas kernels."""
    jcfg, params, model = _load(name)
    text = _text(jcfg, 2, 3)
    codes = np.random.default_rng(4).integers(0, jcfg.num_image_tokens, (2, jcfg.image_seq_len)).astype(np.int32)
    model.requires_grad_(True)
    try:
        loss = tdalle.forward(model, torch.from_numpy(text).long(), torch.from_numpy(codes).long(), return_loss=True)
        loss.backward()
        grads = weights.dalle_tree({n: p.grad for n, p in model.named_parameters()}, model.cfg)
    finally:
        model.zero_grad(set_to_none=True)
        model.requires_grad_(False)
    ref_loss, ref = jax.value_and_grad(
        lambda p: jdalle.forward(p, jcfg, jnp.asarray(text), jnp.asarray(codes), return_loss=True))(params)
    assert abs(loss.item() - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
    assert {"text_pos", "image_pos_h", "image_pos_w"} <= set(grads)
    for port, r in _pairs(grads, ref):
        err = np.abs(port - r).max() / max(np.abs(r).max(), 1e-30)
        assert err <= GRAD_REL, err


def _noise(cfg, n_gen, b, seed):
    return np.random.default_rng(seed).gumbel(size=(n_gen, b, cfg.total_tokens)).astype(np.float32)


@pytest.mark.parametrize("name", ["dense", "pattern_tied"])
@pytest.mark.parametrize("cond_scale,prime_len", [(1.0, 0), (3.0, 0), (3.0, 7)])
def test_codes_equal_jax_under_shared_noise(name, cond_scale, prime_len):
    """The prefill (text positions, primer at image positions 0..p-1) and
    the eager decode loop (each code at its own raster position)."""
    jcfg, params, model = _load(name)
    text = _text(jcfg, 2, 5)
    primer = np.random.default_rng(6).integers(0, jcfg.num_image_tokens, (2, prime_len)).astype(np.int32)
    noise = _noise(jcfg, jcfg.image_seq_len - prime_len, 2, 7)
    kw = dict(filter_thres=THRES, cond_scale=cond_scale, prime_len=prime_len)
    ref = jsamp.sample_image_codes(params, jcfg, jnp.asarray(text), jax.random.PRNGKey(0),
                                   primer_codes=jnp.asarray(primer) if prime_len else None,
                                   noise_override=jnp.asarray(noise), **kw)
    port = tsamp.sample_image_codes(model, torch.from_numpy(text).long(),
                                    primer_codes=torch.from_numpy(primer).long() if prime_len else None,
                                    noise_override=torch.from_numpy(noise), graphs=False, **kw)
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
    assert len(np.unique(port.numpy())) > 3


def _text_noise(key, n_gen, b, total_tokens):
    """The gumbel noise of JAX `generate_texts`' key chain, per token."""
    rows = []
    for _ in range(n_gen):
        key, sk = jax.random.split(key)
        rows.append(np.asarray(gumbel_noise(sk, (b, total_tokens), jnp.float32)))
    return np.stack(rows)


@pytest.mark.parametrize("name", ["dense", "dense_tied"])
@pytest.mark.parametrize("n0", [1, 4])
def test_generate_texts_equal_jax_under_its_key_chain(name, n0):
    """Text positions in the prefill, in every cached step (the cache's
    offset) and in the uncached re-forward."""
    jcfg, params, model = _load(name)
    prompt = np.random.default_rng(n0).integers(1, jcfg.num_text_tokens, (2, n0)).astype(np.int32)
    key = jax.random.PRNGKey(11 + n0)
    noise = torch.from_numpy(_text_noise(key, jcfg.text_seq_len - n0, 2, jcfg.total_tokens))
    for use_cache in (True, False):
        ref = np.asarray(jsamp.generate_texts(params, jcfg, key, text=jnp.asarray(prompt), filter_thres=THRES,
                                              use_cache=use_cache))
        port = tsamp.generate_texts(model, torch.from_numpy(prompt), filter_thres=THRES, use_cache=use_cache,
                                    noise_override=noise, graphs=False)
        np.testing.assert_array_equal(port.numpy(), ref)


def test_engine_codes_equal_batch1_under_noise():
    """Requests at staggered admissions, each lane at its own image
    position, against batch-1 `sample_image_codes` of both packages under
    the request's noise."""
    jcfg, params, model = _load("pattern")
    texts = _text(jcfg, 4, 8)
    noise = np.random.default_rng(9).gumbel(size=(4, jcfg.image_seq_len, jcfg.total_tokens)).astype(np.float32)
    engine = GenerationEngine(model, engine_cfg=EngineConfig(num_slots=3, block_size=4, filter_thres=THRES,
                                                            noise_override=True), graphs=False)
    reqs = []
    for i in range(4):
        reqs.append(engine.submit(texts[i], cond_scale=3.0 if i == 1 else 1.0, noise=noise[i]))
        for _ in range(3 + 2 * i):
            engine.poll()
    engine.run_until_idle()
    for i, req in enumerate(reqs):
        cond = 3.0 if i == 1 else 1.0
        port = tsamp.sample_image_codes(model, torch.from_numpy(texts[i:i + 1]).long(), filter_thres=THRES,
                                        cond_scale=cond, noise_override=torch.from_numpy(noise[i][:, None]),
                                        graphs=False).numpy()[0]
        ref = np.asarray(jsamp.sample_image_codes(params, jcfg, jnp.asarray(texts[i:i + 1]), jax.random.PRNGKey(0),
                                                  filter_thres=THRES, cond_scale=cond,
                                                  noise_override=jnp.asarray(noise[i][:, None])))[0]
        np.testing.assert_array_equal(port, ref)
        np.testing.assert_array_equal(req.codes, port)


def test_decode_steps_record_the_same_ops(monkeypatch):
    """The CPU stand-in for "capturable": every decode step of the image
    and text loops runs the same aten ops on the same shapes, none reading
    the device from the host, so the position comes from the device."""
    from test_torch_decode_graphs import FORBIDDEN, _record

    _, _, model = _load("pattern_tied")
    text = torch.from_numpy(_text(model.cfg, 1, 10)).long()
    steps = _record(monkeypatch, lambda: tsamp.sample_image_codes(
        model, text, torch.Generator().manual_seed(0), cond_scale=3.0, graphs=False))
    monkeypatch.undo()
    steps += _record(monkeypatch, lambda: tsamp.generate_texts(
        model, text[:, :2], torch.Generator().manual_seed(1), graphs=False))
    image, texts = steps[: model.cfg.image_seq_len - 1], steps[model.cfg.image_seq_len - 1:]
    for group in (image, texts):
        assert len(group) > 2 and all(s == group[0] for s in group)
        assert not any(op[0] in FORBIDDEN for op in group[0])
        assert any(op[0] == "embedding" for op in group[0])


def test_bridge_round_trip_and_jax_checkpoint(tmp_path):
    """`dalle_tree(dalle_state_dict(tree))` gives the tree back leaf for
    leaf, position tables included; a JAX v3 checkpoint of a rotary-off
    model loads through `load_dalle_checkpoint` and gives JAX's logits."""
    from dalle_pytorch_tpu.models import vae as jvae
    from dalle_pytorch_tpu.training.checkpoint import save_checkpoint

    jcfg, params, model = _load("dense_tied")
    back = weights.dalle_tree(weights.dalle_state_dict(params, model.cfg), model.cfg)
    n = 0
    for port, ref in _pairs(back, params):
        np.testing.assert_array_equal(port, ref)
        n += 1
    assert n == len(jax.tree_util.tree_leaves(params))
    assert set(back) >= {"text_pos", "image_pos_h", "image_pos_w"} and "text_emb" not in back

    # a VAE's map is a power of two: a 16-pixel, 2-layer VAE gives 4 x 4
    jcfg = jdalle.DALLEConfig(**dict(BASE, image_fmap_size=4))
    params = jax.device_get(jdalle.init_dalle(jax.random.PRNGKey(3), jcfg))
    vcfg = jvae.DiscreteVAEConfig(image_size=16, num_tokens=32, codebook_dim=16, num_layers=2, hidden_dim=8)
    vparams = jax.device_get(jvae.init_discrete_vae(jax.random.PRNGKey(4), vcfg))
    path = str(tmp_path / "jax_rotary_off.pt")
    save_checkpoint(path, {"weights": params, "vae_weights": vparams},
                    {"hparams": jcfg.to_dict(), "vae_params": vcfg.to_dict(), "vae_class_name": "DiscreteVAE",
                     "epoch": 0, "version": "jax"})
    model, vae = weights.load_dalle_checkpoint(path, device="cpu")
    assert not model.cfg.rotary_emb
    text = _text(jcfg, 2, 12)
    codes = np.random.default_rng(13).integers(0, 32, (2, jcfg.image_seq_len)).astype(np.int32)
    with torch.no_grad():
        port = tdalle.forward(model, torch.from_numpy(text).long(), torch.from_numpy(codes).long()).numpy()
    ref = np.asarray(jdalle.forward(params, jcfg, jnp.asarray(text), jnp.asarray(codes)))
    np.testing.assert_allclose(port, ref, atol=LOGIT_ATOL, rtol=0)


def test_facade_builds_and_serves_without_rotary():
    """`DALLE(..., rotary_emb=False)` draws its position tables (N(0, 1),
    separate from the tied logits weight), scores and generates."""
    vae = DiscreteVAE(seed=0, image_size=16, num_tokens=32, codebook_dim=16, num_layers=2, hidden_dim=8,
                      device="cpu")
    dalle = DALLE(vae=vae, dim=32, depth=1, heads=2, dim_head=16, num_text_tokens=40, text_seq_len=6,
                  rotary_emb=False, share_input_output_emb=True, device="cpu")
    module = dalle.module
    for name in ("text_pos", "image_pos_h", "image_pos_w"):
        table = getattr(module, name).weight
        assert table.shape[1] == 32 and 0.5 < float(table.std()) < 1.5
    assert module.text_pos.weight.shape[0] == 7 and module.image_pos_h.weight.shape[0] == 4
    text = torch.from_numpy(_text(dalle.cfg, 2, 14)).long()
    images = dalle.generate_images(text, generator=3, cond_scale=3.0)
    assert images.shape == (2, 16, 16, 3) and bool(torch.isfinite(images).all())
    assert bool(torch.isfinite(dalle(text, images.clamp(0, 1), return_loss=True)))
