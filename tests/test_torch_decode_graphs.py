"""The port's static decode step (`models/sampling.DecodeLoop`), the step a
CUDA graph captures, against the JAX package's scanned loops, on the CPU.

Every case runs with `graphs=False`: the same step the card replays, called
eagerly.  Under shared gumbel noise the image codes and text ids must equal
the JAX package's (`sample_image_codes`, `generate_texts`), for the full
model with and without guidance, a pattern model that gathers its keys
(`sparse_decode`) or masks the whole cache with its row, primed and not,
and a small model with the flagship's features.  The logit stats agree
within 1e-5 relative: the frameworks' f32 logits differ in the last bits
(other summation orders in the products), and the mean entropy sums the
steps in another order.

As a CPU stand-in for "capturable", every decode step records the same ops
on the same shapes, dtypes and Python arguments, and none syncs with the
host or makes a tensor from host data.  `graphs=True` on a CPU model
raises.  The `cuda`-marked tests replay the graphs on the card against the
eager step, and skip here."""
import types

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from dalle_pytorch_tpu_torch import weights
from dalle_pytorch_tpu_torch.models import dalle as tdalle
from dalle_pytorch_tpu_torch.models import sampling as tsamp
from dalle_pytorch_tpu_torch.models import transformer as ttr

CYCLE = ("full", "axial_row", "axial_col", "conv_like")
# seq 31 = text 6 + a 5 x 5 map: image rows of 5 cross the shift rings'
# slot 0 and many prefix lengths
FULL = dict(dim=32, depth=2, heads=2, dim_head=16, num_text_tokens=40, text_seq_len=6,
            num_image_tokens=32, image_fmap_size=5, shift_tokens=True, rotary_emb=True)
PATTERN = dict(FULL, depth=4, attn_types=CYCLE)
FLAGSHIP = dict(PATTERN, share_input_output_emb=True, attn_vfa=True)
PER_HEAD = dict(FULL, attn_types=("sparse", "axial_row"), sparse_per_head=True, sparse_block_size=4)
MODELS = {"full": FULL, "pattern": PATTERN, "pattern_masked": dict(PATTERN, sparse_decode=False),
          "flagship": FLAGSHIP, "per_head": PER_HEAD,
          # the CUDA kernels take head dims 32, 64 and 128
          "card": dict(PATTERN, dim=64, dim_head=32)}
STATS_RTOL = 1e-5
# ops that wait for the device or read host data: none may run in a step
FORBIDDEN = ("_local_scalar_dense", "item", "nonzero", "is_nonzero", "equal", "masked_select", "unique",
             "lift_fresh", "lift_fresh_copy", "tolist")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's modules (the card's machine has no JAX: the tests
    that need it import it here)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from dalle_pytorch_tpu.models import dalle as jdalle
    from dalle_pytorch_tpu.models import sampling as jsamp
    from dalle_pytorch_tpu.ops.sampling import gumbel_noise

    return types.SimpleNamespace(jax=jax, jnp=jnp, dalle=jdalle, sampling=jsamp, gumbel_noise=gumbel_noise, loaded={})


def _load(jx, name):
    """(JAX params, JAX config, the port's model with those weights)."""
    if name not in jx.loaded:
        cfg = MODELS[name]
        jcfg = jx.dalle.DALLEConfig(**cfg)
        params = jx.jax.device_get(jx.dalle.init_dalle(jx.jax.random.PRNGKey(0), jcfg))
        jx.loaded[name] = params, jcfg, weights.load_dalle(params, tdalle.DALLEConfig(**cfg), device="cpu")
    return jx.loaded[name]


def _port(name, device="cpu"):
    """The port's model with seeded weights of its own."""
    return tdalle.init_dalle(tdalle.DALLEConfig(**MODELS[name]), torch.Generator(device).manual_seed(0), device)


def _inputs(jcfg, prime_len, seed=1):
    rng = np.random.default_rng(seed)
    text = rng.integers(1, jcfg.num_text_tokens, (2, jcfg.text_seq_len)).astype(np.int32)
    text[1, 4:] = 0  # padding takes the per-position pad ids
    primer = rng.integers(0, jcfg.num_image_tokens, (2, prime_len)).astype(np.int32) if prime_len else None
    noise = rng.gumbel(size=(jcfg.image_seq_len - prime_len, 2, jcfg.total_tokens)).astype(np.float32)
    return text, primer, noise


def _both(jx, name, cond_scale, prime_len, stats=False, filter_thres=0.5):
    """(JAX output, port output) of sample_image_codes under one noise."""
    params, jcfg, model = _load(jx, name)
    text, primer, noise = _inputs(jcfg, prime_len)
    jnp = jx.jnp
    ref = jx.sampling.sample_image_codes(
        params, jcfg, jnp.asarray(text), jx.jax.random.PRNGKey(0), filter_thres=filter_thres, cond_scale=cond_scale,
        primer_codes=None if primer is None else jnp.asarray(primer), prime_len=prime_len,
        noise_override=jnp.asarray(noise), return_logit_stats=stats)
    port = tsamp.sample_image_codes(
        model, torch.from_numpy(text).long(), filter_thres=filter_thres, cond_scale=cond_scale,
        primer_codes=None if primer is None else torch.from_numpy(primer).long(), prime_len=prime_len,
        noise_override=torch.from_numpy(noise), return_logit_stats=stats, graphs=False)
    return ref, port


@pytest.mark.parametrize("name,cond_scale,prime_len", [
    ("full", 1.0, 0), ("full", 3.0, 0),
    ("pattern", 3.0, 0), ("pattern", 1.0, 12),
    ("pattern_masked", 3.0, 0), ("pattern_masked", 1.0, 12),
    ("flagship", 3.0, 12),
])
def test_static_step_codes_equal_jax(jx, name, cond_scale, prime_len):
    """The eager run of the static step: codes equal to JAX's scanned loop
    under shared noise, with guidance and priming, gathering or masking."""
    gathers = ttr.decode_step.gathers
    ref, port = _both(jx, name, cond_scale, prime_len)
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
    assert len(np.unique(port.numpy()[:, prime_len:])) > 3  # the noise really drives the samples
    pattern_layers = 3 if name in ("pattern", "flagship") else 0  # three of the cycle's four gather
    assert ttr.decode_step.gathers - gathers == pattern_layers * (25 - prime_len - 1)


@pytest.mark.parametrize("name,cond_scale,prime_len", [("full", 3.0, 0), ("pattern", 1.0, 12)])
def test_logit_stats_match_jax(jx, name, cond_scale, prime_len):
    """`return_logit_stats`: codes equal, and the largest logit and mean
    entropy of the guided, top-k-filtered distributions within 1e-5
    relative of JAX's."""
    (ref_codes, ref_stats), (codes, stats) = _both(jx, name, cond_scale, prime_len, stats=True)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(ref_codes))
    assert set(stats) == {"logit_max", "entropy_mean"}
    for key in stats:
        want = float(ref_stats[key])
        assert np.isfinite(want) and want != 0
        assert abs(stats[key].item() - want) <= STATS_RTOL * abs(want), (key, stats[key].item(), want)


def _jax_text_noise(jx, key, n_gen, b, total_tokens):
    """The gumbel noise of JAX `generate_texts`' key chain, per token."""
    rows = []
    for _ in range(n_gen):
        key, sk = jx.jax.random.split(key)
        rows.append(np.asarray(jx.gumbel_noise(sk, (b, total_tokens), jx.jnp.float32)))
    return np.stack(rows)


@pytest.mark.parametrize("name,n0", [("full", 1), ("pattern", 3), ("flagship", 2)])
def test_text_loop_ids_equal_jax(jx, name, n0):
    """The text loop's static step (text-only, no guidance): ids equal to
    JAX's cached generate_texts under its own key chain's noise."""
    params, jcfg, model = _load(jx, name)
    prompt = np.random.default_rng(n0).integers(1, jcfg.num_text_tokens, (2, n0)).astype(np.int32)
    key = jx.jax.random.PRNGKey(11 + n0)
    noise = _jax_text_noise(jx, key, jcfg.text_seq_len - n0, 2, jcfg.total_tokens)
    ref = np.asarray(jx.sampling.generate_texts(params, jcfg, key, text=jx.jnp.asarray(prompt), temperature=0.8))
    port = tsamp.generate_texts(model, torch.from_numpy(prompt), temperature=0.8,
                                noise_override=torch.from_numpy(noise), graphs=False)
    np.testing.assert_array_equal(port.numpy(), ref)


# ---------------------------------------------------------------------------
# a CPU stand-in for "capturable"
# ---------------------------------------------------------------------------


def _describe(x):
    if isinstance(x, torch.Tensor):
        return ("tensor", tuple(x.shape), x.dtype, x.device.type)
    if isinstance(x, (list, tuple)):
        return tuple(_describe(v) for v in x)
    if isinstance(x, dict):
        return tuple((k, _describe(v)) for k, v in sorted(x.items()))
    if isinstance(x, torch.Generator):
        return "generator"
    return repr(x)


class StepRecorder(TorchDispatchMode):
    """The aten ops of each decode step, with their tensors' shapes and
    dtypes and every other argument's value."""

    def __init__(self):
        super().__init__()
        self.steps, self.current = [], None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self.current is not None:
            self.current.append((func.overloadpacket.__name__, str(func), _describe(args), _describe(kwargs or {})))
        return func(*args, **(kwargs or {}))


def _record(monkeypatch, run):
    recorder = StepRecorder()
    advance = tsamp.DecodeLoop.advance

    def recorded(self, *args, **kwargs):
        recorder.current = []
        advance(self, *args, **kwargs)
        recorder.steps.append(recorder.current)
        recorder.current = None

    monkeypatch.setattr(tsamp.DecodeLoop, "advance", recorded)
    with recorder:
        run()
    return recorder.steps


@pytest.mark.parametrize("name,cond_scale,prime_len,noise,stats", [
    ("full", 3.0, 0, True, True), ("pattern", 1.0, 12, False, False),
    ("pattern_masked", 3.0, 0, False, True), ("per_head", 3.0, 7, True, False),
])
def test_every_image_step_records_the_same_ops(monkeypatch, name, cond_scale, prime_len, noise, stats):
    """Steps 1..n of the image loop: one op sequence (names, shapes,
    dtypes, Python arguments) at every position, from the text boundary
    across the rings' slot 0, and no op that syncs with the host."""
    model = _port(name)
    text, primer, noise_np = _inputs(model.cfg, prime_len)
    steps = _record(monkeypatch, lambda: tsamp.sample_image_codes(
        model, torch.from_numpy(text).long(), torch.Generator().manual_seed(3), cond_scale=cond_scale,
        primer_codes=None if primer is None else torch.from_numpy(primer).long(), prime_len=prime_len,
        noise_override=torch.from_numpy(noise_np) if noise else None, return_logit_stats=stats, graphs=False))
    _assert_static(steps, model.cfg.image_seq_len - prime_len - 1)


def test_every_text_step_records_the_same_ops(monkeypatch):
    model = _port("pattern")
    prompt = torch.tensor([[5, 9], [7, 1]])
    steps = _record(monkeypatch, lambda: tsamp.generate_texts(model, prompt, torch.Generator().manual_seed(4),
                                                              graphs=False))
    _assert_static(steps, model.cfg.text_seq_len - 2 - 1)


def _assert_static(steps, n_steps):
    assert len(steps) == n_steps and len(steps[0]) > 50
    for i, step in enumerate(steps[1:], 2):
        assert step == steps[0], f"step {i} differs from step 1"
    names = {op[0] for op in steps[0]}
    assert not names & set(FORBIDDEN), names & set(FORBIDDEN)
    assert {"index_copy_", "index_select", "add_", "argmax"} <= names


# ---------------------------------------------------------------------------
# the switch
# ---------------------------------------------------------------------------


def test_graphs_true_on_a_cpu_model_raises():
    model = _port("full")
    text = torch.ones((1, model.cfg.text_seq_len), dtype=torch.long)
    with pytest.raises(ValueError, match="CUDA device"):
        tsamp.sample_image_codes(model, text, graphs=True)
    with pytest.raises(ValueError, match="CUDA device"):
        tsamp.generate_texts(model, text[:, :2], graphs=True)
    assert not hasattr(model, "_decode_graphs")  # no graph cache was made
    default = tsamp.sample_image_codes(model, text, torch.Generator().manual_seed(0))
    eager = tsamp.sample_image_codes(model, text, torch.Generator().manual_seed(0), graphs=False)
    assert torch.equal(default, eager)  # on the CPU the default is the eager step


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_model():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs replay on the card only")
    model = _port("card", "cuda")
    return model.cfg, model


@pytest.mark.cuda
@pytest.mark.parametrize("cond_scale,prime_len", [(3.0, 0), (1.0, 12)])
def test_replayed_codes_equal_eager_on_card(cuda_model, cond_scale, prime_len):
    """Replayed codes equal eager codes under one noise; two seeded replays
    equal; a new temperature reuses the entry (a hit)."""
    jcfg, model = cuda_model
    text, primer, noise = (None if a is None else torch.from_numpy(a).cuda() for a in _inputs(jcfg, prime_len))
    text = text.long()
    primer = None if primer is None else primer.long()
    kw = dict(cond_scale=cond_scale, primer_codes=primer, prime_len=prime_len)
    graphs = tsamp.decode_graphs(model)
    replayed = tsamp.sample_image_codes(model, text, noise_override=noise, graphs=True, **kw)
    eager = tsamp.sample_image_codes(model, text, noise_override=noise, graphs=False, **kw)
    assert torch.equal(replayed, eager)
    misses = graphs.misses
    seeded = [tsamp.sample_image_codes(model, text, torch.Generator("cuda").manual_seed(5), temperature=t, **kw)
              for t in (1.0, 1.0, 0.7)]
    assert torch.equal(seeded[0], seeded[1])
    assert graphs.misses == misses + 1 and graphs.hits >= 2  # one capture for the generator mode


@pytest.mark.cuda
def test_replayed_text_ids_equal_eager_on_card(cuda_model):
    jcfg, model = cuda_model
    prompt = torch.tensor([[5, 9]], device="cuda")
    noise = torch.from_numpy(np.random.default_rng(2).gumbel(
        size=(jcfg.text_seq_len - 2, 1, jcfg.total_tokens)).astype(np.float32)).cuda()
    replayed = tsamp.generate_texts(model, prompt, noise_override=noise, graphs=True)
    eager = tsamp.generate_texts(model, prompt, noise_override=noise, graphs=False)
    assert torch.equal(replayed, eager)
    longer = torch.tensor([[5, 9, 3, 2]], device="cuda")  # another prompt length reuses the entry
    hits = tsamp.decode_graphs(model).hits
    tsamp.generate_texts(model, longer, noise_override=noise[2:], graphs=True)
    assert tsamp.decode_graphs(model).hits == hits + 1
