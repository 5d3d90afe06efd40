"""The selective remat policies (`remat_policy` "flash", "flash_qkv",
"flash_qkv_ff") and "full" in the port against the JAX package, on the CPU.

A small model with the flagship's features (the four-type cycle, tied
embeddings, `attn_vfa`; at n 151 axial_row compacts at the kernels' tile,
so its layers run the plain VFA pair) is loaded from the JAX `init_dalle`
through `weights.load_dalle`.  Held: every gradient against `jax.grad`
through the JAX model under the same policy; the port's gradients under
every policy equal to the sequential model's; the plain forward (or VFA
pair) run once per layer and step under the selective policies and twice
under "full"; the bytes one layer keeps alive between its forward and its
backward in the order full < flash < flash_qkv < flash_qkv_ff < sequential;
dropout and the bf16 working copy recomputed as the first pass ran them;
and the ValueError for an unknown policy."""
import gc

import numpy as np
import pytest
import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from dalle_pytorch_tpu.models import dalle as jdalle  # noqa: E402
from dalle_pytorch_tpu_torch import weights  # noqa: E402
from dalle_pytorch_tpu_torch.kernels import flash_attention as tfa  # noqa: E402
from dalle_pytorch_tpu_torch.models import dalle as tdalle  # noqa: E402
from dalle_pytorch_tpu_torch.models import transformer as ttr  # noqa: E402

REL = 1e-5  # f32 gradients: max abs difference over the reference leaf's max abs value
POLICIES = ("full", "flash", "flash_qkv", "flash_qkv_ff")
MODEL = dict(dim=64, depth=4, heads=2, dim_head=32, num_text_tokens=50, text_seq_len=7,
             num_image_tokens=32, image_fmap_size=12, shift_tokens=True, rotary_emb=True,
             attn_types=("full", "axial_row", "axial_col", "conv_like"), share_input_output_emb=True,
             attn_vfa=True)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small products gain nothing from torch's threads, and where the suite
    runs in several processes those threads only compete for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_params():
    return jax.device_get(jdalle.init_dalle(jax.random.PRNGKey(0), jdalle.DALLEConfig(**MODEL)))


def _inputs():
    rng = np.random.default_rng(1)
    text = rng.integers(0, MODEL["num_text_tokens"], (2, MODEL["text_seq_len"]))
    codes = rng.integers(0, MODEL["num_image_tokens"], (2, MODEL["image_fmap_size"] ** 2))
    return text, codes


def _port_grads(params, **cfg):
    model = weights.load_dalle(params, tdalle.DALLEConfig(**MODEL, **cfg), device="cpu").requires_grad_(True)
    text, codes = _inputs()
    loss = tdalle.forward(model, torch.from_numpy(text), torch.from_numpy(codes), return_loss=True)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    return loss.detach(), dict(zip(names, grads)), model


class _Counting:
    """Counts the plain forward's and the VFA pair's calls (the CPU stand-in
    for the kernels' launch counters)."""

    def __init__(self, monkeypatch):
        self.calls = {"forward": 0, "vfa_max": 0, "vfa_fwd": 0}
        for key, name in (("forward", "flash_attention_reference"), ("vfa_max", "vfa_max_reference"),
                          ("vfa_fwd", "vfa_fwd_reference")):
            real = getattr(tfa, name)
            monkeypatch.setattr(tfa, name, self._wrap(key, real))

    def _wrap(self, key, real):
        def counted(*args, **kwargs):
            self.calls[key] += 1
            return real(*args, **kwargs)

        return counted


@pytest.mark.parametrize("policy", POLICIES)
def test_gradients_match_jax_and_sequential(jax_params, policy, monkeypatch):
    """Every gradient within 1e-5 of the leaf's largest value of jax.grad
    through the JAX model with the same remat_policy; equal to the port's
    sequential gradients.  The forward kernels' plain versions ran once a
    layer (the selective policies take out and lse from the checkpoint) or
    twice ("full" recomputes them)."""
    seq_loss, seq_grads, _ = _port_grads(jax_params)
    counting = _Counting(monkeypatch)
    loss, grads, model = _port_grads(jax_params, execution="remat", remat_policy=policy)
    calls = counting.calls
    times = 2 if policy == "full" else 1
    assert calls["vfa_max"] == calls["vfa_fwd"] >= 1 * times
    assert calls["forward"] + calls["vfa_max"] == times * MODEL["depth"], calls
    torch.testing.assert_close(loss, seq_loss, rtol=0, atol=0)
    for name, g in grads.items():
        torch.testing.assert_close(g, seq_grads[name], rtol=0, atol=0)

    jcfg = jdalle.DALLEConfig(**MODEL, execution="remat", remat_policy=policy)
    text, codes = _inputs()
    ref_loss, ref = jax.jit(jax.value_and_grad(
        lambda p: jdalle.forward(p, jcfg, jnp.asarray(text), jnp.asarray(codes), return_loss=True)))(jax_params)
    assert abs(loss.item() - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
    port_tree = weights.dalle_tree(grads, model.cfg)
    port_leaves, ref_leaves = jax.tree_util.tree_leaves(port_tree), jax.tree_util.tree_leaves(ref)
    assert len(port_leaves) == len(ref_leaves) == 15 * MODEL["depth"] + 4  # + logits norm and linear
    for port, r in zip(port_leaves, ref_leaves):
        port, r = np.asarray(port), np.asarray(r)
        assert np.abs(port - r).max() <= REL * np.abs(r).max()


class _KeptBytes(TorchDispatchMode):
    """Records the storage of every tensor an op creates (views excluded);
    `alive(...)` sums those still alive, less the given tensors'."""

    def __init__(self):
        super().__init__()
        self.storages = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            for t in out if isinstance(out, (tuple, list)) else (out,):
                if isinstance(t, torch.Tensor):
                    s = t.untyped_storage()
                    self.storages[s.data_ptr()] = (StorageWeakRef(s), s.nbytes())
        return out

    def alive(self, *exclude) -> int:
        gc.collect()
        skip = {t.untyped_storage().data_ptr() for t in exclude}
        return sum(n for ptr, (ref, n) in self.storages.items() if not ref.expired() and ptr not in skip)


def _kept_by_one_layer(execution, policy, index):
    """The bytes that layer `index` of the model keeps alive between its
    forward and its backward (its input and output aside)."""
    cfg = tdalle.DALLEConfig(**MODEL, execution=execution, remat_policy=policy)
    model = tdalle.init_dalle(cfg, torch.Generator().manual_seed(0), device="cpu").requires_grad_(True)
    tr = model.transformer
    spec = tr.specs[index]
    n = cfg.total_seq_len
    x = torch.randn(2, n, MODEL["dim"], requires_grad=True, generator=torch.Generator().manual_seed(1))
    args = (tr.cfg, x, "full", tr.rotary(x.device), None, None, None, False, (None, None),
            tr.attention_inputs(ttr._pattern_key(spec), n, True, x.device))
    layer = tr.layers[index]
    with _KeptBytes() as probe:
        if execution == "remat":
            y = torch.utils.checkpoint.checkpoint(ttr.remat_run(layer, ttr.remat_names(policy)), *args,
                                                  use_reentrant=False)
        else:
            y = layer(*args)
    kept = probe.alive(x, y)
    y.sum().backward()  # the graph the bytes were kept for still runs
    return kept


@pytest.mark.parametrize("index", [0, 1], ids=["full_layer", "vfa_layer"])
def test_kept_bytes_grow_with_the_policy(index):
    """full < flash < flash_qkv < flash_qkv_ff < sequential, on a full layer
    and on a pattern layer that runs the VFA pair: "full" keeps nothing,
    "flash" out (b·h, n, d) and lse (b·h, n) in f32, "flash_qkv" adds the
    projection (b, n, 3·h·d), "flash_qkv_ff" the two up-projections (b, n,
    4·dim) each."""
    kept = [_kept_by_one_layer("remat", p, index) for p in POLICIES] + [_kept_by_one_layer("sequential", "full", index)]
    assert kept == sorted(set(kept)), dict(zip(POLICIES + ("sequential",), kept))
    b, n, h, d = 2, MODEL["text_seq_len"] + MODEL["image_fmap_size"] ** 2, MODEL["heads"], MODEL["dim_head"]
    assert kept[0] == 0
    assert kept[1] == 4 * b * h * n * (d + 1)
    assert kept[2] - kept[1] == 4 * b * n * 3 * h * d, kept
    assert kept[3] - kept[2] == 2 * 4 * b * n * 4 * MODEL["dim"], kept


@pytest.mark.parametrize("policy", POLICIES[1:])
def test_selective_remat_redraws_dropout_and_recomputes_in_bf16(policy):
    """Each layer's dropout generator is rebuilt from its seed in the
    recompute, so a selective policy gives the sequential model's loss and
    gradients with dropout on; on a bf16 working copy (the train step's) it
    recomputes in bf16, the gradients equal the sequential model's."""
    rng = np.random.default_rng(6)
    text = torch.from_numpy(rng.integers(0, 50, (2, 7)))
    codes = torch.from_numpy(rng.integers(0, 32, (2, 144)))
    results = []
    for execution in ("sequential", "remat"):
        cfg = tdalle.DALLEConfig(**dict(MODEL, depth=2), attn_dropout=0.3, ff_dropout=0.3,
                                 execution=execution, remat_policy=policy)
        model = tdalle.init_dalle(cfg, torch.Generator().manual_seed(5), device="cpu").train().requires_grad_(True)
        loss = tdalle.forward(model, text, codes, return_loss=True, generator=torch.Generator().manual_seed(7))
        grads = torch.autograd.grad(loss, list(model.parameters()))
        params = {name: p.to(torch.bfloat16) for name, p in model.named_parameters()}
        loss16 = torch.func.functional_call(model, params, (text, codes), {"return_loss": True})
        loss16.backward()
        results.append((loss.detach(), grads, loss16.detach(), [p.grad for p in model.parameters()]))
    (seq_loss, seq_grads, seq16, seq16_grads), (loss, grads, loss16, grads16) = results
    torch.testing.assert_close(loss, seq_loss, rtol=0, atol=0)
    for a, b in zip(grads, seq_grads):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-7)
    torch.testing.assert_close(loss16, seq16, rtol=0, atol=0)
    for a, b in zip(grads16, seq16_grads):
        assert a.dtype == torch.float32
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_unknown_policy_raises_naming_the_four():
    with pytest.raises(ValueError, match="'full', 'flash', 'flash_qkv', 'flash_qkv_ff'"):
        ttr.remat_names("flash_ff")
    assert ttr.remat_names("full") == ()
    cfg = tdalle.DALLEConfig(**dict(MODEL, depth=1), execution="remat", remat_policy="qkv")
    model = tdalle.init_dalle(cfg, torch.Generator().manual_seed(0), device="cpu").requires_grad_(True)
    text, codes = _inputs()
    with pytest.raises(ValueError, match="remat_policy 'qkv' is not valid"):
        tdalle.forward(model, torch.from_numpy(text), torch.from_numpy(codes), return_loss=True)


def test_policy_keeps_the_flash_operator_and_tagged_regions():
    """What a layer's first run keeps, in order, and that its recompute
    takes each back: the flash forward's (out, lse) under every selective
    policy, the qkv projection (b, n, 3·h·d) from flash_qkv on, the two
    up-projections (b, n, 4·dim) under flash_qkv_ff only."""
    cfg = tdalle.DALLEConfig(**MODEL, execution="remat")
    model = tdalle.init_dalle(cfg, torch.Generator().manual_seed(0), device="cpu").requires_grad_(True)
    tr = model.transformer
    n = cfg.total_seq_len
    b, h, d, dim = 2, MODEL["heads"], MODEL["dim_head"], MODEL["dim"]
    x = torch.randn(b, n, dim, requires_grad=True, generator=torch.Generator().manual_seed(1))
    args = (tr.cfg, x, "full", tr.rotary(x.device), None, None, None, False, (None, None),
            tr.attention_inputs(ttr._pattern_key(tr.specs[0]), n, True, x.device))
    qkv, flash, ff = [(b, n, 3 * h * d)], [((b * h, n, d), (b * h, n))], [(b, n, 4 * dim)] * 2
    for policy, want in (("flash", flash), ("flash_qkv", qkv + flash), ("flash_qkv_ff", qkv + flash + ff)):
        run = ttr.remat_run(tr.layers[0], ttr.remat_names(policy))
        y = torch.utils.checkpoint.checkpoint(run, *args, use_reentrant=False)
        shapes = [tuple(t.shape for t in v) if isinstance(v, tuple) else v.shape for v in run.kept.values]
        assert shapes == want, (policy, shapes)
        assert not any(t.requires_grad for v in run.kept.values for t in (v if isinstance(v, tuple) else (v,)))
        taken = []
        real = run.kept.take
        run.kept.take = lambda name, compute: taken.append(name) or real(name, compute)
        y.sum().backward()
        assert len(taken) == len(want), (policy, taken)
