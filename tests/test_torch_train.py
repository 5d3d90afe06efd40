"""The port's training path against the JAX package's, on the CPU.

Inputs and weights come from numpy or from the JAX package's seeded init and
go through both packages: the gradients of the ops and of the whole DALL-E
loss (the JAX side through the Pallas flash backward in interpret mode), the
train step with Adam, clipping, accumulation, loss scaling and the bad-step
guard, the checkpoint writer and the training CLI.  Dropout is compared only
within the port: torch cannot draw JAX's threefry bits."""
import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from dalle_pytorch_tpu.core import module as jmod  # noqa: E402
from dalle_pytorch_tpu.models import dalle as jdalle  # noqa: E402
from dalle_pytorch_tpu.ops import rotary as jrot  # noqa: E402
from dalle_pytorch_tpu.ops import shift as jshift  # noqa: E402
from dalle_pytorch_tpu.parallel import train_step as jts  # noqa: E402
from dalle_pytorch_tpu_torch import weights  # noqa: E402
from dalle_pytorch_tpu_torch.cli import train_dalle as tcli  # noqa: E402
from dalle_pytorch_tpu_torch.core import module as tmod  # noqa: E402
from dalle_pytorch_tpu_torch.models import dalle as tdalle  # noqa: E402
from dalle_pytorch_tpu_torch.ops import rotary as trot  # noqa: E402
from dalle_pytorch_tpu_torch.ops import shift as tshift  # noqa: E402
from dalle_pytorch_tpu_torch.parallel import train_step as tts  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
REL = 1e-5  # f32 gradients: max abs difference over the reference's max abs value
# seq 128 = text 64 + an 8 x 8 map: the JAX side runs its Pallas flash kernels
LOSS_CFG = dict(dim=64, depth=2, heads=2, dim_head=32, num_text_tokens=50, text_seq_len=64,
                num_image_tokens=32, image_fmap_size=8, shift_tokens=True)
# seq 16: the JAX side runs dense attention, which keeps its jit quick
STEP_CFG = dict(dim=32, depth=1, heads=2, dim_head=16, num_text_tokens=30, text_seq_len=7,
                num_image_tokens=16, image_fmap_size=3, shift_tokens=True)


def _pairs(port, ref):
    """(port leaf, reference leaf) over two trees of the same structure."""
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


def _rel_err(port, ref) -> float:
    return float(np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30))


def _grad_of(port_fn, jax_fn, xs, g):
    """d/dxs sum(fn(*xs) * g) in both packages."""
    txs = [torch.from_numpy(x).requires_grad_(True) for x in xs]
    (port_fn(*txs) * torch.from_numpy(g)).sum().backward()
    ref = jax.grad(lambda *a: jnp.sum(jax_fn(*a) * jnp.asarray(g)), argnums=tuple(range(len(xs))))(
        *(jnp.asarray(x) for x in xs))
    return [t.grad.numpy() for t in txs], [np.asarray(r) for r in ref]


# ---------------------------------------------------------------------------
# gradients of the ops and of the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", ["token_shift", "rotary", "layer_norm"])
def test_op_gradients_match_jax(op):
    """The JAX token shift has a custom_vjp; the port relies on autograd.
    atol 1e-5 (f32, other summation orders)."""
    rng = np.random.default_rng(0)
    if op == "token_shift":
        x = rng.standard_normal((2, 23, 64)).astype(np.float32)
        port, ref = _grad_of(lambda t: tshift.token_shift(t, 31, 4), lambda a: jshift.token_shift(a, 31, 4),
                             [x], rng.standard_normal(x.shape).astype(np.float32))
    elif op == "rotary":
        ang = np.array(jrot.build_dalle_rotary(40, 16, 4))
        t = rng.standard_normal((2, 3, 2, ang.shape[0], 40)).astype(np.float32)
        port, ref = _grad_of(lambda x: trot.apply_rotary(torch.from_numpy(ang), x),
                             lambda x: jrot.apply_rotary(jnp.asarray(ang), x),
                             [t], rng.standard_normal(t.shape).astype(np.float32))
    else:
        x = rng.standard_normal((2, 5, 48)).astype(np.float32)
        scale, bias = (rng.standard_normal(48).astype(np.float32) for _ in range(2))
        port, ref = _grad_of(lambda a, s, b: tmod.layer_norm(a, s, b),
                             lambda a, s, b: jmod.layer_norm({"scale": s, "bias": b}, a),
                             [x, scale, bias], rng.standard_normal(x.shape).astype(np.float32))
    for p, r in zip(port, ref):
        np.testing.assert_allclose(p, r, atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def loss_model():
    jcfg = jdalle.DALLEConfig(**LOSS_CFG, attn_kernel="flash")
    params = jax.device_get(jdalle.init_dalle(jax.random.PRNGKey(0), jcfg))
    model = weights.load_dalle(params, tdalle.DALLEConfig(**LOSS_CFG), device="cpu")
    rng = np.random.default_rng(1)
    text = rng.integers(0, LOSS_CFG["num_text_tokens"], (2, LOSS_CFG["text_seq_len"]))
    text[1, 40:] = 0  # padding
    codes = rng.integers(0, LOSS_CFG["num_image_tokens"], (2, LOSS_CFG["image_fmap_size"] ** 2))
    return jcfg, params, model, text, codes


def test_dalle_loss_gradients_match_jax(loss_model):
    """Every parameter's gradient of the weighted CE, mapped through the
    inverse weight map, against jax.grad (Pallas backward), to 1e-5 of the
    leaf's largest value."""
    jcfg, params, model, text, codes = loss_model
    model.requires_grad_(True)
    loss = tdalle.forward(model, torch.from_numpy(text), torch.from_numpy(codes), return_loss=True)
    loss.backward()
    grads = weights.dalle_tree({n: p.grad for n, p in model.named_parameters()}, model.cfg)
    ref_loss, ref = jax.jit(jax.value_and_grad(
        lambda p: jdalle.forward(p, jcfg, jnp.asarray(text), jnp.asarray(codes), return_loss=True)))(params)
    assert abs(loss.item() - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
    n = 0
    for port, r in _pairs(grads, ref):
        assert _rel_err(port, r) <= REL, (n, _rel_err(port, r))
        n += 1
    assert n == 15 * LOSS_CFG["depth"] + 6  # per layer 6 norm/scale + 9 linear leaves; head + embeddings


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


def _step_batches(poison_step=None):
    rng = np.random.default_rng(2)
    out = []
    for i in range(3):
        text = rng.integers(0, STEP_CFG["num_text_tokens"], (4, STEP_CFG["text_seq_len"])).astype(np.int32)
        codes = rng.integers(0, STEP_CFG["num_image_tokens"], (4, STEP_CFG["image_fmap_size"] ** 2))
        poison = np.full((4,), float(i == poison_step), np.float32)
        out.append({"text": text, "codes": codes.astype(np.int32), "poison": poison})
    return out


def _jax_run(params, jcfg, batches, settings):
    def loss_fn(p, batch, key):
        loss = jdalle.forward(p, jcfg, batch["text"], batch["codes"], return_loss=True)
        return loss * jnp.where(batch["poison"][0] > 0, jnp.nan, 1.0)

    init_fn, step_fn = jts.make_train_step(loss_fn, optax.adam(3e-4), mesh=None, settings=settings)
    state = init_fn(jax.tree_util.tree_map(jnp.asarray, params))
    metrics, snapshots = [], []
    for batch in batches:
        state, m = step_fn(state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
        metrics.append(jax.device_get(m))
        snapshots.append(jax.device_get(state.params))
    return metrics, snapshots


def _port_run(params, batches, settings):
    model = weights.load_dalle(params, tdalle.DALLEConfig(**STEP_CFG), device="cpu")
    model.requires_grad_(True)

    def loss_fn(p, batch, generator):
        loss = torch.func.functional_call(model, p, (batch["text"], batch["codes"]), {"return_loss": True})
        return loss * (float("nan") if batch["poison"][0] > 0 else 1.0)

    init_fn, step_fn = tts.make_train_step(
        loss_fn, functools.partial(torch.optim.Adam, lr=3e-4, betas=(0.9, 0.999), eps=1e-8), settings)
    state = init_fn(dict(model.named_parameters()))
    metrics, snapshots, moments = [], [], []
    for batch in batches:
        state, m = step_fn(state, {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
                                   for k, v in batch.items()})
        metrics.append(m)
        snapshots.append(weights.dalle_tree(model.state_dict(), model.cfg))
        moments.append([s["exp_avg"].clone() for s in state.opt_state.state.values()])
    return metrics, snapshots, moments


@pytest.mark.parametrize("case", ["plain", "grad_accum", "dynamic_scale", "nan_step"])
def test_train_step_matches_jax(case):
    """Three steps of Adam 3e-4 with clip 0.5 on identical weights and
    batches, dropout 0.  Loss and grad norm agree to 1e-5 relative each
    step; the final parameters to 2e-6 absolute (Adam steps are ~3e-4, and
    both packages take the same signs).  A NaN loss on step 2 skips its
    update in both: parameters and moments stay as step 1 left them."""
    jcfg = jdalle.DALLEConfig(**STEP_CFG)
    params = jax.device_get(jdalle.init_dalle(jax.random.PRNGKey(3), jcfg))
    batches = _step_batches(poison_step=1 if case == "nan_step" else None)
    accum = 2 if case == "grad_accum" else 1
    scale = "dynamic" if case == "dynamic_scale" else None
    ref_metrics, ref_params = _jax_run(
        params, jcfg, batches, jts.StepSettings(grad_accum=accum, clip_grad_norm=0.5, loss_scale=scale))
    metrics, port_params, moments = _port_run(
        params, batches, tts.StepSettings(grad_accum=accum, clip_grad_norm=0.5, loss_scale=scale))
    for i, (m, r) in enumerate(zip(metrics, ref_metrics)):
        assert m["skipped"] == int(r["skipped"])
        if case == "nan_step" and i == 1:
            assert m["skipped"] == 1 and not np.isfinite(float(m["loss"]))
            continue
        for key in ("loss", "grad_norm"):
            assert abs(float(m[key]) - float(r[key])) <= 1e-5 * abs(float(r[key])), (i, key)
        if scale is not None:
            assert m["loss_scale"] == float(r["loss_scale"])
    for port, r in _pairs(port_params[-1], ref_params[-1]):
        np.testing.assert_allclose(port, r, atol=2e-6, rtol=0)
    if case == "nan_step":
        for port, before in _pairs(port_params[1], port_params[0]):
            np.testing.assert_array_equal(port, before)
        for port, before in _pairs(ref_params[1], ref_params[0]):
            np.testing.assert_array_equal(port, before)
        for a, b in zip(moments[1], moments[0]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_adam_matches_optax_step_by_step():
    """torch.optim.Adam(betas=(0.9, 0.999), eps=1e-8) against optax.adam on
    the same gradients, five steps, to 1e-6 (a few f32 ulps: the two
    divide in other orders)."""
    rng = np.random.default_rng(4)
    p0 = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (5,), (2, 2, 2))]
    tparams = [torch.from_numpy(p.copy()).requires_grad_(True) for p in p0]
    opt = torch.optim.Adam(tparams, lr=1e-2, betas=(0.9, 0.999), eps=1e-8)
    tx = optax.adam(1e-2)
    jparams = [jnp.asarray(p) for p in p0]
    jstate = tx.init(jparams)
    for _ in range(5):
        grads = [(rng.standard_normal(p.shape) * 10.0 ** rng.integers(-3, 2)).astype(np.float32) for p in p0]
        for t, g in zip(tparams, grads):
            t.grad = torch.from_numpy(g)
        opt.step()
        updates, jstate = tx.update([jnp.asarray(g) for g in grads], jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for t, j in zip(tparams, jparams):
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=1e-6, rtol=0)


@pytest.mark.parametrize("setting", ["with_health"])
def test_train_step_refuses_what_waits(setting):
    """The with_health step still waits (a mesh's sp and pp axes train now:
    `tests/test_torch_seq_parallel.py`, `tests/test_torch_pipeline.py`)."""
    opt = functools.partial(torch.optim.Adam, lr=1e-3)
    with pytest.raises(NotImplementedError, match="later PR"):
        init_fn, step_fn = tts.make_train_step(lambda p, b, g: p["w"].sum(), opt)
        state = init_fn({"w": torch.zeros(2)})
        step_fn(state, {"x": torch.zeros(1)}, with_health=True)


def test_zero_stage_without_a_mesh_is_the_one_process_step():
    """As in the JAX package, the ZeRO stage shards over a mesh's fsdp axis
    and changes nothing without one; a mesh takes a grouped optimizer."""
    from dalle_pytorch_tpu_torch.optim.grouped import Adam

    def run(stage):
        w = torch.nn.Parameter(torch.linspace(-1.0, 1.0, 6))
        init_fn, step_fn = tts.make_train_step(lambda p, b, g: (p["w"] * b["x"]).square().sum(), Adam(1e-2),
                                               tts.StepSettings(zero_stage=stage))
        state = init_fn({"w": w})
        for _ in range(3):
            state, _ = step_fn(state, {"x": torch.arange(6.0)})
        return w.detach()

    assert torch.equal(run(3), run(0))
    with pytest.raises(ValueError, match="grouped optimizer"):
        tts.make_train_step(lambda p, b, g: p["w"].sum(), functools.partial(torch.optim.Adam, lr=1e-3),
                            mesh=object())


def test_unguarded_step_applies_a_nonfinite_update():
    """skip_nonfinite=False: the update runs even on a NaN gradient (no
    `skipped` metric), where the default guard would skip it."""
    for skip, want_nan in ((None, False), (False, True)):
        w = torch.ones(2)
        init_fn, step_fn = tts.make_train_step(lambda p, b, g: (p["w"] * b["x"]).sum(),
                                               functools.partial(torch.optim.SGD, lr=0.1),
                                               tts.StepSettings(skip_nonfinite=skip))
        state, metrics = step_fn(init_fn({"w": w}), {"x": torch.tensor([1.0, float("nan")])})
        assert bool(torch.isnan(w).any()) == want_nan and ("skipped" in metrics) == (not want_nan)


def test_bf16_compute_keeps_f32_masters():
    """compute_dtype bf16: the loss sees bf16 weights, the gradient lands on
    the f32 master, and the update is applied there."""
    w = torch.ones(3)
    seen = []

    def loss_fn(p, batch, generator):
        seen.append(p["w"].dtype)
        return (p["w"] * batch["x"]).sum()

    init_fn, step_fn = tts.make_train_step(loss_fn, functools.partial(torch.optim.SGD, lr=0.5),
                                           tts.StepSettings(compute_dtype=torch.bfloat16))
    state = init_fn({"w": w})
    state, metrics = step_fn(state, {"x": torch.tensor([1.0, 2.0, 4.0])})
    assert seen == [torch.bfloat16] and w.dtype == torch.float32
    torch.testing.assert_close(w.detach(), torch.tensor([0.5, 0.0, -1.0]))
    assert float(metrics["grad_norm"]) == pytest.approx(21 ** 0.5)


# ---------------------------------------------------------------------------
# dropout, remat, null conditioning
# ---------------------------------------------------------------------------


def test_dropout_keeps_rate_and_inverted_scale():
    x = torch.ones(200_000)
    y = tmod.dropout(x, 0.25, torch.Generator().manual_seed(0))
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.75) < 0.01
    assert torch.all(y[kept] == 1 / 0.75)
    assert tmod.dropout(x, 0.0, torch.Generator()) is x and tmod.dropout(x, 0.25, None) is x
    z = tmod.dropout(x, 0.25, torch.Generator().manual_seed(0))
    torch.testing.assert_close(y, z, rtol=0, atol=0)


def _dropout_model(execution):
    cfg = tdalle.DALLEConfig(**STEP_CFG, attn_dropout=0.3, ff_dropout=0.3, execution=execution)
    model = tdalle.init_dalle(cfg, torch.Generator().manual_seed(5), device="cpu")
    return model.train().requires_grad_(True)


def _loss_and_grads(model, seed):
    rng = np.random.default_rng(6)
    text = torch.from_numpy(rng.integers(0, 30, (2, 7)))
    codes = torch.from_numpy(rng.integers(0, 16, (2, 9)))
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    loss = tdalle.forward(model, text, codes, return_loss=True, generator=gen)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return loss.detach(), grads


def test_remat_gradients_equal_sequential_with_dropout():
    """The remat recompute rebuilds each layer's dropout generator from its
    seed, so it draws the masks of the first pass: same loss, same
    gradients.  Dropout really is on: another seed gives another loss."""
    seq_loss, seq_grads = _loss_and_grads(_dropout_model("sequential"), 7)
    remat_loss, remat_grads = _loss_and_grads(_dropout_model("remat"), 7)
    torch.testing.assert_close(remat_loss, seq_loss, rtol=0, atol=0)
    for a, b in zip(remat_grads, seq_grads):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-7)
    other, _ = _loss_and_grads(_dropout_model("sequential"), 8)
    plain, _ = _loss_and_grads(_dropout_model("sequential"), None)
    assert other.item() != seq_loss.item() and plain.item() != seq_loss.item()


def test_remat_recomputes_on_the_bf16_working_copy():
    """A bf16-compute train step of a remat model recomputes each layer on
    the step's bf16 working copy (the module holds its f32 masters again by
    the backward): loss and gradients equal the sequential model's."""
    results = []
    for execution in ("sequential", "remat"):
        cfg = tdalle.DALLEConfig(**dict(STEP_CFG, depth=2), execution=execution)
        model = tdalle.init_dalle(cfg, torch.Generator().manual_seed(0), device="cpu").requires_grad_(True)
        params = {name: p.to(torch.bfloat16) for name, p in model.named_parameters()}
        text, codes = torch.ones(2, 7, dtype=torch.long), torch.arange(18).reshape(2, 9) % 16
        loss = torch.func.functional_call(model, params, (text, codes), {"return_loss": True})
        loss.backward()
        results.append((loss.detach(), [p.grad for p in model.parameters()]))
    (seq_loss, seq_grads), (remat_loss, remat_grads) = results
    torch.testing.assert_close(remat_loss, seq_loss, rtol=0, atol=0)
    for a, b in zip(remat_grads, seq_grads):
        assert a.dtype == torch.float32
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_selective_remat_policy_waits():
    """An unknown remat policy raises ValueError naming the four when a
    gradient is taken; inference does not rematerialise, so it runs under
    any policy, the known ones included."""
    text, codes = torch.ones(1, 7, dtype=torch.long), torch.zeros(1, 9, dtype=torch.long)
    cfg = tdalle.DALLEConfig(**STEP_CFG, execution="remat", remat_policy="selective")
    model = tdalle.init_dalle(cfg, torch.Generator().manual_seed(0), device="cpu").requires_grad_(True)
    with pytest.raises(ValueError, match="'full', 'flash', 'flash_qkv', 'flash_qkv_ff'"):
        tdalle.forward(model, text, codes, return_loss=True)
    for policy in ("selective", "full", "flash", "flash_qkv", "flash_qkv_ff"):
        model.transformer.cfg = dataclasses.replace(model.transformer.cfg, remat_policy=policy)
        with torch.no_grad():  # inference does not rematerialise
            assert torch.isfinite(tdalle.forward(model, text, codes, return_loss=True))


def test_null_cond_blanks_every_caption_at_prob_one():
    model = tdalle.init_dalle(tdalle.DALLEConfig(**STEP_CFG), torch.Generator().manual_seed(0), device="cpu")
    text = torch.randint(1, 30, (3, 7), generator=torch.Generator().manual_seed(1))
    codes = torch.zeros(3, 9, dtype=torch.long)
    blanked = tdalle.forward(model, text, codes, return_loss=True, null_cond_prob=1.0,
                             generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close(blanked, tdalle.forward(model, torch.zeros_like(text), codes, return_loss=True))
    with pytest.raises(ValueError, match="generator"):
        tdalle.forward(model, text, codes, return_loss=True, null_cond_prob=0.5)


# ---------------------------------------------------------------------------
# checkpoint and CLI
# ---------------------------------------------------------------------------


def test_cli_checkpoint_loads_in_jax(tmp_path):
    """A checkpoint written by the port's trainer loads in the JAX package's
    load_checkpoint: the JAX forward on it gives the port's logits to 1e-5,
    its VAE gives the port's codes, and Adam's moments come as trees of the
    parameters' structure."""
    from dalle_pytorch_tpu.models import vae as jvae
    from dalle_pytorch_tpu.training.checkpoint import load_checkpoint, unflatten_like
    from dalle_pytorch_tpu_torch.models import vae as tvae

    out = str(tmp_path / "run")
    assert tcli.main(["--dummy_run", "2", "--device", "cpu", "--telemetry", "off", "--shift_tokens",
                      "--dalle_output_file_name", out]) == 0
    trees, meta = load_checkpoint(out + ".pt")
    jcfg = jdalle.DALLEConfig.from_dict(meta["hparams"])
    vcfg = jvae.DiscreteVAEConfig(**{k: v for k, v in meta["vae_params"].items() if k != "normalization"})
    assert meta["global_step"] == 2 and meta["vae_class_name"] == "DiscreteVAE"
    model, vae = weights.load_dalle_checkpoint(out + ".pt", device="cpu")
    rng = np.random.default_rng(7)
    text = rng.integers(0, jcfg.num_text_tokens, (2, jcfg.text_seq_len))
    codes = rng.integers(0, jcfg.num_image_tokens, (2, jcfg.image_seq_len))
    with torch.no_grad():
        port = tdalle.forward(model, torch.from_numpy(text), torch.from_numpy(codes)).numpy()
    ref = np.asarray(jdalle.forward(trees["weights"], jcfg, jnp.asarray(text), jnp.asarray(codes)))
    np.testing.assert_allclose(port, ref, atol=1e-5, rtol=0)
    pixels = rng.random((2, vcfg.image_size, vcfg.image_size, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tvae.get_codebook_indices(vae, torch.from_numpy(pixels)).numpy(),
        np.asarray(jvae.get_codebook_indices(trees["vae_weights"], vcfg, jnp.asarray(pixels))))
    # the optimizer state in optax's layout: the JAX CLI's template restores it
    opt = unflatten_like(optax.adam(3e-4).init(trees["weights"]), trees["opt_state"])[0]
    assert int(opt.count) == 2
    assert (jax.tree_util.tree_structure(opt.mu) == jax.tree_util.tree_structure(trees["weights"])
            == jax.tree_util.tree_structure(opt.nu))


def test_cli_dummy_run_exits_zero(tmp_path):
    """`python -m dalle_pytorch_tpu_torch.cli.train_dalle --dummy_run 3
    --device cpu` trains three steps with a finite loss each and writes its
    checkpoint."""
    out = tmp_path / "dalle"
    proc = subprocess.run(
        [sys.executable, "-m", "dalle_pytorch_tpu_torch.cli.train_dalle", "--dummy_run", "3", "--telemetry", "off",
         "--device", "cpu", "--dalle_output_file_name", str(out)],
        capture_output=True, text=True, cwd=REPO, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(REPO)),
    )
    assert proc.returncode == 0, proc.stderr
    steps = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith('{"step"')]
    # the JAX CLI's dummy batch: 2 x the devices the run uses (one), the last one ragged
    assert [s["step"] for s in steps] == [1, 2, 3] and [s["batch"] for s in steps] == [2, 2, 1]
    assert all(np.isfinite(s["loss"]) for s in steps)
    assert (tmp_path / "dalle.pt").exists()


# each flag that used to wait, beside what still refuses on its path: the
# folder without a VAE where OpenAI's dVAE is neither in the cache nor
# fetchable (the fetch is injected: no network), --resume beside
# --dalle_path, --lr_decay with the Hugging Face tokenizer, a remote shard
# spec, no data at all
_REFUSED = {
    "--image_text_folder": (["--image_text_folder", "data"], "OpenAI's pretrained dVAE is not in the cache .*"
                                                              "fetching it failed"),
    "--resume": (["--resume", "auto", "--dalle_path", "x.pt", "--dummy_run", "1"], "mutually exclusive"),
    "--lr_decay": (["--lr_decay", "--hug", "--dummy_run", "1"], "Hugging Face tokenizer.*item 4"),
    # a mesh of dp 2 x sp 2 in one process: launch its 4 ranks (sp and pp train: tests/test_torch_mesh_cli.py)
    "--mesh_dp": (["--mesh_dp", "2", "--mesh_sp", "2", "--dummy_run", "1"], "a mesh of 4 ranks runs one process per "
                                                                              "device: launch 4 processes"),
    "--wds": (["--wds", "--image_text_folder", "gs://bucket/s-{0..3}.tar"], "remote tar shards.*item 10"),
}


@pytest.mark.parametrize("argv", [["--image_text_folder", "data"], ["--resume", "auto"], ["--lr_decay"],
                                  ["--mesh_dp", "2"], ["--wds"], []])
def test_cli_refuses_flags_that_wait(argv, tmp_path, monkeypatch):
    from dalle_pytorch_tpu_torch.models import pretrained

    def no_network(url, dst):
        raise OSError(f"no network to fetch {url}")

    monkeypatch.setenv("DALLE_PYTORCH_TPU_CACHE", str(tmp_path))
    monkeypatch.setattr(pretrained, "_urllib_fetch", no_network)
    argv, match = _REFUSED[argv[0]] if argv else ([], "--image_text_folder is required")
    with pytest.raises(SystemExit, match=match):
        tcli.main(argv + ["--device", "cpu"])
