"""Low-precision parameter storage in the port's train step against the JAX
package's, on the CPU: `stochastic_round` bit for bit against JAX
`_stochastic_round` under the same bits, unbiased and exact; bf16 storage
with Adafactor training with no f32 master; the whole step
(`param_dtype=bf16`, `grad_dtype=bf16`, Adafactor) against JAX
`make_train_step` over 3 steps, with the rounding bits built from JAX's key
chain and handed to the port (`round_bits`: torch cannot draw threefry);
the bad-step guard; and the training CLI's `--remat_policy` and
`--param_dtype`."""
import functools
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from dalle_pytorch_tpu.models import dalle as jdalle  # noqa: E402
from dalle_pytorch_tpu.parallel import train_step as jts  # noqa: E402
from dalle_pytorch_tpu_torch import weights  # noqa: E402
from dalle_pytorch_tpu_torch.cli import train_dalle as tcli  # noqa: E402
from dalle_pytorch_tpu_torch.models import dalle as tdalle  # noqa: E402
from dalle_pytorch_tpu_torch.optim.adafactor import Adafactor  # noqa: E402
from dalle_pytorch_tpu_torch.optim.grouped import GroupedState  # noqa: E402
from dalle_pytorch_tpu_torch.parallel import train_step as tts  # noqa: E402

# seq 16 (the JAX side attends densely and jits quickly); dim 128 so that
# qkv and the GEGLU weights take Adafactor's factored statistics
STEP = dict(dim=128, depth=1, heads=2, dim_head=32, num_text_tokens=30, text_seq_len=7,
            num_image_tokens=16, image_fmap_size=3, shift_tokens=True)
DIFFER_AT_MOST = 1e-4  # of the elements (f32 gradients summed in other orders)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small products gain nothing from torch's threads, and where the suite
    runs in several processes those threads only compete for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_bits(key, x):
    return np.asarray(jax.random.bits(key, x.shape, jnp.uint32) & jnp.uint32(0xFFFF))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stochastic_round_matches_jax_bit_for_bit(seed):
    """The same f32 inputs and the same 16 bits an element give the same
    bf16 bits: values around 1, tiny, huge, negative, subnormal, zero and
    bf16-exact ones."""
    from dalle_pytorch_tpu.parallel.train_step import _stochastic_round

    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.standard_normal(4096), rng.standard_normal(512) * 1e-30,
                        rng.standard_normal(512) * 1e30, [0.0, -0.0, 1.0, -2.5, 3.140625, 1e-41, -1e-41]])
    x = x.astype(np.float32)
    key = jax.random.PRNGKey(seed)
    ref = np.asarray(_stochastic_round(jnp.asarray(x), key, jnp.bfloat16).view(jnp.uint16))
    got = tts.stochastic_round(torch.from_numpy(x), torch.from_numpy(_jax_bits(key, x).astype(np.int32)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16), ref)
    # round to nearest, the step's other rounding, as JAX's astype
    nearest = torch.from_numpy(x).to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(nearest, np.asarray(jnp.asarray(x).astype(jnp.bfloat16).view(jnp.uint16)))


def test_stochastic_round_is_unbiased_and_exact():
    """Values bf16 holds exactly pass through under any bits; a value a
    quarter of the way between two bf16 neighbours rounds up about a quarter
    of the time (the generator's draw), never to anything else."""
    x = torch.tensor([1.0, -2.5, 0.0, 3.140625])
    for seed in range(3):
        got = tts.stochastic_round(x, generator=torch.Generator().manual_seed(seed))
        torch.testing.assert_close(got.float(), x, rtol=0, atol=0)
    lo = 1.0
    hi = float(torch.nextafter(torch.tensor(1.0, dtype=torch.bfloat16), torch.tensor(2.0, dtype=torch.bfloat16)))
    x = torch.full((4096,), lo + 0.25 * (hi - lo))
    got = tts.stochastic_round(x, generator=torch.Generator().manual_seed(7)).float()
    assert abs((got == hi).float().mean().item() - 0.25) < 0.03
    assert set(got.unique().tolist()) <= {lo, hi}


def _tiny_model(**kw):
    cfg = tdalle.DALLEConfig(dim=32, depth=2, num_text_tokens=64, text_seq_len=8, heads=4, dim_head=8,
                             num_image_tokens=32, image_fmap_size=4, **kw)
    return tdalle.init_dalle(cfg, torch.Generator().manual_seed(0), device="cpu")


def _tiny_batch(model, b=8):
    gen = torch.Generator().manual_seed(0)
    cfg = model.cfg
    return {"text": torch.randint(0, cfg.num_text_tokens, (b, cfg.text_seq_len), generator=gen),
            "image_codes": torch.randint(0, cfg.num_image_tokens, (b, cfg.image_seq_len), generator=gen)}


def _functional_loss(model):
    def loss_fn(params, batch, generator):
        return torch.func.functional_call(model, params, (batch["text"], batch["image_codes"]),
                                          {"return_loss": True})

    return loss_fn


def test_pure_bf16_params_with_stochastic_rounding():
    """param_dtype=bf16: the model's own parameters become bf16 (no f32
    master exists), Adafactor's statistics stay f32, and training at a small
    learning rate still makes progress."""
    model = _tiny_model()
    batch = _tiny_batch(model)
    init_fn, step_fn = tts.make_train_step(
        _functional_loss(model), Adafactor(3e-3),
        tts.StepSettings(compute_dtype=torch.bfloat16, grad_dtype=torch.bfloat16, param_dtype=torch.bfloat16))
    state = init_fn(dict(model.named_parameters()))
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    assert model.logits_linear.weight.dtype == torch.bfloat16
    assert {t.dtype for g in state.opt_state.groups for t in g.stats.values()} == {torch.float32}
    first = None
    for _ in range(30):
        state, m = step_fn(state, batch)
        first = float(m["loss"]) if first is None else first
    assert np.isfinite(float(m["loss"])) and float(m["loss"]) < first
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}


def test_nonfinite_step_leaves_bf16_params_and_state_untouched():
    model = _tiny_model()
    batch = _tiny_batch(model)
    loss_fn = _functional_loss(model)

    def poisoned(params, b, generator):
        return loss_fn(params, b, generator) * (float("nan") if b.get("poison") is not None else 1.0)

    init_fn, step_fn = tts.make_train_step(
        poisoned, Adafactor(1e-3), tts.StepSettings(grad_dtype=torch.bfloat16, param_dtype=torch.bfloat16))
    state, _ = step_fn(init_fn(dict(model.named_parameters())), batch)
    params = {n: p.clone() for n, p in model.named_parameters()}
    stats = [{k: v.clone() for k, v in g.stats.items()} for g in state.opt_state.groups]
    state, m = step_fn(state, dict(batch, poison=torch.zeros(8)))
    assert m["skipped"] == 1 and state.opt_state.count == 1
    for n, p in model.named_parameters():
        assert torch.equal(p, params[n])
    for g, before in zip(state.opt_state.groups, stats):
        for k, v in g.stats.items():
            assert torch.equal(v, before[k])


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_loss_scale_reports_the_unscaled_loss(grad_accum):
    """Under a dynamic loss scale the grouped path reports the loss and the
    gradient norm of the unscaled run, with or without accumulation: the
    scale (a power of two) divides the gradients only."""
    batch = _tiny_batch(_tiny_model())
    out = []
    for loss_scale in (None, "dynamic"):
        model = _tiny_model()
        init_fn, step_fn = tts.make_train_step(
            _functional_loss(model), Adafactor(1e-3),
            tts.StepSettings(grad_accum=grad_accum, grad_dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                             loss_scale=loss_scale))
        _, m = step_fn(init_fn(dict(model.named_parameters())), batch)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    (loss, gnorm), (scaled_loss, scaled_gnorm) = out
    assert scaled_loss == loss
    assert scaled_gnorm == pytest.approx(gnorm, rel=1e-6)


@pytest.mark.parametrize("kwargs,match", [
    (dict(param_dtype=torch.float16), "bfloat16"),
    (dict(stochastic_round=True), "low-precision"),
    (dict(param_dtype=torch.bfloat16, optimizer="torch"), "grouped optimizer"),
    (dict(grad_dtype=torch.bfloat16, optimizer="torch"), "grouped optimizer"),
])
def test_lowp_settings_refused(kwargs, match):
    """What the JAX package raises for another low-precision dtype and for
    stochastic_round over f32; torch.optim cannot serve bf16 storage or
    gradients."""
    kwargs = dict(kwargs)
    opt = Adafactor(1e-3) if kwargs.pop("optimizer", None) is None else functools.partial(torch.optim.SGD, lr=0.1)
    with pytest.raises(ValueError, match=match):
        tts.make_train_step(lambda p, b, g: p["w"].sum(), opt, tts.StepSettings(**kwargs))


# ---------------------------------------------------------------------------
# the whole step against the JAX package's
# ---------------------------------------------------------------------------


def _batches():
    rng = np.random.default_rng(2)
    return [{"text": rng.integers(0, STEP["num_text_tokens"], (4, STEP["text_seq_len"])).astype(np.int32),
             "codes": rng.integers(0, STEP["num_image_tokens"], (4, STEP["image_fmap_size"] ** 2)).astype(np.int32)}
            for _ in range(3)]


def _jax_run(params, jcfg, batches, settings):
    """The JAX step, and per step the rounding bits its key chain draws
    (split the step key, then one key a leaf in tree order), as port state
    dict entries."""
    def loss_fn(p, batch, key):
        return jdalle.forward(p, jcfg, batch["text"], batch["codes"], return_loss=True)

    init_fn, step_fn = jts.make_train_step(loss_fn, optax.adafactor(1e-3), mesh=None, settings=settings)
    state = init_fn(jax.tree_util.tree_map(jnp.asarray, params))
    leaves, treedef = jax.tree_util.tree_flatten(state.params)
    metrics, snapshots, bits = [], [jax.tree_util.tree_map(np.array, jax.device_get(state.params))], []
    for i, batch in enumerate(batches):
        key = jax.random.PRNGKey(10 + i)
        round_key = jax.random.split(key)[1]
        keys = jax.random.split(round_key, len(leaves))
        tree = treedef.unflatten([_jax_bits(k, x).astype(np.int32) for k, x in zip(keys, leaves)])
        bits.append(weights.dalle_state_dict(tree, tdalle.DALLEConfig(**STEP)))
        state, m = step_fn(state, {k: jnp.asarray(v) for k, v in batch.items()}, key)
        metrics.append(jax.device_get(m))
        # copies: the next step donates these buffers
        snapshots.append(jax.tree_util.tree_map(np.array, jax.device_get(state.params)))
    return metrics, snapshots, bits


def _port_run(params, batches, settings, bits):
    model = weights.load_dalle(params, tdalle.DALLEConfig(**STEP), device="cpu")
    init_fn, step_fn = tts.make_train_step(
        lambda p, b, g: torch.func.functional_call(model, p, (b["text"], b["codes"]), {"return_loss": True}),
        Adafactor(1e-3), settings)
    state = init_fn(dict(model.named_parameters()))
    assert isinstance(state.opt_state, GroupedState)
    metrics, snapshots = [], [None]
    for batch, round_bits in zip(batches, bits):
        state, m = step_fn(state, {k: torch.from_numpy(v).long() for k, v in batch.items()}, round_bits=round_bits)
        metrics.append(m)
        snapshots.append(weights.dalle_tree({k: v.clone() for k, v in model.state_dict().items()}, model.cfg))
    return metrics, snapshots


def _f32(x) -> np.ndarray:
    """A bf16 leaf (a torch tensor or a JAX array) as f32, exactly."""
    if isinstance(x, torch.Tensor):
        assert x.dtype == torch.bfloat16
        return x.float().numpy()
    x = np.asarray(x)
    assert x.dtype == jnp.bfloat16
    return x.astype(np.float32)


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The distance from |x| to the next bf16 up (x bf16-exact, f32)."""
    x = np.abs(x).astype(np.float32)
    up = (x.view(np.uint32) + np.uint32(1 << 16)).view(np.float32)
    return up - x


@pytest.mark.parametrize("case", ["stochastic", "stochastic_grad_accum", "nearest"])
def test_lowp_step_matches_jax(case):
    """Three steps of Adafactor 1e-3 with clip 0.5 on bf16 storage, f32
    compute.  Loss and grad norm within 1e-4 relative each step.  With bf16
    gradients and stochastic rounding (under JAX's bits) the bf16
    parameters are equal on all but 1e-4 of the elements after each step,
    each of the rest within one bf16 step: a gradient whose f32 value lies
    within the two frameworks' summation difference of a bf16 rounding
    boundary rounds to the other bf16 and moves its update.  Round to
    nearest (`stochastic_round=False`) over f32 gradients, where both
    packages round the same f32 sums, equal bit for bit."""
    jcfg = jdalle.DALLEConfig(**STEP)
    params = jax.device_get(jdalle.init_dalle(jax.random.PRNGKey(3), jcfg))
    batches = _batches()
    accum = 2 if case == "stochastic_grad_accum" else 1
    nearest = case == "nearest"
    sr = False if nearest else None
    ref_metrics, ref_params, bits = _jax_run(params, jcfg, batches, jts.StepSettings(
        grad_accum=accum, clip_grad_norm=0.5, grad_dtype=jnp.float32 if nearest else jnp.bfloat16,
        param_dtype=jnp.bfloat16, stochastic_round=sr))
    metrics, port_params = _port_run(params, batches, tts.StepSettings(
        grad_accum=accum, clip_grad_norm=0.5, grad_dtype=torch.float32 if nearest else torch.bfloat16,
        param_dtype=torch.bfloat16, stochastic_round=sr), bits)
    for i, (m, r) in enumerate(zip(metrics, ref_metrics)):
        assert m["skipped"] == int(r["skipped"]) == 0
        for key in ("loss", "grad_norm"):
            assert abs(float(m[key]) - float(r[key])) <= 1e-4 * abs(float(r[key])), (i, key)
    for step in range(len(batches)):
        total = differ = 0
        for port, ref, before in zip(*(jax.tree_util.tree_leaves(t) for t in (
                port_params[step + 1], ref_params[step + 1], ref_params[step]))):
            a, b, b0 = _f32(port), _f32(ref), _f32(before)
            total += a.size
            differ += int((a != b).sum())
            # one bf16 step at the larger of the parameter before the update
            # and after it: an update that nearly cancels the parameter
            # leaves a result whose own steps are finer than the update's
            step_size = _bf16_ulp(np.maximum(np.abs(b0), np.abs(b)))
            assert np.all(np.abs(a - b) <= step_size), (step, float(np.abs(a - b).max()))
        if nearest:
            assert differ == 0, (step, differ)
        assert differ <= DIFFER_AT_MOST * total, (step, differ, total)


# ---------------------------------------------------------------------------
# the training CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", ["flash", "flash_qkv", "flash_qkv_ff"])
def test_cli_remat_policy_and_bf16_storage(tmp_path, policy):
    """`--execution remat --remat_policy P --param_dtype bfloat16` trains
    (finite losses) and writes a checkpoint whose weights are bf16 leaves,
    which the JAX package's reader loads, and whose hparams carry the
    policy; Adam's moments, restored through optax's template, are f32
    trees of the weights' structure."""
    import optax
    from dalle_pytorch_tpu.training.checkpoint import load_checkpoint, unflatten_like

    out = str(tmp_path / "run")
    assert tcli.main(["--dummy_run", "2", "--device", "cpu", "--telemetry", "off", "--execution", "remat", "--remat_policy", policy,
                      "--param_dtype", "bfloat16", "--dalle_output_file_name", out]) == 0
    trees, meta = load_checkpoint(out + ".pt")
    assert meta["hparams"]["remat_policy"] == policy and meta["hparams"]["execution"] == "remat"
    assert {np.asarray(x).dtype for x in jax.tree_util.tree_leaves(trees["weights"])} == {np.dtype(jnp.bfloat16)}
    # optax's template of the f32 view, as the JAX CLI builds it for bf16 storage
    f32 = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), trees["weights"])
    opt = unflatten_like(optax.adam(3e-4).init(f32), trees["opt_state"])[0]
    assert int(opt.count) == 2
    assert {np.asarray(x).dtype for x in jax.tree_util.tree_leaves(opt.mu)} == {np.dtype(np.float32)}
    assert jax.tree_util.tree_structure(opt.mu) == jax.tree_util.tree_structure(trees["weights"])
    model, _ = weights.load_dalle_checkpoint(out + ".pt", device="cpu")
    assert model.dtype == torch.bfloat16
    jcfg = jdalle.DALLEConfig.from_dict(meta["hparams"])
    text = np.ones((1, jcfg.text_seq_len), np.int32)
    with torch.no_grad():
        port = tdalle.forward(model, torch.from_numpy(text).long()).float().numpy()
    ref = np.asarray(jdalle.forward(trees["weights"], jcfg, jnp.asarray(text)), np.float32)
    assert np.isfinite(port).all() and np.abs(port - ref).max() <= 0.05 * np.abs(ref).max()


def test_cli_refuses_an_unknown_policy():
    with pytest.raises(SystemExit):
        tcli.main(["--dummy_run", "1", "--device", "cpu", "--remat_policy", "selective"])


# ---------------------------------------------------------------------------
# the numerics smoke
# ---------------------------------------------------------------------------


def test_numerics_smoke_tool(capsys):
    """`python -m dalle_pytorch_tpu_torch.tools.numerics_smoke` at a CPU
    size: one JSON line whose loss falls (a learning rate the few steps
    show); at learning rate 0 the loss does not fall and it exits 2."""
    from dalle_pytorch_tpu_torch.tools import numerics_smoke

    small = ["--dim", "128", "--depth", "1", "--heads", "2", "--dim_head", "32", "--batch", "2",
             "--text_tokens", "100", "--device", "cpu"]
    assert numerics_smoke.main(small + ["--steps", "20", "--lr", "1e-2"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["decreased"] and out["backend"] == "cpu" and out["steps"] == 20
    assert [i for i, _ in out["loss_curve"]] == [0, 5, 10, 15, 19]
    assert out["loss_last_mean4"] < 0.95 * out["loss_first"]
    with pytest.raises(SystemExit) as exc:
        numerics_smoke.main(small + ["--steps", "5", "--lr", "0"])
    assert exc.value.code == 2
    assert not json.loads(capsys.readouterr().out.strip().splitlines()[-1])["decreased"]
