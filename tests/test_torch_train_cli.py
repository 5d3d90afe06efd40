"""The port's training CLI on real data (`cli/train_dalle.py`,
`training/resume.py`, `optim/plateau.py`) against the JAX package's, on
the CPU.

- `--dummy_run` builds the JAX CLI's dummy model and batch
  (`_apply_dummy_run_defaults` on a parsed `--dummy_run`).
- Reduce-on-plateau: the scale sequence and the parameters equal
  `optax.chain(optax.adam, optax.contrib.reduce_on_plateau)` on a loss
  sequence that plateaus.
- A run on a folder of images, resumed from a step checkpoint (weights,
  Adam's moments, the plateau state, the data cursor, the generators),
  gives the uninterrupted run's losses exactly; the JAX package restores
  its optimizer state.
- The port resumes a checkpoint that the JAX CLI's `--dummy_run
  --save_every_n_steps 1` wrote: its next loss is within 1e-5 relative of
  the JAX CLI's loss at that step.
- Rotation keeps the JAX file names; `--resume auto` takes the newest
  checkpoint that loads; the tar-shard path trains; `--taming` trains
  through a taming VQGAN (its files, or the converted cache); a
  torch-reference vae.pt trains; the flags that still wait exit naming
  their ROADMAP.md item."""
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
optax = pytest.importorskip("optax")
import jax.numpy as jnp  # noqa: E402

from dalle_pytorch_tpu.cli import train_dalle as jcli  # noqa: E402
from dalle_pytorch_tpu.models import dalle as jdalle  # noqa: E402
from dalle_pytorch_tpu.models.vae import DiscreteVAEConfig as JaxVAEConfig  # noqa: E402
from dalle_pytorch_tpu.training.checkpoint import load_checkpoint as jax_load  # noqa: E402
from dalle_pytorch_tpu.training.checkpoint import unflatten_like  # noqa: E402
from dalle_pytorch_tpu_torch.cli import train_dalle as tcli  # noqa: E402
from dalle_pytorch_tpu_torch.models import vae as tvae  # noqa: E402
from dalle_pytorch_tpu_torch.optim.grouped import Adam  # noqa: E402
from dalle_pytorch_tpu_torch.optim.plateau import PlateauState, ReduceOnPlateau  # noqa: E402
from dalle_pytorch_tpu_torch.parallel.train_step import StepSettings, make_train_step  # noqa: E402
from dalle_pytorch_tpu_torch.training import resume  # noqa: E402
from torch_data_refs import write_pairs, write_shard  # noqa: E402

# a small model for real-data runs: 16 x 16 images through a 2-layer VAE (4 x 4 codes)
MODEL_FLAGS = ["--dim", "32", "--depth", "2", "--heads", "2", "--dim_head", "16", "--text_seq_len", "8",
               "--num_text_tokens", "1000", "--truncate_captions", "--device", "cpu"]
VAE = dict(image_size=16, num_tokens=32, codebook_dim=16, num_layers=2, hidden_dim=8)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A folder of 10 pairs (PNG and JPEG), a shard of it, a VAE checkpoint."""
    root = tmp_path_factory.mktemp("train_data")
    write_pairs(root / "pairs", 10, seed=4)
    write_shard(root / "pairs.tar", root / "pairs")
    vae = tvae.init_discrete_vae(tvae.DiscreteVAEConfig(**VAE), torch.Generator().manual_seed(0), "cpu")
    tcli.write_vae_checkpoint(str(root / "vae.npz"), vae)
    return root


def _run(argv, capsys):
    """main(argv) in process, telemetry off: (the per-step records, the last
    line)."""
    assert tcli.main([*argv, "--telemetry", "off"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    return [r for r in lines if "loss" in r], lines[-1]


def test_dummy_run_builds_the_jax_cli_model_and_batch(monkeypatch):
    """ROADMAP.md Queue 3 item 1: dim_head 16, no rotary, a batch of 2 x the
    devices the run uses (one), one epoch, at most two workers."""
    jargs = jcli.build_parser().parse_args(["--dummy_run"])
    monkeypatch.setattr(jax, "device_count", lambda: 1)
    jcli._apply_dummy_run_defaults(jargs)
    targs = tcli.resolve_args(["--dummy_run"])
    for name in ("dim", "depth", "heads", "dim_head", "text_seq_len", "num_text_tokens", "batch_size", "epochs",
                 "num_workers", "save_every_n_steps", "rotary_emb", "shift_tokens", "loss_img_weight",
                 "learning_rate", "clip_grad_norm", "seed"):
        assert getattr(targs, name) == getattr(jargs, name), name
    vae_cfg = JaxVAEConfig(**tcli._DUMMY_VAE)
    ref = jdalle.DALLEConfig.from_vae(
        vae_cfg, dim=jargs.dim, depth=jargs.depth, num_text_tokens=jargs.num_text_tokens,
        text_seq_len=jargs.text_seq_len, heads=jargs.heads, dim_head=jargs.dim_head,
        loss_img_weight=jargs.loss_img_weight, attn_types=tuple(jargs.attn_types.split(",")),
        shift_tokens=jargs.shift_tokens, rotary_emb=jargs.rotary_emb).to_dict()
    got = tcli.model_config(targs, tvae.DiscreteVAEConfig(**tcli._DUMMY_VAE), None).to_dict()
    assert set(got) <= set(ref)
    assert json.loads(json.dumps(got)) == json.loads(json.dumps({k: ref[k] for k in got}))
    assert not got["rotary_emb"] and got["dim_head"] == 16 and targs.batch_size == 2
    # an explicit --batch_size wins, as in the JAX CLI
    assert tcli.resolve_args(["--dummy_run", "--batch_size", "6"]).batch_size == 6


def test_plateau_and_adam_follow_optax_chain():
    """A loss that falls for 6 steps and then stays flat: the scale halves
    after 10 steps without improvement, waits out a 10-step cooldown,
    halves again, and never drops below min_scale; the parameters follow
    optax's chain within 1e-6 relative, the scales exactly."""
    lr = 3e-4
    rng = np.random.default_rng(0)
    w0 = rng.standard_normal((3, 5)).astype(np.float32)
    values = np.concatenate([np.linspace(5.0, 4.0, 6), np.full(60, 4.0)]).astype(np.float32)
    grads = rng.standard_normal((len(values), 3, 5)).astype(np.float32)

    def loss_fn(params, batch, generator):  # value batch["v"], gradient batch["g"]
        lin = (params["w"] * batch["g"]).sum()
        return lin - lin.detach() + batch["v"]

    plateau = ReduceOnPlateau(factor=0.5, patience=10, cooldown=10, min_scale=0.3)
    init_fn, step_fn = make_train_step(loss_fn, Adam(lr), StepSettings(), plateau=plateau)
    params = {"w": torch.from_numpy(w0.copy())}
    state = init_fn(params)
    tx = optax.with_extra_args_support(optax.chain(optax.adam(lr), optax.contrib.reduce_on_plateau(
        factor=0.5, patience=10, cooldown=10, min_scale=0.3)))
    jw = jnp.asarray(w0)
    jstate = tx.init(jw)
    scales = []
    for v, g in zip(values, grads):
        state, _ = step_fn(state, {"v": torch.tensor(v), "g": torch.from_numpy(g)})
        updates, jstate = tx.update(jnp.asarray(g), jstate, jw, value=jnp.asarray(v))
        jw = optax.apply_updates(jw, updates)
        for name in PlateauState.FIELDS:
            assert float(getattr(state.plateau, name)) == float(getattr(jstate[1], name)), name
        scales.append(float(state.plateau.scale))
        np.testing.assert_allclose(params["w"].numpy(), np.asarray(jw), rtol=1e-6, atol=1e-7)
    assert sorted(set(scales), reverse=True) == [1.0, 0.5, float(np.float32(0.3))]


def test_resumed_run_equals_uninterrupted(data, tmp_path, capsys):
    """Two epochs of 5 batches on the folder, --lr_decay, two workers;
    the resume starts mid-epoch from the step-6 file and gives the same
    losses and the same final weights, moments and plateau state."""
    flags = ["--image_text_folder", str(data / "pairs"), *MODEL_FLAGS, "--epochs", "2", "--batch_size", "2",
             "--lr_decay", "--num_workers", "2", "--save_every_n_steps", "6", "--attn_dropout", "0.1"]
    full, _ = _run([*flags, "--vae_path", str(data / "vae.npz"), "--dalle_output_file_name",
                    str(tmp_path / "full")], capsys)
    assert [r["step"] for r in full] == list(range(1, 11)) and [r["epoch"] for r in full] == [0] * 5 + [1] * 5
    step_file = tmp_path / "full_step6.npz"
    meta = resume.load_checkpoint(str(step_file))[1]
    assert meta["global_step"] == 7 and meta["data_state"]["epoch"] == 1 and meta["data_state"]["epoch_batches"] == 2
    rest, _ = _run([*flags, "--resume", str(step_file), "--dalle_output_file_name", str(tmp_path / "rest")], capsys)
    assert [r["step"] for r in rest] == list(range(8, 11))
    assert [r["loss"] for r in rest] == [r["loss"] for r in full[7:]]
    assert [r["lr_scale"] for r in rest] == [r["lr_scale"] for r in full[7:]]
    a, b = (resume.load_checkpoint(str(tmp_path / f"{n}.pt")) for n in ("full", "rest"))
    assert a[1]["global_step"] == b[1]["global_step"] == 10
    for x, y in zip(a[0]["opt_state"].leaves + jax.tree_util.tree_leaves(a[0]["weights"]),
                    b[0]["opt_state"].leaves + jax.tree_util.tree_leaves(b[0]["weights"])):
        assert torch.equal(x, y)
    # the JAX package restores the port's optimizer state into optax's chain
    trees, jmeta = jax_load(str(tmp_path / "rest.pt"))
    tx = optax.with_extra_args_support(optax.chain(optax.adam(3e-4), optax.contrib.reduce_on_plateau(
        factor=0.5, patience=10, cooldown=10, min_scale=1e-6 / 3e-4)))
    opt = unflatten_like(tx.init(trees["weights"]), trees["opt_state"])
    assert int(opt[0][0].count) == 10 and float(opt[1].scale) == rest[-1]["lr_scale"]


def test_port_resumes_a_jax_cli_checkpoint(tmp_path, capsys):
    """The JAX CLI's dummy run, a checkpoint a step; the port resumes its
    step-1 file (weights, VAE, Adam's moments, the data cursor) and its next
    loss is the JAX CLI's loss at that step within 1e-5 relative."""
    out = tmp_path / "J"
    jcli.main(["--dummy_run", "3", "--telemetry", "off", "--log_every_n_steps", "1", "--save_every_n_steps", "1",
               "--async_checkpoint", "0", "--dalle_output_file_name", str(out)])
    logged = [json.loads(x) for x in open(f"{out}.metrics.jsonl")]
    jax_losses = {r["step"]: r["loss"] for r in logged if "loss" in r}
    batch = int(jax.device_count()) * 2
    capsys.readouterr()
    records, _ = _run(["--dummy_run", "3", "--batch_size", str(batch), "--device", "cpu", "--resume",
                       f"{out}_step1.npz", "--dalle_output_file_name", str(tmp_path / "P")], capsys)
    assert "optimizer state not restored" not in capsys.readouterr().out
    assert len(records) == 1 and records[0]["step"] == 3
    assert abs(records[0]["loss"] - jax_losses[2]) <= 1e-5 * abs(jax_losses[2])


def test_rotation_keeps_the_jax_names(tmp_path, capsys):
    out = tmp_path / "rot"
    _run(["--dummy_run", "6", "--device", "cpu", "--save_every_n_steps", "1", "--keep_n_checkpoints", "2",
          "--dalle_output_file_name", str(out)], capsys)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["rot.pt", "rot_step4.npz", "rot_step5.npz"]
    for name in ("run_step12.npz", "a/b_step3.npz", "x.npz"):
        assert resume.rotation_glob(name) == jcli._rotation_glob(name)


def test_resume_auto_takes_the_newest_checkpoint_that_loads(tmp_path, capsys):
    out = tmp_path / "auto"
    first, _ = _run(["--dummy_run", "4", "--device", "cpu", "--resume", "auto", "--dalle_output_file_name", str(out)],
                    capsys)
    assert len(first) == 4  # nothing to resume: a fresh start
    again, last = _run(["--dummy_run", "4", "--device", "cpu", "--resume", "auto", "--dalle_output_file_name",
                        str(out)], capsys)
    assert again == [] and last["global_step"] == 4  # the finished run has no epoch left
    assert resume.load_checkpoint(f"{out}.pt")[1]["epoch"] == 1
    _run(["--dummy_run", "4", "--device", "cpu", "--save_every_n_steps", "1", "--dalle_output_file_name",
          str(tmp_path / "steps")], capsys)
    newest = tmp_path / "steps_step3.npz"
    newest.write_bytes(newest.read_bytes()[:200])  # a torn write
    # a step file ranks by its name when its meta is unreadable, and before
    # the main file on a tie (both at global step 4)
    assert resume.checkpoint_candidates(str(tmp_path / "steps.pt"))[:2] == [newest, tmp_path / "steps.pt"]
    assert resume.find_latest_valid_checkpoint(str(tmp_path / "steps.pt"), log=None) == str(tmp_path / "steps.pt")
    (tmp_path / "steps.pt").unlink()
    assert resume.find_latest_valid_checkpoint(str(tmp_path / "steps.pt"), log=None) == str(
        tmp_path / "steps_step2.npz")


def test_tar_shards_train_and_the_checkpoint_generates(data, tmp_path, capsys):
    """--wds over a local shard: finite losses; the checkpoint (no rotary,
    the JAX CLI's default) samples through the port's generate path."""
    from dalle_pytorch_tpu_torch import weights
    from dalle_pytorch_tpu_torch.models import sampling

    out = tmp_path / "wds"
    records, last = _run(["--image_text_folder", str(data / "pairs.tar"), "--wds", *MODEL_FLAGS, "--epochs", "1",
                          "--batch_size", "3", "--vae_path", str(data / "vae.npz"), "--num_workers", "0",
                          "--dalle_output_file_name", str(out)], capsys)
    assert len(records) == 3 and all(np.isfinite(r["loss"]) for r in records)  # 9 captioned samples, batch 3
    model, vae = weights.load_dalle_checkpoint(f"{out}.pt", device="cpu")
    assert not model.cfg.rotary_emb and hasattr(model, "text_pos")
    codes = sampling.sample_image_codes(model, torch.ones(2, 8, dtype=torch.long), torch.Generator().manual_seed(0),
                                        cond_scale=3.0)
    assert codes.shape == (2, 16)


# the mesh flags of item 7 train now: tests/test_torch_mesh_cli.py runs the same four settings
@pytest.mark.parametrize("flags,item", [
    (["--chinese"], 4), (["--hug"], 4), (["--sample_every_n_steps", "10"], 8), (["--bpe_path", "bpe.model"], 4)])
def test_flags_that_wait_name_their_item(flags, item):
    with pytest.raises(SystemExit, match=f"ROADMAP.md Queue 1 item {item}"):
        tcli.main(["--dummy_run", "1", "--device", "cpu", *flags])


@pytest.mark.parametrize("flags,setting", [
    (["--stable_softmax"], {"stable": True}), (["--execution", "reversible"], {"execution": "reversible"}),
    (["--shared_attn_ids", "0,0"], {"shared_attn_ids": [0, 0]})])
def test_flags_of_the_transformer_settings_train(flags, setting, tmp_path, capsys):
    """The flags that waited for the transformer settings now train a
    dummy run, the setting in the printed config."""
    records, _ = _run(["--dummy_run", "1", "--device", "cpu", "--dalle_output_file_name", str(tmp_path / "s"),
                       *flags], capsys)
    assert len(records) == 1 and np.isfinite(records[0]["loss"])
    config = resume.load_checkpoint(str(tmp_path / "s.pt"))[1]["hparams"]
    assert {k: config[k] for k in setting} == setting


# the reference derives the code map from the first attention resolution
# (num_layers = log2(resolution / attn_resolutions[0])), the published
# configs' last level: 4 x 4 codes here
TAMING = dict(ch=8, ch_mult=(1, 2, 2), num_res_blocks=1, attn_resolutions=(4,), resolution=16, z_channels=8,
              n_embed=32, embed_dim=8)
TAMING_YAML = """model:
  params:
    n_embed: 32
    embed_dim: 8
    ddconfig:
      ch: 8
      ch_mult: [1, 2, 2]
      num_res_blocks: 1
      attn_resolutions: [4]
      resolution: 16
      z_channels: 8
"""


@pytest.mark.parametrize("case", ["paths", "gumbel_paths", "published_from_cache"])
def test_taming_trains(case, data, tmp_path, monkeypatch, capsys):
    """`--taming` trains on the folder through a taming VQGAN: a `.ckpt` and
    its yaml (Euclidean, GumbelVQ), or the published default read from a
    converted cache (`DALLE_PYTORCH_TPU_CACHE`) with no fetch.  The
    checkpoint holds the VQGanVAE, which the JAX package's loader reads and
    the port generates from."""
    from dalle_pytorch_tpu.models import vae_registry as jregistry
    from dalle_pytorch_tpu_torch import checkpoint, weights
    from dalle_pytorch_tpu_torch.models import pretrained, sampling
    from dalle_pytorch_tpu_torch.models import vqgan as tvqgan
    from taming_fixture import make_taming_state_dict

    def no_network(url, dst):
        raise AssertionError(f"fetched {url}")

    monkeypatch.setattr(pretrained, "_urllib_fetch", no_network)
    cfg = tvqgan.VQGANConfig(**TAMING, is_gumbel=case == "gumbel_paths")
    state = make_taming_state_dict(cfg, np.random.RandomState(1))
    if case == "published_from_cache":
        monkeypatch.setenv("DALLE_PYTORCH_TPU_CACHE", str(tmp_path / "cache"))
        checkpoint.save_checkpoint(str(tmp_path / "cache" / pretrained.VQGAN_CONVERTED),
                                   {"params": tvqgan.convert_taming_state_dict(state, cfg)},
                                   {"vqgan_config": cfg.to_dict()})
        flags = ["--taming"]
    else:
        torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in state.items()}, "epoch": 7},
                   tmp_path / "vq.ckpt")
        (tmp_path / "vq.yaml").write_text(TAMING_YAML)
        flags = ["--taming", "--vqgan_model_path", str(tmp_path / "vq.ckpt"), "--vqgan_config_path",
                 str(tmp_path / "vq.yaml")]
    out = tmp_path / "vq_run"
    records, _ = _run(["--image_text_folder", str(data / "pairs"), *MODEL_FLAGS, *flags, "--epochs", "1",
                       "--batch_size", "5", "--num_workers", "0", "--dalle_output_file_name", str(out)], capsys)
    assert len(records) == 2 and all(np.isfinite(r["loss"]) for r in records)
    trees, meta = jax_load(f"{out}.pt")
    assert meta["vae_class_name"] == "VQGanVAE"
    assert jregistry.config_from_meta("VQGanVAE", meta["vae_params"]).to_dict() == cfg.to_dict()
    model, vae = weights.load_dalle_checkpoint(f"{out}.pt", "cpu")
    assert model.cfg.image_fmap_size == 4 and model.cfg.num_image_tokens == 32 and vae.cfg == cfg
    codes = sampling.sample_image_codes(model, torch.ones(1, 8, dtype=torch.long), torch.Generator().manual_seed(0))
    assert codes.shape == (1, 16)


def test_refusals_of_the_data_path(data, tmp_path, monkeypatch, capsys):
    """No --vae_path with no OpenAI dVAE in the cache and no network (the
    fetch is injected) exits naming the cache; a torch-reference vae.pt
    trains, its codes those of the VAE it was written from; the VQGAN paths
    without --taming, a remote shard spec and --resume beside --dalle_path
    exit."""
    from dalle_pytorch_tpu_torch import weights
    from dalle_pytorch_tpu_torch.models import pretrained
    from torch_port_refs import reference_vae_state_dict

    def no_network(url, dst):
        raise OSError(f"no network to fetch {url}")

    monkeypatch.setenv("DALLE_PYTORCH_TPU_CACHE", str(tmp_path / "cache"))
    monkeypatch.setattr(pretrained, "_urllib_fetch", no_network)
    folder = ["--image_text_folder", str(data / "pairs"), "--device", "cpu"]
    with pytest.raises(SystemExit, match=f"not in the cache {tmp_path / 'cache'}.*fetching it failed"):
        tcli.main(folder)
    vae = tvae.init_discrete_vae(tvae.DiscreteVAEConfig(**VAE), torch.Generator().manual_seed(5), "cpu")
    torch.save({"hparams": VAE, "weights": reference_vae_state_dict(weights.vae_tree(vae.state_dict(), vae.cfg),
                                                                      vae.cfg)}, tmp_path / "vae.pt")
    out = tmp_path / "ref_vae"
    records, _ = _run([*folder, *MODEL_FLAGS, "--vae_path", str(tmp_path / "vae.pt"), "--epochs", "1",
                       "--batch_size", "5", "--num_workers", "0", "--dalle_output_file_name", str(out)], capsys)
    assert len(records) == 2 and all(np.isfinite(r["loss"]) for r in records)
    trees, meta = resume.load_checkpoint(f"{out}.pt")
    for name, value in weights.vae_tree(vae.state_dict(), vae.cfg)["enc_convs"][0].items():
        torch.testing.assert_close(trees["vae_weights"]["enc_convs"][0][name], value, rtol=0, atol=0)
    with pytest.raises(SystemExit, match="require --taming"):
        tcli.main([*folder, "--vqgan_config_path", "v.yaml"])
    with pytest.raises(SystemExit, match="https://host/s-000.tar: remote tar shards.*item 10"):
        tcli.main(["--image_text_folder", "https://host/s-{000..003}.tar", "--wds", "--device", "cpu"])
    with pytest.raises(SystemExit, match="mutually exclusive"):
        tcli.main(["--dummy_run", "1", "--resume", "auto", "--dalle_path", "x.pt", "--device", "cpu"])
