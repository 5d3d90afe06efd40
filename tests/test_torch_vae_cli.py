"""The port's VAE training CLI (`cli/train_vae.py`) against the JAX
package's, on the CPU, at the JAX CLI test's sizes (16 px, 32 tokens, two
layers).

- The port's `vae.pt` loads through the JAX `load_checkpoint`, and its
  weights give the same codes in JAX as in the port.
- The logger writes `vae.metrics.jsonl` and the step-0 grids of originals
  and soft and hard reconstructions, with the codebook histogram, as the
  JAX CLI test expects of JAX.
- The JAX `train_vae --resume PATH` takes the port's file, and the port's
  `--resume PATH` the JAX CLI's: each starts from the other's weights
  exactly (an `--epochs 0` run saves what it resumed) and trains on.
  `--resume auto` starts fresh without a file and resumes its own.
- The port's `train_dalle --vae_path` trains on the port-trained VAE.
- Each flag whose machinery waits exits naming its ROADMAP.md item."""
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from dalle_pytorch_tpu.cli import train_vae as jcli  # noqa: E402
from dalle_pytorch_tpu.models import vae as jvae  # noqa: E402
from dalle_pytorch_tpu.training.checkpoint import load_checkpoint as jax_load  # noqa: E402
from dalle_pytorch_tpu_torch import checkpoint  # noqa: E402
from dalle_pytorch_tpu_torch.cli import train_dalle as tdalle_cli  # noqa: E402
from dalle_pytorch_tpu_torch.cli import train_vae as tcli  # noqa: E402
from dalle_pytorch_tpu_torch.models import vae as tvae  # noqa: E402
from torch_data_refs import write_pairs  # noqa: E402

PIL = pytest.importorskip("PIL.Image")

# tests/test_cli.py's `trained_vae` sizes
SIZES = ["--image_size", "16", "--num_tokens", "32", "--num_layers", "2", "--emb_dim", "16", "--hidden_dim", "16",
         "--num_resnet_blocks", "0", "--batch_size", "8", "--save_every_n_steps", "0"]
JAX_QUIET = ["--telemetry", "off", "--async_checkpoint", "0", "--prefetch_batches", "0", "--num_workers", "0"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    ws = tmp_path_factory.mktemp("vae_cli")
    write_pairs(ws / "data", 16, seed=8)
    return ws


def _port(argv, capsys):
    """tcli.main(argv) on the CPU, telemetry off unless argv sets it: (its
    JSON lines, everything it printed)."""
    tele = [] if "--telemetry" in argv else ["--telemetry", "off"]
    assert tcli.main([*argv, *tele, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    return [json.loads(x) for x in out.splitlines() if x.startswith("{")], out


@pytest.fixture(scope="module")
def trained(workspace):
    """The port's run: one epoch of two steps, logged at step 0."""
    assert tcli.main(["--image_folder", str(workspace / "data"), *SIZES, "--epochs", "1", "--telemetry", "off",
                      "--vae_output_file_name", str(workspace / "vae"), "--device", "cpu"]) == 0
    return workspace / "vae.pt"


def _leaves(path):
    trees, meta = jax_load(str(path))
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(trees["weights"])], meta


def test_checkpoint_loads_in_jax_with_the_same_codes(trained):
    trees, meta = jax_load(str(trained))
    assert sorted(meta) == ["hparams", "version"] and meta["hparams"]["num_tokens"] == 32
    jcfg = jvae.DiscreteVAEConfig(**meta["hparams"])
    vae = tdalle_cli.load_vae_checkpoint(str(trained), "cpu")
    images = np.random.default_rng(0).random((4, 16, 16, 3)).astype(np.float32)
    ref = jvae.get_codebook_indices(jax.tree_util.tree_map(jnp.asarray, trees["weights"]), jcfg, jnp.asarray(images))
    np.testing.assert_array_equal(tvae.get_codebook_indices(vae, torch.from_numpy(images)).numpy(), np.asarray(ref))


def test_logger_writes_the_grids_and_the_histogram(workspace, trained):
    """tests/test_cli.py's `test_train_vae_image_and_histogram_logging`,
    on the port's files."""
    img_dir = workspace / "vae.images"
    for name in ("original_images", "reconstructions", "hard_reconstructions"):
        p = img_dir / f"step0_{name}.png"
        assert p.exists(), p
        assert PIL.open(p).size[0] > 16  # a grid, not a single tile
    records = [json.loads(line) for line in open(workspace / "vae.metrics.jsonl")]
    hists = [r["codebook_indices_hist"] for r in records if "codebook_indices_hist" in r]
    assert hists and sum(hists[0]["counts"]) > 0
    first = next(r for r in records if "loss" in r)
    assert first["step"] == 0 and sorted(first) == ["codebook_used", "epoch", "loss", "lr", "step", "temperature",
                                                    "ts"]
    assert [r["epoch"] for r in records if "epoch_time_s" in r] == [0]


def test_jax_resumes_the_port_checkpoint(workspace, trained, capsys):
    port_leaves, port_meta = _leaves(trained)
    common = ["--image_folder", str(workspace / "data"), *SIZES, *JAX_QUIET, "--resume", str(trained)]
    params, cfg = jcli.main([*common, "--epochs", "0", "--vae_output_file_name", str(workspace / "jax_from_port")])
    assert cfg.to_dict() == jvae.DiscreteVAEConfig(**port_meta["hparams"]).to_dict()
    for got, want in zip(jax.tree_util.tree_leaves(params), port_leaves):
        np.testing.assert_array_equal(np.asarray(got), want)
    params, _ = jcli.main([*common, "--epochs", "1", "--vae_output_file_name", str(workspace / "jax_from_port")])
    assert "resumed VAE weights" in capsys.readouterr().out
    assert all(np.isfinite(np.asarray(x)).all() for x in jax.tree_util.tree_leaves(params))


def test_port_resumes_the_jax_checkpoint(workspace, capsys):
    jcli.main(["--image_folder", str(workspace / "data"), *SIZES, *JAX_QUIET, "--epochs", "1",
               "--transparent", "--vae_output_file_name", str(workspace / "jax_vae")])
    jax_leaves, jax_meta = _leaves(workspace / "jax_vae.pt")
    common = ["--image_folder", str(workspace / "data"), *SIZES, "--resume", str(workspace / "jax_vae.pt")]
    lines, out = _port([*common, "--epochs", "0", "--vae_output_file_name", str(workspace / "port_from_jax")], capsys)
    assert "resumed the VAE weights" in out and lines[0]["resumed_from"] == str(workspace / "jax_vae.pt")
    assert lines[0]["config"]["channels"] == 4  # the hparams come from the checkpoint
    leaves, meta = _leaves(workspace / "port_from_jax.pt")
    assert meta["hparams"] == jax_meta["hparams"]
    for got, want in zip(leaves, jax_leaves):
        np.testing.assert_array_equal(got, want)
    lines, _ = _port([*common, "--epochs", "1", "--vae_output_file_name", str(workspace / "port_from_jax")], capsys)
    steps = [r for r in lines if "loss" in r]
    assert len(steps) == 2 and all(np.isfinite(r["loss"]) for r in steps)


def test_resume_auto(workspace, capsys):
    common = ["--image_folder", str(workspace / "data"), *SIZES, "--epochs", "0", "--resume", "auto",
              "--vae_output_file_name", str(workspace / "auto")]
    lines, out = _port(common, capsys)
    assert "starting fresh" in out and lines[0]["resumed_from"] is None
    lines, out = _port(common, capsys)
    assert lines[0]["resumed_from"] == str(workspace / "auto.pt")
    with pytest.raises(SystemExit, match="does not exist"):
        tcli.main([*common[:-4], "--resume", str(workspace / "missing.pt"), "--device", "cpu"])


def test_train_dalle_trains_on_the_port_vae(workspace, trained, capsys):
    argv = ["--vae_path", str(trained), "--image_text_folder", str(workspace / "data"), "--dim", "32", "--depth", "1",
            "--heads", "2", "--dim_head", "8", "--text_seq_len", "16", "--num_text_tokens", "64", "--epochs", "1",
            "--batch_size", "4", "--save_every_n_steps", "0", "--truncate_captions", "--num_workers", "0",
            "--dalle_output_file_name", str(workspace / "dalle"), "--device", "cpu"]
    assert tdalle_cli.main(argv) == 0
    steps = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith('{"step"')]
    assert len(steps) == 4 and all(np.isfinite(r["loss"]) for r in steps)  # 16 pairs, batches of 4
    trees, meta = checkpoint.load_checkpoint(str(workspace / "dalle.pt"))
    assert meta["vae_params"]["num_tokens"] == 32 and meta["hparams"]["num_image_tokens"] == 32


@pytest.mark.parametrize("flags, item", [
    (["--telemetry", "tele"], None), (["--profile_steps", "1:3"], None), (["--health_every", "1"], 8),
    (["--inject_fault", "sigterm@2"], 8), (["--fleet_inject_skew", "0.5"], 8), (["--async_checkpoint", "1"], 8),
    (["--prefetch_batches", "2"], 10),
])
def test_flags_that_wait_exit_naming_their_item(workspace, flags, item, capsys):
    """The machinery that waits exits naming its item; `--telemetry DIR`
    and `--profile_steps A:B` run (the hub came with item 8's telemetry)."""
    argv = ["--image_folder", str(workspace / "data"), *SIZES, "--epochs", "1", *flags, "--vae_output_file_name",
            str(workspace / f"flag_{flags[0][2:]}"), "--device", "cpu"]
    if item is None:
        with pytest.MonkeyPatch.context() as mp:
            mp.chdir(workspace)
            assert tcli.main(argv) == 0
        tele = workspace / ("tele" if flags[0] == "--telemetry" else "flag_profile_steps.telemetry")
        assert (tele / f"flag_{flags[0][2:]}.spans.jsonl").exists()
        assert (flags[0] != "--profile_steps") or len(list((tele / "traces").glob("*.json"))) == 1
        return
    with pytest.raises(SystemExit, match=rf"{flags[0]}.*ROADMAP.md Queue 1 item {item}\)"):
        tcli.main(argv)


def test_telemetry_flags_act(workspace, capsys):
    """The flags that act under telemetry: the directory, the headroom
    monitor's ledger gauges (no alarm on the CPU: no allocator), the sync
    and the capture; `--telemetry off` writes nothing."""
    lines, _ = _port(["--image_folder", str(workspace / "data"), *SIZES, "--epochs", "1", "--fleet", "0",
                      "--profile_on_alarm", "0", "--hbm_headroom_frac", "0.5", "--telemetry_sync", "0",
                      "--telemetry_heartbeat_s", "0", "--telemetry", str(workspace / "acting"),
                      "--vae_output_file_name", str(workspace / "acting")], capsys)
    assert lines[-1] == {"checkpoint": str(workspace / "acting.pt"), "global_step": 2}
    records = [json.loads(x) for x in (workspace / "acting" / "acting.spans.jsonl").read_text().splitlines()]
    kinds = [r["kind"] for r in records]
    assert kinds.count("step") == 2 and kinds.count("mem_ledger") == 1 and "alarm" not in kinds
    flushed = [r["step"] for r in records if r["kind"] == "metrics"]
    assert flushed == sorted(flushed) and flushed[-1] == 2  # the last flush at the loop's last step
    assert {"data_wait", "dispatch", "log", "checkpoint"} <= {r["name"] for r in records if r["kind"] == "span"}
    assert not list(workspace.glob("acting/hang_*")) and not (workspace / "acting" / "traces").exists()
    lines, _ = _port(["--image_folder", str(workspace / "data"), *SIZES, "--epochs", "0", "--telemetry", "off",
                      "--vae_output_file_name", str(workspace / "inert")], capsys)
    assert not (workspace / "inert.telemetry").exists()
