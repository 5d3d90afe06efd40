"""The three training CLIs across processes, on gloo on the CPU: two ranks
of `train_dalle --dummy_run` under a ZeRO-3 fsdp mesh and under tp print
the one-process run's losses, and the ZeRO-3 run's checkpoints carry the
mesh's topology, load in the JAX package and resume in the one-process
CLI; `train_clip` at dp2 prints the one-process losses (its contrastive
loss is over the global batch); `train_vae` trains under the backend; and a
mesh without its processes, or a torch backend without a rendezvous, exits
saying how to launch; a sharded run resumes a one-process checkpoint.  The
ranks are subprocesses that meet at a `file://` rendezvous under the
test's temporary directory."""
import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dalle_pytorch_tpu.models import dalle as jdalle
from dalle_pytorch_tpu.training.checkpoint import load_checkpoint as jax_load
from dalle_pytorch_tpu.training.checkpoint import unflatten_like
from dalle_pytorch_tpu_torch import weights
from dalle_pytorch_tpu_torch.cli import train_clip as clip_cli
from dalle_pytorch_tpu_torch.cli import train_dalle as dalle_cli
from dalle_pytorch_tpu_torch.cli import train_vae as vae_cli
from dalle_pytorch_tpu_torch.models import dalle as tdalle
from dalle_pytorch_tpu_torch.parallel import registry
from torch_data_refs import write_pairs

REPO = Path(__file__).resolve().parent.parent
DALLE = ["--dummy_run", "3", "--batch_size", "4", "--save_every_n_steps", "1"]
CLIP = ["--dim_text", "32", "--dim_image", "32", "--dim_latent", "16", "--text_enc_depth", "1", "--text_seq_len",
        "16", "--text_heads", "2", "--visual_enc_depth", "1", "--visual_heads", "2", "--visual_image_size", "16",
        "--visual_patch_size", "8", "--truncate_captions", "--epochs", "1", "--batch_size", "8",
        "--save_every_n_steps", "0"]
VAE = ["--image_size", "16", "--num_tokens", "32", "--num_layers", "2", "--emb_dim", "16", "--hidden_dim", "16",
       "--num_resnet_blocks", "0", "--batch_size", "8", "--save_every_n_steps", "0", "--epochs", "1",
       "--num_workers", "0"]


def _launch(module, argv, world, rendezvous):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, "-m", module, *argv, "--device", "cpu", "--distributed_backend", "torch",
                              "--coordinator_address", f"file://{rendezvous}", "--num_processes", str(world),
                              "--process_id", str(rank)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                             cwd=REPO, env=env) for rank in range(world)]


def _records(text):
    return [json.loads(x) for x in text.splitlines() if x.startswith('{"step"')]


def _in_process(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main([*argv, "--device", "cpu"]) == 0
    return out.getvalue()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every multi-process run at once (two ranks each), then the
    one-process runs they are held against."""
    ws = tmp_path_factory.mktemp("parallel_cli")
    write_pairs(ws / "data", 16, seed=9)
    jobs = {
        "dalle_z3": _launch("dalle_pytorch_tpu_torch.cli.train_dalle", [*DALLE, "--mesh_fsdp", "2", "--zero_stage",
                            "3", "--dalle_output_file_name", str(ws / "z3")], 2, ws / "rdv_z3"),
        "dalle_tp2": _launch("dalle_pytorch_tpu_torch.cli.train_dalle", [*DALLE, "--mesh_tp", "2",
                             "--dalle_output_file_name", str(ws / "tp2")], 2, ws / "rdv_tp2"),
        "clip_dp2": _launch("dalle_pytorch_tpu_torch.cli.train_clip", [*CLIP, "--image_text_folder", str(ws / "data"),
                            "--clip_output_file_name", str(ws / "clip2")], 2, ws / "rdv_clip"),
        "vae_dp2": _launch("dalle_pytorch_tpu_torch.cli.train_vae", [*VAE, "--image_folder", str(ws / "data"),
                           "--vae_output_file_name", str(ws / "vae2")], 2, ws / "rdv_vae"),
    }
    one = {"dalle": _in_process(dalle_cli.main, [*DALLE, "--dalle_output_file_name", str(ws / "one")])}
    # a sharded run resumed from the one-process run's step file (the JAX CLI's format)
    jobs["dalle_z3_resumed"] = _launch("dalle_pytorch_tpu_torch.cli.train_dalle", [
        *DALLE, "--mesh_fsdp", "2", "--zero_stage", "3", "--resume", str(ws / "one_step1.npz"),
        "--dalle_output_file_name", str(ws / "z3_resumed")], 2, ws / "rdv_z3_resumed")
    one["clip"] = _in_process(clip_cli.main, [*CLIP, "--image_text_folder", str(ws / "data"),
                                              "--clip_output_file_name", str(ws / "clip1")])
    out = {}
    for name, procs in jobs.items():
        texts = [p.communicate(timeout=600) for p in procs]
        for p, (_, err) in zip(procs, texts):
            assert p.returncode == 0, f"{name}: {err[-3000:]}"
        out[name] = texts
    return ws, out, one


@pytest.mark.parametrize("run", ["dalle_z3", "dalle_tp2"])
def test_two_ranks_print_the_one_process_losses(runs, run):
    _, out, one = runs
    got, want = _records(out[run][0][0]), _records(one["dalle"])
    assert [r["step"] for r in got] == [1, 2, 3] and [r["batch"] for r in got] == [4, 4, 2]
    np.testing.assert_allclose([r["loss"] for r in got], [r["loss"] for r in want], rtol=1e-5)
    np.testing.assert_allclose([r["grad_norm"] for r in got], [r["grad_norm"] for r in want], rtol=1e-5)
    assert not _records(out[run][1][0])  # rank 1 prints no records


def test_zero3_checkpoint_loads_in_jax_and_resumes_in_one_process(runs, tmp_path):
    """The ZeRO-3 run's checkpoint is the one-process file: JAX's reader
    takes it, the forward on it gives the port's logits, the optimizer state
    restores into optax's template, its meta carries the mesh; and the
    one-process CLI resumed from its step file ends where the one-process
    run ends."""
    ws, out, one = runs
    trees, meta = jax_load(str(ws / "z3.pt"))
    assert meta["topology"] == registry.topology_meta({"dp": 1, "fsdp": 2, "tp": 1, "sp": 1, "pp": 1},
                                                      device_count=2)
    jcfg = jdalle.DALLEConfig.from_dict(meta["hparams"])
    model, _ = weights.load_dalle_checkpoint(str(ws / "z3.pt"), device="cpu")
    one_model, _ = weights.load_dalle_checkpoint(str(ws / "one.pt"), device="cpu")
    for (name, a), b in zip(model.state_dict().items(), one_model.state_dict().values()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-7, err_msg=name)
    rng = np.random.default_rng(3)
    text = rng.integers(0, jcfg.num_text_tokens, (2, jcfg.text_seq_len))
    codes = rng.integers(0, jcfg.num_image_tokens, (2, jcfg.image_seq_len))
    with torch.no_grad():
        port = tdalle.forward(model, torch.from_numpy(text), torch.from_numpy(codes)).numpy()
    ref = np.asarray(jdalle.forward(trees["weights"], jcfg, jnp.asarray(text), jnp.asarray(codes)))
    np.testing.assert_allclose(port, ref, atol=1e-5, rtol=0)
    opt = unflatten_like(optax.adam(3e-4).init(trees["weights"]), trees["opt_state"])[0]
    assert int(opt.count) == 3
    assert jax.tree_util.tree_structure(opt.mu) == jax.tree_util.tree_structure(trees["weights"])

    resumed = _in_process(dalle_cli.main, [*DALLE, "--resume", str(ws / "z3_step1.npz"),
                                           "--dalle_output_file_name", str(tmp_path / "resumed")])
    got, want = _records(resumed), _records(one["dalle"])
    assert [r["step"] for r in got] == [3]
    np.testing.assert_allclose(got[0]["loss"], want[-1]["loss"], rtol=1e-5)


def test_a_sharded_run_resumes_a_one_process_checkpoint(runs):
    """--resume on a mesh: every rank reads the full file and keeps its
    shards of the weights and of Adam's moments; the step it runs is the
    one-process run's last."""
    _, out, one = runs
    got, want = _records(out["dalle_z3_resumed"][0][0]), _records(one["dalle"])
    assert [r["step"] for r in got] == [3]
    np.testing.assert_allclose(got[0]["loss"], want[-1]["loss"], rtol=1e-5)
    np.testing.assert_allclose(got[0]["grad_norm"], want[-1]["grad_norm"], rtol=1e-5)


def test_clip_at_dp2_prints_the_one_process_losses(runs):
    """Each data rank reads its share of each global batch, and the
    contrastive loss runs over the gathered latents: the global batch's
    loss, which the row order does not change."""
    ws, out, one = runs
    got, want = _records(out["clip_dp2"][0][0]), _records(one["clip"])
    assert len(got) == len(want) == 2
    np.testing.assert_allclose([r["loss"] for r in got], [r["loss"] for r in want], rtol=1e-4)
    assert (ws / "clip2.pt").exists()


def test_vae_trains_under_the_backend(runs):
    ws, out, _ = runs
    got = _records(out["vae_dp2"][0][0])
    assert len(got) == 2 and all(np.isfinite(r["loss"]) for r in got)
    assert (ws / "vae2.pt").exists() and not _records(out["vae_dp2"][1][0])


@pytest.mark.parametrize("main,argv", [
    (dalle_cli.main, ["--dummy_run", "1", "--mesh_fsdp", "2"]),
    (dalle_cli.main, ["--dummy_run", "1", "--mesh_tp", "2"]),
    (clip_cli.main, ["--image_text_folder", "data", "--mesh_dp", "2"]),
])
def test_a_mesh_without_its_processes_says_how_to_launch(main, argv):
    with pytest.raises(SystemExit, match="launch 2 processes.*torch.distributed.run --nproc_per_node 2"):
        main([*argv, "--device", "cpu"])


@pytest.mark.parametrize("main,argv", [
    (dalle_cli.main, ["--dummy_run", "1"]),
    (clip_cli.main, ["--image_text_folder", "data"]),
    (vae_cli.main, ["--image_folder", "data"]),
])
def test_a_torch_backend_without_a_rendezvous_exits(main, argv, monkeypatch):
    for key in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(SystemExit, match="no rendezvous.*torchrun"):
        main([*argv, "--distributed_backend", "jax", "--device", "cpu"])
