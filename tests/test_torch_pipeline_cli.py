"""`train_dalle --mesh_pp` across processes, on gloo on the CPU: two ranks at
`--pp_num_micro 2`, and at `--pp_interleave 2`, print the one-process CLI's
losses (depth 4); the pipelined run's checkpoint is the one-process v3 file
with pp 2 and the interleave in its `topology` (and no pipeline knob in its
hparams: the JAX package's forward takes it), and it resumes on one
process and on the interleaved pipeline, as a one-process checkpoint
resumes on the pipeline, each resumed step giving the one-process run's
loss; its weights are the one-process run's.  The ranks are subprocesses
that meet at a `file://` rendezvous under the test's temporary directory
(`test_torch_parallel_cli._launch`)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.models import dalle as jdalle
from dalle_pytorch_tpu.training.checkpoint import load_checkpoint as jax_load
from dalle_pytorch_tpu_torch import weights
from dalle_pytorch_tpu_torch.cli import train_dalle as dalle_cli
from dalle_pytorch_tpu_torch.models import dalle as tdalle
from dalle_pytorch_tpu_torch.parallel import registry
from test_torch_parallel_cli import _in_process, _launch, _records

MODULE = "dalle_pytorch_tpu_torch.cli.train_dalle"
DALLE = ["--dummy_run", "3", "--batch_size", "4", "--save_every_n_steps", "1", "--depth", "4"]
RTOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _wait(jobs):
    out = {}
    for name, procs in jobs.items():
        texts = [p.communicate(timeout=600) for p in procs]
        for p, (_, err) in zip(procs, texts):
            assert p.returncode == 0, f"{name}: {err[-3000:]}"
        out[name] = texts
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The pipelined runs, then the resumed ones (while the one-process
    resume runs in this process)."""
    ws = tmp_path_factory.mktemp("pipeline_cli")
    jobs = {
        "pp2": _launch(MODULE, [*DALLE, "--mesh_pp", "2", "--pp_num_micro", "2", "--dalle_output_file_name",
                                str(ws / "pp2")], 2, ws / "rdv_pp2"),
        "pp2_v2": _launch(MODULE, [*DALLE, "--mesh_pp", "2", "--pp_num_micro", "2", "--pp_interleave", "2",
                                   "--dalle_output_file_name", str(ws / "pp2_v2")], 2, ws / "rdv_pp2_v2"),
    }
    one = {"one": _in_process(dalle_cli.main, [*DALLE, "--dalle_output_file_name", str(ws / "one")])}
    out = _wait(jobs)
    jobs = {
        # the pipeline's step file on the interleaved pipeline, and the one-process run's on the pipeline
        "pp2_v2_resumed": _launch(MODULE, [*DALLE, "--mesh_pp", "2", "--pp_num_micro", "2", "--pp_interleave",
                                           "2", "--resume", str(ws / "pp2_step1.npz"), "--dalle_output_file_name",
                                           str(ws / "pp2_v2_resumed")], 2, ws / "rdv_v2_resumed"),
        "pp2_resumed": _launch(MODULE, [*DALLE, "--mesh_pp", "2", "--resume", str(ws / "one_step1.npz"),
                                        "--dalle_output_file_name", str(ws / "pp2_resumed")], 2, ws / "rdv_resumed"),
    }
    one["one_resumed"] = _in_process(dalle_cli.main, [*DALLE, "--resume", str(ws / "pp2_step1.npz"),
                                                       "--dalle_output_file_name", str(ws / "one_resumed")])
    out.update(_wait(jobs))
    return ws, out, one


@pytest.mark.parametrize("run", ["pp2", "pp2_v2"])
def test_two_stages_print_the_one_process_losses(runs, run):
    _, out, one = runs
    got, want = _records(out[run][0][0]), _records(one["one"])
    assert [r["step"] for r in got] == [1, 2, 3] and [r["batch"] for r in got] == [4, 4, 2]
    np.testing.assert_allclose([r["loss"] for r in got], [r["loss"] for r in want], rtol=RTOL)
    np.testing.assert_allclose([r["grad_norm"] for r in got], [r["grad_norm"] for r in want], rtol=1e-5)
    assert not _records(out[run][1][0])  # rank 1 prints no records


def test_the_pipelined_checkpoint_is_the_one_process_file_with_its_topology(runs):
    ws, _, _ = runs
    trees, meta = jax_load(str(ws / "pp2.pt"))
    want = registry.topology_meta({"dp": 1, "fsdp": 1, "tp": 1, "sp": 1, "pp": 2}, device_count=2)
    assert meta["topology"] == dict(want, pp_interleave=1)
    assert jax_load(str(ws / "pp2_v2.pt"))[1]["topology"]["pp_interleave"] == 2
    one, _ = jax_load(str(ws / "one.pt"))
    got, want = (jax.tree_util.tree_leaves(t["weights"]) for t in (trees, one))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-7)
    # the pipeline's knobs stay out of the hparams: the JAX package's forward takes the file
    jcfg = jdalle.DALLEConfig.from_dict(meta["hparams"])
    assert jcfg.pipeline_axis is None
    model, _ = weights.load_dalle_checkpoint(str(ws / "pp2.pt"), device="cpu")
    rng = np.random.default_rng(3)
    text = rng.integers(0, jcfg.num_text_tokens, (2, jcfg.text_seq_len))
    codes = rng.integers(0, jcfg.num_image_tokens, (2, jcfg.image_seq_len))
    with torch.no_grad():
        port = tdalle.forward(model, torch.from_numpy(text), torch.from_numpy(codes)).numpy()
    ref = np.asarray(jdalle.forward(trees["weights"], jcfg, jnp.asarray(text), jnp.asarray(codes)))
    np.testing.assert_allclose(port, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("run", ["one_resumed", "pp2_v2_resumed", "pp2_resumed"])
def test_a_checkpoint_resumes_across_pipelines(runs, run):
    """one process <- pp2 -> pp2 with interleave 2, and one process -> pp2:
    the resumed step is the one-process run's last, its loss within 1e-6."""
    _, out, one = runs
    got = _records(one[run] if run == "one_resumed" else out[run][0][0])
    want = _records(one["one"])
    assert [r["step"] for r in got] == [3]
    np.testing.assert_allclose(got[0]["loss"], want[-1]["loss"], rtol=RTOL)
