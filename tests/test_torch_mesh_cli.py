"""The mesh flags that waited for ring attention and the pipeline, now run
by `train_dalle` across processes on gloo on the CPU: `--mesh_sp 2`
(replicas of the step, as the JAX CLI's `--mesh_sp` on a model without
`seq_shard_axis`), `--mesh_pp 2`, `--mesh_fsdp 2 --mesh_pp 2` and
`--mesh_tp 2 --mesh_sp 2` each print the one-process CLI's losses and
record their mesh in the checkpoint's `topology`.  The ranks are
subprocesses that meet at a `file://` rendezvous under the test's temporary
directory (`test_torch_parallel_cli._launch`)."""
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.training.checkpoint import load_checkpoint as jax_load
from dalle_pytorch_tpu_torch.cli import train_dalle as dalle_cli
from test_torch_parallel_cli import _in_process, _launch, _records

DALLE = ["--dummy_run", "3", "--batch_size", "4", "--save_every_n_steps", "0"]
FLAGS = {
    "sp2": (["--mesh_sp", "2"], 2),
    "pp2": (["--mesh_pp", "2"], 2),
    "fsdp2_pp2": (["--mesh_fsdp", "2", "--mesh_pp", "2"], 4),
    "tp2_sp2": (["--mesh_tp", "2", "--mesh_sp", "2"], 4),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ws = tmp_path_factory.mktemp("mesh_cli")
    jobs = {name: _launch("dalle_pytorch_tpu_torch.cli.train_dalle",
                          [*DALLE, *flags, "--dalle_output_file_name", str(ws / name)], world, ws / f"rdv_{name}")
            for name, (flags, world) in FLAGS.items()}
    one = _in_process(dalle_cli.main, [*DALLE, "--dalle_output_file_name", str(ws / "one")])
    out = {}
    for name, procs in jobs.items():
        texts = [p.communicate(timeout=600) for p in procs]
        for p, (_, err) in zip(procs, texts):
            assert p.returncode == 0, f"{name}: {err[-3000:]}"
        out[name] = texts
    return ws, out, one


@pytest.mark.parametrize("name", list(FLAGS))
def test_the_mesh_flags_that_waited_train(name, runs):
    ws, out, one = runs
    got, want = _records(out[name][0][0]), _records(one)
    assert [r["step"] for r in got] == [1, 2, 3] and [r["batch"] for r in got] == [4, 4, 2]
    np.testing.assert_allclose([r["loss"] for r in got], [r["loss"] for r in want], rtol=1e-5)
    np.testing.assert_allclose([r["grad_norm"] for r in got], [r["grad_norm"] for r in want], rtol=1e-5)
    flags, world = FLAGS[name]
    mesh = jax_load(str(ws / f"{name}.pt"))[1]["topology"]["mesh"]
    assert mesh == {"dp": 1, "fsdp": 1, "tp": 1, "sp": 1, "pp": 1, **{
        flags[i][len("--mesh_"):]: int(flags[i + 1]) for i in range(0, len(flags), 2)}}
    assert all(not _records(texts[0]) for texts in out[name][1:])  # the other ranks print no records
