"""The pipeline in the sharded train step (`pipeline_axis="pp"`,
`parallel/pipeline.py`) on a gloo world of 2 CPU processes: pp 2 at M 2
and M 3, interleave 2, dropout, remat with bf16 storage (injected rounding
bits), a dynamic loss scale and gradient accumulation; and the pp axis
without the model knob (replicas).  Each case's loss and gradient of the
initial weights match the JAX package's one-device `forward` / `jax.grad`
on the same v3 weights (loss rtol 1e-5, leaves rtol 5e-3 / atol 2e-5), and
its three Adam steps the port's one-process step (losses, gradient norms,
final parameters to 1e-5); each stage holds its own layers and every leaf
outside the stack, no more.  Also the JAX package's `default_num_micro`
and `pipeline_comm_bytes`, its chunk map and its refusals (a reversible
pipeline, a bad split).  World 4 (pp 4, and pp beside fsdp and sp):
`test_torch_pipeline_mesh.py`.  Rank code: `torch_mesh_ranks.py` (no
JAX)."""
import jax
import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from dalle_pytorch_tpu.models import dalle as jdalle
from dalle_pytorch_tpu.parallel import pipeline as jpipeline
from dalle_pytorch_tpu_torch.models.dalle import DALLE, DALLEConfig
from dalle_pytorch_tpu_torch.parallel import pipeline
from test_torch_seq_parallel import assert_matches_jax, assert_matches_one_process, jax_loss_and_grads

WORLD2 = ["pp2_m2", "pp2_m3", "pp2_v2", "pp2_dropout", "pp2_remat_bf16", "pp2_replicas"]
NOT_JAX = {"pp2_dropout", "pp2_remat_bf16"}  # other dropout masks; bf16 storage


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return ranks.spawn_world(tmp_path_factory.mktemp("pp_world2"), 2, WORLD2)


@pytest.fixture(scope="module")
def jax_ref():
    return jax_loss_and_grads(ranks.CASES["pp2_m2"])


@pytest.mark.parametrize("name", WORLD2)
def test_pp_step_matches_one_process(name, world2):
    refs, got = world2
    assert_matches_one_process(got[name], refs[name])
    for losses in got[name]["loss_by_rank"]:  # every stage reads the last stage's loss
        np.testing.assert_allclose(losses, got[name]["loss"], rtol=1e-6)


@pytest.mark.parametrize("name", [n for n in WORLD2 if n not in NOT_JAX])
def test_pp_loss_and_gradients_match_jax(name, world2, jax_ref):
    assert_matches_jax(world2[1][name], ranks.CASES[name], jax_ref)


def assert_stages_hold_their_layers(got, case):
    """Each stage's resident parameters are its layers and the leaves
    outside the stack; RecordingAdam's statistics (mu, nu and the recorded
    gradient) three times that."""
    cfg = ranks.model_config(case)
    want = ranks.stage_param_bytes(cfg, case.mesh["pp"], cfg.pp_interleave)
    assert [r["params"] for r in got["resident_by_rank"]] == want
    assert [r["moments"] for r in got["resident_by_rank"]] == [3 * b for b in want]
    assert max(want) < sum(p.numel() * 4 for p in DALLE(cfg).parameters())


@pytest.mark.parametrize("name", ["pp2_m2", "pp2_v2"])
def test_each_stage_holds_its_layers_and_the_leaves_outside(name, world2):
    assert_stages_hold_their_layers(world2[1][name], ranks.CASES[name])


def test_make_mesh_builds_the_pp_axis(world2):
    """`make_mesh(MeshConfig(pp=2))` lays the five axes out with pp 2; a
    replica of the step (no `pipeline_axis`) holds every parameter."""
    _, got = world2
    assert got["pp2_m2"]["mesh"] == {"dp": 1, "fsdp": 1, "tp": 1, "sp": 1, "pp": 2}
    assert got["pp2_replicas"]["resident_by_rank"][0]["params"] == sum(
        p.numel() * 4 for p in DALLE(ranks.model_config(ranks.CASES["pp2_replicas"])).parameters())


@pytest.mark.parametrize("batch,stages", [(8, 2), (8, 4), (6, 4), (7, 2), (1, 2), (12, 3), (64, 8)])
def test_default_num_micro_and_comm_bytes_match_jax(batch, stages):
    assert pipeline.default_num_micro(batch, stages) == jpipeline.default_num_micro(batch, stages)
    for kw in ({}, {"num_micro": 1, "itemsize": 2}, {"interleave": 2, "include_backward": False}):
        assert pipeline.pipeline_comm_bytes(batch, 24, 64, stages, **kw) == jpipeline.pipeline_comm_bytes(
            batch, 24, 64, stages, **kw)


def test_stage_chunks_follow_the_jax_interleave_map():
    """Device s holds chunks s, s + P, ...: the layers JAX's transposed
    stacked axis puts on it, in the order a micro-batch reaches them."""
    depth, stages, v = 8, 2, 2
    order = np.arange(depth).reshape(v, stages, depth // (stages * v)).swapaxes(0, 1).reshape(depth)
    for s in range(stages):
        got = [i for start, stop in pipeline.stage_chunks(depth, stages, s, v) for i in range(start, stop)]
        assert got == list(order[s * depth // stages:(s + 1) * depth // stages])
    with pytest.raises(ValueError, match=r"depth 6 % \(pp 2 \* interleave 2\) != 0"):
        pipeline.stage_chunks(6, 2, 0, 2)


def test_a_reversible_pipeline_is_refused_as_in_jax():
    cfg = dict(ranks.MODEL, depth=2, pipeline_axis="pp", execution="reversible")
    text = torch.ones(1, cfg["text_seq_len"], dtype=torch.long)
    codes = torch.zeros(1, cfg["image_fmap_size"] ** 2, dtype=torch.long)
    with pytest.raises(ValueError, match="pipeline_axis is not supported with execution='reversible'"):
        DALLE(DALLEConfig(**cfg))(text, codes, return_loss=True)
    jcfg = jdalle.DALLEConfig(**cfg, scan_layers=True)
    with pytest.raises(ValueError, match="pipeline_axis is not supported with execution='reversible'"):
        jdalle.forward(jdalle.init_dalle(jax.random.PRNGKey(0), jcfg), jcfg, text.numpy(), codes.numpy(),
                       return_loss=True)


def test_a_bad_micro_batch_split_is_refused():
    with pytest.raises(ValueError, match="batch 6 % num_micro 4 != 0"):
        pipeline.pipeline(None, None, [], 6, (2, 4), [0, 1], 0, 4, 1, torch.float32, torch.device("cpu"))
    with pytest.raises(ValueError, match=r"interleave needs num_micro \(1\) >= pp stages \(2\)"):
        pipeline.pipeline(None, None, [], 6, (2, 4), [0, 1], 0, 1, 2, torch.float32, torch.device("cpu"))
