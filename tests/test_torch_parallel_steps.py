"""The sharded train step (`parallel/train_step.py` on a mesh) on gloo
worlds of 2 and 4 CPU processes, against the port's one-process step on the
same global batches: three steps of each configuration of
`torch_dist_ranks.CASES` (dp, fsdp at ZeRO 1/2/3, tp, dp x tp, fsdp x tp
at ZeRO-3, Adafactor on fsdp x tp, gradient accumulation (also at ZeRO-3),
ZeRO-3 under remat and reversible execution and at depth 6, bf16 storage
with injected rounding bits, a dynamic loss scale's overflow, clipping,
dropout, remat and reversible execution under tp, a shared feed-forward
under fsdp x tp at ZeRO-3; every case with tied embeddings and per-head
sparse layers) give the same losses and gradient norms to 1e-5 and the same final
parameters to 1e-5 (each leaf's norm-wise relative difference); the ZeRO-3
losses also match the JAX package's dp4 x fsdp2 ZeRO-3 mesh step to 2e-4,
as `test_parallel.py` holds its own; ZeRO-3 shards the parameters and
ZeRO-1 keeps them replicated; ZeRO-3's gathered parameters alive at once
do not grow with depth (one layer's at a time, not the model's); the full
state is gathered onto rank 0 alone.  Each world is spawned once (one torch thread
a rank, a `file://` rendezvous under the test's temporary directory); the
rank code imports no JAX."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.multiprocessing as mp

import torch_dist_ranks as ranks
from dalle_pytorch_tpu.models import dalle as jdalle
from dalle_pytorch_tpu.models.dalle import DALLEConfig as JDALLEConfig
from dalle_pytorch_tpu.parallel.mesh import MeshConfig as JMeshConfig
from dalle_pytorch_tpu.parallel.mesh import make_mesh as jmake_mesh
from dalle_pytorch_tpu.parallel.train_step import StepSettings as JStepSettings
from dalle_pytorch_tpu.parallel.train_step import make_train_step as jmake_train_step
from dalle_pytorch_tpu_torch import weights

RTOL = 1e-5


def _world(tmp_path_factory, world):
    out = tmp_path_factory.mktemp(f"world{world}")
    names = [n for n, c in ranks.CASES.items() if c.world == world]
    refs = {}
    for name in names:
        inputs = ranks.make_inputs(ranks.CASES[name])
        torch.save(inputs, out / f"{name}.inputs.pt")
        refs[name] = ranks.one_process(ranks.CASES[name], inputs)
    mp.spawn(ranks.rank_main, args=(world, str(out / "rendezvous"), str(out), names), nprocs=world)
    got = {}
    for name in names:
        got[name] = torch.load(out / f"{name}.result.pt")
        others = [torch.load(out / f"{name}.rank{r}.pt") for r in range(1, world)]
        for key in ("resident", "has_full_state", "gathered_peak"):
            got[name][f"{key}_by_rank"] = [got[name][key]] + [o[key] for o in others]
    return refs, got, out


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return _world(tmp_path_factory, 2)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return _world(tmp_path_factory, 4)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


@pytest.mark.parametrize("name", list(ranks.CASES))
def test_mesh_step_matches_one_process(name, request):
    refs, got, _ = request.getfixturevalue("world2" if ranks.CASES[name].world == 2 else "world4")
    ref, res = refs[name], got[name]
    np.testing.assert_allclose(res["loss"], ref["loss"], rtol=RTOL)
    np.testing.assert_allclose(res["grad_norm"], ref["grad_norm"], rtol=RTOL)
    assert res["skipped"] == ref["skipped"]
    if ranks.CASES[name].poison_step is not None:
        assert res["skipped"][ranks.CASES[name].poison_step] == 1 and sum(res["skipped"]) == 1
    assert set(res["params"]) == set(ref["params"])
    worst = max((_rel(res["params"][k], ref["params"][k]), k) for k in ref["params"])
    assert worst[0] <= RTOL, worst
    assert any(_rel(ref["params"][k], ranks.make_inputs(ranks.CASES[name])["weights"][k]) > 0
               for k in ref["params"])  # the steps moved the weights


def test_zero3_shards_parameters_and_zero1_keeps_them_replicated(world2):
    _, got, _ = world2
    dp, z1, z3 = (got[n]["resident_by_rank"] for n in ("dp2", "fsdp2_z1", "fsdp2_z3"))
    for r in range(2):
        assert z1[r]["params"] == dp[r]["params"]  # ZeRO-1: parameters replicated
        assert z1[r]["moments"] <= 0.6 * dp[r]["moments"]  # ...its moments sharded
        assert z3[r]["params"] <= 0.6 * dp[r]["params"] and z3[r]["moments"] <= 0.6 * dp[r]["moments"]


def test_zero3_gathers_one_layer_at_a_time(world2):
    """The most bytes of gathered parameters alive at once during ZeRO-3's
    steps: the same at depth 6 as at depth 3 (a layer's, plus the
    embeddings and logits gathered for the step), under a quarter of the
    depth-6 model; and the one-process state is gathered onto rank 0
    alone."""
    _, got, _ = world2
    deep, shallow = got["fsdp2_z3_depth6"], got["fsdp2_z3"]
    for r in range(2):
        peak = deep["gathered_peak_by_rank"][r]
        assert 0 < peak <= shallow["gathered_peak_by_rank"][r]
        assert peak <= 0.25 * deep["param_bytes"], (peak, deep["param_bytes"])
    for name in ("fsdp2_z3", "fsdp2_z1", "dp2", "tp2"):
        assert got[name]["has_full_state_by_rank"] == [True, False]


def test_zero3_losses_match_the_jax_mesh_step(world2):
    """The port's fsdp2 ZeRO-3 losses against the JAX package's dp4 x fsdp2
    ZeRO-3 step on its 8 virtual devices, from the same weights and
    batches."""
    _, got, out = world2
    case = ranks.CASES["fsdp2_z3"]
    inputs = torch.load(out / "fsdp2_z3.inputs.pt")
    cfg = ranks.model_config(case)
    jcfg = JDALLEConfig(**ranks.MODEL)
    params = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), weights.dalle_tree(inputs["weights"], cfg))

    def loss_fn(p, batch, key):
        return jdalle.forward(p, jcfg, batch["text"], batch["image_codes"], return_loss=True)

    init_fn, step_fn = jmake_train_step(loss_fn, optax.adam(ranks.LR), mesh=jmake_mesh(JMeshConfig(dp=4, fsdp=2)),
                                        settings=JStepSettings(zero_stage=3))
    state = init_fn(params)
    losses = []
    for i, batch in enumerate(inputs["batches"]):
        state, m = step_fn(state, {"text": jnp.asarray(batch["text"].numpy().astype(np.int32)),
                                   "image_codes": jnp.asarray(batch["codes"].numpy().astype(np.int32))},
                           jax.random.PRNGKey(i))
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(got["fsdp2_z3"]["loss"], losses, rtol=2e-4)
