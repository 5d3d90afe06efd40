"""The pipeline on a gloo world of 4 CPU processes: pp 4 at depth 8, fsdp
2 x pp 2 at ZeRO-3 and sp 2 x pp 2 through the ring, each held against the
JAX package's one-device `forward` / `jax.grad` (loss rtol 1e-5, leaves
rtol 5e-3 / atol 2e-5) and the port's one-process step (1e-5), the stages'
resident bytes those of their layers and the leaves outside the stack (a
ZeRO-3 stage half of that).  Rank code: `torch_mesh_ranks.py` (no JAX)."""
import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from test_torch_pipeline import assert_stages_hold_their_layers
from test_torch_seq_parallel import assert_matches_jax, assert_matches_one_process, jax_loss_and_grads

WORLD4 = ["pp4_depth8", "fsdp2_pp2_z3", "sp2_pp2_ring"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return ranks.spawn_world(tmp_path_factory.mktemp("pp_world4"), 4, WORLD4)


@pytest.fixture(scope="module")
def jax_refs():
    return {depth: jax_loss_and_grads(ranks.CASES[name]) for depth, name in ((4, "fsdp2_pp2_z3"), (8, "pp4_depth8"))}


@pytest.mark.parametrize("name", WORLD4)
def test_pp_step_matches_one_process(name, world4):
    refs, got = world4
    assert_matches_one_process(got[name], refs[name])
    for losses in got[name]["loss_by_rank"]:
        np.testing.assert_allclose(losses, got[name]["loss"], rtol=1e-6)


@pytest.mark.parametrize("name", WORLD4)
def test_pp_loss_and_gradients_match_jax(name, world4, jax_refs):
    case = ranks.CASES[name]
    assert_matches_jax(world4[1][name], case, jax_refs[ranks.model_config(case).depth])


def test_each_stage_holds_its_layers_and_the_leaves_outside(world4):
    assert_stages_hold_their_layers(world4[1]["pp4_depth8"], ranks.CASES["pp4_depth8"])


def test_a_zero3_stage_holds_half_its_layers(world4):
    """fsdp 2 x pp 2 at ZeRO-3: mesh (1, 2, 1, 1, 2), and each rank (stage
    r % 2) holds at most 0.6 of what its stage holds unsharded."""
    _, got = world4
    assert got["fsdp2_pp2_z3"]["mesh"] == {"dp": 1, "fsdp": 2, "tp": 1, "sp": 1, "pp": 2}
    case = ranks.CASES["fsdp2_pp2_z3"]
    cfg = ranks.model_config(case)
    whole = ranks.stage_param_bytes(cfg, 2, cfg.pp_interleave)
    z3 = [r["params"] for r in got["fsdp2_pp2_z3"]["resident_by_rank"]]
    assert all(z3[r] <= 0.6 * whole[r % 2] for r in range(4)), (z3, whole)
