"""Sequence parallelism in the sharded train step (`seq_shard_axis="sp"`) on
gloo worlds of 2 and 4 CPU processes: the DALL-E with rotary, the token
shift, tied embeddings and the full/axial_row/conv_like cycle, its 24
positions split over sp 2 and sp 4 (so that the text/image boundary and the
token shift's halo cross ranks), through ring attention and through the
gathered plain attention, with dropout and gradient accumulation, beside
dp and beside tp (with dropout); and the sp axis without the model knob (replicas of the step, the JAX
CLI's `--mesh_sp`).  Each case's loss and gradient of the initial weights
match the JAX package's one-device `forward` / `jax.grad` on the same v3
weights (loss rtol 1e-5, leaves rtol 5e-3 / atol 2e-5, the tolerances of
`tests/test_parallel.py`'s pipeline tests), and its three Adam steps the
port's one-process step (losses, gradient norms, final parameters to 1e-5).
Rank code: `torch_mesh_ranks.py` (no JAX)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from dalle_pytorch_tpu.models import dalle as jdalle
from dalle_pytorch_tpu_torch import weights

RTOL = 1e-5
WORLD2 = ["sp2_ring", "sp2_dense", "sp2_ring_dropout_accum", "sp2_replicas"]
WORLD4 = ["sp4_ring", "sp4_dense", "dp2_sp2_ring", "tp2_sp2_ring_dropout"]
DROPOUT = {"sp2_ring_dropout_accum", "tp2_sp2_ring_dropout"}  # the JAX package draws other masks


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return ranks.spawn_world(tmp_path_factory.mktemp("sp_world2"), 2, WORLD2)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return ranks.spawn_world(tmp_path_factory.mktemp("sp_world4"), 4, WORLD4)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def jax_loss_and_grads(case):
    """The JAX package's one-device loss and gradient (as the port's
    parameter names) of the case's initial weights on its first batch."""
    cfg = ranks.model_config(case)
    # the scanned layers: one compiled layer body, the unrolled stack's numbers
    jcfg = jdalle.DALLEConfig(**{**ranks.MODEL, "depth": cfg.depth}, scan_layers=True)
    inputs = ranks.make_inputs(case)
    params = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), weights.dalle_tree(inputs["weights"], cfg))
    batch = inputs["batches"][0]
    text, codes = (jnp.asarray(batch[k].numpy().astype(np.int32)) for k in ("text", "codes"))
    loss_fn = jax.value_and_grad(lambda p: jdalle.forward(p, jcfg, text, codes, return_loss=True))
    loss, grads = jax.jit(loss_fn)(params)
    return float(loss), grads


def assert_matches_jax(res, case, ref):
    loss, jgrads = ref
    np.testing.assert_allclose(res["first_loss"], loss, rtol=RTOL)
    cfg = ranks.model_config(case)
    port = weights.dalle_tree(res["grads"], cfg)
    got, want = jax.tree_util.tree_leaves(port), jax.tree_util.tree_leaves(jgrads)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=5e-3, atol=2e-5)


def assert_matches_one_process(res, ref):
    np.testing.assert_allclose(res["loss"], ref["loss"], rtol=RTOL)
    np.testing.assert_allclose(res["grad_norm"], ref["grad_norm"], rtol=RTOL)
    worst = max((_rel(res["params"][k], ref["params"][k]), k) for k in ref["params"])
    assert worst[0] <= RTOL, worst
    worst = max((_rel(res["grads"][k], ref["grads"][k]), k) for k in ref["grads"])
    assert worst[0] <= 1e-5, worst


@pytest.fixture(scope="module")
def jax_ref():
    return jax_loss_and_grads(ranks.CASES["sp2_ring"])


@pytest.mark.parametrize("name", WORLD2 + WORLD4)
def test_sp_step_matches_one_process(name, request):
    refs, got = request.getfixturevalue("world2" if name in WORLD2 else "world4")
    assert_matches_one_process(got[name], refs[name])
    # every rank reads the global batch's loss
    for losses in got[name]["loss_by_rank"]:
        np.testing.assert_allclose(losses, got[name]["loss"], rtol=1e-6)


@pytest.mark.parametrize("name", [n for n in WORLD2 + WORLD4 if n not in DROPOUT])
def test_sp_loss_and_gradients_match_jax(name, request, jax_ref):
    _, got = request.getfixturevalue("world2" if name in WORLD2 else "world4")
    assert_matches_jax(got[name], ranks.CASES[name], jax_ref)


def test_make_mesh_builds_the_sp_axis(world2):
    """`make_mesh(MeshConfig(sp=2))` lays the five axes out with sp 2, and
    its sp ranks hold every parameter (sp shards the sequence, not the
    weights)."""
    _, got = world2
    assert got["sp2_ring"]["mesh"] == {"dp": 1, "fsdp": 1, "tp": 1, "sp": 2, "pp": 1}
    full = got["sp2_ring"]["resident_by_rank"]
    assert full[0] == full[1] == got["sp2_replicas"]["resident_by_rank"][0]
