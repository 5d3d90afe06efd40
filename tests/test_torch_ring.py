"""The port's ring attention (`parallel/ring.py`) on gloo worlds of 2 and 4
CPU processes, against the JAX package's `ring_attention` on the 8-device
virtual CPU mesh (`tests/conftest.py`) with sp 2 and sp 4: causal,
non-causal, and causal under an axial_row pattern, each rank's part of the
output within 2e-5 and of dq, dk and dv within 5e-5 (the JAX ring tests'
tolerances), and the dense attention of the whole sequence within the same;
`ring_comm_bytes` equals the JAX package's; a hop of two tensors round the
ring lands on the next rank, through gloo's own route on CPU tensors.  Rank
code: `torch_mesh_ranks.ring_main` (no JAX)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_mesh_ranks as ranks
from dalle_pytorch_tpu.ops import masks as jmasks
from dalle_pytorch_tpu.parallel import ring as jring
from dalle_pytorch_tpu.parallel.mesh import MeshConfig as JMeshConfig
from dalle_pytorch_tpu.parallel.mesh import make_mesh as jmake_mesh
from dalle_pytorch_tpu_torch.ops.attention import attend
from dalle_pytorch_tpu_torch.ops.masks import _pattern_mask_np
from dalle_pytorch_tpu_torch.parallel import ring

B, H, N, D, FMAP = 2, 2, 32, 8, 4  # n = 32: text_len 17 + a 4 x 4 image, less the final token
KINDS = ("causal", "non_causal", "axial_row")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cases():
    rng = np.random.default_rng(5)
    out = {}
    for kind in KINDS:
        q, k, v, do = (torch.from_numpy(rng.standard_normal((B, H, N, D)).astype(np.float32)) for _ in range(4))
        mask = torch.from_numpy(_pattern_mask_np("axial_row", N, FMAP, 5, 1)) if kind == "axial_row" else None
        out[kind] = {"q": q, "k": k, "v": v, "do": do, "causal": kind != "non_causal", "mask": mask}
    return out


@pytest.fixture(scope="module")
def cases():
    return _cases()


def _spawn(out_dir, world, cases):
    torch.save(cases, os.path.join(out_dir, "ring.inputs.pt"))
    mp.spawn(ranks.ring_main, args=(world, os.path.join(out_dir, "rendezvous"), str(out_dir)), nprocs=world)
    return [torch.load(os.path.join(out_dir, f"ring.rank{r}.pt")) for r in range(world)]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, cases):
    return {world: _spawn(tmp_path_factory.mktemp(f"ring{world}"), world, cases) for world in (2, 4)}


def _jax_ring(c, sp):
    mesh = jmake_mesh(JMeshConfig(dp=-1, sp=sp))
    mask = None if c["mask"] is None else jnp.asarray(jmasks._pattern_mask_np("axial_row", N, FMAP, 5, 1))

    def f(q, k, v):
        return jring.ring_attention(q, k, v, mesh, causal=c["causal"], mask=mask)

    @jax.jit
    def out_and_grads(q, k, v, do):
        out, vjp = jax.vjp(f, q, k, v)
        return (out, *vjp(do))

    return [np.asarray(t) for t in out_and_grads(*(jnp.asarray(c[x].numpy()) for x in ("q", "k", "v", "do")))]


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("kind", KINDS)
def test_ring_matches_the_jax_ring_and_dense_attention(kind, world, cases, worlds):
    c = cases[kind]
    got = [np.concatenate([r[kind][x].numpy() for r in worlds[world]], axis=2) for x in ("out", "dq", "dk", "dv")]
    want = _jax_ring(c, world)
    for name, a, b, tol in zip(("out", "dq", "dk", "dv"), got, want, (2e-5, 5e-5, 5e-5, 5e-5)):
        np.testing.assert_allclose(a, b, atol=tol, err_msg=name)
    # the dense attention of the whole sequence, under the same masks
    q, k, v = (c[x].clone().requires_grad_(True) for x in ("q", "k", "v"))
    mask = torch.ones(N, N, dtype=torch.bool) if c["mask"] is None else c["mask"].clone()
    if c["causal"]:
        mask &= torch.ones(N, N, dtype=torch.bool).tril()
    dense = attend(q * D ** -0.5, k, v, mask=mask)
    dense.backward(c["do"])
    for name, a, b, tol in zip(("out", "dq", "dk", "dv"), got, (dense, q.grad, k.grad, v.grad),
                               (2e-5, 5e-5, 5e-5, 5e-5)):
        np.testing.assert_allclose(a, b.detach().numpy(), atol=tol, err_msg=name)


@pytest.mark.parametrize("world", [2, 4])
def test_a_hop_reaches_the_next_rank(world, worlds):
    for r, got in enumerate(worlds[world]):
        a, b = got["hop"]
        prev = (r - 1) % world
        assert torch.equal(a, torch.full((3,), float(prev))) and torch.equal(b, torch.full((2, 2), prev))
        assert got["route"] == "gloo"


@pytest.mark.parametrize("args", [(2, 8, 640, 128, 2), (1, 4, 32, 16, 8), (4, 2, 100, 64, 4)])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_ring_comm_bytes_match_jax(args, itemsize):
    for backward in (True, False):
        assert ring.ring_comm_bytes(*args, itemsize=itemsize, include_backward=backward) == \
            jring.ring_comm_bytes(*args, itemsize=itemsize, include_backward=backward)
