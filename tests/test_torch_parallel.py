"""The port's host modules of distributed training, held against the JAX
package's: the partition registry's spec of every leaf on the meshes and
ZeRO stages of `test_resharding.py`, its fingerprint, `topology_meta`,
`MeshConfig.resolve`, the backend registry, the comms ledger's bytes, and
the name map under which the port's parameters meet the registry.  No
process group is started here (`test_torch_parallel_steps.py` runs the
sharded step)."""
import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.models import dalle as jdalle
from dalle_pytorch_tpu.models.dalle import DALLEConfig as JDALLEConfig
from dalle_pytorch_tpu.observability import comms as jcomms
from dalle_pytorch_tpu.parallel import backend as jbackend
from dalle_pytorch_tpu.parallel import mesh as jmesh
from dalle_pytorch_tpu.parallel import registry as jregistry
from dalle_pytorch_tpu.parallel.train_step import StepSettings as JStepSettings
from dalle_pytorch_tpu_torch import weights
from dalle_pytorch_tpu_torch.models.dalle import DALLEConfig
from dalle_pytorch_tpu_torch.observability import comms
from dalle_pytorch_tpu_torch.parallel import backend, mesh, registry, sharding
from dalle_pytorch_tpu_torch.parallel.train_step import StepSettings

# test_resharding.py's MESH_CASES, as axis sizes
MESH_CASES = [
    ({"dp": 8}, 0),
    ({"dp": 1, "fsdp": 8}, 1),
    ({"dp": 1, "fsdp": 8}, 3),
    ({"dp": 2, "tp": 4}, 0),
    ({"dp": 2, "pp": 4}, 0),
    ({"dp": 1, "fsdp": 2, "tp": 2, "pp": 2}, 3),
]
MODEL = dict(dim=128, depth=4, num_text_tokens=384, text_seq_len=16, heads=4, dim_head=32, num_image_tokens=512,
             image_fmap_size=8)


@pytest.fixture(scope="module")
def jax_params():
    params = jdalle.init_dalle(jax.random.PRNGKey(0), JDALLEConfig(**MODEL))
    return {jregistry._path_str(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}


@pytest.mark.parametrize("axes,zero_stage", MESH_CASES)
@pytest.mark.parametrize("moments", [False, True])
def test_registry_specs_match_jax_leaf_for_leaf(jax_params, axes, zero_stage, moments):
    """Every leaf of a DALL-E's JAX tree gets the JAX package's spec, as
    parameter and as optimizer moment, on each mesh and ZeRO stage."""
    port, ref = registry.default_registry(), jregistry.default_registry()
    full = {**{a: 1 for a in jmesh.MESH_AXES}, **axes}
    for path, leaf in jax_params.items():
        got = port.resolve(path, leaf.shape, full, zero_stage=zero_stage, moments=moments)
        want = ref.resolve(path, leaf.shape, full, zero_stage=zero_stage, moments=moments)
        assert tuple(got) == tuple(want), (path, axes, zero_stage, got, want)
    specs = (sharding.opt_state_specs if moments else sharding.param_specs)(jax_params, full, zero_stage)
    assert specs == {path: ref.resolve(path, leaf.shape, full, zero_stage=zero_stage, moments=moments)
                     for path, leaf in jax_params.items()}
    assert port.shard_fraction(jax_params, full, zero_stage) == pytest.approx(
        ref.shard_fraction(jax_params, full, zero_stage), rel=1e-12)


def test_name_map_reaches_every_jax_leaf(jax_params):
    """The weight bridge's name map puts each of the port's parameters on a
    leaf of the JAX tree with its shape, and reaches every leaf."""
    paths = weights.dalle_param_paths(DALLEConfig(**MODEL))
    assert {p.path for p in paths.values()} == set(jax_params)
    for name, p in paths.items():
        assert tuple(jax_params[p.path].shape) == p.shape, name


def test_fingerprint_and_topology_match_jax():
    assert registry.default_registry().fingerprint() == jregistry.default_registry().fingerprint()
    assert registry.PartitionRegistry(min_shard_size=256).fingerprint() == \
        jregistry.PartitionRegistry(min_shard_size=256).fingerprint()
    assert registry.default_registry().describe() == jregistry.default_registry().describe()
    for axes in ({"dp": 2, "fsdp": 1, "tp": 2, "sp": 1, "pp": 1}, {"fsdp": 4}, {}):
        assert registry.topology_meta(axes) == jregistry.topology_meta(axes)
        assert registry.topology_meta(axes, device_count=8) == jregistry.topology_meta(axes, device_count=8)
        assert registry.normalize_mesh_axes(axes) == jregistry.normalize_mesh_axes(axes)
    assert registry.meshes_equal({"dp": 8, "tp": 1}, {"dp": 8}) and not registry.meshes_equal({"dp": 8}, {"fsdp": 8})


@pytest.mark.parametrize("cfg,n", [((-1, 1, 1), 8), ((-1, 2, 2), 8), ((2, 2, 2), 8), ((1, 4, 1), 4),
                                   ((-1, 3, 1), 8), ((2, 2, 1), 8)])
def test_mesh_config_resolve_matches_jax(cfg, n):
    dp, fsdp, tp = cfg
    try:
        want = jmesh.MeshConfig(dp, fsdp, tp).resolve(n)
    except AssertionError:  # the port raises ValueError, which `python -O` keeps
        with pytest.raises(ValueError, match="devices"):
            mesh.MeshConfig(dp, fsdp, tp).resolve(n)
        return
    got = mesh.MeshConfig(dp, fsdp, tp).resolve(n)
    assert (got.dp, got.fsdp, got.tp, got.sp, got.pp) == (want.dp, want.fsdp, want.tp, want.sp, want.pp)


@pytest.mark.parametrize("cfg", [(1, 1, 1, 2, 1), (1, 1, 1, 1, 2), (2, 1, 1, 2, 2), (1, 2, 1, 1, 4), (1, 1, 2, 4, 1)])
def test_mesh_lays_sp_and_pp_out_as_jax(cfg):
    """sp and pp build meshes now: ranks take their coordinates where the
    JAX package lays its devices, row-major over (dp, fsdp, tp, sp, pp), and
    each rank's sp and pp groups are the JAX mesh's rows along those axes."""
    jm = jmesh.make_mesh(jmesh.MeshConfig(*cfg), devices=jax.devices()[: int(np.prod(cfg))])
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    axes = dict(zip(mesh.MESH_AXES, cfg))
    assert mesh.MeshConfig(*cfg).resolve(int(np.prod(cfg))) == mesh.MeshConfig(*cfg)
    for index in np.ndindex(ids.shape):
        r = int(ids[index])
        assert tuple(mesh.mesh_coordinate(r, axes).values()) == index
        for d, axis in enumerate(mesh.MESH_AXES):
            row = ids[index[:d] + (slice(None),) + index[d + 1:]]
            assert mesh.axis_ranks(r, axis, axes) == [int(x) for x in row], (axis, r)


def test_mesh_context_publishes_the_active_mesh():
    assert mesh.active_mesh() is None
    with mesh.mesh_context({"dp": 2}) as m:
        assert mesh.active_mesh() is m
    assert mesh.active_mesh() is None


def test_mesh_coordinates_are_row_major():
    axes = {"dp": 2, "fsdp": 2, "tp": 2}
    coords = [mesh.mesh_coordinate(r, axes) for r in range(8)]
    want = np.arange(8).reshape(2, 2, 2)
    for r, c in enumerate(coords):
        assert want[c["dp"], c["fsdp"], c["tp"]] == r


def test_backend_registry_matches_jax():
    """The same flags, names and dummy behaviour as the JAX registry; `jax`
    names the torch backend, so that a JAX command line runs as it is."""
    parser = backend.wrap_arg_parser(argparse.ArgumentParser())
    jparser = jbackend.wrap_arg_parser(argparse.ArgumentParser())
    assert {a.dest for a in parser._actions} == {a.dest for a in jparser._actions}
    args = parser.parse_args(["--distributed_backend", "none"])
    be = backend.set_backend_from_args(args)
    be.initialize()
    assert be.get_world_size() == 1 and be.is_root_worker() and be.get_local_rank() == 0
    assert not backend.is_distributed
    be.check_batch_size(4)
    assert be.average_all(3.0) == 3.0
    for name in ("jax", "torch"):
        be = backend.set_backend_from_args(parser.parse_args(["--distributed_backend", name, "--num_processes", "2",
                                                             "--process_id", "1"]))
        assert isinstance(be, backend.TorchBackend) and backend.is_distributed and be.BACKEND_NAME == "Torch"
        assert backend.using_backend("torch") and backend.using_backend(backend.TorchBackend)
    with pytest.raises(ValueError, match="unknown distributed backend"):
        backend.set_backend_from_args(argparse.Namespace(distributed_backend="nccl"))
    with pytest.raises(ValueError, match="unknown distributed backend"):
        jbackend.set_backend_from_args(argparse.Namespace(distributed_backend="nccl"))


def test_torch_backend_without_rendezvous_exits(monkeypatch):
    for key in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    be = backend.TorchBackend(cpu=True)
    with pytest.raises(SystemExit, match="torchrun"):
        be.initialize()


@pytest.mark.parametrize("axes,kw", [
    ({"dp": 2, "tp": 2}, {}),
    ({"fsdp": 4}, {}),
    ({"fsdp": 4}, {"zero_stage": 1}),
    ({"fsdp": 4}, {"zero_stage": 3, "grad_accum": 2}),
    ({"dp": 2, "fsdp": 2, "tp": 2}, {"zero_stage": 3, "compute_itemsize": 2}),
    ({"dp": 4}, {"param_shard_fraction": 0.75}),
])
def test_comms_ledger_matches_jax(axes, kw):
    base = dict(param_bytes=1e6, grad_bytes=4e6, batch=16, seq_len=64, dim=32, depth=4, heads=4, dim_head=8)
    assert comms.step_comms_ledger(axes, **base, **kw) == jcomms.step_comms_ledger(axes, **base, **kw)
    for n in (1, 2, 8):
        assert comms.ring_all_reduce_bytes(1e6, n) == jcomms.ring_all_reduce_bytes(1e6, n)
        assert comms.all_gather_bytes(1e6, n) == jcomms.all_gather_bytes(1e6, n)
        assert comms.reduce_scatter_bytes(1e6, n) == jcomms.reduce_scatter_bytes(1e6, n)


def test_comms_ledger_prices_sp_and_pp_as_jax():
    """The ledger's sp row (ring attention in every layer) and pp row (the
    stage hops) give the JAX package's bytes."""
    base = dict(param_bytes=1, grad_bytes=1, batch=2, seq_len=4, dim=4, depth=1, heads=1, dim_head=4)
    for axes, kw in (({"sp": 2}, {}), ({"pp": 4}, {"pp_num_micro": 2, "pp_interleave": 2}),
                     ({"dp": 2, "sp": 2, "pp": 2}, {"compute_itemsize": 2})):
        assert comms.step_comms_ledger(axes, **base, **kw) == jcomms.step_comms_ledger(axes, **base, **kw)


def test_dalle_step_comms_matches_jax_on_a_model(jax_params):
    """The ledger of a live DALL-E step: the port's parameters (full, under
    their names) priced through the registry on their JAX paths give the
    JAX package's bytes for its tree."""
    cfg = DALLEConfig(**MODEL)
    paths = weights.dalle_param_paths(cfg)
    params = {name: torch.zeros(p.shape[::-1] if p.transposed else p.shape) for name, p in paths.items()}
    jtree = jax.tree_util.tree_map(jnp.asarray, jdalle.init_dalle(jax.random.PRNGKey(0), JDALLEConfig(**MODEL)))
    for axes, stage in (({"dp": 2, "fsdp": 2, "tp": 2}, 3), ({"fsdp": 4}, 1), ({"tp": 4}, 0),
                        ({"dp": 2, "pp": 2}, 0), ({"sp": 2, "tp": 2, "pp": 2}, 3)):
        got = comms.dalle_step_comms(axes, params, cfg, 16, StepSettings(zero_stage=stage),
                                     registry=registry.default_registry())
        want = jcomms.dalle_step_comms(axes, jtree, JDALLEConfig(**MODEL), 16, JStepSettings(zero_stage=stage),
                                       registry=jregistry.default_registry())
        assert got["total_bytes_per_step"] == pytest.approx(want["total_bytes_per_step"], rel=1e-12)
        assert [r["axis"] for r in got["per_axis"]] == [r["axis"] for r in want["per_axis"]]
    assert comms.tree_float_bytes(params) == jcomms.tree_float_bytes(jtree)
    assert comms.dalle_step_comms(None, params, cfg, 16) is None


def test_comms_roofline_matches_jax():
    for args in ((1e9, 1e12, 1e14, 1e11, 1), (1e6, 1e12, 1e12, 1e12, 1), (1e9, 8e12, 1e12, 1e11, 8)):
        got = comms.comms_roofline(*args[:2], peak_flops=args[2], link_bytes_per_s=args[3], n_chips=args[4])
        want = jcomms.comms_roofline(*args[:2], peak_flops=args[2], ici_bytes_per_s=args[3], n_chips=args[4])
        for key in ("comms_s_at_peak", "compute_s_at_peak", "comms_over_compute", "bound", "n_chips", "peak_flops"):
            assert got[key] == want[key], key
        assert got["link_bytes_per_s"] == want["ici_bytes_per_s"]


def test_placements_and_shard_tree():
    from torch.distributed.tensor import Replicate, Shard

    spec = registry.P("fsdp", "tp")
    assert sharding.placements(spec) == [Replicate(), Shard(0), Shard(1), Replicate(), Replicate()]
    x = torch.arange(32.0).view(4, 8)
    axes = {"dp": 1, "fsdp": 2, "tp": 2}
    pieces = [sharding.shard_tree({"x": x}, {"x": spec}, axes, rank=r)["x"] for r in range(4)]
    assert torch.equal(pieces[0], x[:2, :4]) and torch.equal(pieces[1], x[:2, 4:])
    assert torch.equal(pieces[2], x[2:, :4]) and torch.equal(pieces[3], x[2:, 4:])
    # the JAX layout's spec on a linear weight: its dims swap on the port's
    assert sharding.torch_spec(registry.P("fsdp", "tp"), True) == registry.P("tp", "fsdp")
