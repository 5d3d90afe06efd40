"""The device mesh (counterpart of `dalle_pytorch_tpu/parallel/mesh.py`).

The JAX package lays one logical mesh over every device with five named
axes and lets XLA emit the collectives.  The port runs one process per
device and builds a `torch.distributed` `DeviceMesh` over the processes,
with the same five axes:

  dp    pure data parallelism (gradients averaged over it)
  fsdp  data parallelism plus parameter and optimizer sharding (ZeRO)
  tp    tensor parallelism (attention heads, the feed-forward hidden size
        and the vocabulary split over it, Megatron's pattern)
  sp    sequence parallelism (each rank holds a contiguous part of the
        sequence; ring attention, `parallel/ring.py`) when the model's
        `seq_shard_axis` names it, else replicas of the step
  pp    pipeline parallelism (each rank runs its stage's layers,
        `parallel/pipeline.py`) when the model's `pipeline_axis` names it,
        else replicas of the step

The batch splits over (dp, fsdp) alone, as the JAX package's `BATCH_AXES`.
Ranks take their mesh coordinates in row-major order over (dp, fsdp, tp,
sp, pp), the JAX package's device order: pp varies fastest.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Mapping, Optional, Tuple, Union

import torch.distributed as dist

AXIS_DP = "dp"
AXIS_FSDP = "fsdp"
AXIS_TP = "tp"
AXIS_SP = "sp"
AXIS_PP = "pp"
MESH_AXES = (AXIS_DP, AXIS_FSDP, AXIS_TP, AXIS_SP, AXIS_PP)
# the axes of the port's DeviceMesh, in rank order
TORCH_MESH_AXES = MESH_AXES
# the axes the batch splits over
BATCH_AXES = (AXIS_DP, AXIS_FSDP)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    dp: int = -1  # -1: absorb all remaining ranks
    fsdp: int = 1
    tp: int = 1
    sp: int = 1
    pp: int = 1

    def resolve(self, n_devices: int) -> "MeshConfig":
        """Fill `dp=-1` with the ranks the other axes leave, as the JAX
        package does; a ValueError (the JAX package's AssertionError) when
        the product is not `n_devices`."""
        fixed = self.fsdp * self.tp * self.sp * self.pp
        dp = n_devices // fixed if self.dp == -1 else self.dp
        if dp * fixed != n_devices:
            raise ValueError(f"mesh {self.dp}x{self.fsdp}x{self.tp}x{self.sp}x{self.pp} != {n_devices} devices")
        return MeshConfig(dp, self.fsdp, self.tp, self.sp, self.pp)


_ACTIVE_MESH: contextvars.ContextVar = contextvars.ContextVar("dalle_torch_active_mesh", default=None)


def active_mesh():
    """The mesh of the innermost `mesh_context`, or None."""
    return _ACTIVE_MESH.get()


@contextlib.contextmanager
def mesh_context(mesh):
    """Publish `mesh` to `active_mesh()` for the block."""
    token = _ACTIVE_MESH.set(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE_MESH.reset(token)


def axis_sizes(mesh) -> dict:
    """{axis: size} of a DeviceMesh, or a plain mapping passed through (the
    comms ledger and the registry price meshes from their shape alone)."""
    if mesh is None:
        return {}
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.mesh.shape))
    return dict(mesh)


def mesh_coordinate(rank: int, axes: Mapping[str, int]) -> dict:
    """{axis: coordinate} of `rank` on a mesh of `axes` sizes, row-major
    over (dp, fsdp, tp, sp, pp)."""
    out = {}
    for axis in reversed(TORCH_MESH_AXES):
        size = int(axes.get(axis, 1))
        out[axis] = rank % size
        rank //= size
    return {axis: out[axis] for axis in TORCH_MESH_AXES}


def make_mesh(cfg: MeshConfig = MeshConfig(), device_type: str = "cuda",
              world_size: Optional[int] = None):
    """The (dp, fsdp, tp, sp, pp) DeviceMesh over the initialised process
    group, `dp=-1` resolved against its world size."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size() if world_size is None else world_size
    cfg = cfg.resolve(world)
    return init_device_mesh(device_type, tuple(getattr(cfg, axis) for axis in TORCH_MESH_AXES),
                            mesh_dim_names=TORCH_MESH_AXES)


def mesh_groups(mesh) -> Tuple[dict, object]:
    """({axis: its process group, None where the axis has size 1}, the
    group of this rank's data ranks: every rank that shares its (tp, sp,
    pp) coordinates, in row-major order over (dp, fsdp), None when that is
    one rank).  Every rank builds every data group, in the same order, as
    `new_group` asks."""
    axes = axis_sizes(mesh)
    groups = {axis: (mesh.get_group(axis) if axes[axis] > 1 else None) for axis in TORCH_MESH_AXES}
    inner = axes[AXIS_TP] * axes[AXIS_SP] * axes[AXIS_PP]
    data = None
    if axes[AXIS_DP] * axes[AXIS_FSDP] > 1:
        cached = getattr(mesh, "_dalle_data_group", None)
        if cached is None:
            world = dist.get_world_size()
            me = dist.get_rank()
            for t in range(inner):
                group = dist.new_group(list(range(t, world, inner)))
                if me % inner == t:
                    cached = group
            mesh._dalle_data_group = cached
        data = cached
    return groups, data


def axis_ranks(rank: int, axis: str, axes: Mapping[str, int]) -> list:
    """The global ranks of `rank`'s group along `axis`, in coordinate order
    (the peers of its point-to-point rotations)."""
    coord = mesh_coordinate(rank, axes)
    stride = 1
    for name in reversed(TORCH_MESH_AXES):
        if name == axis:
            break
        stride *= int(axes.get(name, 1))
    base = rank - coord[axis] * stride
    return [base + i * stride for i in range(int(axes.get(axis, 1)))]


def resolve_axes(mesh_or_axes: Union[Mapping[str, int], object, None]) -> dict:
    """{dp, fsdp, tp, sp, pp} sizes of a mesh or a mapping (missing axes
    are 1)."""
    axes = axis_sizes(mesh_or_axes)
    return {axis: int(axes.get(axis, 1)) for axis in TORCH_MESH_AXES}
