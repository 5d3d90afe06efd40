"""Helpers shared by the port's command lines (counterpart of
`dalle_pytorch_tpu/cli/common.py`)."""
from __future__ import annotations

from dalle_pytorch_tpu_torch.core.device import resolve_device
from dalle_pytorch_tpu_torch.parallel import backend as backend_mod
from dalle_pytorch_tpu_torch.parallel.mesh import MeshConfig, make_mesh
# the generate and serve CLIs' loader of any checkpoint format, as in the
# JAX package; it lives with the weight converters it feeds
from dalle_pytorch_tpu_torch.weights import load_dalle_bundle  # noqa: F401


def warn_vocab_mismatch(num_text_tokens: int, tokenizer) -> None:
    """Out-of-vocab caption ids are clamped by the model
    (`models/dalle.remap_and_bos`); say so at every entry point that pairs
    a tokenizer with a model."""
    vocab = getattr(tokenizer, "vocab_size", None)
    if vocab is not None and num_text_tokens < vocab:
        print(
            f"WARNING: model num_text_tokens {num_text_tokens} < tokenizer vocab "
            f"{vocab}; out-of-range caption ids will be clamped onto the last "
            f"vocab id — check --num_text_tokens / tokenizer choice"
        )


def refuse(what: str, item: int) -> SystemExit:
    """The exit of a flag or input whose machinery the port does not have
    yet, naming its ROADMAP.md Queue 1 item."""
    return SystemExit(f"{what} is not ported yet; it comes with a later PR of the port (ROADMAP.md Queue 1 item "
                      f"{item})")


def add_mesh_flags(parser, pipeline: bool = False) -> None:
    """--zero_stage and the mesh's axis sizes, the JAX CLIs' flags; with
    `pipeline` also --mesh_sp and --mesh_pp, and the pipeline's
    --pp_num_micro and --pp_interleave."""
    parser.add_argument("--zero_stage", type=int, default=0, choices=[0, 1, 2, 3],
                        help="ZeRO: 1/2 shard the optimizer moments over fsdp, 3 the parameters too")
    axes = (("dp", -1), ("fsdp", 1), ("tp", 1)) + ((("sp", 1), ("pp", 1)) if pipeline else ())
    for name, default in axes:
        parser.add_argument(f"--mesh_{name}", type=int, default=default,
                            help="-1 absorbs the ranks the other axes leave" if name == "dp" else None)
    if pipeline:
        parser.add_argument("--pp_num_micro", type=int, default=None,
                            help="pipeline micro-batches (default: the JAX package's choice)")
        parser.add_argument("--pp_interleave", type=int, default=1,
                            help="circular pipeline: chunks a stage (needs depth %% (pp*v) == 0 and "
                                 "num_micro >= pp)")


def start_backend(args):
    """The backend of the flags, initialised: (backend, device).  A torch
    backend joins its process group (gloo under --device cpu, NCCL on the
    card) and each rank takes the card of its local rank."""
    be = backend_mod.set_backend_from_args(args)
    be.initialize()
    return be, resolve_device(args.device, rank=be.get_local_rank() if backend_mod.is_distributed else None)


def build_mesh(args, be, device):
    """The (dp, fsdp, tp, sp, pp) DeviceMesh of the flags over the
    backend's processes, or None for a one-process run; a mesh of more
    ranks than processes exits, and under the dummy backend says how to
    launch them."""
    cfg = MeshConfig(args.mesh_dp, args.mesh_fsdp, args.mesh_tp, getattr(args, "mesh_sp", 1),
                     getattr(args, "mesh_pp", 1))
    world = be.get_world_size()
    try:
        resolved = cfg.resolve(world)
    except ValueError:
        n = max(cfg.dp, 1) * cfg.fsdp * cfg.tp * cfg.sp * cfg.pp
        if not backend_mod.is_distributed:
            raise SystemExit(f"a mesh of {n} ranks runs one process per device: launch {n} processes, "
                             f"python -m torch.distributed.run --nproc_per_node {n} -m <this module> "
                             "--distributed_backend torch ...") from None
        raise SystemExit(f"the mesh dp {cfg.dp} x fsdp {cfg.fsdp} x tp {cfg.tp} x sp {cfg.sp} x pp {cfg.pp} does "
                         f"not fit {world} processes") from None
    if not backend_mod.is_distributed:
        return None, resolved
    return make_mesh(resolved, device.type), resolved
