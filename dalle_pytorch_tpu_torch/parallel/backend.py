"""The distributed-backend facade (counterpart of
`dalle_pytorch_tpu/parallel/backend.py`): the same registry, argument-parser
wrapping and topology queries, with the JAX package's `JaxBackend` replaced by
`TorchBackend`, which joins a `torch.distributed` process group.  The
command-line name `jax` maps to it, so that a JAX command line runs as it is.

The JAX package drives every local device from one process; the port runs
one process per device (torchrun's model), so a mesh of N ranks is N
processes.  `DummyBackend` is one process: a mesh that resolves to more than
one rank under it exits, saying how to launch the N processes.

`TorchBackend` takes NCCL on the card and gloo only for a run that asked for
the CPU; it never falls back from one to the other.  It rendezvouses at
`--coordinator_address` (host:port, or a URL such as tcp://host:port or
file:///path) with `--num_processes` and `--process_id`, or else through
torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT).
"""
from __future__ import annotations

import os
from typing import Any, Optional

import torch
import torch.distributed as dist

from dalle_pytorch_tpu_torch.core.device import local_rank


class DistributedBackend:
    """The template of a backend (the JAX package's, and before it the
    reference's `distributed_backend.py`)."""

    BACKEND_NAME = "None"
    ROOT_RANK = 0

    def __init__(self):
        self.is_initialized = False

    def has_backend(self) -> bool:
        return True

    def initialize(self):
        self._initialize()
        self.is_initialized = True

    def _initialize(self):
        raise NotImplementedError

    def require_init(self):
        assert self.is_initialized, f"{self.BACKEND_NAME} backend not initialized; call initialize() first"

    def wrap_arg_parser(self, parser):
        return parser

    def get_world_size(self) -> int:
        self.require_init()
        return self._get_world_size()

    def get_rank(self) -> int:
        self.require_init()
        return self._get_rank()

    def get_local_rank(self) -> int:
        self.require_init()
        return self._get_local_rank()

    def is_root_worker(self) -> bool:
        return self.get_rank() == self.ROOT_RANK

    def is_local_root_worker(self) -> bool:
        return self.get_local_rank() == self.ROOT_RANK

    def local_barrier(self):
        self.require_init()
        self._local_barrier()

    def check_batch_size(self, batch_size: int):
        assert batch_size >= self.get_world_size(), (
            f"batch size can't be smaller than number of processes ({batch_size} < {self.get_world_size()})"
        )

    def average_all(self, value):
        """The mean of `value` (a number or a tensor) over every process."""
        self.require_init()
        return self._average_all(value)

    def shutdown(self) -> None:
        """Leave the process group, where there is one."""

    def describe(self):
        """{backend, world_size} of the process group, or None."""
        return None


class DummyBackend(DistributedBackend):
    """One process, no process group (the reference's dummy backend)."""

    BACKEND_NAME = "Dummy"

    def _initialize(self):
        pass

    def _get_world_size(self) -> int:
        return 1

    def _get_rank(self) -> int:
        return self.ROOT_RANK

    def _get_local_rank(self) -> int:
        return self.ROOT_RANK

    def _local_barrier(self):
        pass

    def _average_all(self, value):
        return value


class TorchBackend(DistributedBackend):
    """A `torch.distributed` process group: NCCL on the card, gloo when the
    run asked for the CPU (`cpu=True`)."""

    BACKEND_NAME = "Torch"

    def wrap_arg_parser(self, parser):
        parser.add_argument("--coordinator_address", type=str, default=None,
                            help="host:port (or tcp:// / file:// URL) of the rendezvous; without it, torchrun's "
                                 "environment")
        parser.add_argument("--num_processes", type=int, default=None)
        parser.add_argument("--process_id", type=int, default=None)
        return parser

    def __init__(self, coordinator_address=None, num_processes=None, process_id=None, cpu: bool = False):
        super().__init__()
        self._coord = (coordinator_address, num_processes, process_id)
        self.cpu = cpu

    def _initialize(self):
        if dist.is_initialized():
            return
        coord, num, pid = self._coord
        kind = "gloo" if self.cpu else "nccl"
        if not self.cpu and not torch.cuda.is_available():
            raise RuntimeError("--distributed_backend torch on the card needs CUDA; pass --device cpu for gloo")
        if coord is not None:
            if num is None or pid is None:
                raise ValueError("--coordinator_address takes --num_processes and --process_id")
            url = coord if "://" in coord else f"tcp://{coord}"
            dist.init_process_group(kind, init_method=url, world_size=num, rank=pid)
        elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            dist.init_process_group(kind, init_method="env://")
        else:
            raise SystemExit("--distributed_backend torch: no rendezvous; launch the processes under torchrun "
                             "(python -m torch.distributed.run --nproc_per_node N -m ...) or give "
                             "--coordinator_address, --num_processes and --process_id")
        if not self.cpu:
            torch.cuda.set_device(self._get_local_rank() % torch.cuda.device_count())

    def _get_world_size(self) -> int:
        return dist.get_world_size()

    def _get_rank(self) -> int:
        return dist.get_rank()

    def _get_local_rank(self) -> int:
        if "LOCAL_RANK" in os.environ:
            return local_rank()
        return dist.get_rank()

    def _local_barrier(self):
        dist.barrier()

    def _average_all(self, value):
        if dist.get_world_size() == 1:
            return value
        device = torch.device("cpu") if self.cpu else torch.device("cuda", torch.cuda.current_device())
        t = torch.as_tensor(value, dtype=torch.float64, device=device).clone()
        dist.all_reduce(t)
        t /= dist.get_world_size()
        return float(t) if t.ndim == 0 else t

    def shutdown(self) -> None:
        if dist.is_initialized():
            dist.destroy_process_group()

    def describe(self):
        return {"backend": dist.get_backend(), "world_size": dist.get_world_size()}


_DEFAULT = "none"
BACKENDS = {
    "none": DummyBackend,
    "dummy": DummyBackend,
    "torch": TorchBackend,
    # a JAX command line runs as it is
    "jax": TorchBackend,
}

is_distributed: Optional[bool] = None
backend: Optional[DistributedBackend] = None


def wrap_arg_parser(parser):
    parser.add_argument("--distributed_backend", "--distr_backend", type=str, default=_DEFAULT,
                        help="none, or torch (jax is another name for it): one process per device")
    for b in dict.fromkeys(BACKENDS.values()):
        parser = b().wrap_arg_parser(parser)
    return parser


def set_backend_from_args(args: Any) -> DistributedBackend:
    """Select, store and return the backend of the parsed flags; a run on
    `--device cpu` takes gloo."""
    global is_distributed, backend
    name = getattr(args, "distributed_backend", _DEFAULT).lower()
    if name not in BACKENDS:
        raise ValueError(f"unknown distributed backend: {name!r} (choose from {sorted(BACKENDS)})")
    if BACKENDS[name] is TorchBackend:
        device = getattr(args, "device", None)
        backend = TorchBackend(getattr(args, "coordinator_address", None), getattr(args, "num_processes", None),
                               getattr(args, "process_id", None),
                               cpu=device is not None and torch.device(device).type == "cpu")
        is_distributed = True
    else:
        backend = DummyBackend()
        is_distributed = False
    return backend


def using_backend(test_backend) -> bool:
    if isinstance(test_backend, str):
        return backend is not None and backend.BACKEND_NAME.lower() == test_backend.lower()
    return isinstance(backend, test_backend)
