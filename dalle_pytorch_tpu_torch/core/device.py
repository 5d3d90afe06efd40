"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU.  With no
card and no explicit CPU request they raise: they never fall back to the CPU
on their own.  A distributed run puts each process on the card of its local
rank (torchrun's `LOCAL_RANK`, or the one the caller passes).
"""
from __future__ import annotations

import os
from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def local_rank() -> int:
    """This process's rank on its machine: torchrun's `LOCAL_RANK`, 0 when
    it is not set."""
    return int(os.environ.get("LOCAL_RANK", 0))


def resolve_device(device: DeviceLike = None, rank: Optional[int] = None) -> torch.device:
    """`None` means the card of this process's local rank (`rank`, else
    `local_rank()`): `cuda:{rank % device_count}`.  An explicit "cuda"
    without an index takes the same card; "cpu" is the only way onto the
    CPU.  Raises RuntimeError when CUDA is asked for (explicitly or by
    default) and no card is available."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", (local_rank() if rank is None else rank) % torch.cuda.device_count())
    return dev
