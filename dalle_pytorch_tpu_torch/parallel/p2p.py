"""Point-to-point rotations between ranks: the ring's K/V hop and gradient
packet (`parallel/ring.py`), the token shift's halo (`ops/shift.py`) and
the pipeline's stage hop (`parallel/pipeline.py`), the port's counterparts
of the JAX package's `ppermute`.

`exchange` sends one buffer to a rank and receives one from another: the
tensors of a hop are packed into one byte buffer, so that each hop is one
send and one receive.  The route is chosen by the default group's backend
name, never by catching an error:

  nccl        `dist.batch_isend_irecv`, the send and the receive posted as
              one group (NCCL runs a group's sends and receives together,
              so a ring of two, whose next rank is also its previous one,
              cannot deadlock)
  gloo        `isend` and `irecv` of CPU tensors, both posted before
              either is waited on
  gloo-host   what a CUDA tensor takes under gloo (whose send of a CUDA
              tensor writes from the device pointer and aborts the
              process): the packed buffer is copied to the host, sent,
              received into a host buffer and copied back, the compute
              staying on the card

`exchange.calls` and `exchange.bytes` count the hops and the bytes sent.
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist


def route(device: torch.device) -> str:
    """The route a hop of tensors on `device` takes on the default group."""
    backend = dist.get_backend()
    if backend == "nccl":
        return "nccl"
    if backend == "gloo":
        return "gloo-host" if device.type == "cuda" else "gloo"
    return backend


def _pack(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.detach().contiguous().reshape(-1).view(torch.uint8) for t in tensors])


def _unpack(buf: torch.Tensor, like: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    out, at = [], 0
    for t in like:
        n = t.numel() * t.element_size()
        part = buf[at:at + n]
        if at % t.element_size():  # an unaligned segment: a copy of its bytes
            part = part.clone()
        out.append(part.view(t.dtype).view(t.shape))
        at += n
    return out


def exchange(tensors: Sequence[torch.Tensor], send_to: int, recv_from: int) -> List[torch.Tensor]:
    """Send `tensors` to global rank `send_to` and receive, from global rank
    `recv_from`, tensors of the same shapes and dtypes, new tensors on
    their device.  Both peers call it at the same point of their programs;
    a rank that sends to itself gets its own tensors back."""
    device = tensors[0].device
    send = _pack(tensors)
    recv = torch.empty_like(send)
    exchange.calls += 1
    exchange.bytes += send.numel()
    if send_to == recv_from == dist.get_rank():
        recv.copy_(send)
        return _unpack(recv, tensors)
    how = route(device)
    if how == "nccl":
        works = dist.batch_isend_irecv([dist.P2POp(dist.isend, send, send_to), dist.P2POp(dist.irecv, recv, recv_from)])
        for work in works:
            work.wait()
        return _unpack(recv, tensors)
    host = how == "gloo-host"
    send_buf = send.cpu() if host else send
    recv_buf = torch.empty(recv.shape, dtype=torch.uint8) if host else recv
    works = [dist.isend(send_buf, send_to), dist.irecv(recv_buf, recv_from)]
    for work in works:
        work.wait()
    if host:
        recv.copy_(recv_buf)
    return _unpack(recv, tensors)


exchange.calls = 0
exchange.bytes = 0
