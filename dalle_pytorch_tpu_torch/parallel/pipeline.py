"""Pipeline parallelism over the `pp` ranks (counterpart of
`dalle_pytorch_tpu/parallel/pipeline.py`).

Each stage holds its own layers: depth / P contiguous ones, or under
interleave v the JAX package's chunk map (the depth splits into v·P chunks
of depth / (v·P) layers, and stage s holds chunks s, s + P, ..., so a
micro-batch loops the stages v times).  The batch splits into M
micro-batches, and the schedule runs the JAX package's ticks: T = v·M + P
- 1 of them, in each of which a stage runs one chunk on the micro-batch
(virtual micro-batch t - s) it holds, if any, and then every stage passes
its activation to the next (`parallel/p2p.exchange`, the JAX package's
`ppermute`; the last stage's goes back to stage 0, which banks it for the
micro-batch's next round).

The forward runs without autograd and keeps only each virtual micro-batch's
stage input.  The backward is an explicit reverse schedule: the last stage
starts with the last virtual micro-batch and the loss's cotangent (or, in
an earlier round, the cotangent stage 0 sent round); each stage recomputes
its chunk from the saved input under autograd, pulls the cotangent back
through it and sends the input's cotangent to the previous stage.  Stage 0
hands the first round's cotangents to the embeddings.

`Pipeline` is that schedule as a `torch.autograd.Function` whose inputs are
the stage's parameters (the tensors the forward ran on: a caller's
`functional_call`, such as the train step's working copy), so that the
backward runs the recompute on them and returns their gradients, and whose
output is the stack's output on the last stage (a 0-d zero elsewhere, for
the caller's loss to carry the backward to every stage).  A stage that has
no micro-batch at a tick (a bubble) computes nothing; the stages tick
together all the same, and a stage's sp or tp ranks always hold the same
micro-batch, so their collectives meet.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from dalle_pytorch_tpu_torch.parallel.p2p import exchange


def default_num_micro(batch: int, stages: int) -> int:
    """The JAX package's choice: the divisor of `batch` that is at least
    `stages` and closest to 2·stages; if none reaches `stages`, the largest
    divisor."""
    divs = [m for m in range(1, batch + 1) if batch % m == 0]
    cands = [m for m in divs if m >= stages]
    if cands:
        return min(cands, key=lambda m: (abs(m - 2 * stages), m))
    return max(divs)


def pipeline_comm_bytes(batch: int, seq: int, dim: int, stages: int, num_micro: Optional[int] = None,
                        itemsize: int = 4, interleave: int = 1, include_backward: bool = True) -> float:
    """Per-rank wire bytes of one pipelined pass, as the JAX package prices
    it: every tick moves one micro-batch's activation (batch / M, seq, dim)
    to the next stage, T = v·M + P - 1 ticks forward and as many backward."""
    if num_micro is None:
        num_micro = default_num_micro(batch, stages)
    ticks = interleave * num_micro + stages - 1
    hop = float(batch // num_micro) * seq * dim * itemsize
    return ticks * hop * (2.0 if include_backward else 1.0)


def check_split(depth: int, stages: int, interleave: int) -> None:
    """The JAX package's asserts on the layer split, as ValueErrors."""
    if interleave < 1:
        raise ValueError(f"interleave must be >= 1, got {interleave}")
    if depth % (stages * interleave):
        raise ValueError(f"depth {depth} % (pp {stages} * interleave {interleave}) != 0")


def stage_chunks(depth: int, stages: int, stage: int, interleave: int = 1) -> Tuple[Tuple[int, int], ...]:
    """The (start, stop) layer ranges stage `stage` holds, in the order a
    micro-batch reaches them: chunks stage, stage + P, ... of depth / (v·P)
    layers (the JAX package's cyclic map; one contiguous chunk at v 1)."""
    check_split(depth, stages, interleave)
    size = depth // (stages * interleave)
    return tuple(((stage + r * stages) * size, (stage + r * stages + 1) * size) for r in range(interleave))


@dataclasses.dataclass(frozen=True)
class Schedule:
    """One pipelined pass on this rank: P stages (`ranks`, global ranks in
    stage order), this rank's stage, M micro-batches of `micro_shape`
    activations, v rounds."""

    ranks: Tuple[int, ...]
    stage: int
    num_micro: int
    interleave: int
    micro_shape: Tuple[int, ...]
    dtype: torch.dtype
    device: torch.device

    @property
    def stages(self) -> int:
        return len(self.ranks)

    @property
    def ticks(self) -> int:
        return self.interleave * self.num_micro + self.stages - 1

    def hop(self, h: torch.Tensor, forward: bool) -> torch.Tensor:
        """Every stage's `h` to the next stage (forward) or the previous one
        (backward), round the ring."""
        P, s = self.stages, self.stage
        to, frm = ((s + 1) % P, (s - 1) % P) if forward else ((s - 1) % P, (s + 1) % P)
        return exchange([h], self.ranks[to], self.ranks[frm])[0]


# run(chunk, h, micro, leaves) -> the stage's chunk `chunk` (its index in
# the stage's chunks) on micro-batch `micro`'s activation h, on the module's
# own parameters (leaves None) or on `leaves` (the stage's parameters, in
# the order the Function took them)
Run = Callable[[int, torch.Tensor, int, Optional[Sequence[torch.Tensor]]], torch.Tensor]


class Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run: Run, sched: Schedule, x: torch.Tensor, *params):
        P, s, M, v = sched.stages, sched.stage, sched.num_micro, sched.interleave
        VM = v * M
        xm = x.split(sched.micro_shape[0]) if s == 0 else None
        h = torch.zeros(sched.micro_shape, dtype=sched.dtype, device=sched.device)
        saved: List[Optional[torch.Tensor]] = [None] * VM
        outs: List[Optional[torch.Tensor]] = [None] * M
        ring: List[Optional[torch.Tensor]] = [None] * M
        for t in range(sched.ticks):
            if s == 0:
                if v > 1 and t >= P:  # the last stage's output of virtual micro t - P, for its next round
                    ring[(t - P) % M] = h
                if t < VM:
                    h = xm[t] if t < M else ring[t % M]
            j = t - s
            if 0 <= j < VM:
                saved[j] = h
                h = run(j // M, h, j % M, None)
                if s == P - 1 and j // M == v - 1:
                    outs[j % M] = h
            h = sched.hop(h, forward=True)
        ctx.run, ctx.sched = run, sched
        ctx.save_for_backward(*saved, *params)
        if s == P - 1:
            return torch.cat(outs)
        return torch.zeros((), dtype=sched.dtype, device=sched.device)

    @staticmethod
    def backward(ctx, g):
        run, sched = ctx.run, ctx.sched
        P, s, M, v = sched.stages, sched.stage, sched.num_micro, sched.interleave
        VM = v * M
        saved, params = ctx.saved_tensors[:VM], ctx.saved_tensors[VM:]
        want = ctx.needs_input_grad[3:]
        leaves = [p.detach().requires_grad_(w) for p, w in zip(params, want)]
        used = [leaf for leaf, w in zip(leaves, want) if w]
        grads: List[Optional[torch.Tensor]] = [None] * len(used)
        gm = g.split(sched.micro_shape[0]) if s == P - 1 else None
        dh = torch.zeros(sched.micro_shape, dtype=sched.dtype, device=sched.device)
        dx: List[Optional[torch.Tensor]] = [None] * M
        dring: List[Optional[torch.Tensor]] = [None] * M
        for u in range(sched.ticks):
            j_lin = u - (P - 1 - s)
            jj = VM - 1 - j_lin  # virtual micro-batches in reverse order
            if s == P - 1:
                if v > 1 and u >= P:  # stage 0's input cotangent of virtual micro VM + P - 1 - u
                    dring[(VM + P - 1 - u) % M] = dh
                if 0 <= j_lin < VM:
                    dh = gm[jj % M] if jj >= (v - 1) * M else dring[jj % M]
            if 0 <= j_lin < VM:
                h_in = saved[jj].detach().requires_grad_(True)
                with torch.enable_grad():
                    out = run(jj // M, h_in, jj % M, leaves)
                got = torch.autograd.grad(out, [h_in] + used, dh, allow_unused=True)
                for k, gk in enumerate(got[1:]):
                    if gk is not None:
                        grads[k] = gk if grads[k] is None else grads[k] + gk
                dh = got[0]
                if s == 0 and jj < M:
                    dx[jj % M] = dh
            dh = sched.hop(dh.contiguous(), forward=False)
        out_grads, it = [], iter(grads)
        for p, w in zip(params, want):
            if not w:
                out_grads.append(None)
                continue
            gk = next(it)
            out_grads.append(torch.zeros_like(p) if gk is None else gk)
        dxs = torch.cat(dx) if s == 0 and ctx.needs_input_grad[2] else None
        return (None, None, dxs, *out_grads)


def pipeline(run: Run, x: Optional[torch.Tensor], params: Sequence[torch.Tensor], batch: int,
             micro_shape_tail: Tuple[int, ...], ranks: Sequence[int], stage: int, num_micro: Optional[int],
             interleave: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The stack over the stages: `x` (batch, *tail), the stage input on
    stage 0 (None elsewhere); returns the stack's output on the last stage,
    a 0-d zero elsewhere.  num_micro None takes `default_num_micro`; a batch
    that M does not divide, or interleave with M below the stages, raises as
    the JAX package asserts."""
    P = len(ranks)
    M = default_num_micro(batch, P) if num_micro is None else int(num_micro)
    if batch % M:
        raise ValueError(f"batch {batch} % num_micro {M} != 0")
    if interleave > 1 and M < P:
        raise ValueError(f"interleave needs num_micro ({M}) >= pp stages ({P}): the wrap-around buffer must be "
                         "written before it is read")
    sched = Schedule(tuple(ranks), stage, M, interleave, (batch // M, *micro_shape_tail), dtype, device)
    if x is None:
        x = torch.empty(0, dtype=dtype, device=device)
    return Pipeline.apply(run, sched, x, *params)
