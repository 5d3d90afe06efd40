"""Reversible execution (counterpart of `dalle_pytorch_tpu/models/reversible.py`).

The twin stream of RevNet-style layers: both streams start as x; layer i
adds its attention branch to the first stream, `x1 += f_i(x2)`, then its
feed-forward branch to the second, `x2 += g_i(x1)`; the output is
`(x1 + x2) / 2`.  Each layer's input follows from its output
(`x2 = y2 - g_i(y1)`, then `x1 = y1 - f_i(x2)`), so the backward rebuilds
the inputs layer by layer instead of keeping them: the memory of the
activations stays that of two streams, whatever the depth.

`Reversible` is that backward as a `torch.autograd.Function`.  Its forward
runs the stack without a graph and saves the two final streams; its backward
walks the layers in reverse and, at each, recomputes g_i and then f_i under
autograd on the rebuilt inputs and pulls the stream gradients back through
them, in the order of the JAX package's `rev_bwd`.  The parameters the
forward used are explicit inputs of the Function and get their gradients
from `torch.autograd.grad`, so the Function serves a caller's
`functional_call` (the train step's bf16 working copy): the backward runs
each branch on those tensors, not on whatever the module holds by then.  A
parameter that several layers share is one input, and its gradient is the
sum over them.  Dropout needs nothing of its own: a branch draws its masks
from a seed fixed per layer and branch before the forward, so the recompute
draws the same ones.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

# branch(i, kind, h, params) -> layer i's branch ("attn" or "ff") on h; with
# `params` (the layer's parameter names -> tensors) it runs on them, with
# None on the module's own
Branch = Callable[[int, str, torch.Tensor, Optional[Dict[str, torch.Tensor]]], torch.Tensor]


def twin_stream(branch: Branch, depth: int, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two streams after `depth` layers, as plain tensor ops (the
    forward of `Reversible`, and the whole pass where no gradient is
    taken)."""
    x1 = x2 = x
    for i in range(depth):
        x1 = x1 + branch(i, "attn", x2, None)
        x2 = x2 + branch(i, "ff", x1, None)
    return x1, x2


class Reversible(torch.autograd.Function):
    """(branch, plan, x, *params) -> (y1, y2).  `plan[i]` maps layer i's
    parameter names to indices into `params`; `params` holds each tensor
    once.  `on_rebuilt`, when set, is called at the end of each backward
    with the two streams it rebuilt for the first layer's input, which
    both equal x up to rounding (a diagnostic of the reconstruction)."""

    on_rebuilt: Optional[Callable[[torch.Tensor, torch.Tensor], None]] = None

    @staticmethod
    def forward(ctx, branch: Branch, plan: List[Dict[str, int]], x, *params):
        y1, y2 = twin_stream(branch, len(plan), x)
        ctx.branch, ctx.plan = branch, plan
        ctx.save_for_backward(y1, y2, *params)
        return y1, y2

    @staticmethod
    def backward(ctx, dy1, dy2):
        y1, y2, *params = ctx.saved_tensors
        want = ctx.needs_input_grad[3:]
        leaves = [p.detach().requires_grad_(w) for p, w in zip(params, want)]
        grads: List[Optional[torch.Tensor]] = [None] * len(leaves)

        def pull(i: int, kind: str, h: torch.Tensor, dout: torch.Tensor):
            """Recompute layer i's branch on h under autograd; (its output,
            the gradient of h, accumulated into `grads` the parameters')."""
            names = ctx.plan[i]
            used = sorted({k for k in names.values() if want[k]})
            h = h.detach().requires_grad_(True)
            with torch.enable_grad():
                out = ctx.branch(i, kind, h, {n: leaves[k] for n, k in names.items()})
            got = torch.autograd.grad(out, [h] + [leaves[k] for k in used], dout, allow_unused=True)
            for k, g in zip(used, got[1:]):
                if g is not None:
                    grads[k] = g if grads[k] is None else grads[k] + g
            return out.detach(), got[0]

        for i in reversed(range(len(ctx.plan))):
            g, dh = pull(i, "ff", y1, dy2)  # x2 = y2 - g_i(y1)
            x2 = y2 - g
            z1 = dy1 + dh
            f, dh = pull(i, "attn", x2, z1)  # x1 = y1 - f_i(x2)
            x1 = y1 - f
            dy1, dy2 = z1, dy2 + dh
            y1, y2 = x1, x2
        if Reversible.on_rebuilt is not None:
            Reversible.on_rebuilt(y1, y2)
        return (None, None, dy1 + dy2, *grads)


def reversible(branch: Branch, layer_params: List[Dict[str, torch.Tensor]], x: torch.Tensor) -> torch.Tensor:
    """The twin stream's output `(y1 + y2) / 2`, differentiable through
    `Reversible`.  layer_params[i]: the parameters layer i's branches use,
    by name: the tensors the forward runs on, which the backward gets its
    gradients for (a tensor shared by several layers counts once)."""
    params: List[torch.Tensor] = []
    index: Dict[int, int] = {}
    plan = []
    for named in layer_params:
        entry = {}
        for name, t in named.items():
            if id(t) not in index:
                index[id(t)] = len(params)
                params.append(t)
            entry[name] = index[id(t)]
        plan.append(entry)
    y1, y2 = Reversible.apply(branch, plan, x, *params)
    return (y1 + y2) / 2
