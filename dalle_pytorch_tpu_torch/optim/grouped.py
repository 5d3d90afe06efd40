"""Optimizers that work on groups of same-shape leaves and hand their update
back as an f32 tensor, as optax's `update` does.

`torch.optim`'s `step()` writes each parameter in place with the parameter's
own rounding, so it cannot serve low-precision storage, which adds the f32
update to an f32 view of the parameter and rounds the sum stochastically
(`parallel/train_step.py`).  A grouped optimizer keeps its statistics in
f32, stacked per group, and works on one group at a time: the train step
stacks a group's gradients and parameters, casts them to f32, asks for the
update and writes the result back, so no f32 copy of all the parameters
ever exists at once.  Leaves of one shape share a group (and a launch per
op), up to `group_elements` elements of f32 a group.

The interface: `init(params) -> GroupedState`; `update(grads, group,
params, count) -> (updates, group)` on one group's stacked f32 tensors (the
leaf dims after a leading stack dim), `count` the number of updates applied
before this one; `step_groups(state, grads, params, write)` runs every group
on dicts of leaves and hands each group's f32 parameters and update to
`write`, which applies them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

Tree = Dict[str, torch.Tensor]


@dataclasses.dataclass
class Group:
    names: Tuple[str, ...]
    shape: Tuple[int, ...]  # one leaf's shape
    stats: Dict[str, torch.Tensor]  # f32, each with the leading stack dim


@dataclasses.dataclass
class GroupedState:
    count: int
    groups: List[Group]


class GroupedOptimizer:
    group_elements = 1 << 26  # f32 elements of one stacked group at most
    # each element's update reads that element's statistics alone, so the
    # sharded step may run it on a rank's shard of a leaf
    elementwise = False

    def _init_stats(self, shape: Tuple[int, ...], n: int, device) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def update(self, grads: torch.Tensor, group: Group, params: torch.Tensor,
               count: int) -> Tuple[torch.Tensor, Group]:
        raise NotImplementedError

    def init(self, params: Tree) -> GroupedState:
        """Group the leaves by shape, in first-seen order, each group at
        most `group_elements` elements; statistics zero, f32."""
        by_shape: Dict[Tuple[int, ...], List[str]] = {}
        for name, p in params.items():
            by_shape.setdefault(tuple(p.shape), []).append(name)
        groups = []
        for shape, names in by_shape.items():
            per = max(1, self.group_elements // max(1, int(np.prod(shape))))
            for i in range(0, len(names), per):
                chunk = tuple(names[i:i + per])
                groups.append(Group(chunk, shape, self._init_stats(shape, len(chunk), params[chunk[0]].device)))
        return GroupedState(0, groups)

    def step_groups(self, state: GroupedState, grads: Tree, params: Tree,
                    write: Callable[[Tuple[str, ...], torch.Tensor, torch.Tensor], None]) -> None:
        """One update of every group, in place in `state`: stack the group's
        gradients and parameters, cast them to f32, compute the update and
        call `write(names, p32, u32)` with the stacked f32 parameters (a
        fresh tensor that `write` may overwrite) and update, the leading
        dim running over `names`."""
        for i, group in enumerate(state.groups):
            p32 = torch.stack([params[n] for n in group.names]).float()
            u32, state.groups[i] = self.update(torch.stack([grads[n] for n in group.names]).float(),
                                               group, p32, state.count)
            write(group.names, p32, u32)
        state.count += 1


def leaf_dims(x: torch.Tensor) -> Tuple[int, ...]:
    """The leaf dims of a stacked tensor (all but the leading one)."""
    return tuple(range(1, x.ndim))


class Adam(GroupedOptimizer):
    """`optax.adam(learning_rate)` at its defaults (b1 0.9, b2 0.999, eps
    1e-8, eps_root 0, no Nesterov): the moments' update, the bias
    corrections at the new count, m / (sqrt(v) + eps), times
    -learning_rate.  `learning_rate` may be a 0-d f32 tensor on the
    parameters' device, which the caller changes in place between steps
    (the VAE CLI's per-epoch decay: `optax.chain(scale_by_adam(),
    scale(-1))` times a traced lr, the same product)."""

    B1, B2, EPS = 0.9, 0.999, 1e-8
    elementwise = True

    def __init__(self, learning_rate: float):
        self.lr = learning_rate

    def _init_stats(self, shape, n, device):
        zeros = torch.zeros((n, *shape), dtype=torch.float32, device=device)
        return {"mu": zeros, "nu": zeros.clone()}

    def update(self, grads, group, params, count):
        b1, b2 = self.B1, self.B2
        mu = (1 - b1) * grads + b1 * group.stats["mu"]
        nu = (1 - b2) * grads.square() + b2 * group.stats["nu"]
        t = count + 1
        # 1 - b^t in f32, b rounded to f32 first, as optax's bias correction
        c1, c2 = (np.float32(1) - np.float32(b) ** np.float32(t) for b in (b1, b2))
        updates = (mu / float(c1)) / ((nu / float(c2)).sqrt() + self.EPS) * -self.lr
        return updates, dataclasses.replace(group, stats={"mu": mu, "nu": nu})
