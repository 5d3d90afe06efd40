"""Adafactor, the counterpart of `optax.adafactor` (optax 0.2.6) at its
defaults, on groups of same-shape leaves (`optim/grouped.py`).

The chain, per leaf, in optax's order: `scale_by_factored_rms` (decay
1 - (count + 1)^-0.8; g² + 1e-30; a leaf whose second-largest dim is at
least 128 keeps row and column means of g² over its two largest dims,
optax's `_factored_dims`, and is scaled by (v_row / mean(v_row))^-1/2 and
v_col^-1/2, any other leaf by its own v^-1/2), `clip_by_block_rms(1.0)`
(divide by max(1, rms(u))), `scale_by_learning_rate`,
`scale_by_param_block_rms` (times the parameter's rms, floored at 1e-3),
then times -1.  No momentum, no weight decay.  The learning rate is the one
setting: every caller of the JAX package takes the rest at optax's
defaults, as the constants below.  The statistics are f32.

`torch.optim.Adafactor` is another algorithm (it factors every tensor of two
or more dims and uses other epsilons), so it is not used.  The JAX package
runs this update in XLA; here it is plain tensor ops, a few launches per
group.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from dalle_pytorch_tpu_torch.optim.grouped import GroupedOptimizer, leaf_dims


MIN_DIM_SIZE_TO_FACTOR = 128
DECAY_RATE = 0.8
CLIPPING_THRESHOLD = 1.0
EPS = 1e-30  # added to g²
MIN_SCALE = 1e-3  # the floor of the parameter's rms


def factored_dims(shape: Tuple[int, ...]) -> Optional[Tuple[int, int]]:
    """optax's `_factored_dims`: (second-largest dim, largest dim) of the
    leaf, by a stable argsort, or None when the leaf has fewer than two dims
    or its second-largest is under `MIN_DIM_SIZE_TO_FACTOR`."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < MIN_DIM_SIZE_TO_FACTOR:
        return None
    return int(order[-2]), int(order[-1])


class Adafactor(GroupedOptimizer):
    def __init__(self, learning_rate: float):
        self.lr = learning_rate

    def _init_stats(self, shape, n, device):
        dims = factored_dims(shape)
        if dims is None:
            return {"v": torch.zeros((n, *shape), dtype=torch.float32, device=device)}
        d1, d0 = dims
        row = tuple(s for i, s in enumerate(shape) if i != d0)
        col = tuple(s for i, s in enumerate(shape) if i != d1)
        return {"v_row": torch.zeros((n, *row), dtype=torch.float32, device=device),
                "v_col": torch.zeros((n, *col), dtype=torch.float32, device=device)}

    @staticmethod
    def decay(count: int) -> Tuple[float, float]:
        """(decay, 1 - decay) at `count`, each rounded to f32 as optax
        computes them."""
        d = np.float32(1.0) - np.float32(count + 1) ** np.float32(-DECAY_RATE)
        return float(d), float(np.float32(1.0) - d)

    def update(self, grads, group, params, count):
        d, one_minus_d = self.decay(count)
        g2 = grads.square() + EPS
        dims = factored_dims(group.shape)
        if dims is None:
            v = d * group.stats["v"] + one_minus_d * g2
            stats = {"v": v}
            updates = grads * v.rsqrt()
        else:
            d1, d0 = dims  # leaf dims; +1 on the stacked tensors
            v_row = d * group.stats["v_row"] + one_minus_d * g2.mean(dim=d0 + 1)
            v_col = d * group.stats["v_col"] + one_minus_d * g2.mean(dim=d1 + 1)
            stats = {"v_row": v_row, "v_col": v_col}
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_factor = (v_row / v_row.mean(dim=reduced_d1 + 1, keepdim=True)).rsqrt()
            col_factor = v_col.rsqrt()
            updates = grads * row_factor.unsqueeze(d0 + 1) * col_factor.unsqueeze(d1 + 1)
        dims_all = leaf_dims(updates)
        shape1 = (-1,) + (1,) * len(dims_all)
        rms = updates.square().mean(dim=dims_all).sqrt()
        updates = updates / torch.clamp(rms / CLIPPING_THRESHOLD, min=1.0).view(shape1)
        updates = updates * self.lr
        prms = params.square().mean(dim=dims_all).sqrt()
        prms = torch.where(prms <= MIN_SCALE, torch.full_like(prms, MIN_SCALE), prms)
        updates = updates * prms.view(shape1)
        return -updates, dataclasses.replace(group, stats=stats)
