"""Reduce the learning rate on a plateau of the loss (counterpart of
`optax.contrib.reduce_on_plateau`, which the JAX train CLI chains after
Adam under `--lr_decay`: factor 0.5, patience 10, cooldown 10, min_scale
1e-6 / lr).

Each step's loss is averaged over `accumulation_size` steps; when the
average fails to beat the best one by `rtol` (and `atol`) `patience` times
in a row, the scale is multiplied by `factor` (not below `min_scale`) and
a cooldown of `cooldown` steps begins, in which the plateau count stays 0.
The optimizer's update is multiplied by the new scale, as optax's chain
multiplies it.  The state is six device scalars, updated in place with
tensor ops, so a step that reads it makes no host sync.
"""
from __future__ import annotations

import dataclasses

import torch

_INT32_MAX = torch.iinfo(torch.int32).max


@dataclasses.dataclass
class PlateauState:
    """optax's `ReduceLROnPlateauState`, field for field: f32 `scale`,
    `best_value` and `avg_value`; int32 `plateau_count`, `cooldown_count`
    and `count`."""

    scale: torch.Tensor
    best_value: torch.Tensor
    plateau_count: torch.Tensor
    cooldown_count: torch.Tensor
    count: torch.Tensor
    avg_value: torch.Tensor

    FIELDS = ("scale", "best_value", "plateau_count", "cooldown_count", "count", "avg_value")

    def tensors(self):
        return [getattr(self, name) for name in self.FIELDS]


def _safe_increment(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x < _INT32_MAX, x + 1, x)


class ReduceOnPlateau:
    def __init__(self, factor: float = 0.1, patience: int = 10, rtol: float = 1e-4, atol: float = 0.0,
                 cooldown: int = 0, accumulation_size: int = 1, min_scale: float = 0.0):
        if not 0.0 < factor < 1.0:
            raise ValueError(f"factor must lie in (0, 1), got {factor}")
        if rtol < 0.0 or atol < 0.0 or (rtol == 0.0 and atol == 0.0) or rtol > 1.0:
            raise ValueError(f"need rtol in [0, 1] and atol >= 0, not both 0; got rtol {rtol}, atol {atol}")
        self.factor, self.patience, self.rtol, self.atol = factor, patience, rtol, atol
        self.cooldown, self.accumulation_size, self.min_scale = cooldown, accumulation_size, min_scale

    def init(self, device=None) -> PlateauState:
        def scalar(value, dtype):
            return torch.tensor(value, dtype=dtype, device=device)

        return PlateauState(scale=scalar(1.0, torch.float32), best_value=scalar(float("inf"), torch.float32),
                            plateau_count=scalar(0, torch.int32), cooldown_count=scalar(0, torch.int32),
                            count=scalar(0, torch.int32), avg_value=scalar(0.0, torch.float32))

    @torch.no_grad()
    def update(self, state: PlateauState, value: torch.Tensor) -> None:
        """Take one step's loss `value` into `state`, in place (optax's
        `update_fn` before it scales the updates)."""
        count = state.count
        new_count = _safe_increment(count)
        avg = (count * state.avg_value + value.to(state.avg_value)) / new_count
        # the plateau logic, run where the accumulated count is reached
        improved = avg < (1 - self.rtol) * state.best_value - self.atol
        best = torch.where(improved, avg, state.best_value)
        plateau = torch.where(improved, torch.zeros_like(count), _safe_increment(state.plateau_count))
        hit = plateau == self.patience
        cooling = state.cooldown_count > 0
        scale = torch.where(cooling, state.scale,
                            torch.clamp_min(torch.where(hit, state.scale * self.factor, state.scale), self.min_scale))
        plateau = torch.where(cooling | hit, torch.zeros_like(plateau), plateau)
        cooldown = torch.where(cooling, state.cooldown_count - 1,
                               torch.where(hit, self.cooldown, 0).to(torch.int32))
        due = new_count == self.accumulation_size
        for name, reached, kept in (("scale", scale, state.scale), ("best_value", best, state.best_value),
                                    ("plateau_count", plateau, state.plateau_count),
                                    ("cooldown_count", cooldown, state.cooldown_count),
                                    ("count", torch.zeros_like(count), new_count),
                                    ("avg_value", torch.zeros_like(avg), avg)):
            getattr(state, name).copy_(torch.where(due, reached, kept))
