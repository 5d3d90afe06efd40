"""The bad-step guard (counterpart of `dalle_pytorch_tpu/training/resilience.py`
`nonfinite_guard`): a poisoned gradient skips the optimizer update instead of
writing NaN into the parameters and the optimizer's moments.

The JAX package decides inside the compiled step with `lax.cond`; PyTorch
runs eagerly, so the guard reads the flag on the host, one device sync per
step.
"""
from __future__ import annotations

from typing import Callable, Union

import torch


def nonfinite_guard(update_fn: Callable[[], None], finite: Union[bool, torch.Tensor]) -> bool:
    """Run `update_fn()` (the optimizer update) only when `finite` holds,
    for example `isfinite(grad_norm)`; otherwise leave parameters and
    moments untouched.  Returns whether the update ran."""
    if not bool(finite):
        return False
    update_fn()
    return True
