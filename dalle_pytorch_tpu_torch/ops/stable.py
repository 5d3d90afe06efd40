"""The softmax and the output scaling of the `stable` DALL-E variant (counterpart of
`dalle_pytorch_tpu/ops/stable.py`)."""
from __future__ import annotations

import torch


def stable_softmax(t: torch.Tensor, dim: int = -1, alpha: float = 32.0 ** 2) -> torch.Tensor:
    """Softmax with pre-scaled max subtraction for low-precision stability."""
    t = t / alpha
    t = t - torch.amax(t, dim=dim, keepdim=True).detach()
    return torch.softmax(t * alpha, dim=dim)



def divide_max(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """x over its max along `dim`, the max detached (the `stable` model's
    transformer output, before the logits)."""
    return x / torch.amax(x, dim=dim, keepdim=True).detach()
