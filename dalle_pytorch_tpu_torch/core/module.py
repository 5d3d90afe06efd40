"""Layer primitives of the port, and the weight layouts of the JAX package.

The JAX package stores linear weights as (in, out) and convolution kernels
as HWIO over NHWC images; its transposed convolution is an input-dilated
convolution with a spatially flipped kernel.  The port's modules hold
PyTorch's own layouts (`nn.Linear` (out, in), `nn.Conv2d` (O, I, kh, kw),
`nn.ConvTranspose2d` (I, O, kh, kw)) and run NCHW inside.  The converters
below map one layout onto the other; the functions below them take the JAX
package's layouts and NHWC images at their boundary, so a test can hold each
against its JAX counterpart directly.
"""
from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F

from dalle_pytorch_tpu_torch.core.shard import uniform

# ---------------------------------------------------------------------------
# layout converters (JAX package -> PyTorch)
# ---------------------------------------------------------------------------


def linear_weight(w: torch.Tensor) -> torch.Tensor:
    """(in, out) -> (out, in)."""
    return w.t().contiguous()


def conv_weight(w: torch.Tensor) -> torch.Tensor:
    """HWIO -> (O, I, kh, kw)."""
    return w.permute(3, 2, 0, 1).contiguous()


def conv_transpose_weight(w: torch.Tensor) -> torch.Tensor:
    """The JAX package's dilated-conv kernel (flipped HWIO) -> the
    `ConvTranspose2d` weight (I, O, kh, kw)."""
    return w.flip(0, 1).permute(2, 3, 0, 1).contiguous()


# ---------------------------------------------------------------------------
# functions with the JAX package's layouts at their boundary
# ---------------------------------------------------------------------------


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ w (+ b), w stored (in, out)."""
    return F.linear(x, linear_weight(w).to(x.dtype), None if b is None else b.to(x.dtype))


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Normalise in f32 and cast back to x's dtype, as the JAX package does."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, unbiased=False, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def embedding(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return F.embedding(ids, table)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


def conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    stride: int = 1,
    padding: Union[int, str] = "SAME",
) -> torch.Tensor:
    """NHWC x, HWIO w.  `padding` is an int or "SAME" (stride 1)."""
    if padding == "SAME":
        if stride != 1:
            raise NotImplementedError("SAME padding is implemented for stride 1 only")
        padding = "same"
    y = F.conv2d(_nchw(x), conv_weight(w).to(x.dtype), None if b is None else b.to(x.dtype),
                 stride=stride, padding=padding)
    return _nhwc(y)


def conv2d_transpose(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    stride: int = 2,
    kernel: int = 4,
    torch_padding: int = 1,
) -> torch.Tensor:
    """NHWC x, the JAX package's flipped-HWIO w; the output geometry of
    `ConvTranspose2d(kernel, stride, torch_padding)`."""
    if w.shape[0] != kernel:
        raise ValueError(f"kernel {kernel} does not match weight {tuple(w.shape)}")
    y = F.conv_transpose2d(_nchw(x), conv_transpose_weight(w).to(x.dtype),
                           None if b is None else b.to(x.dtype),
                           stride=stride, padding=torch_padding)
    return _nhwc(y)


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator] = None,
            cols: Optional[slice] = None, last_total: Optional[int] = None) -> torch.Tensor:
    """Inverted dropout: keep each element with probability 1 - rate and
    scale it by 1 / (1 - rate).  The identity when rate is 0 or no
    generator is given (the JAX package: no key).  `generator` lies on x's
    device; the same generator state draws the same mask.  Under the
    sharded train step x holds this rank's rows of the micro-batch (and,
    with `cols`, those columns of a last dim of `last_total`): the mask is
    drawn for those places alone, with the values a one-process run draws
    there (`core/shard.uniform`)."""
    if generator is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = uniform(x.shape, generator, x.device, cols, last_total) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


@torch.no_grad()
def fan_in_uniform_(layer: torch.nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """The JAX package's initialisation of a linear or conv layer, in
    place: weight and bias uniform in ±1/sqrt(fan_in)."""
    w = layer.weight
    if isinstance(layer, torch.nn.ConvTranspose2d):
        fan_in = w.shape[0] * w.shape[2] * w.shape[3]  # (I, O, kh, kw)
    else:
        fan_in = w[0].numel()  # (out, in) or (O, I, kh, kw)
    bound = fan_in ** -0.5
    w.uniform_(-bound, bound, generator=generator)
    if layer.bias is not None:
        layer.bias.uniform_(-bound, bound, generator=generator)


class LayerNorm(torch.nn.Module):
    """Layer norm with the JAX package's parameter names and its f32
    arithmetic (`scale`, `bias`, eps 1e-5)."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.scale = torch.nn.Parameter(torch.ones(dim))
        self.bias = torch.nn.Parameter(torch.zeros(dim))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.scale, self.bias, self.eps)
