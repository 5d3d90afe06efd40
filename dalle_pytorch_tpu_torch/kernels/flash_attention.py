"""Flash attention, forward and backward: the CUDA kernels' wrappers and
their plain versions.

Counterpart of `dalle_pytorch_tpu/kernels/flash_attention.py`: the forward
(`_fwd_kernel` / `_flash_fwd`), the two-pass backward (`_dq_kernel` and
`_dkv_kernel` / `_flash_bwd`) and the `custom_vjp` that joins them
(`_flash_vjp_fwd` / `_flash_vjp_bwd`).  Attention runs on (b·h, n, d) with
f32 accumulation, causal masking and an optional per-batch key-padding row;
the log-sum-exp comes back as (b·h, n), not broadcast over 128 lanes as on
the TPU.

`flash_fwd` launches `csrc/flash_fwd.cu` and `flash_bwd` the two kernels of
`csrc/flash_bwd.cu` for CUDA tensors; each takes its plain version
(`flash_attention_reference`, `flash_attention_backward_reference`) only for
CPU tensors.  There is no fallback from a kernel to a plain version.
`flash_attention` goes through the autograd function `FlashAttention`
whenever a gradient is wanted, and straight to `flash_fwd` otherwise.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from dalle_pytorch_tpu_torch.kernels import build

_NEG = -1e30  # the TPU kernel's fill for masked scores
# lse at or below this: the row sees no key (its lse is -1e30, see _delta)
_DEAD_LSE = _NEG / 2
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)


def _masked_scores(q, k, causal, scale, mask, key_mask, h):
    s = torch.einsum("bid,bjd->bij", q.float() * scale, k.float())
    n = q.shape[1]
    neg = torch.tensor(_NEG, dtype=torch.float32, device=s.device)
    if causal:
        pos = torch.arange(n, device=s.device)
        s = torch.where(pos[None, :] <= pos[:, None], s, neg)
    if mask is not None:
        if mask.ndim == 3:  # per-head (h, n, n): tile over the batch
            mask = mask.repeat(q.shape[0] // mask.shape[0], 1, 1)
        s = torch.where(mask.to(torch.bool), s, neg)
    if key_mask is not None:
        keep = torch.repeat_interleave(key_mask > 0, h, dim=0)[:, None, :]
        s = torch.where(keep, s, neg)
    return s


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    h: int = 1,
    causal: bool = True,
    scale: Optional[float] = None,
    mask: Optional[torch.Tensor] = None,
    key_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch forward of the same function as the kernel, the
    forward math of the JAX package's `_dense_recompute_grads`.

    q, k, v: (bh, n, d); key_mask: optional (bh // h, n), nonzero = attend;
    mask: optional (n, n) or per-head (h, n, n) pattern, True = attend.
    Returns (out (bh, n, d) in q's dtype, lse (bh, n) f32)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = _masked_scores(q, k, causal, scale, mask, key_mask, h)
    lse = torch.logsumexp(s, dim=-1)
    # softmax, not exp(s - lse): a fully masked row (every score -1e30) must
    # average v, and -1e30 + log(n) rounds back to -1e30 in f32
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bij,bjd->bid", p, v.float())
    return out.to(q.dtype), lse


def _delta(out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(do * out), (bh, n) f32, as `_flash_bwd` computes it.

    A row that sees no key has lse = -1e30, so p = exp(s - lse) is 1 for
    every one of its n keys and the JAX package's `_dense_recompute_grads`
    takes delta = do . sum_j v_j for it, not do . out (out averages v)."""
    do32 = do.float()
    live = (do32 * out.float()).sum(-1)
    dead = (do32 * v.float().sum(1, keepdim=True)).sum(-1)
    return torch.where(lse <= _DEAD_LSE, dead, live)


def flash_attention_backward_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    h: int = 1,
    causal: bool = True,
    scale: Optional[float] = None,
    mask: Optional[torch.Tensor] = None,
    key_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch backward of the same function as the kernels: the math
    of the JAX package's `_dense_recompute_grads`, with p = exp(s - lse)
    recomputed over all n keys and delta from `_delta`.

    out, lse: the forward's; do: (bh, n, d).  Returns (dq, dk, dv) in the
    dtypes of q, k and v, computed in f32."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = _masked_scores(q, k, causal, scale, mask, key_mask, h)
    p = torch.exp(s - lse[..., None])
    do32 = do.float()
    dv = torch.einsum("bij,bid->bjd", p, do32)
    dp = torch.einsum("bid,bjd->bij", do32, v.float())
    ds = p * (dp - _delta(out, lse, do, v)[..., None])
    dq = torch.einsum("bij,bjd->bid", ds, k.float()) * scale
    dk = torch.einsum("bij,bid->bjd", ds, q.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _is_cuda(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def _check_cuda_inputs(q, k, v, h, key_mask):
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must all lie on the same CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash attention takes float32 or bfloat16 q, k, v of one dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash attention takes q, k, v of one shape (bh, n, d); got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    bh, n, d = q.shape
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash attention takes head dims {_HEAD_DIMS}; got {d}")
    if bh % h or not 0 < bh <= 65535:
        raise ValueError(f"bh = {bh} must be a positive multiple of h = {h}, at most 65535")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if key_mask is not None:
        if key_mask.shape != (bh // h, n) or key_mask.dtype != torch.int32:
            raise ValueError(f"key_mask must be int32 of shape {(bh // h, n)}; got {key_mask.dtype} {tuple(key_mask.shape)}")
        if key_mask.device != q.device or not key_mask.is_contiguous():
            raise ValueError("key_mask must be contiguous on q's device")


def _check_cuda_residuals(q, out, lse, do):
    for name, t in (("out", out), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q's shape, dtype and device; got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if lse.shape != q.shape[:2] or lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError(f"lse must be float32 of shape {tuple(q.shape[:2])}; got {lse.dtype} {tuple(lse.shape)}")
    if not lse.is_contiguous():
        raise ValueError("lse must be contiguous")


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry point -> (its source in csrc/, how many pointers it takes first)
_ENTRIES = {
    "flash_fwd": ("flash_fwd", 6),
    "flash_bwd_dq": ("flash_bwd", 8),
    "flash_bwd_dkv": ("flash_bwd", 9),
}


def _entry(name: str):
    """The C entry point `name`, its library built and loaded at first use.
    Every entry takes its pointers, then (bh, n, d, h, scale, causal, dtype,
    stream)."""
    source, n_ptrs = _ENTRIES[name]
    fn = getattr(build.load(source), name)
    if fn.argtypes is None:
        fn.argtypes = [_P] * n_ptrs + [_I, _I, _I, _I, _F, _I, _I, _P]
        fn.restype = ctypes.c_int
    return fn


def _call(name: str, q, tensors, h, causal, scale) -> None:
    """Launch entry `name` on q's card, on its current stream; `tensors` are
    its pointer arguments in order (None for a null pointer)."""
    bh, n, d = q.shape
    fn = _entry(name)
    with torch.cuda.device(q.device):
        rc = fn(*(None if t is None else t.data_ptr() for t in tensors), bh, n, d, h,
                float(scale), int(causal), _DTYPES[q.dtype],
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with code {rc}")


def _launch(q, k, v, h, causal, scale, key_mask):
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    _call("flash_fwd", q, (q, k, v, key_mask, out, lse), h, causal, scale)
    return out, lse


def flash_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    h: int = 1,
    causal: bool = True,
    scale: Optional[float] = None,
    mask: Optional[torch.Tensor] = None,
    key_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(bh, n, d) attention forward -> (out (bh, n, d), lse (bh, n) f32).

    On CUDA tensors this launches the kernel (and counts the launch in
    `flash_fwd.launches`) or raises; on CPU tensors it runs the plain
    version.  It builds no autograd graph of its own: `flash_attention`
    gives it its gradient.  `mask` (a static pattern) is taken on the CPU
    only until the sparse slice brings it to the kernel."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if key_mask is not None:
        key_mask = key_mask.to(torch.int32).contiguous()
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, h, causal, scale, mask, key_mask)
    if not _is_cuda(q):
        raise ValueError(f"flash_fwd runs on CUDA or CPU tensors, not {q.device}")
    if mask is not None:
        raise NotImplementedError(
            "the CUDA flash kernel takes no pattern mask yet: it comes with "
            "the sparse-attention slice"
        )
    _check_cuda_inputs(q, k, v, h, key_mask)
    out, lse = _launch(q, k, v, h, causal, scale, key_mask)
    flash_fwd.launches += 1
    return out, lse


flash_fwd.launches = 0


def flash_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    h: int = 1,
    causal: bool = True,
    scale: Optional[float] = None,
    mask: Optional[torch.Tensor] = None,
    key_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(bh, n, d) attention backward -> (dq, dk, dv), from the forward's
    out and lse and the output gradient do.

    On CUDA tensors delta = rowsum(do * out) is a torch op, as it is XLA in
    the JAX package, and then the dq kernel and the dk/dv kernel launch,
    each counted in `flash_bwd.dq_launches` / `flash_bwd.dkv_launches`, or
    it raises; on CPU tensors it runs the plain version."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if key_mask is not None:
        key_mask = key_mask.to(torch.int32).contiguous()
    if q.device.type == "cpu":
        return flash_attention_backward_reference(q, k, v, out, lse, do, h, causal, scale, mask, key_mask)
    if not _is_cuda(q):
        raise ValueError(f"flash_bwd runs on CUDA or CPU tensors, not {q.device}")
    if mask is not None:
        raise NotImplementedError(
            "the CUDA flash kernels take no pattern mask yet: it comes with "
            "the sparse-attention slice"
        )
    _check_cuda_inputs(q, k, v, h, key_mask)
    _check_cuda_residuals(q, out, lse, do)
    delta = _delta(out, lse, do, v)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    _call("flash_bwd_dq", q, (q, k, v, do, lse, delta, key_mask, dq), h, causal, scale)
    flash_bwd.dq_launches += 1
    _call("flash_bwd_dkv", q, (q, k, v, do, lse, delta, key_mask, dk, dv), h, causal, scale)
    flash_bwd.dkv_launches += 1
    return dq, dk, dv


flash_bwd.dq_launches = 0
flash_bwd.dkv_launches = 0


class FlashAttention(torch.autograd.Function):
    """(bh, n, d) flash attention with its gradient: the forward saves
    (q, k, v, out, lse) as `_flash_vjp_fwd` does, and the backward is
    `flash_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, h, causal, scale, mask, key_mask):
        out, lse = flash_fwd(q, k, v, h, causal, scale, mask, key_mask)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (h, causal, scale, mask, key_mask)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, out, lse, do.contiguous(), *ctx.args)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    causal: bool = True,
    scale: Optional[float] = None,
    key_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(b, h, n, d) attention, the counterpart of the JAX package's
    `flash_attention`.  q is unscaled (scale defaults to d^-1/2);
    key_mask: optional (b, n), nonzero = attend.  Differentiable through
    `FlashAttention` when grad is enabled and an input requires it; a plain
    `flash_fwd` call otherwise."""
    b, h, n, d = q.shape
    qf, kf, vf = (t.reshape(b * h, n, d).contiguous() for t in (q, k, v))
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        out = FlashAttention.apply(qf, kf, vf, h, causal, scale, mask, key_mask)
    else:
        out, _ = flash_fwd(qf, kf, vf, h=h, causal=causal, scale=scale, mask=mask, key_mask=key_mask)
    return out.reshape(b, h, n, d)
