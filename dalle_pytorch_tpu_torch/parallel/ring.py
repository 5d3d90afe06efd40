"""Ring attention over the `sp` ranks (counterpart of
`dalle_pytorch_tpu/parallel/ring.py`).

Each rank holds a contiguous part of the sequence (n_loc positions, global
position = rank · n_loc + local index).  The forward keeps its queries and
passes K/V blocks round the ring: after n_dev - 1 hops every rank has seen
every block, accumulating an online softmax (m, l, acc) in f32 whatever the
input dtype, under the causal mask of the global positions and, for a
pattern layer, its 2-D pattern sliced by row owner.  The backward keeps K
and V where they are and rotates a (q, do, lse, delta, dq) packet a full
cycle: each rank adds its keys' part to the dq of the queries it holds and
their part to its own dk and dv, and each packet comes home with its dq
finished.  q and do ride in the input dtype, lse, delta and dq in f32, as
the JAX ring's.  The blocks are plain torch in f32, as the JAX ring is
plain XLA (no Pallas kernel), and the hops go through `parallel/p2p.py`.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from dalle_pytorch_tpu_torch.parallel.p2p import exchange

_NEG = -1e30


def _causal(s: torch.Tensor, q_owner: int, k_owner: int, n: int) -> torch.Tensor:
    """Scores of the query block of `q_owner` against the key block of
    `k_owner`, masked where the key's global position is past the query's."""
    i = torch.arange(n, device=s.device)
    keep = (k_owner * n + i[None, :]) <= (q_owner * n + i[:, None])
    return torch.where(keep, s, torch.full((), _NEG, device=s.device))


def _masked(s: torch.Tensor, block: Optional[torch.Tensor]) -> torch.Tensor:
    return s if block is None else torch.where(block, s, torch.full((), _NEG, device=s.device))


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, ranks, me, causal, scale, mask_rows, mask_cols):
        n_dev, n = len(ranks), q.shape[2]
        nxt, prv = ranks[(me + 1) % n_dev], ranks[(me - 1) % n_dev]
        q32 = q.float() * scale
        b, h, _, d = q.shape
        m = torch.full((b, h, n, 1), _NEG, device=q.device)
        l = torch.zeros((b, h, n, 1), device=q.device)
        acc = torch.zeros((b, h, n, d), device=q.device)
        k_cur, v_cur = k, v
        for step in range(n_dev):
            src = (me - step) % n_dev  # whose block this rank holds now
            s = q32 @ k_cur.float().transpose(-1, -2)
            if causal:
                s = _causal(s, me, src, n)
            s = _masked(s, None if mask_rows is None else mask_rows[:, src * n:(src + 1) * n])
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + p @ v_cur.float()
            m = m_new
            if step < n_dev - 1:
                k_cur, v_cur = exchange([k_cur, v_cur], nxt, prv)
        out = (acc / l.clamp_min(1e-30)).to(q.dtype)
        lse = m + torch.log(l.clamp_min(1e-30))
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (ranks, me, causal, scale, mask_cols)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        ranks, me, causal, scale, mask_cols = ctx.args
        n_dev, n = len(ranks), q.shape[2]
        nxt, prv = ranks[(me + 1) % n_dev], ranks[(me - 1) % n_dev]
        k32, v32 = k.float(), v.float()
        delta = (do.float() * out.float()).sum(-1, keepdim=True)
        dk, dv = torch.zeros_like(k32), torch.zeros_like(v32)
        packet = [q, do.contiguous(), lse, delta, torch.zeros(q.shape, device=q.device)]
        for step in range(n_dev):
            q_raw, do_raw, lse_cur, delta_cur, dq_cur = packet
            q_cur, do_cur = q_raw.float(), do_raw.float()
            owner = (me - step) % n_dev  # whose queries this rank holds now
            s = (q_cur * scale) @ k32.transpose(-1, -2)
            if causal:
                s = _causal(s, owner, me, n)
            s = _masked(s, None if mask_cols is None else mask_cols[owner * n:(owner + 1) * n])
            p = torch.exp(s - lse_cur)
            dp = do_cur @ v32.transpose(-1, -2)
            ds = p * (dp - delta_cur)
            dq_cur = dq_cur + (ds @ k32) * scale
            dk = dk + (ds.transpose(-1, -2) @ q_cur) * scale
            dv = dv + p.transpose(-1, -2) @ do_cur
            # every step hops, the last too, so that each packet ends at its owner
            packet = exchange([q_raw, do_raw, lse_cur, delta_cur, dq_cur], nxt, prv)
        return (packet[4].to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)) + (None,) * 6


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, ranks: Sequence[int], me: int,
                   causal: bool = True, scale: Optional[float] = None,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention of this rank's queries over the whole sequence, n sharded
    over the ring `ranks` (global ranks in order; this rank is `ranks[me]`):
    q, k, v (b, h, n_loc, d), this rank's positions me · n_loc + i.  `mask`:
    an optional (n, n) bool pattern of the global sequence (True = may
    attend); each rank keeps its row block (forward) and column block
    (backward).  Equal to dense softmax attention with the same masks."""
    n = q.shape[2]
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    rows = cols = None
    if mask is not None:
        rows = mask[me * n:(me + 1) * n]
        cols = mask[:, me * n:(me + 1) * n]
    return _Ring.apply(q, k, v, tuple(ranks), me, causal, scale, rows, cols)


def ring_comm_bytes(batch: int, heads: int, seq_shard: int, dim_head: int, n_dev: int, itemsize: int = 4,
                    include_backward: bool = True) -> float:
    """Per-rank wire bytes of one `ring_attention` call over an `n_dev` ring,
    as the JAX package prices it: K and V blocks hop n_dev - 1 times in the
    input dtype; backward, the (q, do, lse, delta, dq) packet hops n_dev
    times, q and do in the input dtype, lse, delta and dq in f32."""
    kv_block = float(batch * heads * seq_shard * dim_head * itemsize)
    fwd = (n_dev - 1) * 2.0 * kv_block
    if not include_backward:
        return fwd
    f32_block = float(batch * heads * seq_shard * dim_head * 4)
    scalar_block = float(batch * heads * seq_shard * 4)
    packet = 2.0 * kv_block + f32_block + 2.0 * scalar_block
    return fwd + n_dev * packet
