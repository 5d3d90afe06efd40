"""The arithmetic of the bf16 tensor-core VFA pair (`csrc/flash_vfa_tc.cuh`:
the max pass and the fixed-max pass), emulated in torch on the CPU and held
against the JAX package.

The emulation follows the two bodies rounding for rounding: bf16 q, k and
v; S = q k^T in f32 with the scale applied after the product, the same in
both passes; the mask in natural units (-1e30 for a masked key, keys past n
absent), so gmax is exactly -1e30 for a row that sees no key; p = 2^((s -
gmax) log2 e) in f32, l summed from the f32 p, and p rounded to bf16 only as
the PV operand; the tiles each block walks are those of the compacted
grid's row lists (`pattern_tables`).  It is held against the JAX compacted
grid with `vfa=True` in interpret mode (its max pass's gmax, its output and
lse), against the port's plain pair at the ragged n 257 with rows that see
no key, and against the online tensor-core emulation (`tc_forward`).  Tests
marked `cuda` hold the card's two kernels to the emulation and the bf16 VFA
forward to the bf16 online compacted kernel, and skip without a card."""
import math

import numpy as np
import pytest
import torch
from test_torch_flash_tc import (  # noqa: F401 (cuda_device: a fixture)
    LOG2E,
    LSE_TOL,
    NEG,
    OUT_TOL,
    P_SLACK,
    _bf16_step,
    _inputs,
    _pattern,
    cuda_device,
    tc_forward,
)
from test_torch_vfa import _mask, jfa  # noqa: F401 (jfa: a fixture)

from dalle_pytorch_tpu_torch.kernels import flash_attention as tfa
from dalle_pytorch_tpu_torch.ops import masks as tmasks

GMAX_TOL = 1e-4  # relative to max(|gmax|, 1), the card's tolerance for the max pass (chip_smoke.py)


def tc_vfa(q, k, v, h, causal, scale, mask=None, key_mask=None, slack=False):
    """Both bf16 VFA bodies, rounding for rounding: q, k, v (bh, n, d) bf16,
    mask (n, n) or per-head (h, n, n) bool or None, key_mask (bh // h, n)
    nonzero = attend or None.  Returns (gmax (bh, n) f32, out bf16, lse
    f32, l f32), and with `slack` also (bh, n, d) f32: how far the card's
    out may lie from this one before its final rounding because a p within
    P_SLACK of a bf16 rounding midpoint may round the other way there, as
    `tc_forward` has it."""
    bh, n, d = q.shape
    tq, tk = tfa.tile_shapes(d)[0]
    tables = tfa.pattern_tables(mask, n, d, causal, grid="compact")
    qf, kf, vf = q.float(), k.float(), v.float()
    pos = torch.arange(n)
    sc = np.float32(scale)

    def scores(b, rows, cols):
        """the masked S of batch-heads b, natural units"""
        s = torch.einsum("brd,bcd->brc", qf[b][:, rows], kf[b][:, cols]) * sc
        allow = torch.ones(len(b), len(rows), len(cols), dtype=torch.bool)
        if causal:
            allow &= cols[None, None, :] <= rows[None, :, None]
        if mask is not None:
            heads = mask if mask.ndim == 3 else mask[None].expand(h, n, n)
            allow &= heads[b % h][:, rows][:, :, cols]
        if key_mask is not None:
            allow &= (key_mask[b // h][:, cols] != 0)[:, None, :]
        return torch.where(allow, s, torch.tensor(NEG))

    gmax = torch.full((bh, n), NEG)
    l = torch.zeros(bh, n)
    o = torch.zeros(bh, n, d)
    amb = torch.zeros(bh, n, d)
    for head in range(tables.heads):
        b = torch.arange(bh) if tables.heads == 1 else torch.arange(head, bh, h)
        ptr, col = tables.row_ptr[head], tables.col[head]
        for i in range(math.ceil(n / tq)):
            rows = pos[i * tq:(i + 1) * tq]
            tiles = col[ptr[i]:ptr[i + 1]].tolist()
            m = torch.full((len(b), len(rows)), NEG)
            for j in tiles:  # pass 1
                m = torch.maximum(m, scores(b, rows, pos[j * tk:(j + 1) * tk]).amax(-1))
            acc, lsum, amb_t = torch.zeros(len(b), len(rows), d), torch.zeros(len(b), len(rows)), 0.0
            for j in tiles:  # pass 2, against the fixed maximum
                cols = pos[j * tk:(j + 1) * tk]  # keys past n do not exist: p = 0
                p = torch.exp2((scores(b, rows, cols) - m[..., None]) * np.float32(LOG2E))
                lsum = lsum + p.sum(-1)
                acc = acc + torch.einsum("brc,bcd->brd", p.bfloat16().float(), vf[b][:, cols])
                if slack:
                    apart = (p * (1 + P_SLACK)).bfloat16().float() - (p * (1 - P_SLACK)).bfloat16().float()
                    amb_t = amb_t + torch.einsum("brc,bcd->brd", apart, vf[b][:, cols].abs())
            gmax[b[:, None], rows[None]] = m
            l[b[:, None], rows[None]] = lsum
            o[b[:, None], rows[None]] = acc
            if slack:
                amb[b[:, None], rows[None]] = amb_t
    dead = gmax <= NEG / 2
    lc = l.clamp_min(1e-30)
    out = torch.where(dead[..., None], vf.sum(1, keepdim=True) / np.float32(n), o / lc[..., None]).bfloat16()
    lse = torch.where(dead, torch.tensor(NEG), gmax + torch.log(lc))
    if slack:
        return gmax, out, lse, l, torch.where(dead[..., None], 0.0, amb / lc[..., None])
    return gmax, out, lse, l


def _f32(x):
    """a torch tensor or a JAX / numpy array as an f32 torch tensor"""
    return x.float() if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x, np.float32))


def _gmax_err(gmax, ref):
    ref = _f32(ref)
    return ((gmax - ref).abs() / ref.abs().clamp_min(1.0)).max().item()


def _max_err(a, b):
    return (a.float() - _f32(b)).abs().max().item()


@pytest.mark.parametrize("kind", ["axial_row", "sparse_per_head"])
@pytest.mark.parametrize("d", [64, 128])
def test_emulation_matches_pallas_vfa(jfa, d, kind):
    """b=1, h=2, n=256, causal: the emulation against the JAX compacted
    grid with vfa=True in interpret mode (block 128): gmax against its max
    pass within 1e-4 relative, out against its fixed-max pass within 2e-2
    and lse within 1e-4; l >= 1 on every row."""
    import jax.numpy as jnp

    b, h, n = 1, 2, 256
    mask = _mask(kind, n, 16, h)
    q, k, v = _inputs(d + len(kind), b * h, n, d)
    jq, jk, jv = (jnp.asarray(t.float().numpy().reshape(b, h, n, d)) for t in (q, k, v))
    ref_out = jfa.flash_attention(jq, jk, jv, mask=jnp.asarray(mask), block_q=128, block_k=128, grid="compact",
                                  vfa=True)
    rec = jfa.pl.outputs
    ref_gmax = np.asarray(rec["_max_kernel_compact"])[..., 0]
    ref_lse = np.asarray(rec["_fwd_kernel_compact_vfa"][1])[..., 0]

    gmax, out, lse, l = tc_vfa(q, k, v, h, True, d ** -0.5, torch.from_numpy(mask))
    assert _gmax_err(gmax, ref_gmax) <= GMAX_TOL
    assert _max_err(out, np.asarray(ref_out).reshape(b * h, n, d)) <= OUT_TOL
    assert _max_err(lse, ref_lse) <= LSE_TOL
    assert torch.all(l >= 1)


def _dead_rows_case(dead, b, h, n, seed):
    """(mask, key_mask) at length n: the axial_row pattern, with its first
    five rows emptied ("pattern") or with every key of the last batch masked
    ("key_mask")."""
    mask = _pattern("axial_row", n)
    key_mask = None
    if dead == "pattern":
        mask[:5] = False
    else:
        rng = np.random.default_rng(seed)
        key_mask = torch.from_numpy((rng.random((b, n)) > 0.25).astype(np.int32))
        key_mask[:, 0] = 1
        key_mask[-1] = 0
    return mask, key_mask


@pytest.mark.parametrize("dead", ["pattern", "key_mask"])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_emulation_matches_plain_vfa_with_rows_that_see_no_key(d, dead):
    """The ragged n 257 (the prefill length), causal, with rows that see no
    key: gmax against `vfa_max_reference` (1e-4 relative, exactly -1e30 on
    those rows), out and lse against `vfa_fwd_reference` (2e-2, 1e-4), and
    against the online emulation `tc_forward` (the pattern case; it takes no
    key mask) or the plain online forward (the key-mask case) at the same
    tolerances; l >= 1 on every live row."""
    b, h, n = 2, 2, 257
    scale = d ** -0.5
    mask, key_mask = _dead_rows_case(dead, b, h, n, d)
    q, k, v = _inputs(d + 3, b * h, n, d)
    gmax, out, lse, l = tc_vfa(q, k, v, h, True, scale, mask, key_mask)
    qf, kf, vf = q.float(), k.float(), v.float()
    ref_gmax = tfa.vfa_max_reference(qf, kf, h, True, scale, mask, key_mask)
    dead_rows = ref_gmax == NEG
    assert dead_rows.any() and torch.equal(gmax == NEG, dead_rows)
    assert _gmax_err(gmax, ref_gmax) <= GMAX_TOL
    ref_out, ref_lse = tfa.vfa_fwd_reference(qf, kf, vf, ref_gmax, h, True, scale, mask, key_mask)
    assert _max_err(out, ref_out) <= OUT_TOL and _max_err(lse, ref_lse) <= LSE_TOL
    if dead == "pattern":
        online, online_lse = tc_forward(q, k, v, h, True, scale, mask)
    else:
        online, online_lse = tfa.flash_attention_reference(qf, kf, vf, h, True, scale, mask, key_mask)
    assert _max_err(out, online) <= OUT_TOL and _max_err(lse, online_lse) <= LSE_TOL
    assert torch.all(lse[dead_rows] == NEG)
    assert torch.all(l[~dead_rows] >= 1)


@pytest.mark.parametrize("d", [32, 64, 128])
def test_emulation_largest_score_gives_p_one(d):
    """Both passes compute the same S, so the row's largest score gives
    s - gmax = 0 and p = 1 exactly: l >= 1 on every live row and the
    fixed-max pass adds no p above 1 (per-head pattern and key padding,
    n 300)."""
    b, h, n = 2, 2, 300
    q, k, v = _inputs(d + 5, b * h, n, d)
    mask = tmasks.build_block_sparse_mask(n, 16, heads=h).bool()
    rng = np.random.default_rng(d)
    key_mask = torch.from_numpy((rng.random((b, n)) > 0.5).astype(np.int32))
    key_mask[:, 0] = 1
    gmax, out, lse, l = tc_vfa(q, k, v, h, True, d ** -0.5, mask, key_mask)
    assert torch.all(gmax > NEG) and torch.all(l >= 1)
    # l counts each key's p <= 1 at most once: l <= the keys the row may see
    seen = (torch.ones(n, n).tril().bool() & mask.repeat(b, 1, 1) &
            torch.repeat_interleave(key_mask != 0, h, dim=0)[:, None, :]).sum(-1)
    assert torch.all(l <= seen)
    ref_out, ref_lse = tfa.vfa_fwd_reference(q.float(), k.float(), v.float(), gmax, h, True, d ** -0.5, mask,
                                             key_mask)
    assert _max_err(out, ref_out) <= OUT_TOL and _max_err(lse, ref_lse) <= LSE_TOL


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _card_mask(kind, n, h):
    if kind == "sparse_per_head":
        return tmasks.build_block_sparse_mask(1280, 32, heads=h)[:, :n, :n].contiguous()
    return tmasks.build_pattern_mask(kind, 1280, 32)[:n, :n].contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["axial_row", "sparse_per_head", "dead_rows"])
@pytest.mark.parametrize("d,n", [(32, 257), (64, 1280), (128, 705)])
def test_kernels_match_emulation_on_card(cuda_device, d, n, case):
    """The two bf16 kernels on the card, compacted grid, causal, against the
    emulation above on the same inputs: gmax within 1e-4 relative (the f32
    sums of S in another order) and exactly -1e30 on rows that see no key;
    out within one bf16 step plus the emulation's slack plus 1e-6 relative,
    lse within 1e-5; with `dead_rows`, a key mask that masks every key of
    the second batch."""
    h = 2
    q, k, v = _inputs(d + n, 2 * h, n, d)
    mask = _card_mask("axial_row" if case == "dead_rows" else case, n, h)
    key_mask = None
    if case == "dead_rows":
        key_mask = torch.ones(2, n, dtype=torch.int32)
        key_mask[1] = 0
    want_gmax, want, want_lse, _, slack = tc_vfa(q, k, v, h, True, d ** -0.5, mask, key_mask, slack=True)
    dq, dk, dv, dmask = (t.to(cuda_device) for t in (q, k, v, mask))
    dkmask = None if key_mask is None else key_mask.to(cuda_device)
    tables = tfa.pattern_tables(dmask, n, d, grid="compact", device=cuda_device)
    m, mask_heads = tfa._device_mask(dq, dmask, h)
    gmax = torch.empty(2 * h, n, device=cuda_device)
    tfa._call("flash_max_compact", dq, (dq, dk, dkmask, m, tables.row_ptr, tables.col, gmax), h, True,
              d ** -0.5, mask_heads, tables.heads, tables.col.shape[1], tables.row_tile)
    out, lse = tfa.flash_fwd_compact(dq, dk, dv, tables, h=h, mask=dmask, key_mask=dkmask, vfa=True)
    gmax, out, lse = gmax.cpu(), out.cpu().float(), lse.cpu()
    assert torch.equal(gmax == NEG, want_gmax == NEG)
    gmax_err = _gmax_err(gmax, want_gmax)
    want = want.float()
    top = torch.maximum(out.abs(), want.abs())
    diff = (out - want).abs()
    limit = _bf16_step(top) + slack + 1e-6 * top
    lse_err = (lse - want_lse).abs().max().item()
    print(f"d {d} n {n} {case}: gmax {gmax_err:.3g}, out {diff.max().item():.3g} "
          f"({(diff > limit).sum().item()} beyond the limit), lse {lse_err:.3g}")
    assert gmax_err <= GMAX_TOL
    assert torch.all(diff <= limit)
    assert lse_err <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["axial_row", "conv_like", "sparse_per_head"])
@pytest.mark.parametrize("d", [64, 128])
def test_bf16_vfa_matches_online_compact_on_card(cuda_device, d, kind):
    """n 1280, bh 32, causal, bf16: the VFA pair's out and lse against the
    online compacted kernel's (out 2e-2, lse 1e-4), each launch counted on
    its own counter."""
    h = 8
    q, k, v = (t.to(cuda_device) for t in _inputs(d, 4 * h, 1280, d))
    mask = _card_mask(kind, 1280, h).to(cuda_device)
    tables = tfa.pattern_tables(mask, 1280, d, device=cuda_device)
    assert tables.compact
    counts = (tfa.flash_fwd_compact.launches, tfa.flash_fwd_compact.max_launches,
              tfa.flash_fwd_compact.vfa_launches)
    out, lse = tfa.flash_fwd_compact(q, k, v, tables, h=h, mask=mask, vfa=True)
    online, online_lse = tfa.flash_fwd_compact(q, k, v, tables, h=h, mask=mask)
    after = (tfa.flash_fwd_compact.launches, tfa.flash_fwd_compact.max_launches,
             tfa.flash_fwd_compact.vfa_launches)
    assert np.subtract(after, counts).tolist() == [1, 1, 1]
    assert _max_err(out.cpu(), online.cpu()) <= OUT_TOL
    assert (lse - online_lse).abs().max().item() <= LSE_TOL
