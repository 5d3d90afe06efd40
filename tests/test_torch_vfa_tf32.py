"""The arithmetic of the f32 tensor-core VFA pair (`csrc/flash_vfa_tc.cuh`
over `csrc/flash_fwd_tf32.cuh`: the max pass and the fixed-max pass in
3xTF32), emulated in torch on the CPU and held against the JAX package.

The emulation follows the two bodies rounding for rounding: S = q k^T in
3xTF32 (`test_torch_flash_tf32.product`: each operand split into TF32 hi and
lo, (lo hi + hi lo) + hi hi) with the scale applied after the product, the
same in both passes; the mask in natural units (-1e30 for a masked key, keys
past n absent), so gmax is exactly -1e30 for a row that sees no key; p =
2^((s - gmax) log2 e) in f32, l summed from the f32 p, and p split into hi
and lo only as the PV operand; the tiles each block walks are those of the
compacted grid's row lists (`pattern_tables`).  It is held against the JAX
compacted grid with `vfa=True` in interpret mode (its max pass's gmax, its
output and lse), against the port's plain pair at the ragged n 257 with rows
that see no key, and against the online emulation (`tf32_forward`).  A max
pass of one TF32 product, for contrast, breaks p = 1 at the row's largest
score and misses the max pass's tolerance.  Tests marked `cuda` hold the
card's two f32 kernels to the emulation and the f32 VFA forward to the f32
online compacted kernel, and skip without a card."""
import math

import numpy as np
import pytest
import torch
from test_torch_flash_tc import cuda_device  # noqa: F401 (a fixture)
from test_torch_flash_tf32 import (  # noqa: F401 (one_torch_thread: an autouse fixture)
    LOG2E,
    LSE_TOL,
    NEG,
    OUT_TOL,
    _inputs,
    _pattern,
    one_torch_thread,
    product,
    tf32_forward,
)
from test_torch_vfa import _mask, jfa  # noqa: F401 (jfa: a fixture)
from test_torch_vfa_tc import GMAX_TOL, _card_mask, _dead_rows_case, _gmax_err, _max_err

from dalle_pytorch_tpu_torch.kernels import flash_attention as tfa
from dalle_pytorch_tpu_torch.ops import masks as tmasks


def tf32_vfa(q, k, v, h, causal, scale, mask=None, key_mask=None, max_passes=3):
    """Both f32 VFA bodies, rounding for rounding: q, k, v (bh, n, d) f32,
    mask (n, n) or per-head (h, n, n) bool or None, key_mask (bh // h, n)
    nonzero = attend or None; `max_passes` 1 runs the max pass as one TF32
    product (the fixed-max pass keeps three).  Returns (gmax (bh, n), out,
    lse, l, and pmax: each row's largest p in the fixed-max pass), f32.
    Every query tile of every (batch, head) walks the key tiles at once, in
    ascending order (the order of the CSR row lists); a tile off a block's
    list leaves its rows as they were."""
    bh, n, d = q.shape
    tq, tk = tfa.tile_shapes(d)[0]
    nq, nk = math.ceil(n / tq), math.ceil(n / tk)
    tables = tfa.pattern_tables(mask, n, d, causal, grid="compact")
    on = torch.zeros(tables.heads, nq, nk, dtype=torch.bool)
    for head in range(tables.heads):
        ptr, col = tables.row_ptr[head].tolist(), tables.col[head]
        for i in range(nq):
            on[head, i, col[ptr[i]:ptr[i + 1]].long()] = True
    on = on[torch.arange(bh) % tables.heads]  # (bh, nq, nk): the blocks' lists
    allow = torch.ones(bh, nq * tq, n, dtype=torch.bool)
    if causal:
        allow &= torch.ones(nq * tq, n, dtype=torch.bool).tril()
    if mask is not None:
        allow[:, :n] &= (mask if mask.ndim == 3 else mask[None].expand(h, n, n))[torch.arange(bh) % h]
    if key_mask is not None:
        allow &= (key_mask[torch.arange(bh) // h] != 0)[:, None, :]
    allow = allow.view(bh, nq, tq, n)
    qp = torch.zeros(bh, nq * tq, d)
    qp[:, :n] = q
    qp = qp.view(bh, nq, tq, d)
    pos = torch.arange(n)
    sc = np.float32(scale)

    def scores(cols, passes):
        """the masked S of every query tile against the keys `cols`, natural
        units, scaled after the product"""
        s = product("bird,bcd->birc", qp, k[:, cols], passes) * sc
        return torch.where(allow[..., cols], s, torch.tensor(NEG))

    tiles = [(pos[j * tk:(j + 1) * tk], on[..., j][..., None]) for j in range(nk) if on[..., j].any()]
    m = torch.full((bh, nq, tq), NEG)
    for cols, w in tiles:  # pass 1; keys past n do not exist: p = 0
        m = torch.where(w, torch.maximum(m, scores(cols, max_passes).amax(-1)), m)
    acc, lsum, top = torch.zeros(bh, nq, tq, d), torch.zeros(bh, nq, tq), torch.zeros(bh, nq, tq)
    for cols, w in tiles:  # pass 2, against the fixed maximum
        p = torch.exp2((scores(cols, 3) - m[..., None]) * np.float32(LOG2E))
        lsum = torch.where(w, lsum + p.sum(-1), lsum)
        top = torch.where(w, torch.maximum(top, p.amax(-1)), top)
        acc = torch.where(w[..., None], acc + product("birc,bcd->bird", p, v[:, cols]), acc)
    gmax, l, pmax = (t.reshape(bh, -1)[:, :n] for t in (m, lsum, top))
    o = acc.reshape(bh, -1, d)[:, :n]
    dead = gmax <= NEG / 2
    lc = l.clamp_min(1e-30)
    out = torch.where(dead[..., None], v.sum(1, keepdim=True) / np.float32(n), o / lc[..., None])
    lse = torch.where(dead, torch.tensor(NEG), gmax + torch.log(lc))
    return gmax, out, lse, l, pmax


@pytest.mark.parametrize("kind", ["axial_row", "sparse_per_head"])
@pytest.mark.parametrize("d", [64, 128])
def test_emulation_matches_pallas_vfa(jfa, d, kind):
    """b=1, h=2, n=256, causal: the emulation against the JAX compacted
    grid with vfa=True in interpret mode (block 128): gmax against its max
    pass within 1e-4 relative, out against its fixed-max pass within 1e-4
    and lse within 1e-4; p = 1 at every row's largest score."""
    import jax.numpy as jnp

    b, h, n = 1, 2, 256
    mask = _mask(kind, n, 16, h)
    q, k, v = _inputs(d + len(kind), b * h, n, d)
    jq, jk, jv = (jnp.asarray(t.numpy().reshape(b, h, n, d)) for t in (q, k, v))
    ref_out = jfa.flash_attention(jq, jk, jv, mask=jnp.asarray(mask), block_q=128, block_k=128, grid="compact",
                                  vfa=True)
    rec = jfa.pl.outputs
    ref_gmax = np.asarray(rec["_max_kernel_compact"])[..., 0]
    ref_lse = np.asarray(rec["_fwd_kernel_compact_vfa"][1])[..., 0]

    gmax, out, lse, l, pmax = tf32_vfa(q, k, v, h, True, d ** -0.5, torch.from_numpy(mask))
    assert _gmax_err(gmax, ref_gmax) <= GMAX_TOL
    assert _max_err(out, np.asarray(ref_out).reshape(b * h, n, d)) <= OUT_TOL
    assert _max_err(lse, ref_lse) <= LSE_TOL
    assert torch.all(pmax == 1) and torch.all(l >= 1)


@pytest.mark.parametrize("dead", ["pattern", "key_mask"])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_emulation_matches_plain_vfa_with_rows_that_see_no_key(d, dead):
    """The ragged n 257 (the prefill length), causal, with rows that see no
    key: gmax against `vfa_max_reference` (1e-4 relative, exactly -1e30 on
    those rows), out and lse against `vfa_fwd_reference` and against the
    online emulation `tf32_forward` (1e-4 each); lse -1e30 on those rows,
    l >= 1 on every other."""
    b, h, n = 2, 2, 257
    scale = d ** -0.5
    mask, key_mask = _dead_rows_case(dead, b, h, n, d)
    q, k, v = _inputs(d + 3, b * h, n, d)
    gmax, out, lse, l, _ = tf32_vfa(q, k, v, h, True, scale, mask, key_mask)
    ref_gmax = tfa.vfa_max_reference(q, k, h, True, scale, mask, key_mask)
    dead_rows = ref_gmax == NEG
    assert dead_rows.any() and torch.equal(gmax == NEG, dead_rows)
    assert _gmax_err(gmax, ref_gmax) <= GMAX_TOL
    ref_out, ref_lse = tfa.vfa_fwd_reference(q, k, v, ref_gmax, h, True, scale, mask, key_mask)
    assert _max_err(out, ref_out) <= OUT_TOL and _max_err(lse, ref_lse) <= LSE_TOL
    online, online_lse = tf32_forward(q, k, v, h, True, scale, mask, key_mask)
    assert _max_err(out, online) <= OUT_TOL and _max_err(lse, online_lse) <= LSE_TOL
    assert torch.all(lse[dead_rows] == NEG)
    assert torch.all(l[~dead_rows] >= 1)


@pytest.mark.parametrize("pattern", ["axial_row", "axial_col", "conv_like"])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_emulation_matches_online_emulation(d, pattern):
    """n 256, causal, with a pattern: the VFA pair's out and lse against the
    online 3xTF32 emulation's on the same tiles, 1e-4 each (they sum in
    another order: exp(s - gmax) with no rescale against the running
    maximum)."""
    h, n = 2, 256
    q, k, v = _inputs(d + len(pattern), 2 * h, n, d)
    mask = _pattern(pattern, n)
    _, out, lse, _, _ = tf32_vfa(q, k, v, h, True, d ** -0.5, mask)
    online, online_lse = tf32_forward(q, k, v, h, True, d ** -0.5, mask)
    assert _max_err(out, online) <= OUT_TOL and _max_err(lse, online_lse) <= LSE_TOL


@pytest.mark.parametrize("d", [32, 64, 128])
def test_emulation_largest_score_gives_p_one(d):
    """Both passes compute the same S, so the row's largest score gives
    s - gmax = 0 and p = 1 exactly: each live row's largest p is 1, and l
    lies between 1 and the number of keys the row may see (per-head pattern
    and key padding, n 300)."""
    b, h, n = 2, 2, 300
    q, k, v = _inputs(d + 5, b * h, n, d)
    mask = tmasks.build_block_sparse_mask(n, 16, heads=h).bool()
    rng = np.random.default_rng(d)
    key_mask = torch.from_numpy((rng.random((b, n)) > 0.5).astype(np.int32))
    key_mask[:, 0] = 1
    gmax, out, lse, l, pmax = tf32_vfa(q, k, v, h, True, d ** -0.5, mask, key_mask)
    assert torch.all(gmax > NEG) and torch.all(pmax == 1) and torch.all(l >= 1)
    seen = (torch.ones(n, n).tril().bool() & mask.repeat(b, 1, 1) &
            torch.repeat_interleave(key_mask != 0, h, dim=0)[:, None, :]).sum(-1)
    assert torch.all(l <= seen)
    ref_out, ref_lse = tfa.vfa_fwd_reference(q, k, v, gmax, h, True, d ** -0.5, mask, key_mask)
    assert _max_err(out, ref_out) <= OUT_TOL and _max_err(lse, ref_lse) <= LSE_TOL


@pytest.mark.parametrize("d", [64, 128])
def test_one_tf32_max_pass_breaks_p_one(d):
    """Why the max pass runs the fixed-max pass's three products, not one:
    at the flagship's length (n 1280, causal, axial_row), a max pass of one
    TF32 product (hi hi alone) gives a gmax that is not the fixed-max pass's
    largest score (a row's largest p is then not 1), and lies further than
    1e-4 (relative) from `vfa_max_reference`, while 3xTF32 stays within
    1e-5 of it with p = 1 on every row."""
    h, n = 1, 1280
    q, k, v = _inputs(d + 13, 2, n, d)
    mask = _card_mask("axial_row", n, h).bool()
    ref = tfa.vfa_max_reference(q, k, h, True, d ** -0.5, mask)
    gmax3, _, _, _, pmax3 = tf32_vfa(q, k, v, h, True, d ** -0.5, mask)
    gmax1, _, _, _, pmax1 = tf32_vfa(q, k, v, h, True, d ** -0.5, mask, max_passes=1)
    assert torch.all(pmax3 == 1) and _gmax_err(gmax3, ref) <= 1e-5
    assert (pmax1 != 1).float().mean().item() > 0.5
    assert _gmax_err(gmax1, ref) > GMAX_TOL


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

# How far the card's kernels may lie from the emulation: the card sums each
# product's terms in its own order of f32 additions (in k-steps of 8 per
# pass) and computes 2^x with ex2.approx (2 ulp); a few 2^-24 of each score's
# and each output's terms, as for the online forward
# (test_torch_flash_tf32.py).
CARD_GMAX_SLACK = 1e-5  # relative to max(|gmax|, 1)
CARD_OUT_SLACK = 1e-5  # absolute, plus the same relative to |out|
CARD_LSE_SLACK = 1e-5


def _run_pair(device, q, k, v, h, mask, key_mask=None):
    """gmax from the max pass alone, then (out, lse) of the pair through
    `flash_fwd_compact(vfa=True)`, on `device`"""
    n, d = q.shape[1:]
    dq, dk, dv, dmask = (t.to(device) for t in (q, k, v, mask))
    dkmask = None if key_mask is None else key_mask.to(device)
    tables = tfa.pattern_tables(dmask, n, d, grid="compact", device=device)
    m, mask_heads = tfa._device_mask(dq, dmask, h)
    gmax = torch.empty(q.shape[0], n, device=device)
    tfa._call("flash_max_compact", dq, (dq, dk, dkmask, m, tables.row_ptr, tables.col, gmax), h, True,
              d ** -0.5, mask_heads, tables.heads, tables.col.shape[1], tables.row_tile)
    out, lse = tfa.flash_fwd_compact(dq, dk, dv, tables, h=h, mask=dmask, key_mask=dkmask, vfa=True)
    return gmax.cpu(), out.cpu(), lse.cpu()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["axial_row", "sparse_per_head", "dead_rows"])
@pytest.mark.parametrize("d,n", [(32, 257), (64, 1280), (128, 705)])
def test_kernels_match_emulation_on_card(cuda_device, d, n, case):
    """The two f32 kernels on the card, compacted grid, causal, against the
    emulation above on the same inputs: gmax within CARD_GMAX_SLACK and
    exactly -1e30 on rows that see no key, out within CARD_OUT_SLACK
    (absolute and relative), lse within CARD_LSE_SLACK; with `dead_rows`, a
    key mask that masks every key of the second batch."""
    h = 2
    q, k, v = _inputs(d + n, 2 * h, n, d)
    mask = _card_mask("axial_row" if case == "dead_rows" else case, n, h)
    key_mask = None
    if case == "dead_rows":
        key_mask = torch.ones(2, n, dtype=torch.int32)
        key_mask[1] = 0
    want_gmax, want, want_lse, _, _ = tf32_vfa(q, k, v, h, True, d ** -0.5, mask.bool(), key_mask)
    gmax, out, lse = _run_pair(cuda_device, q, k, v, h, mask, key_mask)
    assert torch.equal(gmax == NEG, want_gmax == NEG)
    gmax_err = _gmax_err(gmax, want_gmax)
    diff = (out - want).abs()
    lse_err = (lse - want_lse).abs().max().item()
    print(f"d {d} n {n} {case}: gmax {gmax_err:.3g}, out {diff.max().item():.3g} "
          f"(relative {(diff / want.abs()).max().item():.3g}), lse {lse_err:.3g}")
    assert gmax_err <= CARD_GMAX_SLACK
    assert torch.all(diff <= CARD_OUT_SLACK * (1 + want.abs()))
    assert lse_err <= CARD_LSE_SLACK


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["axial_row", "conv_like", "sparse_per_head"])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_lse_is_at_least_gmax_on_card(cuda_device, d, kind):
    """n 1280, bh 8, causal: on the card lse >= gmax on every row, exactly
    (l >= 1 because the largest score gives p = 1, which needs the two
    passes' S bit for bit alike), and gmax is finite on every row."""
    h = 2
    q, k, v = _inputs(d + 17, 4 * h, 1280, d)
    gmax, _, lse = _run_pair(cuda_device, q, k, v, h, _card_mask(kind, 1280, h))
    assert torch.all(gmax > NEG)
    assert torch.all(lse >= gmax), (lse - gmax).min().item()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["axial_row", "conv_like", "sparse_per_head"])
@pytest.mark.parametrize("d", [64, 128])
def test_f32_vfa_matches_online_compact_on_card(cuda_device, d, kind):
    """n 1280, bh 32, causal, f32: the VFA pair's out and lse against the
    online compacted kernel's (1e-4 each), each launch counted on its own
    counter."""
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
