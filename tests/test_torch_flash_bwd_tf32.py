"""The arithmetic of the f32 tensor-core backward (`csrc/flash_bwd_tf32.cuh`:
dq with its delta, and dk/dv, 3xTF32 on `wgmma`), emulated in torch on the
CPU and held against the JAX package.

The kernels run only on the card, so this checks on the CPU that the bodies'
precision decisions meet the f32 tolerance the card holds them to (1e-4 of
the reference's largest gradient).  The emulation follows the bodies
rounding for rounding: delta = rowsum(do * out) in f32 (`tc_delta`, do .
sum_j v_j for a row that sees no key); every product in 3xTF32
(`test_torch_flash_tf32.product`: each operand split into TF32 hi and lo by
`cvt.rna`, (lo hi + hi lo) + hi hi) for S = q k^T, dP = do v^T and dQ += dS
K, and for S^T, dP^T, dV += P^T dO and dK += dS^T Q; the scale (times log2
e) applied to S after the product; p = 2^(s - lse log2 e) in f32, a masked
score the f32 product -1e30 log2 e, so that a row that sees no key (lse
-1e30) takes p = 1 exactly; ds = p (dp - delta) in f32, split only as an
operand; dq and dk scaled once at the end.  It walks the kernels' own tiles
(`tile_shapes`) in their order, in the steps the bodies stage them (two
16-row halves of a tile at d 128, and two 32-row halves of dk/dv's at d
64): dq by key tile for every query tile at once (every key
tile for a query tile that holds a row that sees no key), dk/dv by query
tile for every key block at once (and the query tiles off a block's list
that hold such a row); a tile a block does not visit leaves its rows as
they were.  It is held against `jax.grad` through the JAX Pallas backward in
interpret mode (n 256, where it takes the tiles) and against the port's
plain backward at the ragged n 257 with rows that see no key; one TF32 pass,
for contrast, misses the tolerance.  Tests marked `cuda` hold the two
kernels to the emulation on the card, and the compacted dk/dv grid to the
dense one bit for bit, and skip without a card."""
import math

import numpy as np
import pytest
import torch
from test_torch_flash_bwd_tc import _err, _f32, cuda_device  # noqa: F401 (cuda_device: a fixture)
from test_torch_flash_dq_tc import _dead_key_mask, tc_delta
from test_torch_flash_tf32 import LOG2E, _inputs, one_torch_thread, product  # noqa: F401 (an autouse fixture)
from test_torch_vfa_tc import _card_mask

from dalle_pytorch_tpu_torch.kernels import flash_attention as tfa
from dalle_pytorch_tpu_torch.ops import masks as tmasks

TOL = 1e-4  # f32 dq, dk and dv over the reference's max abs value: the card's tolerance (chip_smoke.py)
NEG = -1e30


def _pad(x, rows):
    """x (bh, n, ...) with zero rows appended up to `rows`"""
    out = x.new_zeros((x.shape[0], rows) + tuple(x.shape[2:]))
    out[:, :x.shape[1]] = x
    return out


def tf32_backward(q, k, v, do, out, lse, h, causal, scale, mask=None, key_mask=None, delta=None, passes=3,
                  dtype=torch.float32, bound=False):
    """The f32 tensor-core bodies' backward, rounding for rounding: q, k, v,
    do, out (bh, n, d) f32; lse (bh, n) f32; mask (n, n) or (h, n, n) bool or
    None; key_mask (bh // h, n) nonzero = attend or None; delta (bh, n) f32,
    or None for `tc_delta`'s.  Returns (delta, dq, dk, dv); with `bound`
    also, for each of dq, dk and dv, (bh, n, d): the sum over the terms of
    the magnitudes an error in them scales with (dq: (|ds| + p sum_d |do
    v|) |k|, dk the same with |q|, dv p |do|; the scale in dq and dk).
    `passes` 1 runs every product as one TF32 pass; `dtype` float64 runs the
    same walk in f64 with exact products (for testing the card's slack)."""
    bh, n, d = q.shape
    (tq, tk), (cq, ck) = tfa.tile_shapes(d)
    # rows of the other side a step stages (dq_step, dkv_step)
    dq_step, dkv_step = {32: (64, 64), 64: (64, 32), 128: (16, 16)}[d]
    if delta is None:
        delta = tc_delta(out, lse, do, v)
    exact = dtype == torch.float64

    def prod(eq, a, b):
        return torch.einsum(eq, a, b) if exact else product(eq, a, b, passes)

    qf, kf, vf, dof = (t.to(dtype) for t in (q, k, v, do))
    log2e = _f32(LOG2E).to(dtype)
    sc = _f32(scale).to(dtype) * log2e
    neg = _f32(NEG).to(dtype) * log2e  # the same product as lse * log2e for lse -1e30
    lse2 = lse.to(dtype) * log2e
    deltaf = delta.to(dtype)
    dead = lse <= tfa._DEAD_LSE
    heads = torch.arange(bh) % h
    allow = torch.ones(bh, n, n, dtype=torch.bool)
    if causal:
        allow &= torch.ones(n, n, dtype=torch.bool).tril()
    if mask is not None:
        allow &= (mask if mask.ndim == 3 else mask[None].expand(h, n, n))[heads]
    if key_mask is not None:
        allow &= (key_mask[torch.arange(bh) // h] > 0)[:, None, :]
    tables = None if mask is None else tfa.pattern_tables(mask, n, d, causal, grid="dense")
    pos = torch.arange(n)
    terms = {}

    # dq: every query tile (rows past n zero) walks the key tiles at once
    nq, nk = math.ceil(n / tq), math.ceil(n / tk)
    qp, dop = (_pad(t, nq * tq).view(bh, nq, tq, d) for t in (qf, dof))
    lse2p, deltap = (_pad(t, nq * tq).view(bh, nq, tq) for t in (lse2, deltaf))
    allowp = _pad(allow, nq * tq).view(bh, nq, tq, n)
    every = _pad(dead, nq * tq).view(bh, nq, tq).any(-1)
    end = torch.ceil(torch.clamp(torch.arange(1, nq + 1) * tq, max=n) / tk) if causal else torch.full((nq,), nk)
    dq = torch.zeros(bh, nq, tq, d, dtype=dtype)
    dq_terms = torch.zeros(bh, nq, tq, d, dtype=dtype)
    for j in range(nk):
        on = (j < end)[None].expand(bh, nq)
        if tables is not None:
            on = on & tables.live_rows[heads % tables.heads, :, j].bool()
        w = (on | every)[..., None, None]
        if not w.any():
            continue
        for keys in pos[j * tk:(j + 1) * tk].split(dq_step):  # keys past n do not exist: p = 0
            s = torch.where(allowp[..., keys], prod("bird,bkd->birk", qp, kf[:, keys]) * sc, neg)
            p = torch.exp2(s - lse2p[..., None])
            dp = prod("bird,bkd->birk", dop, vf[:, keys])
            ds = p * (dp - deltap[..., None])
            dq = torch.where(w, dq + prod("birk,bkd->bird", ds, kf[:, keys]), dq)
            if bound:
                dp_abs = torch.einsum("bird,bkd->birk", dop.abs(), vf[:, keys].abs())
                dq_terms += torch.einsum("birk,bkd->bird", ds.abs() + p * dp_abs, kf[:, keys].abs()) * w
    dq = dq.view(bh, -1, d)[:, :n] * _f32(scale).to(dtype)
    terms["dq"] = dq_terms.view(bh, -1, d)[:, :n] * scale

    # dk/dv: every block of 64 keys (keys past n zero) walks the query tiles
    # at once
    nb, nt = math.ceil(n / ck), math.ceil(n / cq)
    kp, vp = (_pad(t, nb * ck).view(bh, nb, ck, d) for t in (kf, vf))
    allow_t = _pad(allow.transpose(1, 2), nb * ck).view(bh, nb, ck, n)
    begin = (torch.arange(nb) * ck) // cq if causal else torch.zeros(nb, dtype=torch.long)
    any_dead = dead.any(1)
    dk = torch.zeros(bh, nb, ck, d, dtype=dtype)
    dv = torch.zeros(bh, nb, ck, d, dtype=dtype)
    dk_terms = torch.zeros(bh, nb, ck, d, dtype=dtype)
    dv_terms = torch.zeros(bh, nb, ck, d, dtype=dtype)
    for it in range(nt):
        tile = pos[it * cq:(it + 1) * cq]
        on = (it >= begin)[None].expand(bh, nb)
        if tables is not None:
            on = on & tables.live_cols[heads % tables.heads, :, it].bool()
        # with a row that sees no key anywhere, the tiles off the list that
        # hold one too
        w = torch.where(any_dead[:, None], on | dead[:, tile].any(1)[:, None], on)[..., None, None]
        if not w.any():
            continue
        for rows in tile.split(dkv_step):
            s = torch.where(allow_t[..., rows], prod("bjkd,bqd->bjkq", kp, qf[:, rows]) * sc, neg)
            p = torch.exp2(s - lse2[:, None, None, rows])
            dp = prod("bjkd,bqd->bjkq", vp, dof[:, rows])
            ds = p * (dp - deltaf[:, None, None, rows])
            dv = torch.where(w, dv + prod("bjkq,bqd->bjkd", p, dof[:, rows]), dv)
            dk = torch.where(w, dk + prod("bjkq,bqd->bjkd", ds, qf[:, rows]), dk)
            if bound:
                dp_abs = torch.einsum("bjkd,bqd->bjkq", vp.abs(), dof[:, rows].abs())
                dk_terms += torch.einsum("bjkq,bqd->bjkd", ds.abs() + p * dp_abs, qf[:, rows].abs()) * w
                dv_terms += torch.einsum("bjkq,bqd->bjkd", p, dof[:, rows].abs()) * w
    dk = dk.view(bh, -1, d)[:, :n] * _f32(scale).to(dtype)
    dv = dv.view(bh, -1, d)[:, :n]
    terms["dk"] = dk_terms.view(bh, -1, d)[:, :n] * scale
    terms["dv"] = dv_terms.view(bh, -1, d)[:, :n]
    if not bound:
        return delta, dq, dk, dv
    return delta, dq, dk, dv, terms


def _residuals(q, k, v, h, causal=True, mask=None, key_mask=None):
    """out and lse from the port's plain forward in f32"""
    return tfa.flash_attention_reference(q, k, v, h, causal, q.shape[-1] ** -0.5, mask, key_mask)


def _dead_case(dead, b, n, d):
    """(mask, key_mask) under which rows see no key: a pattern that leaves
    rows 0..4 no key, or a key mask that masks batch 0's keys 0..39"""
    if dead == "pattern":
        mask = tmasks.build_pattern_mask("axial_row", n, 16).bool()
        mask[:5] = False
        return mask, None
    return None, _dead_key_mask(b, n, d)


@pytest.mark.parametrize("pattern", [None, "axial_row"])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_emulation_matches_pallas_backward(d, pattern):
    """b=2, h=2, n=256 (text 0 + a 16 x 16 map), causal: the emulation's dq,
    dk and dv against jax.grad through the JAX Pallas backward in interpret
    mode (block 128, dense grid, with the pattern where there is one) and
    against the port's plain backward, each within 1e-4 of the reference's
    max."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from dalle_pytorch_tpu.kernels.flash_attention import flash_attention as jflash

    b, h, n = 2, 2, 256
    q, k, v, do = _inputs(d + 5, b * h, n, d) + _inputs(d + 6, b * h, n, d)[:1]
    mask = None if pattern is None else tmasks.build_pattern_mask(pattern, n, 16).bool()
    out, lse = _residuals(q, k, v, h, mask=mask)
    _, dq, dk, dv = tf32_backward(q, k, v, do, out, lse, h, True, d ** -0.5, mask)
    sh = (b, h, n, d)
    jq, jk, jv, jdo = (jnp.asarray(t.numpy().reshape(sh)) for t in (q, k, v, do))

    def loss(q_, k_, v_):
        o = jflash(q_, k_, v_, mask=None if mask is None else mask.numpy(), block_q=128, block_k=128,
                   bwd_impl="pallas", grid="dense")
        return jnp.sum(o * jdo)

    refs = [np.asarray(g).reshape(b * h, n, d) for g in jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)]
    plain = tfa.flash_attention_backward_reference(q, k, v, out, lse, do, h, True, d ** -0.5, mask)
    for got, ref, pl in zip((dq, dk, dv), refs, plain):
        assert _err(got, ref) <= TOL and _err(got, pl) <= TOL


@pytest.mark.parametrize("dead", ["pattern", "key_mask"])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_emulation_matches_plain_backward_with_rows_that_see_no_key(d, dead):
    """The ragged n 257 (the prefill length), causal, with rows that see no
    key (lse -1e30: p = 1 over all n keys, delta = do . sum_j v_j, as the
    plain backward and `_dense_recompute_grads` have it): the emulation's
    delta within `_delta_limit` of `_delta`, and its dq, dk and dv within
    1e-4 of the plain backward's max, dq on those rows alone too."""
    b, h, n = 2, 2, 257
    q, k, v, do = _inputs(d + 3, b * h, n, d) + _inputs(d + 4, b * h, n, d)[:1]
    mask, key_mask = _dead_case(dead, b, n, d)
    out, lse = _residuals(q, k, v, h, mask=mask, key_mask=key_mask)
    rows = lse <= tfa._DEAD_LSE
    assert bool(rows.any())
    delta, dq, dk, dv = tf32_backward(q, k, v, do, out, lse, h, True, d ** -0.5, mask, key_mask)
    assert bool(((delta.double() - tfa._delta(out, lse, do, v).double()).abs()
                 <= tfa._delta_limit(out, lse, do, v)).all())
    plain = tfa.flash_attention_backward_reference(q, k, v, out, lse, do, h, True, d ** -0.5, mask, key_mask)
    for got, ref in zip((dq, dk, dv), plain):
        assert _err(got, ref) <= TOL
    assert _err(dq[rows], plain[0][rows]) <= TOL


@pytest.mark.parametrize("d", [64, 128])
def test_one_tf32_pass_misses_the_tolerance(d):
    """Why three passes: n 256, causal, against the same walk with exact
    products in f64 (the same lse and delta), one TF32 product (hi hi
    alone) in every product puts dq, dk or dv further than 1e-4 of the
    reference's max away, while 3xTF32 stays within 1e-5."""
    h, n = 1, 256
    q, k, v, do = _inputs(d + 9, 2, n, d) + _inputs(d + 10, 2, n, d)[:1]
    out, lse = _residuals(q, k, v, h)
    ref = tf32_backward(q, k, v, do, out, lse, h, True, d ** -0.5, dtype=torch.float64)[1:]
    errs = {}
    for passes in (1, 3):
        grads = tf32_backward(q, k, v, do, out, lse, h, True, d ** -0.5, passes=passes)[1:]
        errs[passes] = max((g.double() - r).abs().max().item() / r.abs().max().item() for g, r in zip(grads, ref))
    assert errs[3] <= 1e-5 < 1e-4 < errs[1], errs


# How far the card's kernels may lie from the emulation, per element, as a
# share of the magnitudes of its terms (`tf32_backward(bound=True)`): the card
# sums each product in its own order of f32 additions (k-steps of 8, three
# passes) and computes 2^x with ex2.approx (2 ulp), a few 2^-24 of each term;
# an f64 run with exact products lies well inside it
# (test_emulation_slack_covers_exact_products), one TF32 pass far outside.
CARD_SLACK = 2.0 ** -16


def _beyond(got, want, terms):
    """the elements of `got` farther from `want` than CARD_SLACK of their
    terms; (count, largest distance over the slack)"""
    diff = (got.double() - want.double()).abs()
    limit = CARD_SLACK * terms.double() + 1e-30
    return int((diff > limit).sum()), (diff / limit).max().item()


@pytest.mark.parametrize("pattern", [None, "axial_row"])
def test_emulation_slack_covers_exact_products(pattern):
    """The limit the card test holds the kernels to covers the same walk with
    exact products in f64 (d 64, n 320: text 64 + a 16 x 16 map, rows that
    see no key through a key mask), and a walk with one TF32 pass per
    product lies beyond it: the limit tells the three-pass kernels from a
    one-pass one."""
    b, h, n, d = 2, 2, 320, 64
    q, k, v, do = _inputs(7, b * h, n, d) + _inputs(8, b * h, n, d)[:1]
    mask = None if pattern is None else tmasks.build_pattern_mask(pattern, n, 16).bool()
    key_mask = torch.ones(b, n, dtype=torch.int32)
    key_mask[1, :30] = 0
    out, lse = _residuals(q, k, v, h, mask=mask, key_mask=key_mask)
    delta, *grads, terms = tf32_backward(q, k, v, do, out, lse, h, True, d ** -0.5, mask, key_mask, bound=True)
    exact = tf32_backward(q, k, v, do, out, lse, h, True, d ** -0.5, mask, key_mask, delta=delta,
                          dtype=torch.float64)[1:]
    one = tf32_backward(q, k, v, do, out, lse, h, True, d ** -0.5, mask, key_mask, delta=delta, passes=1)[1:]
    for name, got, e, o in zip(("dq", "dk", "dv"), grads, exact, one):
        assert _beyond(e, got, terms[name])[0] == 0, name
        assert _beyond(o, got, terms[name])[0] > 0, name


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("case", [None, "axial_row", "dead_rows"])
@pytest.mark.parametrize("d,n", [(32, 257), (64, 1280), (128, 705)])
def test_kernels_match_emulation_on_card(cuda_device, d, n, case):
    """The f32 dq and dk/dv kernels on the card, dense grid, causal, with a
    pattern or with a key mask under which rows see no key: the dq kernel's
    delta within `_delta_limit` of `_delta`, and dq, dk and dv (dk/dv from
    the kernel's delta) against the emulation on the same inputs and delta,
    every element within CARD_SLACK of its terms."""
    h = 2
    q, k, v, do = _inputs(d + n, 2 * h, n, d) + _inputs(d + n + 1, 2 * h, n, d)[:1]
    mask = key_mask = None
    if case == "axial_row":
        mask = _card_mask(case, n, h).bool()
    elif case == "dead_rows":
        _, key_mask = _dead_case("key_mask", 2, n, d)
    out, lse = _residuals(q, k, v, h, mask=mask, key_mask=key_mask)
    cq, ck, cv, cdo, cout, clse = (t.to(cuda_device) for t in (q, k, v, do, out, lse))
    ckm = None if key_mask is None else key_mask.to(cuda_device)
    dq, dk, dv = (torch.empty_like(t) for t in (cq, ck, cv))
    delta = torch.empty_like(clse)
    scale = d ** -0.5
    if mask is None:
        tfa._call("flash_bwd_dq", cq, (cq, ck, cv, cdo, cout, clse, ckm, None, None, dq, delta), h, True, scale)
        tfa._call("flash_bwd_dkv", cq, (cq, ck, cv, cdo, clse, delta, ckm, None, None, dk, dv), h, True, scale)
    else:
        m, mask_heads = tfa._device_mask(cq, mask.to(cuda_device), h)
        t = tfa.pattern_tables(m, n, d, True, grid="dense", device=cuda_device)
        tfa._call("flash_bwd_dq", cq, (cq, ck, cv, cdo, cout, clse, ckm, m, t.live_rows, dq, delta), h, True,
                  scale, mask_heads, t.heads, 0, t.row_tile)
        tfa._call("flash_bwd_dkv", cq, (cq, ck, cv, cdo, clse, delta, ckm, m, t.live_cols, dk, dv), h, True,
                  scale, mask_heads, t.heads, 0, t.col_tile)
    torch.cuda.synchronize()
    delta = delta.cpu()
    assert bool(((delta.double() - tfa._delta(out, lse, do, v).double()).abs()
                 <= tfa._delta_limit(out, lse, do, v)).all())
    _, *want, terms = tf32_backward(q, k, v, do, out, lse, h, True, scale, mask, key_mask, delta=delta, bound=True)
    for name, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        beyond, worst = _beyond(got.cpu(), w, terms[name])
        print(f"d {d} n {n} {case} {name}: {worst:.3g} of the slack at most, {beyond} beyond it")
        assert beyond == 0


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["axial_row", "conv_like", "sparse_per_head"])
@pytest.mark.parametrize("d", [64, 128])
def test_f32_dkv_compact_equals_dense_on_card(cuda_device, kind, d):
    """f32 at n 1280 with the slice's patterns, and a key mask under which
    the second batch sees no key: dk and dv of the compacted grid equal the
    dense grid's with the same mask bit for bit (both run dkv_block_tf32
    over the same query tiles), and both hold to the plain backward within
    1e-4 of its max."""
    b, h, n = 2, 8, 1280
    mask = _card_mask(kind, n, h).bool().to(cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(d + 2)
    q, k, v, do = (torch.randn(b * h, n, d, generator=g, device=cuda_device) for _ in range(4))
    key_mask = torch.ones(b, n, dtype=torch.int32, device=cuda_device)
    key_mask[1] = 0
    res = {}
    for grid in ("dense", "compact"):
        tables = tfa.pattern_tables(mask, n, d, grid=grid, device=cuda_device)
        out, lse = tfa.flash_fwd(q, k, v, h=h, mask=mask, key_mask=key_mask, grid=grid, tables=tables)
        before = (tfa.flash_bwd.dkv_launches, tfa.flash_bwd_compact.dkv_launches)
        res[grid] = tfa.flash_bwd(q, k, v, out, lse, do, h=h, mask=mask, key_mask=key_mask, grid=grid,
                                  tables=tables)
        after = (tfa.flash_bwd.dkv_launches, tfa.flash_bwd_compact.dkv_launches)
        assert after[grid == "compact"] == before[grid == "compact"] + 1
    torch.cuda.synchronize()
    assert bool((lse[h:] <= tfa._DEAD_LSE).all())
    for a, c in zip(res["dense"][1:], res["compact"][1:]):
        assert torch.equal(a, c)
    ref = tfa.flash_attention_backward_reference(q, k, v, out, lse, do, h, True, d ** -0.5, mask, key_mask)
    for got, r in zip(res["dense"][1:], ref[1:]):
        assert (got - r).abs().max().item() / r.abs().max().item() <= TOL
