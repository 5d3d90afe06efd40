"""The arithmetic of the bf16 tensor-core dq body (`csrc/flash_dq_tc.cuh`) and
of the delta both dq bodies compute before their walk, emulated in torch on
the CPU and held against the JAX package.

The kernel runs only on the card, so this checks on the CPU that the body's
precision decisions meet the tolerance the card holds the kernel to: bf16
q, k, v, do and out; delta = rowsum(do * out) with f32 products summed in
f32 (do . sum_j v_j for a row that sees no key); S = q k^T in f32 with the
scale (times log2 e) applied after the product; p = 2^(s - lse log2 e) in
f32, with a masked score set to the f32 product -1e30 log2 e, so that a row
that sees no key (lse -1e30) takes p = 1 exactly; dP = do v^T and ds = p (dp
- delta) in f32; ds rounded to bf16 only as the operand of the dQ product;
f32 accumulation; dq scaled once at the end; the kernel's own tiles
(`tile_shapes`), visiting the key tiles the dense grid visits (every one for
a query tile that holds a row that sees no key).  The emulation is held
against `jax.grad` through the JAX Pallas backward in interpret mode (n 256,
where it takes the tiles) and against the port's plain backward at the ragged
n 257, with rows that see no key; its delta against `_delta`.  Tests marked
`cuda` hold the kernels to the emulation and to `_delta` on the card, and
the compacted grid to the dense grid bit for bit."""
import math

import numpy as np
import pytest
import torch
from test_torch_flash_bwd_tc import (  # noqa: F401 (cuda_device: a fixture)
    DP_SLACK,
    LOG2E,
    P_SLACK,
    TOL,
    _beyond_limit,
    _err,
    _f32,
    _inputs,
    _residuals,
    _spread,
    cuda_device,
)

from dalle_pytorch_tpu_torch.kernels import flash_attention as tfa
from dalle_pytorch_tpu_torch.ops import masks as tmasks


def tc_delta(out, lse, do, v):
    """The dq bodies' delta, (bh, n) f32: per row the products do * out (f32,
    exact for bf16 inputs) summed in f32 over each half of the row's
    channels in ascending order, then the two halves added, as the bf16
    body's two threads a row do; a row that sees no key takes do . sum_j v_j
    in the same order, the column sums of v over the n keys in ascending
    order (the card's fused multiply-adds of do and those sums round once,
    these twice)."""
    d = do.shape[-1]
    do_, out_, v_ = (t.float() for t in (do, out, v))
    vsum = torch.zeros_like(v_[:, 0])
    for j in range(v_.shape[1]):
        vsum = vsum + v_[:, j]
    other = torch.where((lse <= tfa._DEAD_LSE)[..., None], vsum[:, None, :], out_)
    halves = []
    for half in (slice(0, d // 2), slice(d // 2, d)):
        acc = torch.zeros(do_.shape[:2])
        for c in range(half.start, half.stop):
            acc = acc + do_[..., c] * other[..., c]
        halves.append(acc)
    return halves[0] + halves[1]


def tc_dq(q, k, v, do, out, lse, h, causal, scale, mask=None, key_mask=None, slack=False, dtype=torch.float32,
          delta=None):
    """The tensor-core body's dq, rounding for rounding: q, k, v, do, out
    (bh, n, d) bf16; lse (bh, n) f32; mask (n, n) or (h, n, n) bool or None;
    key_mask (bh // h, n) or None; delta (bh, n) f32, or None for
    `tc_delta`'s.  Returns (dq bf16, delta), and with `slack` also (bh, n,
    d) f64: the spread of the ds near a bf16 rounding midpoint times |k| (the
    card's result may differ by it before its final rounding), and the sum
    of the terms' magnitudes.  `dtype` float64 does the same arithmetic in
    f64 (another order of rounding, for testing the slack)."""
    bh, n, d = q.shape
    (tq, tk), _ = tfa.tile_shapes(d)
    if delta is None:
        delta = tc_delta(out, lse, do, v)
    qf, kf, vf, dof = (t.to(dtype) for t in (q, k, v, do))
    log2e = _f32(LOG2E).to(dtype)
    sc = _f32(scale).to(dtype) * log2e
    neg = _f32(-1e30).to(dtype) * log2e  # the same product as lse * log2e for lse -1e30
    lse2 = lse.to(dtype) * log2e
    live = None if mask is None else tfa.pattern_tables(mask, n, d, causal, grid="dense").live_rows
    heads = torch.arange(bh) % h
    dead = lse <= tfa._DEAD_LSE
    pos = torch.arange(n)
    nk = math.ceil(n / tk)
    dq = torch.zeros(bh, n, d, dtype=dtype)
    amb = torch.zeros(bh, n, d, dtype=torch.float64)
    abs_sum = torch.zeros(bh, n, d, dtype=torch.float64)
    for qb in range(math.ceil(n / tq)):
        rows = pos[qb * tq:(qb + 1) * tq]
        end = math.ceil(min((qb + 1) * tq, n) / tk) if causal else nk
        # dq_block's walk: the list, or every key tile when a row of the
        # query tile sees no key
        every = dead[:, rows].any(1)
        for kb in range(nk):
            on_list = torch.full((bh,), kb < end)
            if live is not None:
                on_list &= live[heads % live.shape[0], qb, kb].bool()
            visit = every | on_list
            if not visit.any():
                continue
            w = visit[:, None, None].to(dtype)
            keys = pos[kb * tk:(kb + 1) * tk]
            s = torch.einsum("bqd,bkd->bqk", qf[:, rows], kf[:, keys]) * sc
            allow = torch.ones(bh, len(rows), len(keys), dtype=torch.bool)
            if causal:
                allow &= keys[None, None, :] <= rows[None, :, None]
            if mask is not None:
                m = mask[heads] if mask.ndim == 3 else mask[None]
                allow &= m[:, rows][:, :, keys]
            if key_mask is not None:
                allow &= (key_mask[torch.arange(bh) // h] > 0)[:, keys][:, None, :]
            s = torch.where(allow, s, neg)
            p = torch.exp2(s - lse2[:, rows, None])
            dp = torch.einsum("bqd,bkd->bqk", dof[:, rows], vf[:, keys])
            ds = p * (dp - delta.to(dtype)[:, rows, None])
            dsb = ds.bfloat16().to(dtype)
            dq[:, rows] += torch.einsum("bqk,bkd->bqd", dsb, kf[:, keys]) * w
            if slack:
                w64, k_abs = w.double(), kf[:, keys].double().abs()
                dp_abs = torch.einsum("bqd,bkd->bqk", dof[:, rows].double().abs(), vf[:, keys].double().abs())
                amb_ds = _spread(ds, P_SLACK * ds.abs() + DP_SLACK * p * dp_abs.to(dtype))
                amb[:, rows] += torch.einsum("bqk,bkd->bqd", amb_ds, k_abs) * w64
                abs_sum[:, rows] += torch.einsum("bqk,bkd->bqd", dsb.double().abs(), k_abs) * w64
    dq = (dq * _f32(scale).to(dtype)).bfloat16()
    if not slack:
        return dq, delta
    return dq, delta, amb * scale, abs_sum * scale


def _bf16_residuals(q, k, v, do, h, mask=None, key_mask=None):
    """out (bf16, as the backward receives it in bf16 training) and lse from
    the plain forward in f32 on the same bf16 values."""
    out, lse, _ = _residuals(q, k, v, do, h, mask, key_mask)
    return out.bfloat16(), lse


def _dead_key_mask(b, n, seed):
    """A random key mask that masks batch 0's keys 0..39: under causality its
    rows 0..39 see no key."""
    rng = np.random.default_rng(seed)
    key_mask = torch.from_numpy((rng.random((b, n)) > 0.2).astype(np.int32))
    key_mask[0, :40] = 0
    return key_mask


@pytest.mark.parametrize("pattern", [None, "axial_row"])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_dq_emulation_matches_pallas_backward(d, pattern):
    """b=2, h=2, n=256 (text 0 + a 16 x 16 map), causal: the emulation's dq
    against jax.grad through the JAX Pallas backward in interpret mode
    (block 128, dense grid, with the pattern where there is one) and against
    the port's plain backward, both within 2e-2 of the reference's max."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from dalle_pytorch_tpu.kernels.flash_attention import flash_attention as jflash

    b, h, n = 2, 2, 256
    q, k, v, do = _inputs(d + 7, b * h, n, d)
    mask = None if pattern is None else tmasks.build_pattern_mask(pattern, n, 16).bool()
    out, lse = _bf16_residuals(q, k, v, do, h, mask)
    dq, _ = tc_dq(q, k, v, do, out, lse, h, True, d ** -0.5, mask)
    sh = (b, h, n, d)
    jq, jk, jv, jdo = (jnp.asarray(t.float().numpy().reshape(sh)) for t in (q, k, v, do))

    def loss(q_):
        o = jflash(q_, jk, jv, mask=None if mask is None else mask.numpy(), block_q=128, block_k=128,
                   bwd_impl="pallas", grid="dense")
        return jnp.sum(o * jdo)

    ref_dq = np.asarray(jax.grad(loss)(jq)).reshape(b * h, n, d)
    assert _err(dq, ref_dq) <= TOL
    plain_dq, _, _ = tfa.flash_attention_backward_reference(
        q.float(), k.float(), v.float(), out.float(), lse, do.float(), h, True, d ** -0.5, mask)
    assert _err(dq, plain_dq) <= TOL


@pytest.mark.parametrize("dead", ["pattern", "key_mask"])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_dq_emulation_matches_plain_backward_with_rows_that_see_no_key(d, dead):
    """The ragged n 257 (the prefill length), causal, with rows that see no
    key: a pattern that leaves rows 0..4 no key, or a key mask that masks
    batch 0's keys 0..39.  Such rows take p = 1 over all n keys (lse -1e30)
    and delta = do . sum_j v_j, as the plain backward and
    `_dense_recompute_grads` do, and their query tiles visit every key tile;
    the emulation's dq holds to the plain backward within 2e-2 of its max,
    on those rows alone too."""
    b, h, n = 2, 2, 257
    q, k, v, do = _inputs(d + 3, b * h, n, d)
    mask = key_mask = None
    if dead == "pattern":
        mask = tmasks.build_pattern_mask("axial_row", n, 16).bool()
        mask[:5] = False
    else:
        key_mask = _dead_key_mask(b, n, d)
    out, lse = _bf16_residuals(q, k, v, do, h, mask, key_mask)
    rows = lse <= tfa._DEAD_LSE
    assert bool(rows.any())
    dq, _ = tc_dq(q, k, v, do, out, lse, h, True, d ** -0.5, mask, key_mask)
    plain_dq, _, _ = tfa.flash_attention_backward_reference(
        q.float(), k.float(), v.float(), out.float(), lse, do.float(), h, True, d ** -0.5, mask, key_mask)
    assert _err(dq, plain_dq) <= TOL
    assert _err(dq[rows], plain_dq[rows]) <= TOL


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [64, 128])
def test_fused_delta_matches_plain_delta(d, dtype):
    """n 257 with a key mask under which batch 0's rows 0..39 see no key:
    the fused delta (`tc_delta`, the bf16 body's order) agrees with `_delta`
    within `_delta_limit` on every row, live and dead, and it differs from
    the live rule (do . out) on the dead rows."""
    b, h, n = 2, 2, 257
    q, k, v, do = _inputs(d + 11, b * h, n, d)
    key_mask = _dead_key_mask(b, n, d + 1)
    out, lse = _bf16_residuals(q, k, v, do, h, key_mask=key_mask)
    q, k, v, do, out = (t.to(dtype) for t in (q, k, v, do, out))
    dead = lse <= tfa._DEAD_LSE
    assert 0 < int(dead.sum()) < dead.numel()
    got, want = tc_delta(out, lse, do, v), tfa._delta(out, lse, do, v)
    assert bool(((got.double() - want.double()).abs() <= tfa._delta_limit(out, lse, do, v)).all())
    live_rule = (do.float() * out.float()).sum(-1)
    assert not torch.allclose(got[dead], live_rule[dead])


@pytest.mark.parametrize("pattern", [None, "axial_row"])
def test_dq_emulation_slack_covers_another_rounding_order(pattern):
    """The limit the card test holds the kernel to (one bf16 step, the
    emulation's spread, SUM_SLACK of the terms) covers the same arithmetic
    done in f64, whose every p, ds and sum rounds elsewhere than in f32, on
    the same delta: every dq element lies within it (d 64, n 320: text 64 + a
    16 x 16 map, rows that see no key through a key mask)."""
    b, h, n, d = 2, 2, 320, 64
    q, k, v, do = _inputs(9, b * h, n, d)
    mask = None if pattern is None else tmasks.build_pattern_mask(pattern, n, 16).bool()
    key_mask = torch.ones(b, n, dtype=torch.int32)
    key_mask[1, :30] = 0
    out, lse = _bf16_residuals(q, k, v, do, h, mask, key_mask)
    dq, delta, amb, abs_sum = tc_dq(q, k, v, do, out, lse, h, True, d ** -0.5, mask, key_mask, slack=True)
    dq64, _ = tc_dq(q, k, v, do, out, lse, h, True, d ** -0.5, mask, key_mask, dtype=torch.float64, delta=delta)
    assert not torch.equal(dq, dq64)  # the two orders do differ somewhere
    assert _beyond_limit(dq64, dq, amb, abs_sum)[0] == 0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("case", [None, "axial_row", "dead_rows"])
@pytest.mark.parametrize("d,n", [(32, 257), (64, 1280), (128, 705)])
def test_dq_kernel_matches_emulation_on_card(cuda_device, d, n, case):
    """The bf16 dq kernel on the card, dense grid, causal, with a pattern or
    with a key mask under which rows see no key: its delta within
    `_delta_limit` of `_delta`, and its dq against the emulation on the same
    inputs and the kernel's delta, every element within one bf16 step (the
    final rounding) plus the emulation's spread (a ds within P_SLACK,
    DP_SLACK of a bf16 rounding midpoint may round the other way there) plus
    SUM_SLACK of the terms' magnitudes (f32 sums in another order)."""
    h = 2
    q, k, v, do = _inputs(d + n, 2 * h, n, d)
    mask = key_mask = None
    if case == "axial_row":
        mask = tmasks.build_pattern_mask(case, 1280, 32)[:n, :n].contiguous().bool()
    elif case == "dead_rows":
        key_mask = _dead_key_mask(2, n, d)
    out, lse = _bf16_residuals(q, k, v, do, h, mask, key_mask)
    cq, ck, cv, cdo, cout = (t.to(cuda_device) for t in (q, k, v, do, out))
    clse = lse.to(cuda_device)
    ckm = None if key_mask is None else key_mask.to(cuda_device)
    dq = torch.empty_like(cq)
    delta = torch.empty_like(clse)
    if mask is None:
        tfa._call("flash_bwd_dq", cq, (cq, ck, cv, cdo, cout, clse, ckm, None, None, dq, delta), h, True,
                  d ** -0.5)
    else:
        m, mask_heads = tfa._device_mask(cq, mask, h)
        t = tfa.pattern_tables(m, n, d, True, grid="dense", device=cuda_device)
        tfa._call("flash_bwd_dq", cq, (cq, ck, cv, cdo, cout, clse, ckm, m, t.live_rows, dq, delta), h, True,
                  d ** -0.5, mask_heads, t.heads, 0, t.row_tile)
    torch.cuda.synchronize()
    delta = delta.cpu()
    assert bool(((delta.double() - tfa._delta(out, lse, do, v).double()).abs()
                 <= tfa._delta_limit(out, lse, do, v)).all())
    want, _, amb, abs_sum = tc_dq(q, k, v, do, out, lse, h, True, d ** -0.5, mask, key_mask, slack=True,
                                  delta=delta)
    beyond, diff, steps = _beyond_limit(dq.cpu(), want, amb, abs_sum)
    print(f"d {d} n {n} {case} dq: max diff {diff:.3g} ({steps:.3g} steps), {beyond} beyond the limit")
    assert beyond == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kind", ["axial_row", "conv_like", "sparse_per_head"])
@pytest.mark.parametrize("d", [64, 128])
def test_dq_compact_equals_dense_on_card(cuda_device, kind, d, dtype):
    """n 1280 with the slice's patterns, and a key mask under which the
    second batch sees no key: dq and delta of the compacted grid equal the
    dense grid's with the same mask bit for bit (both run one body over the
    same key tiles), the delta the dq kernel writes holds to `_delta`
    within `_delta_limit`, and dq to the plain backward within the dtype's
    tolerance of its max (2e-2 bf16, 1e-4 f32)."""
    b, h, n = 2, 8, 1280
    if kind == "sparse_per_head":
        mask = tmasks.build_block_sparse_mask(n, 32, heads=h)
    else:
        mask = tmasks.build_pattern_mask(kind, n, 32)
    mask = mask.to(cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(d + 1)
    q, k, v, do = (torch.randn(b * h, n, d, generator=g, device=cuda_device).to(dtype) for _ in range(4))
    key_mask = torch.ones(b, n, dtype=torch.int32, device=cuda_device)
    key_mask[1] = 0
    res = {}
    for grid in ("dense", "compact"):
        t = tfa.pattern_tables(mask, n, d, grid=grid, device=cuda_device)
        out, lse = tfa.flash_fwd(q, k, v, h=h, mask=mask, key_mask=key_mask, grid=grid, tables=t)
        m, mask_heads = tfa._device_mask(q, mask, h)
        dq, delta = torch.empty_like(q), torch.empty_like(lse)
        if grid == "dense":
            tfa._call("flash_bwd_dq", q, (q, k, v, do, out, lse, key_mask, m, t.live_rows, dq, delta), h, True,
                      d ** -0.5, mask_heads, t.heads, 0, t.row_tile)
        else:
            tfa._call("flash_dq_compact", q, (q, k, v, do, out, lse, key_mask, m, t.row_ptr, t.col, dq, delta),
                      h, True, d ** -0.5, mask_heads, t.heads, t.col.shape[1], t.row_tile)
        res[grid] = (dq, delta)
    torch.cuda.synchronize()
    assert bool((lse[h:] <= tfa._DEAD_LSE).all())
    assert torch.equal(res["dense"][0], res["compact"][0]) and torch.equal(res["dense"][1], res["compact"][1])
    dq, delta = res["dense"]
    assert bool(((delta.double() - tfa._delta(out, lse, do, v).double()).abs()
                 <= tfa._delta_limit(out, lse, do, v)).all())
    ref, _, _ = tfa.flash_attention_backward_reference(q, k, v, out, lse, do, h, True, d ** -0.5, mask, key_mask)
    tol = TOL if dtype == torch.bfloat16 else 1e-4
    assert (dq.float() - ref.float()).abs().max().item() / ref.float().abs().max().item() <= tol
