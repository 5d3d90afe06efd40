"""The arithmetic of the bf16 tensor-core dk/dv body (`csrc/flash_bwd_tc.cuh`),
emulated in torch on the CPU and held against the JAX package.

The kernel runs only on the card, so this checks on the CPU that the body's
precision decisions meet the tolerance the card holds the kernel to: bf16
q, k, v and do; S^T = k q^T in f32 with the scale (times log2 e) applied
after the product; p = 2^(s - lse log2 e) in f32, with a masked score set
to the f32 product -1e30 log2 e, so that a row that sees no key (lse -1e30)
takes p = 1 exactly; dP^T = v do^T and ds = p (dp - delta) in f32; p and ds
rounded to bf16 only as the operands of the dV and dK products; f32
accumulation; dk scaled once at the end; the kernel's own tiles
(`tile_shapes`), visiting the query tiles the dense grid visits.  The
emulation is held against `jax.grad` through the JAX Pallas backward in
interpret mode (n 256, where it takes the tiles) and against the port's plain
backward at the ragged n 257, with rows that see no key.  Tests marked
`cuda` hold the kernel to the emulation on the card, and the compacted grid
to the dense grid bit for bit.  The mask the kernels read has 16 bytes of
storage past its end (`_device_mask`), checked on the CPU."""
import math

import numpy as np
import pytest
import torch

from dalle_pytorch_tpu_torch.kernels import flash_attention as tfa
from dalle_pytorch_tpu_torch.ops import masks as tmasks

TOL = 2e-2  # bf16 dk and dv over the reference's max abs value: the card's tolerance (chip_smoke.py)
LOG2E = 1.4426950408889634
# How far the card's f32 p and ds may lie from the emulation's before they
# are rounded to bf16 (a value that close to a rounding midpoint may round
# the other way there): p relative (ex2.approx, and q.k summed in another
# order); ds the same relative plus p times this share of sum_d |v do| (do.v
# summed in another order: at most d - 1 = 127 roundings of 2^-24).
P_SLACK = 2.0 ** -14
DP_SLACK = 2.0 ** -16
# dk and dv sum their f32 terms in another order on the card: this share of
# the sum of the terms' magnitudes
SUM_SLACK = 2.0 ** -16


def _f32(x):
    return torch.tensor(x, dtype=torch.float32)


def _spread(x, delta):
    """How far apart x - delta and x + delta round in bf16: 0, or one bf16
    step where a rounding midpoint lies between them."""
    return ((x + delta).bfloat16().double() - (x - delta).bfloat16().double()).abs()


def tc_dkv(q, k, v, do, lse, delta, h, causal, scale, mask=None, key_mask=None, slack=False,
           dtype=torch.float32):
    """The tensor-core body's dk and dv, rounding for rounding: q, k, v, do
    (bh, n, d) bf16; lse, delta (bh, n) f32; mask (n, n) or (h, n, n) bool
    or None; key_mask (bh // h, n) or None.  Returns (dk bf16, dv bf16), and
    with `slack` also, for each, (bh, n, d) f64: the spread of the p or ds
    near a rounding midpoint times |do| or |q| (the card's result may differ
    by it before its final rounding), and the sum of the terms' magnitudes.
    `dtype` float64 does the same arithmetic in f64 (another order of
    rounding, for testing the slack)."""
    bh, n, d = q.shape
    _, (bq, bk) = tfa.tile_shapes(d)
    qf, kf, vf, dof = (t.to(dtype) for t in (q, k, v, do))
    log2e = _f32(LOG2E).to(dtype)
    sc = _f32(scale).to(dtype) * log2e
    neg = _f32(-1e30).to(dtype) * log2e  # the same product as lse * log2e for lse -1e30
    lse2 = lse.to(dtype) * log2e
    live = None if mask is None else tfa.pattern_tables(mask, n, d, causal, grid="dense").live_cols
    heads = torch.arange(bh) % h
    dead = lse <= tfa._DEAD_LSE
    any_dead = dead.any(1)
    pos = torch.arange(n)
    dk = torch.zeros(bh, n, d, dtype=dtype)
    dv = torch.zeros(bh, n, d, dtype=dtype)
    extra = [torch.zeros(bh, n, d, dtype=torch.float64) for _ in range(4)]  # amb dk, dv; abs dk, dv
    for kb in range(math.ceil(n / bk)):
        keys = pos[kb * bk:(kb + 1) * bk]
        begin = (kb * bk) // bq if causal else 0
        for it in range(math.ceil(n / bq)):
            rows = pos[it * bq:(it + 1) * bq]
            on_list = torch.full((bh,), it >= begin)
            if live is not None:
                on_list &= live[heads % live.shape[0], kb, it].bool()
            # dkv_block's walk: the list, and with a dead row anywhere the
            # tiles off it that hold one
            visit = torch.where(any_dead, on_list | dead[:, rows].any(1), on_list)
            if not visit.any():
                continue
            w = visit[:, None, None].to(dtype)
            s = torch.einsum("bkd,bqd->bkq", kf[:, keys], qf[:, rows]) * sc
            allow = torch.ones(bh, len(keys), len(rows), dtype=torch.bool)
            if causal:
                allow &= rows[None, None, :] >= keys[None, :, None]
            if mask is not None:
                m = mask[heads] if mask.ndim == 3 else mask[None]
                allow &= m[:, rows][:, :, keys].transpose(1, 2)
            if key_mask is not None:
                allow &= (key_mask[torch.arange(bh) // h] > 0)[:, keys][:, :, None]
            s = torch.where(allow, s, neg)
            p = torch.exp2(s - lse2[:, None, rows])
            dp = torch.einsum("bkd,bqd->bkq", vf[:, keys], dof[:, rows])
            ds = p * (dp - delta.to(dtype)[:, None, rows])
            pb, dsb = p.bfloat16().to(dtype), ds.bfloat16().to(dtype)
            dv[:, keys] += torch.einsum("bkq,bqd->bkd", pb, dof[:, rows]) * w
            dk[:, keys] += torch.einsum("bkq,bqd->bkd", dsb, qf[:, rows]) * w
            if slack:
                w64, q_abs, do_abs = w.double(), qf[:, rows].double().abs(), dof[:, rows].double().abs()
                dp_abs = torch.einsum("bkd,bqd->bkq", vf[:, keys].double().abs(), do_abs)
                amb_p = _spread(p, P_SLACK * p)
                amb_ds = _spread(ds, P_SLACK * ds.abs() + DP_SLACK * p * dp_abs.to(dtype))
                extra[0][:, keys] += torch.einsum("bkq,bqd->bkd", amb_ds, q_abs) * w64
                extra[1][:, keys] += torch.einsum("bkq,bqd->bkd", amb_p, do_abs) * w64
                extra[2][:, keys] += torch.einsum("bkq,bqd->bkd", dsb.double().abs(), q_abs) * w64
                extra[3][:, keys] += torch.einsum("bkq,bqd->bkd", pb.double().abs(), do_abs) * w64
    dk = (dk * _f32(scale).to(dtype)).bfloat16()
    dv = dv.bfloat16()
    if not slack:
        return dk, dv
    return dk, dv, (extra[0] * scale, extra[2] * scale), (extra[1], extra[3])


def _bf16_step(x):
    """The spacing of bf16 values at each |x| (8 significant bits)."""
    _, e = torch.frexp(x.abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(x), e - 8)


def _beyond_limit(got, want, amb, abs_sum):
    """The elements of `got` farther from `want` than the card may lie: one
    bf16 step (the two final roundings), the emulation's spread, and
    SUM_SLACK of the terms' magnitudes.  Returns (count beyond, max diff,
    max diff in steps)."""
    got, want = got.double(), want.double()
    top = torch.maximum(got.abs(), want.abs())
    diff = (got - want).abs()
    limit = _bf16_step(top) + amb + SUM_SLACK * abs_sum
    return int((diff > limit).sum()), diff.max().item(), (diff / _bf16_step(top)).max().item()


def _inputs(seed, bh, n, d):
    """bf16-representable q, k, v, do from numpy, as bf16 torch tensors."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((bh, n, d)).astype(np.float32)).bfloat16() for _ in range(4)]


def _residuals(q, k, v, do, h, mask=None, key_mask=None):
    """lse and delta as the backward receives them, from the plain forward
    in f32 on the same bf16 values."""
    scale = q.shape[-1] ** -0.5
    out, lse = tfa.flash_attention_reference(q.float(), k.float(), v.float(), h, True, scale, mask, key_mask)
    return out, lse, tfa._delta(out, lse, do.float(), v.float())


def _err(got, ref):
    ref = torch.from_numpy(np.array(ref, np.float32))
    return (got.float() - ref).abs().max().item() / ref.abs().max().item()


@pytest.mark.parametrize("pattern", [None, "axial_row"])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_emulation_matches_pallas_backward(d, pattern):
    """b=2, h=2, n=256 (text 0 + a 16 x 16 map), causal: the emulation's dk
    and dv against jax.grad through the JAX Pallas backward in interpret mode
    (block 128, dense grid, with the pattern where there is one) and against
    the port's plain backward, both within 2e-2 of the reference's max."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from dalle_pytorch_tpu.kernels.flash_attention import flash_attention as jflash

    b, h, n = 2, 2, 256
    q, k, v, do = _inputs(d, b * h, n, d)
    mask = None if pattern is None else tmasks.build_pattern_mask(pattern, n, 16).bool()
    out, lse, delta = _residuals(q, k, v, do, h, mask)
    dk, dv = tc_dkv(q, k, v, do, lse, delta, h, True, d ** -0.5, mask)
    sh = (b, h, n, d)
    jq, jk, jv, jdo = (jnp.asarray(t.float().numpy().reshape(sh)) for t in (q, k, v, do))

    def loss(k_, v_):
        o = jflash(jq, k_, v_, mask=None if mask is None else mask.numpy(), block_q=128, block_k=128,
                   bwd_impl="pallas", grid="dense")
        return jnp.sum(o * jdo)

    ref_dk, ref_dv = (np.asarray(g).reshape(b * h, n, d) for g in jax.grad(loss, argnums=(0, 1))(jk, jv))
    assert _err(dk, ref_dk) <= TOL and _err(dv, ref_dv) <= TOL
    _, plain_dk, plain_dv = tfa.flash_attention_backward_reference(
        q.float(), k.float(), v.float(), out, lse, do.float(), h, True, d ** -0.5, mask)
    assert _err(dk, plain_dk) <= TOL and _err(dv, plain_dv) <= TOL


@pytest.mark.parametrize("dead", ["pattern", "key_mask"])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_emulation_matches_plain_backward_with_rows_that_see_no_key(d, dead):
    """The ragged n 257 (the prefill length), causal, with rows that see no
    key: a pattern that leaves rows 0..4 no key, or a key mask that masks
    batch 0's keys 0..39.  Such rows take p = 1 over all n keys (lse -1e30),
    as the plain backward and `_dense_recompute_grads` do; the emulation's
    dk and dv hold to the plain backward within 2e-2 of its max."""
    b, h, n = 2, 2, 257
    q, k, v, do = _inputs(d + 1, b * h, n, d)
    mask = key_mask = None
    if dead == "pattern":
        mask = tmasks.build_pattern_mask("axial_row", n, 16).bool()
        mask[:5] = False
    else:
        rng = np.random.default_rng(d)
        key_mask = torch.from_numpy((rng.random((b, n)) > 0.2).astype(np.int32))
        key_mask[0, :40] = 0
    out, lse, delta = _residuals(q, k, v, do, h, mask, key_mask)
    assert bool((lse <= tfa._DEAD_LSE).any())
    dk, dv = tc_dkv(q, k, v, do, lse, delta, h, True, d ** -0.5, mask, key_mask)
    _, plain_dk, plain_dv = tfa.flash_attention_backward_reference(
        q.float(), k.float(), v.float(), out, lse, do.float(), h, True, d ** -0.5, mask, key_mask)
    assert _err(dk, plain_dk) <= TOL and _err(dv, plain_dv) <= TOL


@pytest.mark.parametrize("pattern", [None, "axial_row"])
def test_emulation_slack_covers_another_rounding_order(pattern):
    """The limit the card test holds the kernel to (one bf16 step, the
    emulation's spread, SUM_SLACK of the terms) covers the same arithmetic
    done in f64, whose every p, ds and sum rounds elsewhere than in f32:
    every dk and dv element lies within it (d 64, n 320: text 64 + a 16 x 16
    map, rows that see no key through a key mask)."""
    b, h, n, d = 2, 2, 320, 64
    q, k, v, do = _inputs(5, b * h, n, d)
    mask = None if pattern is None else tmasks.build_pattern_mask(pattern, n, 16).bool()
    key_mask = torch.ones(b, n, dtype=torch.int32)
    key_mask[1, :30] = 0
    _, lse, delta = _residuals(q, k, v, do, h, mask, key_mask)
    dk, dv, (amb_dk, abs_dk), (amb_dv, abs_dv) = tc_dkv(q, k, v, do, lse, delta, h, True, d ** -0.5, mask,
                                                        key_mask, slack=True)
    dk64, dv64 = tc_dkv(q, k, v, do, lse, delta, h, True, d ** -0.5, mask, key_mask, dtype=torch.float64)
    assert not torch.equal(dk, dk64) or not torch.equal(dv, dv64)  # the two orders do differ somewhere
    assert _beyond_limit(dk64, dk, amb_dk, abs_dk)[0] == 0
    assert _beyond_limit(dv64, dv, amb_dv, abs_dv)[0] == 0


@pytest.mark.parametrize("shape", [(257, 257), (2, 257, 257)])
def test_device_mask_has_slack_past_its_end(shape):
    """The bf16 bodies copy a pattern row's bytes as whole 16-byte chunks,
    and the last chunk of the last row can reach up to 15 bytes past the
    mask (n 257: 257 * 257 bytes is not a multiple of 16).  The mask
    `_device_mask` hands the kernels, 2-D or per head, holds the pattern's
    bytes and runs on at least 16 bytes of storage past its last element;
    a mask that already does is passed on as it is, not copied again."""
    rng = np.random.default_rng(len(shape))
    mask = torch.from_numpy(rng.random(shape) > 0.5)
    q = torch.zeros(4, 257, 64)
    m, mask_heads = tfa._device_mask(q, mask, 2)
    assert mask_heads == (2 if len(shape) == 3 else 1)
    assert torch.equal(m, mask) and m.is_contiguous() and m.element_size() == 1
    assert m.untyped_storage().nbytes() - (m.storage_offset() + m.numel()) * m.element_size() >= 16
    again, _ = tfa._device_mask(q, m, 2)
    assert again.data_ptr() == m.data_ptr()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", [None, "axial_row"])
@pytest.mark.parametrize("d,n", [(32, 257), (64, 1280), (128, 705)])
def test_kernel_matches_emulation_on_card(cuda_device, d, n, pattern):
    """The bf16 dk/dv kernel on the card, dense grid, causal, against the
    emulation above on the same inputs (lse and delta handed to both), which
    ties the CPU argument about the body's precision to the kernel itself:
    every dk and dv element within one bf16 step (the two final roundings)
    plus the emulation's spread (p and ds within P_SLACK, DP_SLACK of a bf16
    rounding midpoint may round the other way there) plus SUM_SLACK of the
    terms' magnitudes (f32 sums in another order)."""
    h = 2
    q, k, v, do = _inputs(d + n, 2 * h, n, d)
    mask = None if pattern is None else tmasks.build_pattern_mask(pattern, 1280, 32)[:n, :n].contiguous().bool()
    _, lse, delta = _residuals(q, k, v, do, h, mask)
    want_dk, want_dv, (amb_dk, abs_dk), (amb_dv, abs_dv) = tc_dkv(q, k, v, do, lse, delta, h, True, d ** -0.5,
                                                                  mask, slack=True)
    cq, ck, cv, cdo = (t.to(cuda_device) for t in (q, k, v, do))
    clse, cdelta = lse.to(cuda_device), delta.to(cuda_device)
    dk, dv = torch.empty_like(ck), torch.empty_like(cv)
    if mask is None:
        tfa._call("flash_bwd_dkv", cq, (cq, ck, cv, cdo, clse, cdelta, None, None, None, dk, dv), h, True, d ** -0.5)
    else:
        m, mask_heads = tfa._device_mask(cq, mask, h)
        t = tfa.pattern_tables(m, n, d, True, grid="dense", device=cuda_device)
        tfa._call("flash_bwd_dkv", cq, (cq, ck, cv, cdo, clse, cdelta, None, m, t.live_cols, dk, dv), h, True,
                  d ** -0.5, mask_heads, t.heads, 0, t.col_tile)
    torch.cuda.synchronize()
    for name, got, want, amb, abs_sum in (("dk", dk, want_dk, amb_dk, abs_dk), ("dv", dv, want_dv, amb_dv, abs_dv)):
        beyond, diff, steps = _beyond_limit(got.cpu(), want, amb, abs_sum)
        print(f"d {d} n {n} {pattern} {name}: max diff {diff:.3g} ({steps:.3g} steps), {beyond} beyond the limit")
        assert beyond == 0


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["axial_row", "conv_like", "sparse_per_head"])
@pytest.mark.parametrize("d", [64, 128])
def test_bf16_dkv_compact_equals_dense_on_card(cuda_device, kind, d):
    """bf16 at n 1280 with the slice's patterns, and a key mask under which
    the second batch sees no key: dk and dv of the compacted grid equal the
    dense grid's with the same mask bit for bit (both run dkv_block_tc over
    the same query tiles), and both hold to the plain backward within 2e-2
    of its max."""
    b, h, n = 2, 8, 1280
    if kind == "sparse_per_head":
        mask = tmasks.build_block_sparse_mask(n, 32, heads=h)
    else:
        mask = tmasks.build_pattern_mask(kind, n, 32)
    mask = mask.to(cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(d)
    q, k, v, do = (torch.randn(b * h, n, d, generator=g, device=cuda_device).bfloat16() for _ in range(4))
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
        assert (got.float() - r.float()).abs().max().item() / r.float().abs().max().item() <= TOL
