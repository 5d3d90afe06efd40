"""The arithmetic of the f32 tensor-core forward (`csrc/flash_fwd_tf32.cuh`,
3xTF32 on `wgmma`), emulated in torch on the CPU and held against the JAX
package.

The card cannot be reached from here, so this checks, before any chip time,
that the body's precision decisions meet the f32 tolerances the card holds
the kernel to (out 1e-4 abs, lse 1e-4).  The emulation follows the body
rounding for rounding: every operand split x = hi + lo, hi = x rounded to
TF32 (`cvt.rna`: to nearest, ties away from zero, done here by integer ops
on the f32 bits) and lo = x - hi rounded to TF32 again; each product as
(a_lo b_hi + a_hi b_lo) + a_hi b_hi, for S = q k^T and for P V; the scale
(times log2 e) applied to S after the product; the online softmax once per
key tile at the kernel's own tiles (`tile_shapes`), visiting the tiles the
dense grid visits; p = 2^(s - m) in f32, l summed from the f32 p, p split
only as the PV operand; rows that see no key average v over all n keys.  It
is held against the JAX Pallas forward in interpret mode (n 256, where it
takes the tiles), the JAX dense `attend` at the ragged n 257, and the port's
plain version; one TF32 pass, for contrast, misses the tolerance.  The test
marked `cuda` holds the card's kernel to the emulation and skips without a
card."""
import math

import numpy as np
import pytest
import torch
from test_torch_flash_tc import _pattern, cuda_device  # noqa: F401 (cuda_device: a fixture)

from dalle_pytorch_tpu_torch.kernels import flash_attention as tfa

OUT_TOL = 1e-4  # f32 out, the card's tolerance for the kernel (chip_smoke.py)
LSE_TOL = 1e-4
NEG = -1e30
LOG2E = 1.4426950408889634
PATTERNS = ("axial_row", "axial_col", "conv_like")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The emulations run many small products, which gain nothing from
    torch's threads (a case runs faster on one); where the suite runs in
    several processes on a few cores, those threads only compete for them
    (a case that takes 1 s alone took 70 s so).  One thread for this
    module's tests, the count restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def to_tf32(x):
    """`cvt.rna.tf32.f32` on an f32 tensor: to nearest, ties away from zero,
    the low 13 bits of the f32 bits cleared.  Adding half a TF32 step to the
    bits rounds the magnitude (the sign bit is apart), carrying into the
    exponent where it must."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x):
    """x = hi + lo as the kernel splits it: hi = x in TF32, lo = the
    remainder (exact in f32) in TF32."""
    hi = to_tf32(x)
    return hi, to_tf32(x - hi)


def product(eq, a, b, passes=3):
    """The einsum of a and b as the kernel's wgmma runs it: 3xTF32, the two
    cross terms first, then hi hi; `passes` 1 is one TF32 product."""
    ah, al = split(a)
    bh, bl = split(b)
    if passes == 1:
        return torch.einsum(eq, ah, bh)
    return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)) + torch.einsum(eq, ah, bh)


def tf32_forward(q, k, v, h, causal, scale, mask=None, key_mask=None, passes=3):
    """The f32 tensor-core body's forward, rounding for rounding: q, k, v
    (bh, n, d) f32, mask (n, n) bool or None, key_mask (bh // h, n) nonzero
    = attend or None.  Returns (out f32, lse f32).  Every query tile (the
    kernel's blocks, rows past n zero) walks the key tiles at once, in the
    kernel's order; a tile a block does not visit leaves its m, l and o as
    they were."""
    bh, n, d = q.shape
    tq, tk = tfa.tile_shapes(d)[0]
    nq, nk = math.ceil(n / tq), math.ceil(n / tk)
    live = tfa.pattern_tables(mask, n, d, causal, grid="dense").live_rows[0] if mask is not None else None
    rows = torch.arange(nq * tq).view(nq, tq)
    allow = torch.ones(bh, nq * tq, n, dtype=torch.bool)
    if causal:
        allow &= torch.ones(nq * tq, n, dtype=torch.bool).tril()
    if mask is not None:
        allow[:, :n] &= mask
    if key_mask is not None:
        allow &= (key_mask[torch.arange(bh) // h] > 0)[:, None, :]
    allow = allow.view(bh, nq, tq, n)
    qp = torch.zeros(bh, nq * tq, d)
    qp[:, :n] = q
    qp = qp.view(bh, nq, tq, d)
    pos = torch.arange(n)
    sc = np.float32(scale * LOG2E)
    m = torch.full((bh, nq, tq), NEG)
    l = torch.zeros(bh, nq, tq)
    o = torch.zeros(bh, nq, tq, d)
    for j in range(nk):
        # the query tiles that visit key tile j: up to the causal diagonal,
        # where the pattern leaves the tile live
        visit = torch.ones(nq, dtype=torch.bool)
        if causal:
            visit &= j < torch.ceil(torch.clamp((rows[:, 0] + tq), max=n) / tk)
        if live is not None:
            visit &= live[:, j].bool()
        if not visit.any():
            continue
        cols = pos[j * tk:(j + 1) * tk]  # keys past n do not exist: p = 0
        s = product("bird,bcd->birc", qp, k[:, cols], passes) * sc
        s = torch.where(allow[..., cols], s, torch.tensor(NEG))
        mx = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2(m - mx)
        p = torch.exp2(s - mx[..., None])
        w = visit[None, :, None]
        l = torch.where(w, l * alpha + p.sum(-1), l)
        o = torch.where(w[..., None], o * alpha[..., None] + product("birc,bcd->bird", p, v[:, cols], passes), o)
        m = torch.where(w, mx, m)
    m, l, o = m.reshape(bh, -1)[:, :n], l.reshape(bh, -1)[:, :n], o.reshape(bh, -1, d)[:, :n]
    lc = l.clamp_min(1e-30)
    dead = m == NEG
    out = torch.where(dead[..., None], v.sum(1, keepdim=True) / np.float32(n), o / lc[..., None])
    lse = torch.where(dead, torch.tensor(NEG), m * np.float32(math.log(2)) + torch.log(lc))
    return out, lse


def _inputs(seed, bh, n, d):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((bh, n, d)).astype(np.float32)) for _ in range(3)]


def _err(got, ref):
    return (got - torch.from_numpy(np.array(ref, np.float32))).abs().max().item()


def _hold_to_plain(out, lse, q, k, v, h, causal, mask=None, key_mask=None):
    plain_out, plain_lse = tfa.flash_attention_reference(q, k, v, h, causal, None, mask, key_mask)
    assert _err(out, plain_out) <= OUT_TOL and _err(lse, plain_lse) <= LSE_TOL


def test_to_tf32_rounds_to_nearest_ties_away_and_splits_exactly():
    """The emulated `cvt.rna`: ties round away from zero in both signs, a
    carry reaches the exponent; on random values hi has 13 zero low bits,
    lies within half a TF32 step (2^-11 relative) of x, and hi + lo is x to
    2^-22 relative."""
    one = 1.0
    cases = {one + 2 ** -11: one + 2 ** -10, -(one + 2 ** -11): -(one + 2 ** -10),
             one + 2 ** -11 - 2 ** -23: one, one + 2 ** -11 + 2 ** -23: one + 2 ** -10,
             2.0 - 2 ** -23: 2.0, 3 * 2.0 ** -130: 3 * 2.0 ** -130}
    got = to_tf32(torch.tensor(list(cases), dtype=torch.float32))
    assert got.tolist() == [np.float32(x) for x in cases.values()]
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal(10000) * 10.0 ** rng.uniform(-5, 5, 10000)).astype(np.float32))
    hi, lo = split(x)
    assert torch.all(hi.view(torch.int32) & 0x1FFF == 0) and torch.all(lo.view(torch.int32) & 0x1FFF == 0)
    x64 = x.double()
    assert torch.all((x64 - hi.double()).abs() <= 2.0 ** -11 * x64.abs())
    assert torch.all((x64 - hi.double() - lo.double()).abs() <= 2.0 ** -22 * x64.abs())


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_emulation_matches_pallas_kernel(d, causal):
    """b=2, h=2, n=256: the emulation against the JAX Pallas forward in
    interpret mode (block 128) and against the port's plain version, out
    1e-4 and lse 1e-4."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from dalle_pytorch_tpu.kernels.flash_attention import _flash_fwd

    b, h, n = 2, 2, 256
    q, k, v = _inputs(d + causal, b * h, n, d)
    out, lse = tf32_forward(q, k, v, h, causal, d ** -0.5)
    ref_out, ref_lse = _flash_fwd(*(jnp.asarray(t.numpy()) for t in (q, k, v)), None, None, None, h, causal,
                                  d ** -0.5, 128, 128)
    assert _err(out, ref_out) <= OUT_TOL
    assert _err(lse, np.asarray(ref_lse)[:, :, 0]) <= LSE_TOL
    _hold_to_plain(out, lse, q, k, v, h, causal)


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("d", [32, 64, 128])
def test_emulation_matches_pallas_kernel_with_pattern(d, pattern):
    """b=2, h=2, n=256 (text 0 + a 16 x 16 map), causal, with a pattern:
    the emulation, which skips the tiles the pattern leaves empty at the
    kernel's tile, against the JAX dense-grid `flash_attention` in interpret
    mode (out 1e-4) and the port's plain version (out and lse 1e-4)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from dalle_pytorch_tpu.kernels.flash_attention import flash_attention as jflash

    b, h, n = 2, 2, 256
    q, k, v = _inputs(d + len(pattern), b * h, n, d)
    mask = _pattern(pattern, n)
    out, lse = tf32_forward(q, k, v, h, True, d ** -0.5, mask)
    sh = (b, h, n, d)
    ref = jflash(*(jnp.asarray(t.numpy().reshape(sh)) for t in (q, k, v)), mask=mask.numpy(), block_q=128,
                 block_k=128, grid="dense")
    assert _err(out, np.asarray(ref).reshape(b * h, n, d)) <= OUT_TOL
    _hold_to_plain(out, lse, q, k, v, h, True, mask)


@pytest.mark.parametrize("d", [32, 64, 128])
def test_emulation_matches_pallas_kernel_with_key_padding(d):
    """n=256, causal, with key padding (every row keeps key 0): the emulation
    against the JAX Pallas forward given the same key mask in interpret mode
    and the port's plain version, out and lse 1e-4."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from dalle_pytorch_tpu.kernels.flash_attention import _flash_fwd

    b, h, n = 2, 2, 256
    q, k, v = _inputs(d + 7, b * h, n, d)
    rng = np.random.default_rng(d)
    key_mask = torch.from_numpy((rng.random((b, n)) > 0.3).astype(np.int32))
    key_mask[:, 0] = 1
    out, lse = tf32_forward(q, k, v, h, True, d ** -0.5, key_mask=key_mask)
    ref_out, ref_lse = _flash_fwd(*(jnp.asarray(t.numpy()) for t in (q, k, v)), None, None,
                                  jnp.asarray(key_mask.numpy()), h, True, d ** -0.5, 128, 128)
    assert _err(out, ref_out) <= OUT_TOL
    assert _err(lse, np.asarray(ref_lse)[:, :, 0]) <= LSE_TOL
    _hold_to_plain(out, lse, q, k, v, h, True, key_mask=key_mask)


@pytest.mark.parametrize("pattern,causal", [(None, True), (None, False)] + [(p, True) for p in PATTERNS])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_emulation_matches_dense_attend(d, pattern, causal):
    """The ragged n 257 (the prefill length) that the Pallas kernel does not
    take: the emulation against the JAX dense `attend` (out 1e-4) and the
    port's plain version (out and lse 1e-4)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from dalle_pytorch_tpu.ops.attention import attend

    b, h, n = 2, 2, 257
    q, k, v = _inputs(d + 1, b * h, n, d)
    mask = _pattern(pattern, n)
    out, lse = tf32_forward(q, k, v, h, causal, d ** -0.5, mask)
    full = np.tril(np.ones((n, n), bool)) if causal else np.ones((n, n), bool)
    if mask is not None:
        full &= mask.numpy()
    sh = (b, h, n, d)
    jq, jk, jv = (jnp.asarray(t.numpy().reshape(sh)) for t in (q, k, v))
    ref = attend(jq * d ** -0.5, jk, jv, mask=jnp.asarray(full[None, None]))
    assert _err(out, np.asarray(ref).reshape(b * h, n, d)) <= OUT_TOL
    _hold_to_plain(out, lse, q, k, v, h, causal, mask)


@pytest.mark.parametrize("d", [32, 64, 128])
def test_emulation_rows_that_see_no_key(d):
    """A pattern that leaves the first 5 rows no key and key padding that
    leaves a whole batch none, over two key tiles (n 130): the emulation
    gives them the port's rule (v averaged over all n keys, lse -1e30), as
    the plain version does, and the other rows within 1e-4."""
    b, h, n = 2, 2, 130
    q, k, v = _inputs(d + 3, b * h, n, d)
    mask = torch.ones(n, n, dtype=torch.bool)
    mask[:5] = False
    key_mask = torch.ones(b, n, dtype=torch.int32)
    key_mask[1] = 0
    out, lse = tf32_forward(q, k, v, h, True, d ** -0.5, mask, key_mask)
    _hold_to_plain(out, lse, q, k, v, h, True, mask, key_mask)
    assert torch.all(lse[:, :5] == NEG) and torch.all(lse[h:] == NEG)
    assert torch.all(lse[:h, 5:] > NEG / 2)


@pytest.mark.parametrize("d", [64, 128])
def test_one_tf32_pass_misses_the_tolerance(d):
    """Why three passes: at the flagship's shape of a (batch, head) row
    (n 1280, d 128 or 64, causal) one TF32 product (hi hi alone, 11
    significant bits) puts out or lse further than 1e-4 from an f64 run,
    while 3xTF32 stays within 1e-5 of it."""
    n = 1280
    q, k, v = _inputs(d + 11, 2, n, d)
    s = torch.einsum("bid,bjd->bij", q.double(), k.double()) * d ** -0.5
    s = s.masked_fill(~torch.ones(n, n, dtype=torch.bool).tril(), -math.inf)
    ref_out, ref_lse = torch.einsum("bij,bjd->bid", torch.softmax(s, -1), v.double()), torch.logsumexp(s, -1)
    errs = {}
    for passes in (1, 3):
        out, lse = tf32_forward(q, k, v, 1, True, d ** -0.5, passes=passes)
        errs[passes] = max((out.double() - ref_out).abs().max().item(), (lse.double() - ref_lse).abs().max().item())
    assert errs[3] <= 1e-5 < 1e-4 < errs[1], errs


# how far the card's kernel may lie from the emulation: the card sums each
# product's terms in its own order of f32 additions (in k-steps of 8 per
# pass, where the emulation's einsum takes its own) and computes 2^x with
# ex2.approx (2 ulp); a few 2^-24 of each score's and each output's terms.
# One TF32 pass would lie 1e-4 to 1e-3 away (test_one_tf32_pass_misses_the_tolerance).
CARD_OUT_SLACK = 1e-5  # absolute, plus the same relative to |out|
CARD_LSE_SLACK = 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", [None, "axial_row"])
@pytest.mark.parametrize("d,n", [(32, 257), (64, 1280), (128, 705)])
def test_kernel_matches_emulation_on_card(cuda_device, d, n, pattern):
    """The f32 kernel on the card, dense and compacted grid, causal, against
    the emulation above on the same inputs, which ties the CPU argument
    about the body's precision to the kernel itself: out within
    CARD_OUT_SLACK (absolute and relative), lse within CARD_LSE_SLACK, and
    the two grids equal bit for bit."""
    h = 2
    q, k, v = _inputs(d + n, 2 * h, n, d)
    mask = None if pattern is None else _pattern_at(pattern, n)
    want, want_lse = tf32_forward(q, k, v, h, True, d ** -0.5, mask)
    dq, dk, dv = (t.to(cuda_device) for t in (q, k, v))
    dmask = None if mask is None else mask.to(cuda_device)
    results = []
    for grid in ("dense", "compact"):
        tables = tfa.pattern_tables(dmask, n, d, True, grid=grid, device=cuda_device)
        results.append(tfa.flash_fwd(dq, dk, dv, h=h, causal=True, mask=dmask, grid=grid, tables=tables))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*results))
    out, lse = (t.cpu() for t in results[0])
    diff = (out - want).abs()
    lse_err = (lse - want_lse).abs().max().item()
    print(f"d {d} n {n} {pattern}: out {diff.max().item():.3g} (relative {(diff / want.abs()).max().item():.3g}), "
          f"lse {lse_err:.3g}")
    assert torch.all(diff <= CARD_OUT_SLACK * (1 + want.abs()))
    assert lse_err <= CARD_LSE_SLACK


def _pattern_at(kind, n):
    """The pattern of the 32 x 32 map (seq 1280) cut to n, as the model's
    prefill takes it."""
    from dalle_pytorch_tpu_torch.ops import masks as tmasks

    return tmasks.build_pattern_mask(kind, 1280, 32)[:n, :n].contiguous().bool()
