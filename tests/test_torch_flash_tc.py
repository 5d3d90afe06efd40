"""The arithmetic of the bf16 tensor-core forward (`csrc/flash_fwd_tc.cuh`),
emulated in torch on the CPU and held against the JAX package.

The card cannot be reached from here, so this checks, before any chip time,
that the body's precision decisions meet the tolerances the card holds the
kernel to: bf16 q, k and v; S = q k^T in f32 with the scale (times log2 e)
applied after the product; the online softmax once per key tile at the
kernel's own tiles (`tile_shapes`), visiting the tiles the dense grid visits;
p = 2^(s - m) in f32, l summed from the f32 p, and p rounded to bf16 only for
the PV product; rows that see no key average v over all n keys.  The
emulation is held against the JAX Pallas forward in interpret mode (n 256,
where it takes the tiles), the JAX dense `attend` at the ragged n 257, and
the port's plain version."""
import math

import numpy as np
import pytest
import torch

from dalle_pytorch_tpu_torch.kernels import flash_attention as tfa
from dalle_pytorch_tpu_torch.ops import masks as tmasks

OUT_TOL = 2e-2  # bf16 out, the card's tolerance for the kernel (chip_smoke.py)
LSE_TOL = 1e-4  # lse, the same in bf16 as in f32
NEG = -1e30
LOG2E = 1.4426950408889634


P_SLACK = 2.0 ** -14  # relative: how far the card's f32 p may lie from the emulation's


def tc_forward(q, k, v, h, causal, scale, mask=None, slack=False):
    """The tensor-core body's forward, rounding for rounding: q, k, v
    (bh, n, d) bf16, mask (n, n) bool or None.  Returns (out bf16, lse f32),
    and with `slack` also (bh, n, d) f32: how far the card's out may lie
    from this one before its final rounding because a p within P_SLACK of a
    bf16 rounding midpoint may round the other way there (the card sums the
    scores in another order), each such p's two roundings apart times |v|,
    over l."""
    bh, n, d = q.shape
    (tq, tk), _ = tfa.tile_shapes(d)
    live = tfa.pattern_tables(mask, n, d, causal, grid="dense").live_rows[0] if mask is not None else None
    qf, kf, vf = q.float(), k.float(), v.float()
    pos = torch.arange(n)
    out = torch.empty(bh, n, d, dtype=torch.bfloat16)
    lse = torch.empty(bh, n)
    for i in range(math.ceil(n / tq)):
        rows = pos[i * tq:(i + 1) * tq]
        end = math.ceil(min((i + 1) * tq, n) / tk) if causal else math.ceil(n / tk)
        m = torch.full((bh, len(rows)), NEG)
        l = torch.zeros(bh, len(rows))
        o = torch.zeros(bh, len(rows), d)
        amb = torch.zeros(bh, len(rows), d)
        for j in range(end):
            if live is not None and not live[i, j]:
                continue
            cols = pos[j * tk:(j + 1) * tk]  # keys past n do not exist: p = 0
            s = torch.einsum("brd,bcd->brc", qf[:, rows], kf[:, cols]) * np.float32(scale * LOG2E)
            allow = torch.ones(len(rows), len(cols), dtype=torch.bool)
            if causal:
                allow &= cols[None, :] <= rows[:, None]
            if mask is not None:
                allow &= mask[rows][:, cols]
            s = torch.where(allow, s, torch.tensor(NEG))
            mx = torch.maximum(m, s.amax(-1))
            alpha = torch.exp2(m - mx)
            p = torch.exp2(s - mx[..., None])
            l = l * alpha + p.sum(-1)
            o = o * alpha[..., None] + torch.einsum("brc,bcd->brd", p.bfloat16().float(), vf[:, cols])
            if slack:
                apart = (p * (1 + P_SLACK)).bfloat16().float() - (p * (1 - P_SLACK)).bfloat16().float()
                amb = amb * alpha[..., None] + torch.einsum("brc,bcd->brd", apart, vf[:, cols].abs())
            m = mx
        lc = l.clamp_min(1e-30)
        dead = m == NEG
        o = torch.where(dead[..., None], vf.sum(1, keepdim=True) / np.float32(n), o / lc[..., None])
        out[:, rows] = o.bfloat16()
        lse[:, rows] = torch.where(dead, torch.tensor(NEG), m * np.float32(math.log(2)) + torch.log(lc))
        if slack:
            amb[:, :] = torch.where(dead[..., None], 0.0, amb / lc[..., None])
            slack_out = amb if i == 0 else torch.cat([slack_out, amb], 1)
    return (out, lse, slack_out) if slack else (out, lse)


def _inputs(seed, bh, n, d):
    """bf16-representable q, k, v from numpy, as bf16 torch tensors."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((bh, n, d)).astype(np.float32)).bfloat16() for _ in range(3)]


def _pattern(kind, n):
    return None if kind is None else tmasks.build_pattern_mask(kind, n, 16).bool()


def _errors(out, lse, ref_out, ref_lse=None):
    err = (out.float() - torch.from_numpy(np.array(ref_out, np.float32))).abs().max().item()
    lse_err = None if ref_lse is None else (lse - torch.from_numpy(np.array(ref_lse, np.float32))).abs().max().item()
    return err, lse_err


@pytest.mark.parametrize("pattern", [None, "axial_row"])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_emulation_matches_pallas_kernel(d, pattern):
    """b=2, h=2, n=256 (text 0 + a 16 x 16 map), causal: the emulation
    against the JAX Pallas forward in interpret mode (block 128; with the
    pattern, the JAX dense-grid `flash_attention`) and against the port's
    plain version, out 2e-2 and lse 1e-4."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from dalle_pytorch_tpu.kernels.flash_attention import _flash_fwd
    from dalle_pytorch_tpu.kernels.flash_attention import flash_attention as jflash

    b, h, n = 2, 2, 256
    q, k, v = _inputs(d, b * h, n, d)
    mask = _pattern(pattern, n)
    out, lse = tc_forward(q, k, v, h, True, d ** -0.5, mask)
    jq, jk, jv = (jnp.asarray(t.float().numpy()) for t in (q, k, v))
    if mask is None:
        ref_out, ref_lse = _flash_fwd(jq, jk, jv, None, None, None, h, True, d ** -0.5, 128, 128)
        err, lse_err = _errors(out, lse, ref_out, np.asarray(ref_lse)[:, :, 0])
        assert lse_err <= LSE_TOL
    else:
        sh = (b, h, n, d)
        ref_out = jflash(jq.reshape(sh), jk.reshape(sh), jv.reshape(sh), mask=mask.numpy(), block_q=128,
                         block_k=128, grid="dense")
        err, _ = _errors(out, lse, np.asarray(ref_out).reshape(b * h, n, d))
    assert err <= OUT_TOL
    plain_out, plain_lse = tfa.flash_attention_reference(q.float(), k.float(), v.float(), h, True, None, mask)
    err, lse_err = _errors(out, lse, plain_out, plain_lse)
    assert err <= OUT_TOL and lse_err <= LSE_TOL


@pytest.mark.parametrize("pattern", [None, "axial_row"])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_emulation_matches_dense_attend(d, pattern):
    """The ragged n 257 (the prefill length) that the Pallas kernel does not
    take, causal: the emulation against the JAX dense `attend` (out 2e-2)
    and the port's plain version (out 2e-2, lse 1e-4)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from dalle_pytorch_tpu.ops.attention import attend

    b, h, n = 2, 2, 257
    q, k, v = _inputs(d + 1, b * h, n, d)
    mask = _pattern(pattern, n)
    out, lse = tc_forward(q, k, v, h, True, d ** -0.5, mask)
    full = np.tril(np.ones((n, n), bool))
    if mask is not None:
        full &= mask.numpy()
    sh = (b, h, n, d)
    jq, jk, jv = (jnp.asarray(t.float().numpy().reshape(sh)) for t in (q, k, v))
    ref = attend(jq * d ** -0.5, jk, jv, mask=jnp.asarray(full[None, None]))
    err, _ = _errors(out, lse, np.asarray(ref).reshape(b * h, n, d))
    assert err <= OUT_TOL
    plain_out, plain_lse = tfa.flash_attention_reference(q.float(), k.float(), v.float(), h, True, None, mask)
    err, lse_err = _errors(out, lse, plain_out, plain_lse)
    assert err <= OUT_TOL and lse_err <= LSE_TOL


def test_emulation_rows_that_see_no_key():
    """A pattern that leaves rows no key: the emulation gives them the port's
    rule (v averaged over all n keys, lse -1e30), as the plain version does."""
    n, d = 130, 64
    q, k, v = _inputs(7, 2, n, d)
    mask = torch.ones(n, n, dtype=torch.bool)
    mask[:5] = False
    out, lse = tc_forward(q, k, v, 1, True, d ** -0.5, mask)
    plain_out, plain_lse = tfa.flash_attention_reference(q.float(), k.float(), v.float(), 1, True, None, mask)
    err, lse_err = _errors(out, lse, plain_out, plain_lse)
    assert err <= OUT_TOL and lse_err <= LSE_TOL
    assert torch.all(lse[:, :5] == NEG)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _bf16_step(x):
    """The spacing of bf16 values at each |x| (8 significant bits)."""
    _, e = torch.frexp(x.abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(x), e - 8)


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", [None, "axial_row"])
@pytest.mark.parametrize("d,n", [(32, 257), (64, 1280), (128, 705)])
def test_kernel_matches_emulation_on_card(cuda_device, d, n, pattern):
    """The bf16 kernel on the card, dense grid, causal, against the emulation
    above on the same inputs, which ties the CPU argument about the body's
    precision to the kernel itself: every out element within one bf16 step
    (the two final roundings) plus the emulation's slack (p that may round
    the other way) plus 1e-6 relative (f32 sums in another order), and lse
    within 1e-5."""
    h = 2
    q, k, v = _inputs(d + n, 2 * h, n, d)
    mask = None if pattern is None else tmasks.build_pattern_mask(pattern, 1280, 32)[:n, :n].contiguous()
    want, want_lse, slack = tc_forward(q, k, v, h, True, d ** -0.5, mask, slack=True)
    dmask = tables = None
    if mask is not None:
        dmask = mask.to(cuda_device)
        tables = tfa.pattern_tables(dmask, n, d, True, grid="dense", device=cuda_device)
    out, lse = tfa.flash_fwd(*(t.to(cuda_device) for t in (q, k, v)), h=h, causal=True, mask=dmask,
                             grid="dense", tables=tables)
    out, want, lse = out.cpu().float(), want.float(), lse.cpu()
    top = torch.maximum(out.abs(), want.abs())
    diff = (out - want).abs()
    limit = _bf16_step(top) + slack + 1e-6 * top
    lse_err = (lse - want_lse).abs().max().item()
    print(f"d {d} n {n} {pattern}: out {diff.max().item():.3g} ({(diff / _bf16_step(top)).max().item():.3g} "
          f"steps; {(diff > _bf16_step(top)).sum().item()} elements beyond one step, "
          f"{(diff > limit).sum().item()} beyond the limit; slack max {slack.max().item():.3g}), lse {lse_err:.3g}")
    assert torch.all(diff <= limit)
    assert lse_err <= 1e-5
