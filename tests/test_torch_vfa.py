"""The VFA forward (the compacted grid's two-pass forward: a max pass, then
accumulation against the fixed row maxima) in the port against the JAX
package's.

On the CPU the plain versions `vfa_max_reference` and `vfa_fwd_reference`
are held against the JAX compacted grid with `vfa=True` in interpret mode
(its max pass's gmax, its output and lse), at n 384 with 128 blocks, and the
gradient through `FlashAttention(vfa=True)` against `jax.grad`.  Rows that
see no key follow the port's rule.  The wrappers' dispatch runs on tensors
that pass for CUDA tensors.  Tests marked `cuda` hold the two kernels
against their plain versions and against the online compacted kernel on the
card, and skip without one."""
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu_torch.kernels import flash_attention as tfa
from dalle_pytorch_tpu_torch.ops import masks as tmasks

N, FMAP, BLOCK, D = 384, 16, 128, 32
OUT_ATOL, OUT_RTOL, LSE_ATOL = 2e-5, 1e-4, 1e-5  # f32: the two sides sum in other orders
KINDS = ["axial_row", "conv_like", "sparse_per_head", "axial_row_key_mask"]


def _mask(kind, n=N, fmap=FMAP, heads=2):
    """(n, n), or (heads, n, n) for per-head 'sparse', bool numpy pattern."""
    if kind == "sparse_per_head":
        return tmasks.build_block_sparse_mask(n, fmap, heads=heads).numpy()
    return tmasks.build_pattern_mask(kind.replace("_key_mask", ""), n, fmap).numpy()


def _inputs(kind, b=1, h=2, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((b, h, N, D)).astype(np.float32) for _ in range(4))
    kmask = None
    if kind.endswith("_key_mask"):
        kmask = (rng.random((b, N)) > 0.25).astype(np.int32)
        kmask[:, 0] = 1  # every row keeps key 0, so no row goes dead
    return q, k, v, g, kmask


class _Recorder:
    """Stands in for `pallas` in the JAX kernel module: each `pallas_call`
    is the real one, whose outputs are kept by kernel name."""

    def __init__(self, real):
        self.real, self.outputs = real, {}

    def __getattr__(self, name):
        return getattr(self.real, name)

    def pallas_call(self, kernel, *args, **kwargs):
        call = self.real.pallas_call(kernel, *args, **kwargs)
        name = getattr(kernel, "func", kernel).__name__

        def run(*operands):
            out = call(*operands)
            self.outputs[name] = out
            return out

        return run


@pytest.fixture
def jfa(monkeypatch):
    pytest.importorskip("jax")
    from dalle_pytorch_tpu.kernels import flash_attention as jfa

    monkeypatch.setattr(jfa, "pl", _Recorder(jfa.pl))
    return jfa


@pytest.mark.parametrize("kind", KINDS)
def test_plain_vfa_matches_the_pallas_vfa(jfa, kind):
    """gmax, out and lse of the plain pair against the JAX max pass and
    fixed-max pass (`flash_attention(..., grid="compact", vfa=True)`,
    interpret mode)."""
    import jax.numpy as jnp

    b, h = 1, 2
    mask = _mask(kind)
    q, k, v, _, kmask = _inputs(kind)
    ref_out = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask=jnp.asarray(mask),
                                  block_q=BLOCK, block_k=BLOCK, grid="compact", vfa=True,
                                  key_mask=None if kmask is None else jnp.asarray(kmask))
    rec = jfa.pl.outputs
    assert {"_max_kernel_compact", "_fwd_kernel_compact_vfa"} <= set(rec)
    ref_gmax = np.asarray(rec["_max_kernel_compact"])[..., 0]
    ref_lse = np.asarray(rec["_fwd_kernel_compact_vfa"][1])[..., 0]

    tq, tk, tv = (torch.from_numpy(a.reshape(b * h, N, D)) for a in (q, k, v))
    tmask, tkmask = torch.from_numpy(mask), None if kmask is None else torch.from_numpy(kmask)
    gmax = tfa.vfa_max_reference(tq, tk, h, True, None, tmask, tkmask)
    out, lse = tfa.vfa_fwd_reference(tq, tk, tv, gmax, h, True, None, tmask, tkmask)
    np.testing.assert_allclose(gmax.numpy(), ref_gmax, atol=LSE_ATOL, rtol=0)
    np.testing.assert_allclose(out.numpy().reshape(q.shape), np.asarray(ref_out), atol=OUT_ATOL, rtol=OUT_RTOL)
    np.testing.assert_allclose(lse.numpy(), ref_lse, atol=LSE_ATOL, rtol=0)

    # what a CPU tensor runs through the wrapper on the compacted grid: the same plain pair
    got, got_lse = tfa.flash_fwd(tq, tk, tv, h=h, mask=tmask, key_mask=tkmask, grid="compact", vfa=True)
    torch.testing.assert_close(got, out, rtol=0, atol=0)
    torch.testing.assert_close(got_lse, lse, rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["axial_row", "sparse_per_head"])
def test_vfa_gradient_matches_jax(jfa, kind):
    """Output and gradients of `flash_attention(..., vfa=True)` (the plain
    VFA pair, then the plain backward from its lse) against jax.grad through
    the JAX compacted VFA forward and its Pallas backward, atol 1e-4."""
    import jax
    import jax.numpy as jnp

    mask = _mask(kind)
    q, k, v, g, _ = _inputs(kind, seed=1)

    def loss(q_, k_, v_):
        out = jfa.flash_attention(q_, k_, v_, mask=jnp.asarray(mask), block_q=BLOCK, block_k=BLOCK,
                                  grid="compact", vfa=True)
        return jnp.sum(out * jnp.asarray(g)), out

    (_, ref_out), ref = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, mask=torch.from_numpy(mask), vfa=True)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out), atol=1e-4, rtol=0)
    for port, r in zip((tq.grad, tk.grad, tv.grad), ref):
        np.testing.assert_allclose(port.numpy(), np.asarray(r), atol=1e-4, rtol=0)


def test_rows_that_see_no_key_follow_the_port_rule():
    """A key mask that kills every key of one batch, at the ragged primed
    prefill length n = 705: those rows' gmax is -1e30, and the fixed-max
    pass gives them the online forward's answer (v averaged over all n keys,
    lse -1e30); the other rows agree with the online forward too."""
    n, h, d = 705, 2, 32
    mask = torch.from_numpy(_mask("axial_row", 1280, 32)[:n, :n].copy())
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal((2 * h, n, d)).astype(np.float32)) for _ in range(3))
    kmask = torch.from_numpy((rng.random((2, n)) > 0.25).astype(np.int32))
    kmask[0, 0] = 1
    kmask[1] = 0
    gmax = tfa.vfa_max_reference(q, k, h, True, None, mask, kmask)
    assert torch.all(gmax[h:] == -1e30) and torch.all(gmax[:h] > -1e30)
    out, lse = tfa.vfa_fwd_reference(q, k, v, gmax, h, True, None, mask, kmask)
    ref_out, ref_lse = tfa.flash_attention_reference(q, k, v, h, True, None, mask, kmask)
    torch.testing.assert_close(out, ref_out, atol=2e-5, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-5, rtol=0)
    torch.testing.assert_close(out[h:], v[h:].mean(dim=1, keepdim=True).expand(h, n, d), atol=1e-5, rtol=0)
    assert torch.all(lse[h:] == -1e30)


# ---------------------------------------------------------------------------
# the CUDA wrappers' dispatch, on tensors that pass for CUDA tensors
# ---------------------------------------------------------------------------


@pytest.fixture
def fake_cuda(monkeypatch):
    """Meta tensors taken for CUDA tensors; `_call` records each launch
    (entry, pointer arguments, tile) instead of making it."""
    calls = []
    monkeypatch.setattr(tfa, "_is_cuda", lambda t: True)
    monkeypatch.setattr(tfa, "_call", lambda name, q, tensors, h, causal, scale, mask_heads=1, tab_heads=1,
                        tab_len=0, tile=(0, 0): calls.append((name, tensors, tile)))
    return calls


def _counters():
    return (tfa.flash_fwd.launches, tfa.flash_fwd_compact.launches, tfa.flash_fwd_compact.max_launches,
            tfa.flash_fwd_compact.vfa_launches)


@pytest.mark.parametrize("d", [64, 128])
def test_vfa_dispatch_on_a_compacting_pattern(fake_cuda, d):
    """axial_row at n 1280 compacts: with vfa the forward launches the max
    pass, then the fixed-max pass on the max pass's gmax, each counted on
    its own and neither as an online compacted forward; the backward is
    the compacted pair, as without vfa."""
    calls = fake_cuda
    n, h = 1280, 16
    q, k, v, do = (torch.empty((32, n, d), device="meta") for _ in range(4))
    mask = torch.from_numpy(_mask("axial_row", n, 32))
    before = _counters()
    out = tfa.FlashAttention.apply(q.requires_grad_(True), k, v, h, True, None, mask, None, "auto", None, True, None)
    assert [c[0] for c in calls] == ["flash_max_compact", "flash_fwd_compact_vfa"]
    assert np.subtract(_counters(), before).tolist() == [0, 0, 1, 1]
    (_, max_ptrs, max_tile), (_, vfa_ptrs, vfa_tile) = calls
    gmax = max_ptrs[6]
    assert gmax.shape == (32, n) and gmax.dtype == torch.float32 and vfa_ptrs[7] is gmax
    assert max_tile == vfa_tile == tfa.tile_shapes(d)[0]
    assert vfa_ptrs[8].shape == (32, n, d) and vfa_ptrs[9].shape == (32, n)
    calls.clear()
    out.backward(do)
    assert [c[0] for c in calls] == ["flash_dq_compact", "flash_dkv_compact"]


@pytest.mark.parametrize("kind,grid", [("full", "auto"), ("axial_col", "auto"), ("axial_row", "dense")])
def test_dense_grid_ignores_vfa(fake_cuda, kind, grid):
    """A call on the dense grid (no pattern, a pattern that kills no tile,
    or grid="dense") launches the dense forward whatever `vfa` says."""
    calls = fake_cuda
    q, k, v = (torch.empty((32, 1280, 64), device="meta") for _ in range(3))
    mask = None if kind == "full" else torch.from_numpy(_mask(kind, 1280, 32))
    before = _counters()
    tfa.flash_fwd(q, k, v, h=16, mask=mask, grid=grid, vfa=True)
    assert [c[0] for c in calls] == ["flash_fwd"]
    assert np.subtract(_counters(), before).tolist() == [1, 0, 0, 0]


def test_cpu_vfa_counts_no_launch():
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((4, 130, 32)).astype(np.float32)) for _ in range(3))
    mask = torch.from_numpy(_mask("axial_row", 130, 8))
    before = _counters()
    out, _ = tfa.flash_fwd(q, k, v, h=2, mask=mask, grid="compact", vfa=True)
    ref, _ = tfa.flash_attention_reference(q, k, v, 2, True, None, mask)
    torch.testing.assert_close(out, ref, atol=2e-6, rtol=0)
    assert _counters() == before


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("kind,n,d,dead", [("axial_row", 1280, 64, False), ("conv_like", 705, 128, False),
                                           ("sparse_per_head", 1280, 128, False), ("axial_row", 705, 64, True)])
def test_vfa_kernels_match_plain_and_online_on_card(cuda_device, dtype, tol, kind, n, d, dead):
    """The max pass against `vfa_max_reference` (1e-4 relative), the
    fixed-max pass against `vfa_fwd_reference` and against the online
    compacted kernel (out at the dtype's tolerance, lse 1e-4); with `dead`,
    a key mask kills every key of the second batch (rows that see no key)
    at a ragged n."""
    h = 2
    if kind == "sparse_per_head":
        mask = tmasks.build_block_sparse_mask(1280, 32, heads=h)[:, :n, :n]
    else:
        mask = tmasks.build_pattern_mask(kind, 1280, 32)[:n, :n]
    mask = mask.contiguous().to(cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn(2 * h, n, d, generator=g, device=cuda_device).to(dtype) for _ in range(3))
    kmask = None
    if dead:
        kmask = (torch.rand(2, n, generator=g, device=cuda_device) > 0.25).to(torch.int32)
        kmask[0, 0] = 1
        kmask[1] = 0
    tables = tfa.pattern_tables(mask, n, d, device=cuda_device)
    assert tables.compact
    before = _counters()
    out, lse = tfa.flash_fwd_compact(q, k, v, tables, h=h, mask=mask, key_mask=kmask, vfa=True)
    online, online_lse = tfa.flash_fwd_compact(q, k, v, tables, h=h, mask=mask, key_mask=kmask)
    torch.cuda.synchronize()
    assert np.subtract(_counters(), before).tolist() == [0, 1, 1, 1]
    gmax = torch.empty_like(lse)
    m, mask_heads = tfa._device_mask(q, mask, h)
    tfa._call("flash_max_compact", q, (q, k, kmask, m, tables.row_ptr, tables.col, gmax), h, True,
              d ** -0.5, mask_heads, tables.heads, tables.col.shape[1], tables.row_tile)
    torch.cuda.synchronize()
    ref_gmax = tfa.vfa_max_reference(q, k, h, True, None, mask, kmask)
    assert ((gmax - ref_gmax).abs() / ref_gmax.abs().clamp_min(1.0)).max().item() <= 1e-4
    ref_out, ref_lse = tfa.vfa_fwd_reference(q, k, v, gmax, h, True, None, mask, kmask)
    for want, want_lse in ((ref_out, ref_lse), (online, online_lse)):
        assert (out.float() - want.float()).abs().max().item() <= tol
        assert (lse - want_lse).abs().max().item() <= 1e-4
    if dead:
        assert torch.all(gmax[h:] == -1e30) and torch.equal(out[h:], online[h:])
        # the rule itself, computed apart from the kernels: each channel of v
        # summed over the n keys in ascending order in f32, divided by n
        acc = torch.zeros(h, d)
        for vj in v[h:].float().cpu().unbind(1):
            acc = acc + vj
        want = (acc / torch.full_like(acc, n)).to(dtype)
        assert torch.equal(out[h:].cpu(), want[:, None].expand(h, n, d)) and torch.all(lse[h:] == -1e30)
