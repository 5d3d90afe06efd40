"""The port's flash-attention backward against the JAX package's.

On the CPU the autograd function runs the plain backward.  It is held
against `jax.grad` through the JAX Pallas backward (interpret mode, as the
JAX package's own tests run it) where n is a multiple of the TPU block and
every row keeps a key, and against the JAX package's `_dense_recompute_grads`
at ragged n, with rows that see no key.  Tests marked `cuda` hold the CUDA
kernels against the plain backward on the card and skip without one."""
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu_torch.kernels import flash_attention as tfa

ATOL = 5e-5  # f32, as tests/test_flash.py holds the Pallas backward


def _arrays(rng, bh, n, d, count=4):
    return [rng.standard_normal((bh, n, d)).astype(np.float32) for _ in range(count)]


def _key_mask(rng, b, n, keep_first):
    kmask = (rng.random((b, n)) > 0.3).astype(np.int32)
    if keep_first:
        kmask[:, 0] = 1  # every row keeps a key
    return kmask


@pytest.mark.parametrize(
    "n,block,causal,padded",
    [(128, 128, True, False), (128, 128, False, True), (256, 128, True, True), (256, 256, False, False)],
)
def test_plain_backward_matches_pallas(n, block, causal, padded):
    """b=2, h=2, d=32: dq, dk, dv through the port's autograd function
    against jax.grad of the JAX flash_attention with bwd_impl='pallas'."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from dalle_pytorch_tpu.kernels.flash_attention import flash_attention

    b, h, d = 2, 2, 32
    rng = np.random.default_rng(n + block)
    q, k, v, do = (a.reshape(b, h, n, d) for a in _arrays(rng, b * h, n, d))
    kmask = _key_mask(rng, b, n, keep_first=True) if padded else None

    def loss(q_, k_, v_):
        out = flash_attention(q_, k_, v_, causal=causal, block_q=block, block_k=block, bwd_impl="pallas",
                              key_mask=None if kmask is None else jnp.asarray(kmask))
        return jnp.sum(out * jnp.asarray(do))

    ref = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal=causal,
                              key_mask=None if kmask is None else torch.from_numpy(kmask))
    (out * torch.from_numpy(do)).sum().backward()
    for port, r in zip((tq.grad, tk.grad, tv.grad), ref):
        np.testing.assert_allclose(port.numpy(), np.asarray(r), atol=ATOL, rtol=0)


@pytest.mark.parametrize("n", [257, 16])
@pytest.mark.parametrize("causal,padded", [(True, False), (True, True), (False, True)])
def test_plain_backward_matches_dense_recompute(n, causal, padded):
    """Ragged n.  Padded causal: the first keys of batch 0 are masked, so its
    first rows see no key; padded non-causal: batch 1 masks every key.  Such
    rows take p = 1 over all n keys, as `_dense_recompute_grads` does."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from dalle_pytorch_tpu.kernels.flash_attention import _dense_recompute_grads

    b, h, d = 2, 2, 32
    rng = np.random.default_rng(n)
    q, k, v, do = _arrays(rng, b * h, n, d)
    kmask = None
    if padded:
        kmask = _key_mask(rng, b, n, keep_first=False)
        if causal:
            kmask[0, : max(2, n // 8)] = 0
        else:
            kmask[1] = 0
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    tkm = None if kmask is None else torch.from_numpy(kmask)
    out, lse = tfa.flash_fwd(tq, tk, tv, h=h, causal=causal, key_mask=tkm)
    if padded:
        assert (lse <= tfa._DEAD_LSE).any()
    grads = tfa.flash_bwd(tq, tk, tv, out, lse, tdo, h=h, causal=causal, key_mask=tkm)
    ref = _dense_recompute_grads(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None,
        None if kmask is None else jnp.asarray(kmask), h, causal, d ** -0.5,
        jnp.asarray(lse.numpy())[..., None], jnp.asarray(do))
    for port, r in zip(grads, ref):
        # a row that sees no key sums n unit-weight products, so its
        # gradients reach hundreds: the 5e-5 holds relative to the largest
        r = np.asarray(r)
        np.testing.assert_allclose(port.numpy(), r, atol=ATOL * max(1.0, np.abs(r).max()), rtol=0)


def test_gradient_only_where_asked():
    """Under no_grad, or with no input needing a gradient, flash_attention is
    a plain forward call and builds no graph; with grad it matches the plain
    forward's output."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(a.reshape(1, 2, 24, 32)) for a in _arrays(rng, 2, 24, 32, count=3))
    plain = tfa.flash_attention(q, k, v)
    assert plain.grad_fn is None
    qg = q.clone().requires_grad_(True)
    with torch.no_grad():
        assert tfa.flash_attention(qg, k, v).grad_fn is None
    out = tfa.flash_attention(qg, k, v)
    assert out.grad_fn is not None
    torch.testing.assert_close(out.detach(), plain, rtol=0, atol=0)


def test_cpu_tensors_do_not_count_launches():
    rng = np.random.default_rng(4)
    q, k, v, do = (torch.from_numpy(a) for a in _arrays(rng, 4, 33, 32))
    out, lse = tfa.flash_fwd(q, k, v, h=2)
    before = (tfa.flash_bwd.dq_launches, tfa.flash_bwd.dkv_launches)
    tfa.flash_bwd(q, k, v, out, lse, do, h=2)
    assert (tfa.flash_bwd.dq_launches, tfa.flash_bwd.dkv_launches) == before


def _fake_cuda(monkeypatch, bh=4, n=64, d=64):
    """Tensors that the wrapper takes for CUDA tensors: meta tensors, with
    the device check patched (this machine has no card)."""
    monkeypatch.setattr(tfa, "_is_cuda", lambda t: True)
    q, k, v, out, do = (torch.empty((bh, n, d), device="meta") for _ in range(5))
    return q, k, v, out, torch.empty((bh, n), device="meta"), do


def test_pattern_mask_on_cuda_raises(monkeypatch):
    """The backward refuses, before any launch, a per-head mask with shared
    tables and tables built for another length."""
    args = _fake_cuda(monkeypatch)
    per_head = torch.ones(2, 64, 64, dtype=torch.bool)
    shared = tfa.pattern_tables(np.ones((64, 64), bool), 64, 64, device="meta")
    before = (tfa.flash_bwd.dq_launches, tfa.flash_bwd_compact.dq_launches)
    with pytest.raises(ValueError, match="per-head mask requires per-head"):
        tfa.flash_bwd(*args, h=2, mask=per_head, tables=shared)
    other = tfa.pattern_tables(np.ones((2, 128, 128), bool), 128, 64, device="meta")
    with pytest.raises(ValueError, match="tables for n=128"):
        tfa.flash_bwd(*args, h=2, mask=per_head, tables=other)
    assert (tfa.flash_bwd.dq_launches, tfa.flash_bwd_compact.dq_launches) == before


def test_cuda_tensor_without_kernel_raises_rather_than_falling_back(monkeypatch, tmp_path):
    """A CUDA tensor launches the kernels or raises: when they cannot be
    built, the plain backward is not taken."""
    from dalle_pytorch_tpu_torch.kernels import build

    args = _fake_cuda(monkeypatch)

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(build, "_nvcc", no_nvcc)
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    before = (tfa.flash_bwd.dq_launches, tfa.flash_bwd.dkv_launches)
    with pytest.raises(RuntimeError, match="nvcc"):
        tfa.flash_bwd(*args, h=2)
    assert (tfa.flash_bwd.dq_launches, tfa.flash_bwd.dkv_launches) == before


@pytest.mark.parametrize("bad", ["lse_dtype", "do_shape"])
def test_residuals_are_checked_on_cuda(monkeypatch, bad):
    q, k, v, out, lse, do = _fake_cuda(monkeypatch)
    if bad == "lse_dtype":
        lse = lse.to(torch.bfloat16)
    else:
        do = torch.empty((4, 64, 32), device="meta")
    with pytest.raises(ValueError, match="lse|do"):
        tfa.flash_bwd(q, k, v, out, lse, do, h=2)


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
@pytest.mark.parametrize(
    "bh,h,n,d,causal,padded",
    [(64, 16, 257, 64, True, False), (16, 16, 1280, 64, True, False),
     (8, 4, 300, 64, False, True), (4, 2, 100, 32, True, True), (4, 2, 130, 128, True, True)],
)
def test_backward_kernels_match_plain_on_card(cuda_device, dtype, tol, bh, h, n, d, causal, padded):
    """dq, dk, dv of the kernels against the plain backward on the same
    inputs: max abs error over the reference's max abs value."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v, do = (torch.randn(bh, n, d, generator=g, device=cuda_device).to(dtype) for _ in range(4))
    kmask = None
    if padded:
        kmask = (torch.rand(bh // h, n, generator=g, device=cuda_device) > 0.2).to(torch.int32)
        kmask[0, :7] = 0  # rows that see no key
        if not causal:
            kmask[-1] = 0
    out, lse = tfa.flash_fwd(q, k, v, h=h, causal=causal, key_mask=kmask)
    before = (tfa.flash_bwd.dq_launches, tfa.flash_bwd.dkv_launches)
    grads = tfa.flash_bwd(q, k, v, out, lse, do, h=h, causal=causal, key_mask=kmask)
    torch.cuda.synchronize()
    assert (tfa.flash_bwd.dq_launches, tfa.flash_bwd.dkv_launches) == (before[0] + 1, before[1] + 1)
    ref = tfa.flash_attention_backward_reference(q, k, v, out, lse, do, h, causal, d ** -0.5, None, kmask)
    for port, r in zip(grads, ref):
        assert port.dtype == dtype
        err = (port.float() - r.float()).abs().max().item() / r.float().abs().max().item()
        assert err <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_compact_rows_that_see_no_key_on_card(cuda_device, dtype, tol):
    """A pattern that kills tiles (axial_row on a 16 x 16 map, n = 300) with
    a key mask that leaves rows seeing no key: the compacted grid gives such
    rows the dense grid's second pass (forward) and visits (backward), so
    out, lse, dq, dk and dv equal the dense grid bit for bit, and both hold
    against the plain versions (forward: max abs error; backward: over the
    reference's max abs value)."""
    from dalle_pytorch_tpu_torch.ops import masks

    bh, h, n, d = 8, 2, 300, 64
    mask = masks.build_pattern_mask("axial_row", n, 16).to(cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(3)
    q, k, v, do = (torch.randn(bh, n, d, generator=g, device=cuda_device).to(dtype) for _ in range(4))
    kmask = (torch.rand(bh // h, n, generator=g, device=cuda_device) > 0.2).to(torch.int32)
    kmask[0, :40] = 0  # rows 0..39 of the first batch see no key
    res = {}
    for grid in ("dense", "compact"):
        tables = tfa.pattern_tables(mask, n, d, grid=grid, device=cuda_device)
        out, lse = tfa.flash_fwd(q, k, v, h=h, mask=mask, key_mask=kmask, grid=grid, tables=tables)
        res[grid] = (out, lse, *tfa.flash_bwd(q, k, v, out, lse, do, h=h, mask=mask, key_mask=kmask,
                                              grid=grid, tables=tables))
    torch.cuda.synchronize()
    assert tfa.pattern_tables(mask, n, d).compact
    for a, b in zip(res["dense"], res["compact"]):
        assert torch.equal(a, b)
    out, lse = res["dense"][:2]
    assert bool((lse[:h, :40] <= -1e29).all())
    ref_out, ref_lse = tfa.flash_attention_reference(q, k, v, h, True, d ** -0.5, mask, kmask)
    assert (out.float() - ref_out.float()).abs().max().item() <= tol
    assert (lse - ref_lse).abs().max().item() <= 1e-4
    ref = tfa.flash_attention_backward_reference(q, k, v, out, lse, do, h, True, d ** -0.5, mask, kmask)
    for port, r in zip(res["dense"][2:], ref):
        assert (port.float() - r.float()).abs().max().item() / r.float().abs().max().item() <= tol
