"""The port's flash-attention forward against the JAX package's.

On the CPU the wrapper runs its plain version; it is held against the JAX
Pallas kernel (interpret mode, as the JAX package's own tests run it) where
n is a multiple of the TPU block, and against the JAX dense `attend`
elsewhere.  Tests marked `cuda` hold the CUDA kernel against the plain
version on the card and skip without one."""
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu_torch.kernels import flash_attention as tfa

ATOL = 2e-5  # f32; the plain version and the kernels sum in other orders


def _qkv(rng, bh, n, d):
    return [rng.standard_normal((bh, n, d)).astype(np.float32) for _ in range(3)]


def _port(q, k, v, h, causal, kmask=None):
    return tfa.flash_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), h=h, causal=causal,
        key_mask=None if kmask is None else torch.from_numpy(kmask),
    )


@pytest.mark.parametrize(
    "causal,padded,block",
    [(True, False, 128), (False, False, 128), (True, True, 256), (False, True, 256)],
)
def test_plain_matches_pallas_kernel(causal, padded, block):
    """b=2, h=2, n=256, d=64.  With key padding the first keys of batch 0
    are masked, so its first rows see no key: both average v.  The padded
    cases use one 256 tile, where the Pallas kernel visits every key of a
    fully masked row, as the dense softmax does."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from dalle_pytorch_tpu.kernels.flash_attention import _flash_fwd

    b, h, n, d = 2, 2, 256, 64
    rng = np.random.default_rng(0)
    q, k, v = _qkv(rng, b * h, n, d)
    kmask = None
    if padded:
        kmask = (rng.random((b, n)) > 0.2).astype(np.int32)
        kmask[0, :10] = 0
    out, lse = _port(q, k, v, h, causal, kmask)
    ref_out, ref_lse = _flash_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, None,
        None if kmask is None else jnp.asarray(kmask), h, causal, d ** -0.5, block, block,
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=ATOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse)[:, :, 0], atol=ATOL, rtol=0)
    if padded and causal:  # rows 0..9 of batch 0 saw only masked keys
        np.testing.assert_allclose(out.numpy()[0, :10], np.broadcast_to(v[0].mean(0), (10, d)), atol=ATOL)


@pytest.mark.parametrize("n", [257, 16])
@pytest.mark.parametrize("padded", [False, True])
def test_plain_matches_dense_attend(n, padded):
    """Lengths the Pallas kernel does not take (n = 257, the slice's prefill)
    go through the JAX package's dense `attend`."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from dalle_pytorch_tpu.ops.attention import attend

    b, h, d = 2, 2, 64
    rng = np.random.default_rng(1)
    q, k, v = _qkv(rng, b * h, n, d)
    kmask = (rng.random((b, n)) > 0.3).astype(np.int32) if padded else None
    out, _ = _port(q, k, v, h, True, kmask)
    mask = np.tril(np.ones((n, n), bool))[None, None]
    if padded:
        mask = mask & (kmask > 0)[:, None, None, :]
    sh = (b, h, n, d)
    ref = attend(jnp.asarray(q.reshape(sh)) * d ** -0.5, jnp.asarray(k.reshape(sh)),
                 jnp.asarray(v.reshape(sh)), mask=jnp.asarray(mask))
    np.testing.assert_allclose(out.numpy().reshape(sh), np.asarray(ref), atol=ATOL, rtol=0)


def test_cpu_tensors_do_not_count_launches():
    rng = np.random.default_rng(2)
    before = tfa.flash_fwd.launches
    _port(*_qkv(rng, 4, 33, 32), h=2, causal=True)
    assert tfa.flash_fwd.launches == before


def _fake_cuda(monkeypatch):
    """Tensors that the wrapper takes for CUDA tensors: meta tensors, with
    the device check patched (this machine has no card)."""
    monkeypatch.setattr(tfa, "_is_cuda", lambda t: True)
    return [torch.empty((4, 64, 64), device="meta") for _ in range(3)]


def test_pattern_mask_on_cuda_raises(monkeypatch):
    """A pattern the kernels cannot run as given raises before any launch:
    a per-head mask with tables shared by all heads (they would skip tiles a
    head's own pattern needs), and a mask of the wrong shape."""
    q, k, v = _fake_cuda(monkeypatch)
    per_head = torch.ones(2, 64, 64, dtype=torch.bool)
    shared = tfa.pattern_tables(np.ones((64, 64), bool), 64, 64, device="meta")
    before = (tfa.flash_fwd.launches, tfa.flash_fwd_compact.launches)
    with pytest.raises(ValueError, match="per-head mask requires per-head"):
        tfa.flash_fwd(q, k, v, h=2, mask=per_head, tables=shared)
    with pytest.raises(ValueError, match="mask must be"):
        tfa.flash_fwd(q, k, v, h=2, mask=torch.ones(63, 63, dtype=torch.bool))
    assert (tfa.flash_fwd.launches, tfa.flash_fwd_compact.launches) == before


def test_cuda_tensor_without_kernel_raises_rather_than_falling_back(monkeypatch, tmp_path):
    """A CUDA tensor launches the kernel or raises: when the kernel cannot
    be built, the plain version is not taken."""
    from dalle_pytorch_tpu_torch.kernels import build

    q, k, v = _fake_cuda(monkeypatch)

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(build, "_nvcc", no_nvcc)
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    before = tfa.flash_fwd.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        tfa.flash_fwd(q, k, v, h=2)
    assert tfa.flash_fwd.launches == before


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize(
    "bh,h,n,d,causal,padded,pattern",
    [(64, 16, 257, 64, True, False, None), (32, 16, 1280, 64, True, False, None),
     (8, 4, 300, 64, False, True, None), (4, 2, 100, 32, True, True, None), (4, 2, 130, 128, True, False, None),
     # the bf16 body's head dims, lengths (prefill 257, primed 705, 1280), both
     # maskings, rows that see no key, and a pattern on the dense grid
     (8, 4, 257, 32, False, False, None), (8, 4, 705, 32, True, "dead", None),
     (8, 4, 1280, 32, True, False, None), (8, 4, 705, 64, False, "dead", None),
     (8, 4, 1280, 64, False, False, None), (8, 4, 257, 128, False, "dead", None),
     (8, 4, 705, 128, True, False, None), (32, 8, 1280, 128, True, False, None),
     (8, 4, 1280, 128, True, "dead", None), (8, 4, 1280, 64, True, False, "axial_col"),
     (8, 4, 705, 128, True, True, "axial_col")],
)
def test_kernel_matches_plain_on_card(cuda_device, dtype, tol, bh, h, n, d, causal, padded, pattern):
    """The dense forward against the plain version: f32 on the 3xTF32
    tensor-core body, bf16 on the bf16 one.  padded: key padding with the
    first 7 keys of batch 0 masked ("dead": every key of the last batch,
    whose rows then see no key); pattern: a mask on the dense grid."""
    from dalle_pytorch_tpu_torch.ops import masks

    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn(bh, n, d, generator=g, device=cuda_device).to(dtype) for _ in range(3))
    kmask = None
    if padded:
        kmask = (torch.rand(bh // h, n, generator=g, device=cuda_device) > 0.2).to(torch.int32)
        kmask[0, :7] = 0
        if padded == "dead":
            kmask[-1] = 0
    mask = tables = None
    if pattern is not None:
        mask = masks.build_pattern_mask(pattern, 1280, 32)[:n, :n].contiguous().to(cuda_device)
        tables = tfa.pattern_tables(mask, n, d, causal, grid="dense", device=cuda_device)
    before = tfa.flash_fwd.launches
    out, lse = tfa.flash_fwd(q, k, v, h=h, causal=causal, mask=mask, key_mask=kmask, grid="dense", tables=tables)
    torch.cuda.synchronize()
    assert tfa.flash_fwd.launches == before + 1
    ref_out, ref_lse = tfa.flash_attention_reference(q, k, v, h, causal, d ** -0.5, mask, kmask)
    assert out.dtype == dtype and lse.shape == (bh, n)
    assert (out.float() - ref_out.float()).abs().max().item() <= tol
    assert (lse - ref_lse).abs().max().item() <= 1e-4
    if padded == "dead":
        rows = slice(bh - h, bh)
        assert torch.all(lse[rows] <= -1e29)
        assert (out[rows].float() - v[rows].float().mean(1, keepdim=True)).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("kind,n,d", [("axial_row", 1280, 64), ("conv_like", 705, 128),
                                      ("sparse_per_head", 300, 32), ("axial_col", 257, 64)])
def test_compact_equals_dense_and_plain_on_card(cuda_device, dtype, tol, kind, n, d):
    """A pattern's forward and backward on both grids: the compacted kernels
    equal the dense kernels with the same mask bit for bit, and both hold
    against the plain versions (backward: max abs error over the
    reference's max abs value)."""
    from dalle_pytorch_tpu_torch.ops import masks

    h = 2
    if kind == "sparse_per_head":
        mask = masks.build_block_sparse_mask(1280, 32, heads=h)[:, :n, :n]
    else:
        mask = masks.build_pattern_mask(kind, 1280, 32)[:n, :n]
    mask = mask.contiguous().to(cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v, do = (torch.randn(2 * h, n, d, generator=g, device=cuda_device).to(dtype) for _ in range(4))
    res = {}
    for grid in ("dense", "compact"):
        tables = tfa.pattern_tables(mask, n, d, grid=grid, device=cuda_device)
        out, lse = tfa.flash_fwd(q, k, v, h=h, mask=mask, grid=grid, tables=tables)
        res[grid] = (out, lse, *tfa.flash_bwd(q, k, v, out, lse, do, h=h, mask=mask, grid=grid, tables=tables))
    torch.cuda.synchronize()
    for a, b in zip(res["dense"], res["compact"]):
        assert torch.equal(a, b)
    out, lse = res["dense"][:2]
    ref_out, ref_lse = tfa.flash_attention_reference(q, k, v, h, True, d ** -0.5, mask)
    assert (out.float() - ref_out.float()).abs().max().item() <= tol
    assert (lse - ref_lse).abs().max().item() <= 1e-4
    ref = tfa.flash_attention_backward_reference(q, k, v, out, lse, do, h, True, d ** -0.5, mask)
    for port, r in zip(res["dense"][2:], ref):
        assert (port.float() - r.float()).abs().max().item() / r.float().abs().max().item() <= tol
