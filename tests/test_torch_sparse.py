"""The port's pattern attention against the JAX package's, on the CPU.

Masks, tile tables and decode tables are held `array_equal` to the JAX
package's own functions.  The plain masked attention (what a CPU tensor runs) is held
against the JAX Pallas compacted grid in interpret mode, as the JAX
package's own tests run it, and against the JAX dense `attend`.  The CUDA
wrappers' dispatch is checked on tensors that pass for CUDA tensors (meta
tensors with the device check patched), with the launch itself recorded
instead of made (`tests/test_torch_flash.py` runs them on the card).
`tests/test_torch_sparse_model.py` holds a pattern model."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from dalle_pytorch_tpu.kernels import sparse_index as jsi  # noqa: E402
from dalle_pytorch_tpu.ops import masks as jmasks  # noqa: E402
from dalle_pytorch_tpu_torch.kernels import flash_attention as tfa  # noqa: E402
from dalle_pytorch_tpu_torch.kernels import sparse_index as tsi  # noqa: E402
from dalle_pytorch_tpu_torch.ops import masks as tmasks  # noqa: E402

# ---------------------------------------------------------------------------
# masks and tables
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("attn_type,seq,fmap,kernel,dilation", [
    ("axial_row", 1280, 32, 5, 1), ("axial_col", 1280, 32, 5, 1), ("conv_like", 1280, 32, 5, 1),
    ("conv_like", 51, 6, 3, 1), ("conv_like", 80, 8, 3, 2), ("full", 31, 4, 5, 1),
])
def test_pattern_masks_equal_jax(attn_type, seq, fmap, kernel, dilation):
    port = tmasks.build_pattern_mask(attn_type, seq, fmap, kernel, dilation)
    ref = np.asarray(jmasks.build_pattern_mask(attn_type, seq, fmap, kernel, dilation))
    assert port.dtype == torch.bool
    np.testing.assert_array_equal(port.numpy(), ref)


@pytest.mark.parametrize("seed,heads,block,random_blocks", [(0, None, 16, None), (3, None, 16, 2),
                                                            (5, 4, 16, None), (1, 2, 8, 3)])
def test_block_sparse_masks_equal_jax(seed, heads, block, random_blocks):
    kw = dict(block_size=block, num_random_blocks=random_blocks, seed=seed, heads=heads)
    port = tmasks.build_block_sparse_mask(1280, 32, **kw)
    ref = np.asarray(jmasks.build_block_sparse_mask(1280, 32, **kw))
    np.testing.assert_array_equal(port.numpy(), ref)
    if heads is not None:  # each head draws its own random blocks
        assert not np.array_equal(ref[0], ref[1])


@pytest.mark.parametrize("n,bq,bk", [(1280, 64, 64), (1280, 64, 32), (705, 64, 64), (257, 32, 64)])
def test_block_live_pads_a_ragged_length(n, bq, bk):
    """Where the tiles divide n, the JAX `block_live_np`; otherwise that of
    the mask padded with False to the tile grid."""
    mask = np.asarray(jmasks.build_pattern_mask("axial_row", 1280, 32))[:n, :n]
    port = tmasks.block_live_np(mask, bq, bk)
    assert port.shape == (-(-n // bq), -(-n // bk))
    size = max(-(-n // bq) * bq, -(-n // bk) * bk)
    padded = np.zeros((size, size), bool)
    padded[:n, :n] = mask
    np.testing.assert_array_equal(port, jmasks.block_live_np(padded, bq, bk)[:port.shape[0], :port.shape[1]])
    heads = np.stack([mask, ~mask])
    np.testing.assert_array_equal(tmasks.block_live_np(heads, bq, bk)[1],
                                  tmasks.block_live_np(~mask, bq, bk))


def _pattern(kind, n, heads=2):
    seq, fmap = 1280, 32
    if kind == "sparse":
        return np.array(jmasks.build_block_sparse_mask(seq, fmap))[:n, :n]
    if kind == "sparse_per_head":
        return np.array(jmasks.build_block_sparse_mask(seq, fmap, heads=heads))[:, :n, :n]
    return np.array(jmasks.build_pattern_mask(kind, seq, fmap))[:n, :n]


@pytest.mark.parametrize("kind", ["axial_row", "conv_like", "sparse_per_head"])
@pytest.mark.parametrize("n,bq,bk", [(1280, 64, 64), (705, 64, 32), (257, 32, 64)])
def test_compacted_and_csr_tables_equal_jax(kind, n, bq, bk):
    """`build_compacted_tables` is the JAX one (ragged n through the padded
    liveness), and the CSR lists are its valid entries, row by row and
    column by column."""
    live = tmasks.block_live_np(_pattern(kind, n), bq, bk)
    for causal in (True, False):
        port = tsi.build_compacted_tables(live, bq, bk, causal=causal)
        ref = jsi.build_compacted_tables(live, bq, bk, causal=causal)
        assert set(port) == set(ref) == set(tsi.TABLE_KEYS)
        for key in tsi.TABLE_KEYS:
            np.testing.assert_array_equal(port[key], ref[key])
        assert tsi.live_tile_counts(port) == jsi.live_tile_counts(ref)
        nq, nk = live.shape[-2:]
        csr = tsi.csr_tables(port, nq, nk)
        heads = live.shape[0] if live.ndim == 3 else 1
        full = (live if live.ndim == 3 else live[None]).astype(bool)
        if causal:
            full = full & jsi.block_causal_live_np(nq, nk, bq, bk)[None]
        for h in range(heads):
            for i in range(nq):
                got = csr["col"][h, csr["row_ptr"][h, i]:csr["row_ptr"][h, i + 1]]
                np.testing.assert_array_equal(got, np.flatnonzero(full[h, i]))
            for j in range(nk):
                got = csr["row"][h, csr["col_ptr"][h, j]:csr["col_ptr"][h, j + 1]]
                np.testing.assert_array_equal(got, np.flatnonzero(full[h, :, j]))


@pytest.mark.parametrize("kind", ["axial_row", "axial_col", "conv_like", "sparse", "sparse_per_head"])
def test_decode_tables_equal_jax(kind):
    pattern = _pattern(kind, 300)
    for port, ref in zip(tsi.build_decode_tables(pattern), jsi.build_decode_tables(pattern)):
        np.testing.assert_array_equal(port, ref)
    assert tsi.decode_kv_span(pattern, 300) == jsi.decode_kv_span(pattern, 300)
    assert tsi.decode_kv_span(None, 300) == 300


def test_tile_shapes_come_from_the_kernels_header():
    assert tfa.tile_shapes(64) == ((64, 64), (64, 64)) == tfa.tile_shapes(32)
    assert tfa.tile_shapes(128) == ((64, 32), (32, 64))
    tables = tfa.pattern_tables(_pattern("axial_row", 705), 705, 128)
    assert tables.live_rows.shape == (1, 12, 23) and tables.live_cols.shape == (1, 12, 23)
    assert tables.row_tile == (64, 32) and tables.col_tile == (32, 64)


@pytest.mark.parametrize("kind,compact,live", [("axial_row", True, 119), ("conv_like", True, 144),
                                               ("axial_col", False, 210), ("sparse", False, 210)])
def test_auto_grid_follows_the_tiles_a_pattern_kills(kind, compact, live):
    """At seq 1280, d 64 (64 x 64 tiles, 210 causal tiles): the compacted grid
    exactly where the pattern kills a tile inside the causal triangle."""
    tables = tfa.pattern_tables(_pattern(kind, 1280), 1280, 64)
    assert (tables.compact, tables.live_tiles, tables.causal_tiles) == (compact, live, 210)
    assert tfa.pattern_tables(_pattern(kind, 1280), 1280, 64, grid="dense").compact is False
    assert tfa.pattern_tables(_pattern(kind, 1280), 1280, 64, grid="compact").compact is True
    with pytest.raises(ValueError, match="grid"):
        tfa.pattern_tables(None, 1280, 64, grid="sparse")


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def _qkv(rng, bh, n, d, count=3):
    return [rng.standard_normal((bh, n, d)).astype(np.float32) for _ in range(count)]


@pytest.mark.parametrize("kind", ["axial_row", "sparse_per_head"])
def test_plain_masked_attention_matches_pallas_compact(kind):
    """b=1, h=2, d=32, N=384 (text 128 + a 16 x 16 map): output and
    gradients of the port's autograd function (plain versions on the CPU)
    against jax.grad through the JAX compacted grid (block 128, interpret
    mode), atol 5e-5."""
    from dalle_pytorch_tpu.kernels.flash_attention import flash_attention as jflash

    b, h, n, d = 1, 2, 384, 32
    if kind == "axial_row":
        mask = np.array(jmasks.build_pattern_mask("axial_row", n, 16))
    else:
        mask = np.array(jmasks.build_block_sparse_mask(n, 16, heads=h))
    rng = np.random.default_rng(0)
    q, k, v, g = (a.reshape(b, h, n, d) for a in _qkv(rng, b * h, n, d, count=4))

    def loss(q_, k_, v_):
        out = jflash(q_, k_, v_, mask=mask, block_q=128, block_k=128, grid="compact")
        return jnp.sum(out * jnp.asarray(g)), out

    (_, ref_out), ref = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, mask=torch.from_numpy(mask))
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out), atol=5e-5, rtol=0)
    for port, r in zip((tq.grad, tk.grad, tv.grad), ref):
        np.testing.assert_allclose(port.numpy(), np.asarray(r), atol=5e-5, rtol=0)


@pytest.mark.parametrize("kind", ["axial_col", "conv_like", "sparse"])
def test_plain_masked_attention_matches_dense_attend(kind):
    """n = 257 (ragged, the slice's prefill length): the port's plain
    forward with each pattern against the JAX dense `attend`."""
    from dalle_pytorch_tpu.ops.attention import attend

    b, h, n, d = 2, 2, 257, 32
    mask = _pattern(kind, n)
    rng = np.random.default_rng(1)
    q, k, v = _qkv(rng, b * h, n, d)
    out, _ = tfa.flash_fwd(*(torch.from_numpy(a) for a in (q, k, v)), h=h, mask=torch.from_numpy(mask))
    sh = (b, h, n, d)
    full = (np.tril(np.ones((n, n), bool)) & mask)[None, None]
    ref = attend(jnp.asarray(q.reshape(sh)) * d ** -0.5, jnp.asarray(k.reshape(sh)),
                 jnp.asarray(v.reshape(sh)), mask=jnp.asarray(full))
    np.testing.assert_allclose(out.numpy().reshape(sh), np.asarray(ref), atol=2e-5, rtol=0)


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
                        tab_len=0, tile=(0, 0): calls.append((name, tensors, mask_heads, tab_heads, tile)))

    def tensors(bh=32, n=1280, d=64):
        qkv = [torch.empty((bh, n, d), device="meta") for _ in range(4)]
        return qkv, torch.empty((bh, n), device="meta")

    return calls, tensors


@pytest.mark.parametrize("d", [64, 128])
def test_dispatch_by_pattern(fake_cuda, d):
    """axial_row (kills tiles) reaches the compact entries with tables at
    the kernels' tiles; axial_col (kills none) the dense entries with its
    mask and liveness; full the dense entries with neither.  Each path
    counts its own launches."""
    calls, tensors = fake_cuda
    (q, k, v, do), lse = tensors(d=d)
    row_tile, col_tile = tfa.tile_shapes(d)
    counters = lambda: (tfa.flash_fwd.launches, tfa.flash_fwd.masked_launches, tfa.flash_fwd_compact.launches,  # noqa: E731
                        tfa.flash_bwd.dq_launches, tfa.flash_bwd_compact.dq_launches,
                        tfa.flash_bwd_compact.dkv_launches)
    for kind, want in (("axial_row", ["flash_fwd_compact", "flash_dq_compact", "flash_dkv_compact"]),
                       ("axial_col", ["flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"]),
                       ("full", ["flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"])):
        calls.clear()
        mask = None if kind == "full" else torch.from_numpy(_pattern(kind, 1280))
        before = counters()
        tfa.flash_fwd(q, k, v, h=16, mask=mask)
        tfa.flash_bwd(q, k, v, q, lse, do, h=16, mask=mask)
        assert [c[0] for c in calls] == want
        delta = np.subtract(counters(), before).tolist()
        if kind == "axial_row":
            assert delta == [0, 0, 1, 0, 1, 1]
            assert [c[4] for c in calls] == [row_tile, row_tile, col_tile]
            fwd_ptrs = calls[0][1]
            assert fwd_ptrs[5].shape == (1, -(-1280 // row_tile[0]) + 1)  # row_ptr
        elif kind == "axial_col":
            assert delta == [1, 1, 0, 1, 0, 0]
            assert calls[0][1][4] is not None and calls[0][1][5].shape[1:] == (20, -(-1280 // row_tile[1]))
            assert [c[4] for c in calls] == [row_tile, row_tile, col_tile]
        else:
            assert delta == [1, 0, 0, 1, 0, 0]
            assert all(c[1][4] is None and c[1][5] is None and c[4] == (0, 0) for c in calls[:1])
            assert calls[1][1][7] is None and calls[1][1][8] is None


def test_per_head_masks_take_per_head_tables(fake_cuda):
    calls, tensors = fake_cuda
    (q, k, v, _), _ = tensors(bh=4, n=1280)
    per_head = torch.from_numpy(_pattern("sparse_per_head", 1280, heads=2))
    tfa.flash_fwd(q, k, v, h=2, mask=per_head, grid="compact")
    assert calls[-1][0] == "flash_fwd_compact" and calls[-1][2:4] == (2, 2)
    shared = tfa.pattern_tables(per_head[0], 1280, 64, device="meta")
    with pytest.raises(ValueError, match="per-head mask requires per-head"):
        tfa.flash_fwd(q, k, v, h=2, mask=per_head, tables=shared)
    with pytest.raises(ValueError, match="per-head mask requires per-head"):
        tfa.flash_fwd_compact(q, k, v, shared, h=2, mask=per_head)


def test_cpu_tensors_take_the_plain_version_on_every_grid():
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, 4, 130, 32))
    mask = torch.from_numpy(_pattern("axial_row", 130))
    ref, ref_lse = tfa.flash_attention_reference(q, k, v, 2, True, None, mask)
    before = (tfa.flash_fwd.launches, tfa.flash_fwd_compact.launches)
    for grid in ("auto", "dense", "compact"):
        out, lse = tfa.flash_fwd(q, k, v, h=2, mask=mask, grid=grid)
        torch.testing.assert_close(out, ref, rtol=0, atol=0)
    out, _ = tfa.flash_fwd_compact(q, k, v, tfa.pattern_tables(mask, 130, 32), h=2, mask=mask)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert (tfa.flash_fwd.launches, tfa.flash_fwd_compact.launches) == before
