"""The port's serving quantization (`quantization.py`, the quantized pool of
`models/paged.py`, the dequant-on-use hooks of `models/dalle.py` and
`models/transformer.py`, the v3 bridge in `weights.py`) against the JAX
package's `quantization.py`, on the CPU.

The quantizers give the JAX package's int8 values and scales exactly, and
its fp8 e4m3 bits (torch's float32 -> float8_e4m3fn cast rounds as
ml_dtypes does, ±448 included).  The pricing functions equal JAX's.  A
quantized model's logits (int8 and fp8 weights; an int8 pool; both) stay
within 1e-4 of the JAX package's quantized logits (f32), and the greedy
drift stays within JAX's budgets.  A JAX-quantized v3 file loads into the
port and the port's quantized write loads back into JAX bit for bit; the
quantized pool's prefill scatter equals JAX `write_prefill_to_pool`."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from dalle_pytorch_tpu import quantization as jq  # noqa: E402
from dalle_pytorch_tpu.models import dalle as jdalle  # noqa: E402
from dalle_pytorch_tpu.models import transformer as jtr  # noqa: E402
from dalle_pytorch_tpu.serving import kv_pool as jpool  # noqa: E402
from dalle_pytorch_tpu_torch import quantization as tq  # noqa: E402
from dalle_pytorch_tpu_torch import weights  # noqa: E402
from dalle_pytorch_tpu_torch.models import dalle as tdalle  # noqa: E402
from dalle_pytorch_tpu_torch.models import paged  # noqa: E402
from dalle_pytorch_tpu_torch.models import transformer as ttr  # noqa: E402
from dalle_pytorch_tpu_torch.serving import kv_pool as tpool  # noqa: E402

ATOL = 1e-4
# seq 22 = text 6 + a 4 x 4 map
MODEL = dict(dim=64, depth=2, heads=2, dim_head=32, num_text_tokens=40, text_seq_len=6, num_image_tokens=32,
             image_fmap_size=4, shift_tokens=True)
MODELS = {"full": MODEL, "tied_pattern": dict(MODEL, attn_types=("full", "axial_row"), share_input_output_emb=True,
                                              rotary_emb=False)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_trees = {}


def _tree(name, kind=None):
    """(JAX params, quantized with `kind` when given, JAX config)."""
    key = (name, kind)
    if key not in _trees:
        jcfg = jdalle.DALLEConfig(**MODELS[name])
        params = jax.device_get(jdalle.init_dalle(jax.random.PRNGKey(0), jcfg))
        if kind is not None:
            params = jax.device_get(jq.quantize_tree(params, kind))
        _trees[key] = params, jcfg
    return _trees[key]


def _port(name, kind=None):
    """The port's model of the plain JAX tree, quantized by the port."""
    params, _ = _tree(name)
    model = weights.load_dalle(params, tdalle.DALLEConfig(**MODELS[name]), device="cpu")
    return model if kind is None else tq.quantize_tree(model, kind)


def _weight(rng):
    w = (rng.standard_normal((40, 24)) * rng.uniform(0.01, 3.0, (1, 24))).astype(np.float32)
    w[:, 5] = 0.0  # a zero channel: scale 0, values 0
    return w


def _bits(q):
    q = np.asarray(q)
    return q.view(np.uint8) if q.dtype.name == "float8_e4m3fn" else q


@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_quantize_weight_gives_the_jax_values_and_scales(kind):
    w = _weight(np.random.default_rng(0))
    want = jq.quantize_weight(jnp.asarray(w), kind)
    got = tq.quantize_weight(torch.from_numpy(w.T.copy()), kind)  # the port's (out, in)
    np.testing.assert_array_equal(got["qvalue"].t().numpy(), _bits(want["qvalue"]))
    np.testing.assert_array_equal(got["scale"].numpy(), np.asarray(want["scale"]))
    np.testing.assert_array_equal(tq.maybe_dequant_weight(got["qvalue"], got["scale"]).t().numpy(),
                                  np.asarray(jq.maybe_dequant_weight(want)))


@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_quantize_table_gives_the_jax_values_and_scales(kind):
    t = _weight(np.random.default_rng(1)).T.copy()
    t[3] = 0.0
    want = jq.quantize_table(jnp.asarray(t), kind)
    got = tq.quantize_table(torch.from_numpy(t), kind)
    np.testing.assert_array_equal(got["qvalue"].numpy(), _bits(want["qvalue"]))
    np.testing.assert_array_equal(got["scale"].numpy(), np.asarray(want["scale"]))


def test_fp8_reaches_448_with_ml_dtypes_bits():
    """Every channel's largest value lands on ±448 (e4m3's largest finite),
    and the rest of the e4m3 range rounds as ml_dtypes rounds."""
    rng = np.random.default_rng(2)
    w = rng.uniform(-1, 1, (300, 8)).astype(np.float32) * np.float32(3.7)
    want = _bits(jq.quantize_weight(jnp.asarray(w), "fp8")["qvalue"])
    got = tq.quantize_weight(torch.from_numpy(w.T.copy()), "fp8")["qvalue"].t().numpy()
    np.testing.assert_array_equal(got, want)
    assert {abs(float(v)) for v in torch.from_numpy(got.max(0)).view(tq.FP8).float()} <= {448.0}


def test_quantize_kv_gives_the_jax_values_and_bf16_scales():
    x = np.random.default_rng(3).standard_normal((2, 3, 7, 32)).astype(np.float32)
    x[0, 1, 2] = 0.0
    wq, ws = jq.quantize_kv(jnp.asarray(x))
    gq, gs = tq.quantize_kv(torch.from_numpy(x))
    assert gs.dtype == torch.bfloat16
    np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(gs.float().numpy(), np.asarray(ws.astype(jnp.float32)))
    np.testing.assert_array_equal(tq.dequantize_kv(gq, gs, torch.float32).numpy(),
                                  np.asarray(jq.dequantize_kv(wq, ws, jnp.float32)))


def test_pricing_equals_jax():
    for dh in (8, 32, 64, 128):
        for quant, item in ((None, 4), ("none", 2), ("int8", 4), ("int8", 2)):
            assert tq.kv_bytes_per_elem(quant, item, dh) == jq.kv_bytes_per_elem(quant, item, dh)
        assert tq.kv_pool_reduction(dh) == jq.kv_pool_reduction(dh)
    with pytest.raises(ValueError, match="kv quant"):
        tq.kv_bytes_per_elem("fp8", 2, 64)
    assert tq.assert_quantized_reduction("pool", tq.kv_pool_reduction(64)) == jq.kv_pool_reduction(64)
    with pytest.raises(AssertionError, match="under the 1.9x bar"):
        tq.assert_quantized_reduction("pool", tq.kv_pool_reduction(8))  # dim_head 8: scales eat the win
    for name in MODELS:
        jcfg = _tree(name)[1]
        tcfg = tdalle.DALLEConfig(**MODELS[name]).transformer_config()
        for kv, w in ((None, None), ("int8", None), (None, "int8"), ("int8", "fp8")):
            got = tq.dequant_overhead_flops(tcfg, kv, w, 8, emb_rows=100)
            assert got == jq.dequant_overhead_flops(jcfg.transformer_config(), kv, w, 8, emb_rows=100)


@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("name", list(MODELS))
def test_weight_bytes_and_reduction_equal_jax(name, kind):
    plain, _ = _tree(name)
    quant, _ = _tree(name, kind)
    port_plain, port_quant = _port(name), _port(name, kind)
    assert tq.tree_weight_bytes(port_plain) == jq.tree_weight_bytes(plain)
    assert tq.tree_weight_bytes(port_quant) == jq.tree_weight_bytes(quant)
    assert tq.weight_reduction(port_plain, port_quant) == jq.weight_reduction(plain, quant)
    assert tq.tree_is_quantized(port_quant) and not tq.tree_is_quantized(port_plain)
    assert tq.weight_quant_kind(port_quant) == jq.weight_quant_kind(quant) == kind
    assert port_quant.dtype == torch.float32


@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("name", list(MODELS))
def test_quantized_forward_matches_jax(name, kind):
    """Every matmul dequantized on use, and under the tie the embedding rows
    gathered from the quantized logits weight."""
    quant, jcfg = _tree(name, kind)
    model = _port(name, kind)
    text = np.random.default_rng(4).integers(0, 40, (2, 6))
    codes = np.random.default_rng(5).integers(0, 32, (2, 16))
    want = np.asarray(jdalle.forward(quant, jcfg, jnp.asarray(text), jnp.asarray(codes)))
    got = tdalle.forward(model, torch.from_numpy(text), torch.from_numpy(codes)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_tied_rows_are_the_whole_tables_rows_bit_for_bit():
    model = _port("tied_pattern", "int8")
    cfg, lin = model.cfg, model.logits_linear
    ids = torch.tensor([[0, 3, 31], [7, 7, 1]])
    whole = lin.weight
    np.testing.assert_array_equal(tdalle._table_rows(model, ids, image=True).numpy(),
                                  whole[cfg.num_text_tokens_padded + ids].numpy())
    np.testing.assert_array_equal(tdalle._table_rows(model, ids, image=False).numpy(), whole[ids].numpy())


def test_quantize_tree_is_idempotent_and_dequantize_tree_inverts_it():
    model = _port("full", "int8")
    blocks = [m.qvalue for m in model.modules() if isinstance(m, tq._Quantized)]
    tq.quantize_tree(model, "int8")
    assert [m.qvalue for m in model.modules() if isinstance(m, tq._Quantized)] == blocks
    want = model.logits_linear.weight
    tq.dequantize_tree(model)
    assert not tq.tree_is_quantized(model) and isinstance(model.logits_linear, torch.nn.Linear)
    np.testing.assert_array_equal(model.logits_linear.weight.numpy(), want.numpy())
    with pytest.raises(ValueError, match="dtype must be one of"):
        tq.quantize_tree(model, "int4")


GREEDY_STEPS = 3  # the JAX harness compiles a step per position


@pytest.mark.parametrize("case", ["kv", "weights_kv", "fp8_kv"])
def test_paged_greedy_logits_match_jax(case):
    """The serving path (prefill, the quantized scatter, the paged steps)
    greedy over the image's first positions: logits within 1e-4 of JAX's
    under the same quantization, the drift over the plain run within JAX's
    budgets."""
    kind = {"kv": None, "weights_kv": "int8", "fp8_kv": "fp8"}[case]
    params, jcfg = _tree("tied_pattern", kind)
    model = _port("tied_pattern", kind)
    text = np.random.default_rng(6).integers(1, 40, (6,))
    run = dict(steps=GREEDY_STEPS, block_size=4)
    want = jq.paged_greedy_logits(params, jcfg, text, quantize_kv_mode="int8", **run)
    got = tq.paged_greedy_logits(model, torch.from_numpy(text), quantize_kv_mode="int8", **run)
    np.testing.assert_array_equal(got["codes"].numpy(), np.asarray(want["codes"]))
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]), atol=ATOL, rtol=0)
    base = tq.paged_greedy_logits(_port("tied_pattern"), torch.from_numpy(text), **run)
    metrics = tq.greedy_parity_metrics(base, got)
    if "plain" not in _trees:
        _trees["plain"] = jq.paged_greedy_logits(_tree("tied_pattern")[0], jcfg, text, **run)
    jmetrics = jq.greedy_parity_metrics(_trees["plain"], want)
    budget = tq.KV_PARITY_REL_BUDGET if kind is None else tq.FULL_PARITY_REL_BUDGET
    assert (tq.KV_PARITY_REL_BUDGET, tq.FULL_PARITY_REL_BUDGET) == (jq.KV_PARITY_REL_BUDGET,
                                                                    jq.FULL_PARITY_REL_BUDGET)
    assert 0 < metrics["greedy_logit_drift_rel"] <= budget
    assert abs(metrics["greedy_logit_drift_rel"] - jmetrics["greedy_logit_drift_rel"]) < 1e-3


@pytest.mark.parametrize("n_pre,block_size", [(7, 4), (8, 4)])
def test_quantized_pool_writes_equal_jax(n_pre, block_size):
    jcfg = jdalle.DALLEConfig(**MODEL)
    tcfg = jcfg.transformer_config()
    rng = np.random.default_rng(7)
    mb = -(-tcfg.seq_len // block_size)
    cache = [{k: rng.standard_normal((2, tcfg.heads, tcfg.seq_len, tcfg.dim_head)).astype(np.float32)
              for k in ("k", "v")} for _ in range(tcfg.depth)]
    tables = rng.permutation(np.arange(1, 20))[:2 * mb].reshape(2, mb).astype(np.int32)
    jp = jtr.init_paged_pool(tcfg, 20, block_size, quantize="int8")
    want = jtr.write_prefill_to_pool(tcfg, jp, jnp.asarray(tables),
                                     [{k: jnp.asarray(v) for k, v in c.items()} for c in cache], n_pre, block_size)
    pcfg = tdalle.DALLEConfig(**MODEL).transformer_config()
    got = paged.init_paged_pool(pcfg, 20, block_size, quantize="int8")
    paged.write_prefill_to_pool(pcfg, got, torch.from_numpy(tables).long(),
                                [{k: torch.from_numpy(v) for k, v in c.items()} for c in cache], n_pre, block_size)
    # and a cache quantized before the scatter moves as it is
    again = paged.init_paged_pool(pcfg, 20, block_size, quantize="int8")
    paged.write_prefill_to_pool(pcfg, again, torch.from_numpy(tables).long(),
                                tq.quantize_cache_layers([{k: torch.from_numpy(v) for k, v in c.items()}
                                                          for c in cache]), n_pre, block_size)
    for g, a, w in zip(got["layers"], again["layers"], want["layers"]):
        assert g["k"].dtype == torch.int8 and g["k_scale"].dtype == torch.bfloat16
        for key in ("k", "v", "k_scale", "v_scale"):
            np.testing.assert_array_equal(g[key].float().numpy(), np.asarray(w[key].astype(jnp.float32)))
            assert torch.equal(g[key], a[key])


def test_quantized_paged_step_and_dense_step_match_jax():
    """One paged step over a quantized pool, and one dense cached step over a
    quantized cache (`quantize_cache_layers`), the pattern layer gathering:
    the paged output within 1e-4 of JAX's, its written columns within one
    int8 step; the dense step equal to the paged step over the same
    contents."""
    params, jcfg = _tree("tied_pattern")
    model = _port("tied_pattern")
    tcfg = jcfg.transformer_config()
    pcfg = model.transformer.cfg
    rng = np.random.default_rng(8)
    x = rng.standard_normal((3, 1, tcfg.dim)).astype(np.float32)
    offsets = np.array([tcfg.text_len, 0, 15], np.int32)
    mb = -(-tcfg.seq_len // 4)
    tables = rng.permutation(np.arange(1, 24))[:3 * mb].reshape(3, mb).astype(np.int32)  # disjoint: written below
    tables[1] = 0
    cache = [{k: rng.standard_normal((3, tcfg.heads, tcfg.seq_len, tcfg.dim_head)).astype(np.float32)
              for k in ("k", "v")} for _ in range(tcfg.depth)]
    live = np.array([0, 2])  # the idle slot's table is the trash block, which no prefill writes
    jp = jtr.write_prefill_to_pool(tcfg, jtr.init_paged_pool(tcfg, 24, 4, quantize="int8"),
                                   jnp.asarray(tables[live]),
                                   [{k: jnp.asarray(v[live]) for k, v in c.items()} for c in cache], tcfg.seq_len, 4)
    zero_rings = jtr.init_slot_rings(tcfg, 3)
    out_j, pool_j, _ = jax.jit(jtr.paged_decode_step, static_argnums=(1, 7))(
        params["transformer"], tcfg, jnp.asarray(x), jp, jnp.asarray(tables), jnp.asarray(offsets), zero_rings, 4)
    tp = paged.init_paged_pool(pcfg, 24, 4, quantize="int8")
    paged.write_prefill_to_pool(pcfg, tp, torch.from_numpy(tables[live]).long(),
                                [{k: torch.from_numpy(v[live]) for k, v in c.items()} for c in cache], pcfg.seq_len, 4)
    rings = paged.init_slot_rings(pcfg, 3)
    out = paged.paged_decode_step(model.transformer, torch.from_numpy(x), tp, torch.from_numpy(tables).long(),
                                  torch.from_numpy(offsets).long(), rings, 4)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), atol=ATOL, rtol=0)
    for g, w in zip(tp["layers"], pool_j["layers"]):
        deq = tq.dequantize_kv(g["k"], g["k_scale"], torch.float32).numpy()
        want = np.asarray(jq.dequantize_kv(w["k"], w["k_scale"], jnp.float32))
        step = np.asarray(w["k_scale"].astype(jnp.float32))[..., None]
        assert np.all(np.abs(deq - want) <= step * 1.01 + 1e-7)

    # the dense cached step on a quantized cache (the JAX package runs that
    # math only in the paged view): equal to the paged step over the same
    # quantized contents, a one-slot table at offset 9
    layers = [dict({k: torch.from_numpy(v[:1].copy()) for k, v in c.items()}, shift_attn=torch.zeros(1, 4, 2, 16),
                   shift_ff=torch.zeros(1, 4, 2, 16)) for c in cache]
    tcache = {"offset": torch.tensor(9), "layers": tq.quantize_cache_layers(layers)}
    got, _ = ttr.decode_step(model.transformer, torch.from_numpy(x[:1]), tcache)
    tp = paged.init_paged_pool(pcfg, mb + 1, 4, quantize="int8")
    table = torch.arange(1, mb + 1)[None]
    paged.write_prefill_to_pool(pcfg, tp, table, layers, pcfg.seq_len, 4)
    want = paged.paged_decode_step(model.transformer, torch.from_numpy(x[:1]), tp, table, torch.tensor([9]),
                                   paged.init_slot_rings(pcfg, 1), 4)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)
    for lc, lp in zip(tcache["layers"], tp["layers"]):
        assert torch.equal(lc["k"][0, :, 9], lp["k"][3, :, 1]) and torch.equal(lc["k_scale"][0, :, 9],
                                                                            lp["k_scale"][3, :, 1])


def test_quantized_pool_prices_and_holds_more_blocks():
    jcfg = jdalle.DALLEConfig(**MODEL).transformer_config()
    tcfg = tdalle.DALLEConfig(**MODEL).transformer_config()
    for quant in (None, "int8"):
        jp = jpool.BlockPool(jcfg, 12, 4, quant=quant)
        tp = tpool.BlockPool(tcfg, 12, 4, quant=quant)
        assert tp.bytes(itemsize=4) == jp.bytes(itemsize=4)
        pool = tp.device_pool()
        assert sum(t.numel() * t.element_size() for layer in pool["layers"] for t in layer.values()) == tp.bytes()
        for budget in (1e5, 3e5):
            assert (tpool.blocks_within_bytes(tcfg, budget, 4, 4, quant)
                    == jpool.blocks_within_bytes(jcfg, budget, 4, 4, quant))
    assert tpool.blocks_within_bytes(tcfg, 3e5, 4, 4, "int8") > tpool.blocks_within_bytes(tcfg, 3e5, 4, 4)
    assert tp.summary()["kv_dtype"] == "int8"


@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_quantized_checkpoints_go_both_ways(kind, tmp_path):
    """A tree the JAX package quantized and saved loads into the port and
    computes JAX's logits; the port's quantized model, written through the
    port's writer, reads back in JAX as JAX's own quantized tree, bit for
    bit."""
    from dalle_pytorch_tpu.training.checkpoint import load_checkpoint, save_checkpoint
    from dalle_pytorch_tpu_torch import checkpoint as tckpt

    quant, jcfg = _tree("tied_pattern", kind)
    path = str(tmp_path / "q.npz")
    meta = {"hparams": jcfg.to_dict(), "vae_params": {}, "vae_class_name": "DiscreteVAE"}
    save_checkpoint(path, {"weights": quant}, meta)
    trees, _ = tckpt.load_checkpoint(path, names=("weights",))
    model = weights.load_dalle(trees["weights"], tdalle.DALLEConfig(**MODELS["tied_pattern"]), device="cpu")
    assert tq.weight_quant_kind(model) == kind
    text = np.random.default_rng(9).integers(0, 40, (2, 6))
    np.testing.assert_allclose(tdalle.forward(model, torch.from_numpy(text)).numpy(),
                               np.asarray(jdalle.forward(quant, jcfg, jnp.asarray(text))), atol=ATOL, rtol=0)

    port = _port("tied_pattern", kind)
    out = str(tmp_path / "port.npz")
    tckpt.save_checkpoint(out, {"weights": weights.dalle_tree(port.state_dict(), port.cfg)}, meta)
    back, _ = load_checkpoint(out)
    flat_w = jax.tree_util.tree_leaves_with_path(quant)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back["weights"]))
    assert len(flat_w) == len(flat_b)
    for path_, leaf in flat_w:
        got = flat_b[path_]
        assert np.asarray(got).dtype == np.asarray(leaf).dtype, path_
        np.testing.assert_array_equal(_bits(got), _bits(leaf))
