"""The port's FLOPs accounting against the JAX package's, on the CPU:
`dalle_step_flops` at element granularity equal to JAX's, at tile
granularity equal to the live tiles of the port's own tables (64 query
rows; 64 keys at d <= 64, 32 at d 128); `matmul_param_count` over the
bridged weights; the card's peak table; and the measured count of a step,
taken on the meta device, in which each flash call is counted once, by
`kernels/work.py`'s formula, at the route the card would take."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from dalle_pytorch_tpu.models import dalle as jdalle  # noqa: E402
from dalle_pytorch_tpu.training import profiling as jprof  # noqa: E402
from dalle_pytorch_tpu_torch import weights  # noqa: E402
from dalle_pytorch_tpu_torch.kernels import flash_attention as fa  # noqa: E402
from dalle_pytorch_tpu_torch.kernels import work  # noqa: E402
from dalle_pytorch_tpu_torch.models import dalle as tdalle  # noqa: E402
from dalle_pytorch_tpu_torch.models import transformer as tr  # noqa: E402
from dalle_pytorch_tpu_torch.observability import cuda as obs_cuda  # noqa: E402
from dalle_pytorch_tpu_torch.training import profiling as tprof  # noqa: E402

REL = 1e-12  # the same float arithmetic
BASE = dict(dim=64, heads=2, num_text_tokens=50, text_seq_len=64, num_image_tokens=32, image_fmap_size=8)
CONFIGS = {
    "full": dict(depth=2, dim_head=32, attn_types=("full",)),
    "cycle": dict(depth=4, dim_head=64, attn_types=("full", "axial_row", "axial_col", "conv_like")),
    "sparse_per_head": dict(depth=2, dim_head=32, attn_types=("sparse",), sparse_per_head=True),
    "wide_heads": dict(depth=3, dim_head=128, attn_types=("axial_row", "conv_like", "full")),
}


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(name):
    kw = {**BASE, **CONFIGS[name]}
    jcfg = jdalle.DALLEConfig(**kw)
    params = jdalle.init_dalle(jax.random.PRNGKey(0), jcfg)
    model = weights.load_dalle(jax.tree_util.tree_map(np.asarray, params), tdalle.DALLEConfig(**kw), device="cpu")
    return jcfg, params, model


@pytest.mark.parametrize("name", list(CONFIGS))
def test_step_flops_at_element_granularity_equal_jax(name):
    jcfg, params, model = _pair(name)
    n_port = tprof.matmul_param_count(dict(model.named_parameters()))
    assert n_port == jprof.matmul_param_count(params)
    for batch in (1, 4):
        for backward in (True, False):
            port = tprof.dalle_step_flops(model.cfg, batch, n_port, backward)
            ref = jprof.dalle_step_flops(jcfg, batch, n_port, backward)
            assert abs(port - ref) <= REL * ref, (port, ref)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_step_flops_at_tile_granularity_count_the_tables_live_tiles(name):
    """'tile': each layer's attention priced at its pattern's live tiles of
    `flash_attention.pattern_tables` (its `live_tiles` per table head) at
    the kernels' tiles, whole causal tiles for a full layer."""
    _, _, model = _pair(name)
    cfg, tcfg = model.cfg, model.cfg.transformer_config()
    n, d = cfg.total_seq_len, cfg.dim_head
    (tq, tk), _ = fa.tile_shapes(d)
    live = []
    for spec in tr.derive_layer_specs(tcfg):
        t = fa.pattern_tables(tr._pattern_for(tcfg, *tr._pattern_key(spec)), n, d)
        live.append(t.live_tiles / t.heads)
    density = sum(live) / len(live) * tq * tk / (n * n)
    n_mm = tprof.matmul_param_count(dict(model.named_parameters()))
    want = 3.0 * (2.0 * n_mm * 2 * n + 2.0 * 2.0 * 2 * cfg.heads * n * n * d * density * cfg.depth)
    assert tprof.dalle_step_flops(cfg, 2, n_mm, granularity="tile") == pytest.approx(want, rel=REL)
    assert tprof.dalle_step_flops(cfg, 2, n_mm, granularity="tile") >= tprof.dalle_step_flops(cfg, 2, n_mm)


def test_peak_table_and_mfu(monkeypatch):
    assert tprof.chip_peak_flops() is None and tprof.mfu(1e12, 1.0) is None  # the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for name, bf16, f32 in (("NVIDIA H100 80GB HBM3", 989e12, 494.7e12 / 3), ("NVIDIA H100 PCIe", None, None),
                            ("NVIDIA A100-SXM4-80GB", None, None)):
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None, name=name: name)
        assert tprof.chip_peak_flops(torch.bfloat16) == bf16
        assert tprof.chip_peak_flops(torch.float32) == f32
        assert tprof.chip_peak_flops(torch.float16) is None
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "NVIDIA H100 80GB HBM3")
    assert tprof.mfu(989e12 * 0.5, 1.0) == pytest.approx(0.5)
    assert tprof.chip_peak_flops(torch.bfloat16, device="cpu") is None


def test_step_timer_and_trace(tmp_path):
    timer = tprof.StepTimer()
    timer.start()
    for _ in range(3):
        timer.observe()
    assert len(timer.times) == 3 and set(timer.summary()) == {"best_s", "median_s", "mean_s", "steps"}
    path = tmp_path / "trace.json"
    with tprof.trace(str(path)):
        with torch.profiler.record_function("a_named_block"):
            torch.ones(4).sum()
    assert "a_named_block" in path.read_text()


@pytest.mark.parametrize("mask_kind, vfa", [(None, False), ("axial_row", False), ("axial_row", True),
                                            ("axial_col", False)])
def test_each_flash_call_is_counted_once(mask_kind, vfa):
    """A flash call's forward and backward counted on meta tensors: the aten
    counter sees no product of the call (aten 0), and the tally holds one
    record per kernel the card would run, with `work`'s FLOPs.  The same
    call on CPU tensors runs the plain versions, which tally nothing and
    whose products the counter does see: that is why the count runs on
    meta, where no version runs at all."""
    b, h, n, d = 2, 2, 128, 32
    mask_np = None
    if mask_kind is not None:
        cfg = tr.TransformerConfig(dim=64, depth=1, seq_len=n, heads=h, dim_head=d, image_fmap_size=8)
        mask_np = tr._pattern_for(cfg, mask_kind)
    tables = fa.pattern_tables(mask_np, n, d, device="meta") if mask_np is not None else None

    def call(device):
        g = torch.Generator().manual_seed(0)
        q, k, v = (torch.randn(b, h, n, d, generator=g).to(device).requires_grad_() for _ in range(3))
        mask = None if mask_np is None else torch.from_numpy(mask_np).to(device)
        fa.flash_attention(q, k, v, mask=mask, vfa=vfa, tables=tables if device == "meta" else None
                           ).square().sum().backward()

    (_, ca) = obs_cuda.step_cost_analysis(lambda: call("meta"))
    assert ca["aten_flops"] == 0
    (_, on_cpu) = obs_cuda.step_cost_analysis(lambda: call("cpu"))
    assert on_cpu["flash_records"] == [] and on_cpu["aten_flops"] > 0
    if tables is None:
        want = {"flash_fwd": work.dense_work("fwd", b, h, n, d, torch.float32, True, None)[1],
                "flash_dq": work.dense_work("dq", b, h, n, d, torch.float32, True, None)[1],
                "flash_dkv": work.dense_work("dkv", b, h, n, d, torch.float32, True, None)[1]}
    else:
        def pw(kind, live, tile):
            return work.pattern_work(kind, b * h, n, d, torch.float32, live, tables.heads, tile)[1]

        grid = "compact" if tables.compact else ""
        fwd = {"flash_max_compact": pw("vfa_max", tables.live_tiles, tables.row_tile),
               "flash_fwd_compact_vfa": pw("vfa_fwd", tables.live_tiles, tables.row_tile)} if vfa and grid else {
            ("flash_fwd_compact" if grid else "flash_fwd"): pw("fwd", tables.live_tiles, tables.row_tile)}
        want = {**fwd, ("flash_dq_compact" if grid else "flash_dq"): pw("dq", tables.live_tiles, tables.row_tile),
                ("flash_dkv_compact" if grid else "flash_dkv"): pw("dkv", tables.live_tiles_dkv,
                                                                    tables.col_tile[::-1])}
    got = {r.name: r.flops for r in ca["flash_records"]}
    assert got == want and ca["flash_launches"] == {name: 1 for name in want}
    assert ca["flops"] == sum(want.values())


def _tiny_dalle(**kw):
    from dalle_pytorch_tpu_torch.models import vae as vae_mod

    vcfg = vae_mod.DiscreteVAEConfig(image_size=32, num_tokens=32, codebook_dim=16, num_layers=2,
                                     num_resnet_blocks=0, hidden_dim=16)
    vae = vae_mod.init_discrete_vae(vcfg, torch.Generator().manual_seed(0), "cpu")
    cfg = tdalle.DALLEConfig.from_vae(vcfg, dim=64, depth=3, heads=2, dim_head=32, text_seq_len=64,
                                      num_text_tokens=50, **kw)
    batch = {"text": torch.randint(1, 50, (2, 64)), "image": torch.rand(2, 32, 32, 3)}
    return vae, cfg, batch


def dalle_step_cost(cfg, vae, batch, dtype):
    from dalle_pytorch_tpu_torch.cli.train_dalle import dalle_meta_step

    return obs_cuda.step_cost_analysis(dalle_meta_step(cfg, vae, batch, dtype))[1]


def test_a_tiny_steps_count_holds_one_record_per_layer_and_kernel():
    """`train_dalle.dalle_meta_step`: the step counted on the meta device
    holds each layer's three kernels once, its FLOPs inside the JAX band
    of the analytic count, and the real step on the CPU still trains."""
    from dalle_pytorch_tpu_torch.cli.train_dalle import dalle_loss_fn
    from dalle_pytorch_tpu_torch.optim.grouped import Adam
    from dalle_pytorch_tpu_torch.parallel.train_step import StepSettings, make_train_step

    vae, cfg, batch = _tiny_dalle()
    model = tdalle.init_dalle(cfg, torch.Generator().manual_seed(1), "cpu").train().requires_grad_(True)
    init_fn, step_fn = make_train_step(dalle_loss_fn(model, vae, torch.float32), Adam(1e-3), StepSettings())
    state = init_fn(dict(model.named_parameters()))
    ca = dalle_step_cost(cfg, vae, batch, torch.float32)
    _, metrics = step_fn(state, batch)
    assert np.isfinite(float(metrics["loss"]))
    assert ca["flash_launches"] == {"flash_fwd": 3, "flash_dq": 3, "flash_dkv": 3}
    n_mm = tprof.matmul_param_count(state.params)
    ratio = ca["flops"] / tprof.dalle_step_flops(cfg, 2, n_mm, granularity="tile")
    assert 1 / 3 < ratio < 3


@pytest.mark.parametrize("policy, forwards", [("full", 6), ("flash", 3), ("flash_qkv", 3), ("flash_qkv_ff", 3)])
def test_the_count_follows_the_remat_policy(policy, forwards):
    """Counted on meta, a rematerialised step recomputes as it does on the
    card: "full" runs each layer's forward kernel again in the backward,
    the other policies keep its output; the backward kernels run once a
    layer; the recompute's products lift the aten count over the
    sequential step's, "flash" recomputes every product "full" does, and
    the policies that keep projections recompute fewer."""
    vae, seq_cfg, batch = _tiny_dalle()
    _, cfg, _ = _tiny_dalle(execution="remat", remat_policy=policy)
    seq = dalle_step_cost(seq_cfg, vae, batch, torch.float32)
    full = dalle_step_cost(_tiny_dalle(execution="remat")[1], vae, batch, torch.float32)
    ca = dalle_step_cost(cfg, vae, batch, torch.float32)
    assert ca["flash_launches"] == {"flash_fwd": forwards, "flash_dq": 3, "flash_dkv": 3}
    assert ca["aten_flops"] > seq["aten_flops"]
    if policy in ("full", "flash"):
        assert ca["aten_flops"] == full["aten_flops"]
    else:
        assert ca["aten_flops"] < full["aten_flops"]
