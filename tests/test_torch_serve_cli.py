"""The port's service CLI (`cli/serve.py`) and the generate CLI's `--engine`
on the CPU: `serve --synthetic --loadgen 4` end to end with the loadgen's
report, `serve --prompts` from a v3 checkpoint writing one PNG a prompt
(the images of each request's batch-1 codes), `generate --engine` writing
the PNG that `generate` writes under the same seed, a torch-reference
VQGanVAE dalle.pt and a v2 file served through their flags, the fleet's,
the journal's, the degrade ladder's, the recorder's and the SLO monitor's
flags serving, and the telemetry flags exiting with their ROADMAP.md
item."""
import json

import numpy as np
import pytest
import torch

from dalle_pytorch_tpu_torch import checkpoint, weights
from dalle_pytorch_tpu_torch.cli import generate as generate_cli
from dalle_pytorch_tpu_torch.cli import png
from dalle_pytorch_tpu_torch.cli import serve
from dalle_pytorch_tpu_torch.data import tokenizer as tokenizer_mod
from dalle_pytorch_tpu_torch.models import dalle as tdalle
from dalle_pytorch_tpu_torch.models import sampling as tsamp
from dalle_pytorch_tpu_torch.models import vae as tvae
from dalle_pytorch_tpu_torch.models import vae_registry
from dalle_pytorch_tpu_torch.models import vqgan as tvqgan
from dalle_pytorch_tpu_torch.version import __version__
from torch_port_refs import write_legacy_checkpoint, write_reference_dalle

# the BPE tokenizer's vocabulary; seq 28 = text 12 + a 4 x 4 map
DALLE = dict(dim=64, depth=2, heads=2, dim_head=32, num_text_tokens=49408, text_seq_len=12, num_image_tokens=32,
             image_fmap_size=4, shift_tokens=True, attn_types=("full", "axial_row"))
VAE = dict(image_size=16, num_tokens=32, codebook_dim=16, num_layers=2, hidden_dim=8)
LOADGEN_KEYS = {"requests_completed", "requests_refused", "journeys_completed", "streams", "elapsed_s",
                "ttft_p50_s", "ttft_p99_s", "queue_wait_p50_s", "queue_wait_p99_s", "latency_p50_s",
                "latency_p99_s", "hop_ttft_p50_s", "hop_ttft_p99_s", "hop_latency_p50_s", "hop_latency_p99_s",
                "images_per_sec_per_chip"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A v3 checkpoint of seeded weights, written by the port."""
    cfg, vae_cfg = tdalle.DALLEConfig(**DALLE), tvae.DiscreteVAEConfig(**VAE)
    dalle = tdalle.init_dalle(cfg, torch.Generator().manual_seed(0), "cpu")
    vae = tvae.init_discrete_vae(vae_cfg, torch.Generator().manual_seed(1), "cpu")
    class_name, vae_meta = vae_registry.config_to_meta(vae_cfg)
    path = tmp_path_factory.mktemp("ckpt") / "dalle.pt"
    checkpoint.save_checkpoint(str(path), {"weights": weights.dalle_tree(dalle.state_dict(), cfg),
                                           "vae_weights": weights.vae_tree(vae.state_dict(), vae_cfg)},
                               {"hparams": cfg.to_dict(), "vae_params": vae_meta, "vae_class_name": class_name,
                                "version": __version__})
    return path


def test_serve_synthetic_loadgen_reports(tmp_path, capsys):
    report_path = tmp_path / "report.json"
    report = serve.main(["--synthetic", "--loadgen", "4", "--rate", "50", "--streams", "2", "--slots", "3",
                         "--block_size", "8", "--dim", "64", "--image_fmap_size", "4", "--cond_scale", "2.0",
                         "--report_json", str(report_path), "--device", "cpu"])
    assert LOADGEN_KEYS <= set(report)
    assert report["requests_completed"] == 4 and report["requests_refused"] == 0 and report["streams"] == 2
    assert report["ttft_p99_s"] <= report["latency_p99_s"] and report["images_per_sec_per_chip"] > 0
    assert report["pool"]["free_blocks"] == report["pool_blocks"] and report["refused_total"] == 0
    assert json.loads(report_path.read_text()) == report
    assert "[serving] report:" in capsys.readouterr().out


def test_serve_prompts_writes_the_batch1_images(ckpt, tmp_path):
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("a cat\n\na red dog\na cat\n")
    out = tmp_path / "out"
    report = serve.main(["--dalle_path", str(ckpt), "--prompts", str(prompts), "--slots", "3", "--block_size", "8",
                         "--seed", "4", "--top_k", "0.5", "--cond_scale", "2.0", "--outputs_dir", str(out),
                         "--device", "cpu"])
    assert report["requests_completed"] == 3
    model, vae = weights.load_dalle_checkpoint(ckpt, "cpu")
    for i, (prompt, n) in enumerate((("a cat", 0), ("a red dog", 0), ("a cat", 1))):
        ids = torch.from_numpy(tokenizer_mod.tokenizer.tokenize(prompt, 12, truncate_text=True))
        images = tsamp.generate_images(model, vae, ids, torch.Generator().manual_seed(4 + i), filter_thres=0.5,
                                       cond_scale=2.0)
        want = (np.clip(vae_registry.to_display(vae.cfg, images).numpy()[0], 0, 1) * 255).astype(np.uint8)
        np.testing.assert_array_equal(png.read_png(out / prompt.replace(" ", "_") / f"{n}.png"), want)


def test_generate_engine_writes_the_plain_cli_image(ckpt, tmp_path):
    argv = ["--dalle_path", str(ckpt), "--text", "a cat", "--num_images", "1", "--batch_size", "1", "--seed", "9",
            "--cond_scale", "3.0", "--temperature", "0.8", "--device", "cpu"]
    (plain,) = generate_cli.main(argv + ["--outputs_dir", str(tmp_path / "plain")])
    (engine,) = generate_cli.main(argv + ["--outputs_dir", str(tmp_path / "engine"), "--engine",
                                          "--engine_slots", "2", "--engine_block_size", "8"])
    assert engine.relative_to(tmp_path / "engine") == plain.relative_to(tmp_path / "plain")
    np.testing.assert_array_equal(png.read_png(engine), png.read_png(plain))


def test_generate_engine_seeds_each_image(ckpt, tmp_path):
    """Image j of an --engine run is seeded with --seed + j."""
    paths = generate_cli.main(["--dalle_path", str(ckpt), "--text", "a cat|a dog", "--num_images", "2",
                               "--batch_size", "2", "--seed", "3", "--engine", "--engine_slots", "3",
                               "--engine_block_size", "8", "--outputs_dir", str(tmp_path), "--device", "cpu"])
    model, vae = weights.load_dalle_checkpoint(ckpt, "cpu")
    for j, path in enumerate(paths):
        prompt = "a cat" if j < 2 else "a dog"
        ids = torch.from_numpy(tokenizer_mod.tokenizer.tokenize(prompt, 12, truncate_text=True))
        images = tsamp.generate_images(model, vae, ids, torch.Generator().manual_seed(3 + j), filter_thres=0.9)
        want = (np.clip(vae_registry.to_display(vae.cfg, images).numpy()[0], 0, 1) * 255).astype(np.uint8)
        np.testing.assert_array_equal(png.read_png(path), want)


@pytest.mark.parametrize("flags,item", [
    (["--telemetry", "t"], "item 8"), (["--telemetry_every", "4"], "item 8"),
    (["--telemetry_heartbeat_s", "5"], "item 8"), (["--profile_on_alarm", "2"], "item 8"),
])
def test_serve_refuses_what_is_not_ported(flags, item):
    with pytest.raises(SystemExit, match=f"--{flags[0][2:]}: .*ROADMAP.md Queue 1 {item}"):
        serve.main(["--synthetic", "--loadgen", "1", "--device", "cpu", *flags])


@pytest.mark.parametrize("flags", [
    ["--replicas", "2"], ["--disaggregate"], ["--journal", "{tmp}/j"], ["--degrade"],
    ["--replicas", "2", "--hedge_frac", "0.1"], ["--replicas", "2", "--stall_wedge_s", "2"],
    ["--pool_recorder_capacity", "8"], ["--slo_latency_p99", "1"], ["--slo_ttft_p99", "1"],
    ["--status_json", "{tmp}/status.json"], ["--replicas", "2", "--inject_fault", "kill-replica@3"],
    ["--no_pool_recorder"], ["--deadline_s", "5"], ["--retries", "3"],
])
def test_serve_runs_the_fleet_flags(flags, tmp_path):
    """The flags of the fleet, the journal, the degrade ladder, the pool's
    recorder and the SLO monitor, which the port once refused, serve
    every request, and the report carries what ran."""
    flags = [f.format(tmp=tmp_path) for f in flags]
    report = serve.main(["--synthetic", "--dim", "32", "--depth", "2", "--image_fmap_size", "4", "--loadgen", "3",
                         "--rate", "50", "--slots", "2", "--block_size", "8", "--device", "cpu", *flags])
    assert report["requests_completed"] == 3 and report["refused_total"] == 0
    if "--replicas" in flags or "--disaggregate" in flags:
        assert report["replicas"] == int(flags[flags.index("--replicas") + 1]) if "--replicas" in flags else 1
        assert report["replicas_lost"] == (1 if "--inject_fault" in flags else 0)
    if "--disaggregate" in flags:
        assert report["handoff_requests"] == 3 and report["handoff_bytes"] > 0
    if "--journal" in flags:
        assert report["journal_acked"] == report["journal_accepted"] == 3
    if "--status_json" in flags:
        assert json.loads((tmp_path / "status.json").read_text())["serving"]["queue_depth"] == 0
    pool = report["pool"]
    assert ("recorder_dropped" in pool) == ("--no_pool_recorder" not in flags)
    if "--pool_recorder_capacity" in flags:  # every event past the ring's 8 dropped the oldest
        events = pool["allocs"] + pool["frees"] + pool["truncates"] + sum(pool["defer_events"].values())
        assert pool["allocs"] == pool["frees"] == 3 and pool["recorder_dropped"] == events - 8


@pytest.mark.parametrize("flags", [
    ["--quantize_weights", "int8"], ["--quantize_weights", "fp8", "--quantize_kv", "int8"],
    ["--quantize_kv", "int8", "--spec_k", "2"], ["--spec_k", "3", "--spec_draft_layers", "1"],
    ["--inject_fault", "flood@3:2"],
])
def test_serve_runs_the_serving_levers(flags, capsys):
    """Quantized weights (with the at-rest reduction printed), the int8
    pool, speculative rounds and the flood drill: every request served,
    the report naming what ran."""
    report = serve.main(["--synthetic", "--dim", "32", "--depth", "2", "--image_fmap_size", "4", "--loadgen", "3",
                         "--rate", "50", "--slots", "4", "--block_size", "8", "--device", "cpu", *flags])
    q = report["quantization"]
    # the flood's synthetic requests are reported apart, as the JAX loadgen reports them
    assert report["requests_completed"] == 3 and report["synthetic_completed"] == report["flood_injected"]
    assert report["quarantined"] == 0
    if "--quantize_weights" in flags:
        kind = flags[flags.index("--quantize_weights") + 1]
        assert q["weight_dtype"] == kind and f"weights quantized to {kind}" in capsys.readouterr().out
    assert q["kv_dtype"] == ("int8" if "--quantize_kv" in flags else "float32")
    if "--spec_k" in flags:
        spec = report["spec"]
        assert spec["rounds"] == report["decode_steps"] and 1.0 <= spec["accepted_tokens_per_round"]
    else:
        assert "spec" not in report


TAMING_YAML = """model:
  params:
    n_embed: 32
    embed_dim: 8
    ddconfig: {ch: 8, ch_mult: [1, 2], num_res_blocks: 1, attn_resolutions: [8], resolution: 16, z_channels: 8}
"""


def _vqgan_models():
    """A DALL-E on a small taming VQGAN (its decoder with attention), seeded."""
    vq_cfg = tvqgan.VQGANConfig(ch=8, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,), resolution=16,
                                z_channels=8, n_embed=32, embed_dim=8)
    vq = tvqgan.init_random_like(vq_cfg, torch.Generator().manual_seed(2), "cpu", decoder_attn=True)
    cfg = tdalle.DALLEConfig(**dict(DALLE, image_fmap_size=8))
    return tdalle.init_dalle(cfg, torch.Generator().manual_seed(3), "cpu"), vq


@pytest.mark.parametrize("flag", ["--vqgan_config_path", "--allow_legacy_pickle"])
def test_serve_takes_the_vae_and_format_flags(ckpt, tmp_path, flag):
    """`--vqgan_config_path` serves a torch-reference dalle.pt whose VAE is a
    taming VQGAN (its yaml in a flow mapping the port's reader does not
    take refuses; block form below); `--allow_legacy_pickle` serves a v2
    file of the v3 checkpoint's trees.  The PNGs are the in-memory models'
    batch-1 images."""
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("a cat\na red dog\n")
    if flag == "--allow_legacy_pickle":
        trees, meta = checkpoint.load_checkpoint(str(ckpt))
        write_legacy_checkpoint(tmp_path / "v2.npz", trees, meta, fmt=2)
        argv = ["--dalle_path", str(tmp_path / "v2.npz"), flag]
        model, vae = weights.load_dalle_checkpoint(ckpt, "cpu")
    else:
        model, vae = _vqgan_models()
        params = weights.dalle_tree(model.state_dict(), model.cfg)
        write_reference_dalle(tmp_path / "ref.pt", params, model.cfg, "VQGanVAE", None,
                              {f"model.{k}": v for k, v in vae.state_dict().items()})
        (tmp_path / "vq.yaml").write_text(TAMING_YAML)
        with pytest.raises(ValueError, match="outside the yaml subset"):
            serve.main(["--dalle_path", str(tmp_path / "ref.pt"), flag, str(tmp_path / "vq.yaml"), "--prompts",
                        str(prompts), "--device", "cpu"])
        block = TAMING_YAML.replace("    ddconfig: {ch: 8, ch_mult: [1, 2], num_res_blocks: 1, attn_resolutions: "
                                    "[8], resolution: 16, z_channels: 8}\n",
                                    "    ddconfig:\n      ch: 8\n      ch_mult: [1, 2]\n      num_res_blocks: 1\n"
                                    "      attn_resolutions: [8]\n      resolution: 16\n      z_channels: 8\n")
        (tmp_path / "vq.yaml").write_text(block)
        argv = ["--dalle_path", str(tmp_path / "ref.pt"), flag, str(tmp_path / "vq.yaml")]
    out = tmp_path / "out"
    report = serve.main([*argv, "--prompts", str(prompts), "--slots", "2", "--block_size", "8", "--seed", "4",
                         "--outputs_dir", str(out), "--device", "cpu"])
    assert report["requests_completed"] == 2
    for i, prompt in enumerate(("a cat", "a red dog")):
        ids = torch.from_numpy(tokenizer_mod.tokenizer.tokenize(prompt, 12, truncate_text=True))
        images = tsamp.generate_images(model, vae, ids, torch.Generator().manual_seed(4 + i), filter_thres=0.9)
        want = (np.clip(vae_registry.to_display(vae.cfg, images).numpy()[0], 0, 1) * 255).astype(np.uint8)
        np.testing.assert_array_equal(png.read_png(out / prompt.replace(" ", "_") / "0.png"), want)


def test_serve_needs_a_model_and_traffic():
    with pytest.raises(SystemExit, match="--loadgen N or --prompts FILE"):
        serve.main(["--synthetic", "--device", "cpu"])
    with pytest.raises(SystemExit, match="--dalle_path or --synthetic"):
        serve.main(["--loadgen", "1", "--device", "cpu"])
