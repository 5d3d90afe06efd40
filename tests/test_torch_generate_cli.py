"""The port's generate CLI and its loader, on the CPU: a v3 checkpoint that
the JAX package writes loads through the port's `weights.load_dalle_checkpoint`, and
`cli.generate.main` writes the JAX CLI's directories and file names, PNGs
that decode (with zlib and struct, in this file) to the pixels the JAX package's
`to_display` gives for the same images; a torch-reference dalle.pt, a
VQGanVAE checkpoint and a v2 file generate through their flags."""
import os
import struct
import sys
import zipfile
import zlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from dalle_pytorch_tpu.models import dalle as jdalle  # noqa: E402
from dalle_pytorch_tpu.models import transformer as jtransformer  # noqa: E402
from dalle_pytorch_tpu.models import vae as jvae  # noqa: E402
from dalle_pytorch_tpu.models import vae_registry as jregistry  # noqa: E402
from dalle_pytorch_tpu.models import vqgan as jvqgan  # noqa: E402
from dalle_pytorch_tpu.training.checkpoint import save_checkpoint as jax_save_checkpoint  # noqa: E402
from dalle_pytorch_tpu_torch import weights  # noqa: E402
from dalle_pytorch_tpu_torch.cli import png  # noqa: E402
from dalle_pytorch_tpu_torch.cli import generate as cli  # noqa: E402
from dalle_pytorch_tpu_torch.data import tokenizer as tokenizer_mod  # noqa: E402
from dalle_pytorch_tpu_torch.models import sampling as tsamp  # noqa: E402
from dalle_pytorch_tpu_torch.models import dalle as tdalle  # noqa: E402
from dalle_pytorch_tpu_torch.models import vae as tvae  # noqa: E402
from dalle_pytorch_tpu_torch.models import vae_registry  # noqa: E402
from taming_fixture import make_taming_state_dict  # noqa: E402
from torch_port_refs import reference_vae_state_dict, write_legacy_checkpoint, write_reference_dalle  # noqa: E402

DALLE = dict(dim=32, depth=2, heads=2, dim_head=16, num_text_tokens=49408, text_seq_len=12, num_image_tokens=32,
             image_fmap_size=4, shift_tokens=True, attn_types=("full", "axial_row"))
VAE = dict(image_size=16, num_tokens=32, codebook_dim=16, num_layers=2, hidden_dim=8)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _write(path, params, vae_params, version="0.1.0"):
    jax_save_checkpoint(str(path), {"weights": params, "vae_weights": vae_params},
                        {"hparams": jdalle.DALLEConfig(**DALLE).to_dict(),
                         "vae_params": jvae.DiscreteVAEConfig(**VAE).to_dict(),
                         "vae_class_name": "DiscreteVAE", "version": version})


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    params = jax.device_get(jdalle.init_dalle(jax.random.PRNGKey(0), jdalle.DALLEConfig(**DALLE)))
    vae_params = jax.device_get(jvae.init_discrete_vae(jax.random.PRNGKey(1), jvae.DiscreteVAEConfig(**VAE)))
    path = tmp_path_factory.mktemp("ckpt") / "dalle.pt"
    _write(path, params, vae_params)
    return path, params, vae_params


def _leaves_equal(got, want):
    got_leaves, got_def = jax.tree_util.tree_flatten(jax.tree_util.tree_map(np.asarray, got))
    want_leaves, want_def = jax.tree_util.tree_flatten(want)
    assert got_def == want_def
    for g, w in zip(got_leaves, want_leaves):
        np.testing.assert_array_equal(g, np.asarray(w))


def _state_dicts_equal(got, want):
    want_sd = want.state_dict()
    assert got.state_dict().keys() == want_sd.keys()
    for name, value in got.state_dict().items():
        assert torch.equal(value, want_sd[name]), name


def test_jax_checkpoint_loads_through_the_port_loader(checkpoint, capsys):
    path, params, vae_params = checkpoint
    model, vae = weights.load_dalle_checkpoint(path, "cpu")
    assert model.cfg.to_dict() == {k: v for k, v in jdalle.DALLEConfig(**DALLE).to_dict().items()
                                   if k in model.cfg.to_dict()}
    assert vae.cfg.to_dict() == jvae.DiscreteVAEConfig(**VAE).to_dict()
    _state_dicts_equal(model, weights.load_dalle(params, model.cfg, "cpu"))
    _state_dicts_equal(vae, weights.load_vae(vae_params, vae.cfg, "cpu"))
    assert "note:" not in capsys.readouterr().out


def test_old_transformer_layout_is_migrated(checkpoint, tmp_path, capsys):
    """A tree in the pre-round-5 layout ([q|k|v]-blocked qkv, one GEGLU
    matrix) loads into the same model as the current one, as the JAX
    `migrate_param_layout` migrates it; a version other than the port's is
    noted."""
    _, params, vae_params = checkpoint
    h, dh = DALLE["heads"], DALLE["dim_head"]
    old = dict(params["transformer"])
    old["shared_attn"] = {aid: {**a, "qkv": {"w": np.asarray(a["qkv"]["w"]).reshape(-1, h, 3, dh)
                                             .transpose(0, 2, 1, 3).reshape(-1, 3 * h * dh)}}
                          for aid, a in params["transformer"]["shared_attn"].items()}
    old["shared_ff"] = {fid: {"w1": {k: np.concatenate([np.asarray(f["w1"][k]), np.asarray(f["w1g"][k])], axis=-1)
                                     for k in ("w", "b")}, "w2": f["w2"]}
                        for fid, f in params["transformer"]["shared_ff"].items()}
    migrated = jtransformer.migrate_transformer_layout(old, h, dh)
    _leaves_equal(weights.migrate_transformer_layout(old, h, dh), migrated)
    _write(tmp_path / "old.pt", {**params, "transformer": old}, vae_params, version="0.0.9")
    model, _ = weights.load_dalle_checkpoint(tmp_path / "old.pt", "cpu")
    assert "note: checkpoint version 0.0.9" in capsys.readouterr().out
    _state_dicts_equal(model, weights.load_dalle(params, model.cfg, "cpu"))


def test_other_formats_exit_with_what_they_need(checkpoint, tmp_path):
    """An orbax directory exits naming its item; a torch-reference dalle.pt
    (the same weights, written by `tests/torch_port_refs.py`) loads to the
    v3 checkpoint's models."""
    (tmp_path / "sharded" / "state").mkdir(parents=True)
    with pytest.raises(SystemExit, match="orbax sharded checkpoint.*Queue 1 item 8"):
        weights.load_dalle_checkpoint(tmp_path / "sharded", "cpu")
    path, params, vae_params = checkpoint
    cfg = tdalle.DALLEConfig(**DALLE)
    write_reference_dalle(tmp_path / "ref.pt", params, cfg, "DiscreteVAE", VAE,
                          reference_vae_state_dict(vae_params, tvae.DiscreteVAEConfig(**VAE)))
    with zipfile.ZipFile(tmp_path / "ref.pt") as z:
        assert any(name.endswith("data.pkl") for name in z.namelist())
    model, vae = weights.load_dalle_checkpoint(tmp_path / "ref.pt", "cpu")
    want_model, want_vae = weights.load_dalle_checkpoint(path, "cpu")
    _state_dicts_equal(model, want_model)
    _state_dicts_equal(vae, want_vae)
    with pytest.raises(SystemExit, match="does not exist"):
        weights.load_dalle_checkpoint(tmp_path / "missing.pt", "cpu")


def decode_png(path):
    """PNG -> uint8 array with zlib and struct alone (8-bit, filter 0)."""
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        assert struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0] == zlib.crc32(tag + body)
        chunks.setdefault(tag, []).append(body)
        pos += 12 + n
    w, h, depth, color, comp, filt, interlace = struct.unpack(">IIBBBBB", chunks[b"IHDR"][0])
    assert (depth, comp, filt, interlace) == (8, 0, 0, 0) and b"IEND" in chunks
    c = {0: 1, 2: 3, 6: 4}[color]
    rows = np.frombuffer(zlib.decompress(b"".join(chunks[b"IDAT"])), np.uint8).reshape(h, 1 + w * c)
    assert not rows[:, 0].any()
    return rows[:, 1:].reshape(h, w, c).squeeze(-1) if c == 1 else rows[:, 1:].reshape(h, w, c)


def test_cli_writes_the_jax_directories_and_pixels(checkpoint, tmp_path, capsys):
    path, _, _ = checkpoint
    out = tmp_path / "out"
    timings = {}
    paths = cli.main(["--dalle_path", str(path), "--text", "a cat | a red dog", "--num_images", "3",
                      "--batch_size", "2", "--outputs_dir", str(out), "--seed", "5", "--cond_scale", "2.0",
                      "--device", "cpu"], timings=timings)
    assert sorted(p.relative_to(out).as_posix() for p in paths) == [
        "a_cat/0.png", "a_cat/1.png", "a_cat/2.png", "a_red_dog/0.png", "a_red_dog/1.png", "a_red_dog/2.png"]
    assert sorted(os.listdir(out)) == ["a_cat", "a_red_dog"]
    assert "created 3 images at" in capsys.readouterr().out
    assert set(timings) == {"load_s", "tokenize_s", "prefill_s", "decode_s", "vae_s", "png_s"}

    # the same draws, then the JAX package's pixel conversion
    model, vae = weights.load_dalle_checkpoint(path, "cpu")
    vae_cfg = vae.cfg
    gen = torch.Generator().manual_seed(5)
    jvae_cfg = jvae.DiscreteVAEConfig(**VAE)
    tok = tokenizer_mod.tokenizer
    try:
        from PIL import Image
    except ImportError:
        Image = None
    for prompt in ("a cat", "a red dog"):
        ids = torch.from_numpy(np.repeat(tok.tokenize(prompt, 12, truncate_text=True), 3, axis=0))
        images = torch.cat([tsamp.generate_images(model, vae, ids[i:i + 2], gen, filter_thres=0.9, cond_scale=2.0)
                            for i in (0, 2)])
        np.testing.assert_array_equal(vae_registry.to_display(vae_cfg, images).numpy(),
                                      np.asarray(jregistry.to_display(jvae_cfg, images.numpy())))
        display = np.asarray(jregistry.to_display(jvae_cfg, images.numpy()))
        for i, img in enumerate(display):
            want = (np.clip(img, 0, 1) * 255).astype(np.uint8)
            got = decode_png(out / prompt.replace(" ", "_") / f"{i}.png")
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(png.read_png(out / prompt.replace(" ", "_") / f"{i}.png"), want)
            if Image is not None:
                np.testing.assert_array_equal(np.asarray(Image.open(out / prompt.replace(" ", "_") / f"{i}.png")),
                                              want)


def test_cli_gentxt_names_the_directory_after_the_completion(checkpoint, tmp_path, capsys):
    path, _, _ = checkpoint
    out = tmp_path / "out"
    paths = cli.main(["--dalle_path", str(path), "--text", "a photo", "--num_images", "1", "--gentxt",
                      "--outputs_dir", str(out), "--seed", "2", "--device", "cpu"])
    model, _ = weights.load_dalle_checkpoint(path, "cpu")
    dalle_cfg = model.cfg
    tok = tokenizer_mod.tokenizer
    completed = tsamp.generate_texts(model, torch.from_numpy(tok.tokenize("a photo", 12)[:, :2]),
                                     torch.Generator().manual_seed(2))
    pads = set(range(dalle_cfg.num_text_tokens_padded - 12, dalle_cfg.num_text_tokens_padded))
    text = tok.decode(completed[0].numpy(), pad_tokens=pads)
    assert text.startswith("a photo ")
    assert f"completed text: {text}" in capsys.readouterr().out
    assert paths == [out / text.replace(" ", "_")[:100] / "0.png"] and paths[0].exists()


@pytest.mark.parametrize("flags", [
    ["--spec_k", "2"], ["--spec_k", "2", "--engine"], ["--spec_k", "3", "--spec_draft_layers", "1"],
    ["--spec_k", "3", "--spec_draft_layers", "1", "--engine"], ["--spec_k", "1", "--engine", "--engine_slots", "8"],
])
def test_spec_flags_give_the_images_of_the_run_without_them(checkpoint, tmp_path, flags):
    """`--spec_k` through `generate_images` and through `--engine`: the PNGs
    of the same run without it (speculation keeps every code)."""
    path, _, _ = checkpoint
    run = ["--dalle_path", str(path), "--text", "a cat|a dog", "--num_images", "2", "--batch_size", "2",
           "--cond_scale", "2.0", "--seed", "4", "--engine_block_size", "8", "--device", "cpu"]
    engine = ["--engine"] if "--engine" in flags else []
    timings = {}
    spec = cli.main(run + flags + ["--outputs_dir", str(tmp_path / "spec")], timings=timings)
    plain = cli.main(run + engine + ["--outputs_dir", str(tmp_path / "plain")])
    assert [p.relative_to(tmp_path / "spec") for p in spec] == [p.relative_to(tmp_path / "plain") for p in plain]
    for a, b in zip(spec, plain):
        np.testing.assert_array_equal(png.read_png(a), png.read_png(b))
    if not engine:
        assert 2 <= timings["spec_rounds"] < 2 * 15  # two chunks of 16 codes, more than one a round
    with pytest.raises(ValueError, match="too large for image_fmap_size"):
        cli.main(run + engine + ["--spec_k", "4", "--outputs_dir", str(tmp_path / "refused")])


TAMING = dict(ch=8, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,), resolution=16, z_channels=8,
              n_embed=32, embed_dim=8)
VQ_DALLE = dict(DALLE, image_fmap_size=8)


@pytest.fixture(scope="module")
def vqgan_files(tmp_path_factory):
    """A DALL-E on a small taming VQGAN as a v3 checkpoint (written by the
    JAX package) and as a torch-reference dalle.pt with its yaml."""
    root = tmp_path_factory.mktemp("vqgan")
    vq = jvqgan.VQGANConfig(**TAMING)
    state = make_taming_state_dict(vq, np.random.RandomState(2))
    jcfg = jdalle.DALLEConfig(**VQ_DALLE)
    params = jax.device_get(jdalle.init_dalle(jax.random.PRNGKey(3), jcfg))
    jax_save_checkpoint(str(root / "v3.pt"), {"weights": params,
                                              "vae_weights": jvqgan.convert_taming_state_dict(state, vq)},
                        {"hparams": jcfg.to_dict(), "vae_params": vq.to_dict(), "vae_class_name": "VQGanVAE",
                         "version": "0.1.0"})
    write_reference_dalle(root / "ref.pt", params, tdalle.DALLEConfig(**VQ_DALLE), "VQGanVAE", None,
                          {f"model.{k}": torch.from_numpy(v) for k, v in state.items()})
    (root / "vq.yaml").write_text("""model:
  params:
    n_embed: 32
    embed_dim: 8
    ddconfig:
      ch: 8
      ch_mult: [1, 2]
      num_res_blocks: 1
      attn_resolutions: [8]
      resolution: 16
      z_channels: 8
""")
    return root


@pytest.mark.parametrize("flag", ["--taming", "--vqgan_config_path", "--allow_legacy_pickle"])
def test_the_vae_and_format_flags_generate(checkpoint, vqgan_files, tmp_path, flag):
    """What the item-5 flags waited for: `--taming` on a v3 checkpoint whose
    VAE is a VQGanVAE, `--vqgan_config_path` on a torch-reference VQGanVAE
    dalle.pt, `--allow_legacy_pickle` on a v2 file.  Each writes the PNGs of
    the same draws through the loaded models; the two VQGAN files give one
    run's pixels, and the v2 file the v3 checkpoint's."""
    common = ["--text", "a cat", "--num_images", "2", "--batch_size", "2", "--seed", "7", "--device", "cpu"]
    if flag == "--allow_legacy_pickle":
        path, params, vae_params = checkpoint
        meta = {"hparams": jdalle.DALLEConfig(**DALLE).to_dict(), "vae_params": jvae.DiscreteVAEConfig(**VAE).to_dict(),
                "vae_class_name": "DiscreteVAE", "version": "0.0.5"}
        write_legacy_checkpoint(tmp_path / "v2.npz", {"weights": params, "vae_weights": vae_params}, meta, fmt=2)
        argv, want_from = ["--dalle_path", str(tmp_path / "v2.npz"), flag], path
    elif flag == "--taming":
        argv, want_from = ["--dalle_path", str(vqgan_files / "v3.pt"), "--taming"], vqgan_files / "v3.pt"
    else:
        argv = ["--dalle_path", str(vqgan_files / "ref.pt"), flag, str(vqgan_files / "vq.yaml"), "--taming",
                "--vqgan_model_path", "unused.ckpt"]
        want_from = vqgan_files / "v3.pt"
    paths = cli.main([*argv, *common, "--outputs_dir", str(tmp_path / "out")])
    assert [p.name for p in paths] == ["0.png", "1.png"]
    model, vae = weights.load_dalle_checkpoint(want_from, "cpu")
    ids = torch.from_numpy(np.repeat(tokenizer_mod.tokenizer.tokenize("a cat", 12, truncate_text=True), 2, axis=0))
    images = tsamp.generate_images(model, vae, ids, torch.Generator().manual_seed(7), filter_thres=0.9)
    want = (np.clip(vae_registry.to_display(vae.cfg, images).numpy(), 0, 1) * 255).astype(np.uint8)
    for i, p in enumerate(paths):
        np.testing.assert_array_equal(png.read_png(p), want[i])


def test_cli_needs_a_card_unless_asked_for_the_cpu(checkpoint, monkeypatch):
    path, _, _ = checkpoint
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--dalle_path", str(path), "--text", "a"])


def test_tokenizer_adapters_exit_without_their_package(checkpoint, monkeypatch):
    path, _, _ = checkpoint
    monkeypatch.setitem(sys.modules, "tokenizers", None)
    with pytest.raises(SystemExit, match="--hug: HugTokenizer needs the tokenizers package"):
        cli.main(["--dalle_path", str(path), "--text", "a", "--hug", "--bpe_path", "v.json", "--device", "cpu"])


@pytest.mark.parametrize("shape", [(5, 7), (5, 7, 3), (5, 7, 4)])
def test_png_round_trips(tmp_path, shape):
    pixels = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    png.write_png(tmp_path / "x.png", pixels)
    np.testing.assert_array_equal(decode_png(tmp_path / "x.png"), pixels)
    np.testing.assert_array_equal(png.read_png(tmp_path / "x.png"), pixels)
    with pytest.raises(ValueError):
        png.encode_png(np.zeros((2, 2, 2), np.uint8))
    with pytest.raises(TypeError):
        png.encode_png(np.zeros((2, 2), np.float32))
