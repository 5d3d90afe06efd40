"""The port's pretrained-VAE flow (`models/pretrained.py`) on the CPU, with
injected fetchers (no network): fetch once then the cache, the convert-once
v3 file (and one the JAX package wrote, read with no fetch), the taming
default download, the custom-path contract; the taming yaml reader against
`yaml.safe_load` on published configs' text; the restricted unpickler on a
Lightning-style `.ckpt` and a pickled-module `.pkl` whose classes come from
modules absent at load time, and on hostile globals."""
import io
import pickle
import sys
import types
import zipfile

import numpy as np
import pytest
import torch

yaml = pytest.importorskip("yaml")
jax = pytest.importorskip("jax")

from dalle_pytorch_tpu.models import openai_vae as jovae  # noqa: E402
from dalle_pytorch_tpu.models import pretrained as jpretrained  # noqa: E402
from dalle_pytorch_tpu.models import vqgan as jvqgan  # noqa: E402
from dalle_pytorch_tpu_torch.models import openai_vae as tovae  # noqa: E402
from dalle_pytorch_tpu_torch.models import pretrained  # noqa: E402
from dalle_pytorch_tpu_torch.models import vqgan as tvqgan  # noqa: E402
from taming_fixture import make_taming_state_dict  # noqa: E402

SMALL = dict(ch=8, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,), resolution=16, z_channels=8,
             n_embed=32, embed_dim=8)


def make_fetcher(payload=b"weights", log=None):
    log = log if log is not None else []

    def fetch(url, dst):
        log.append(url)
        with open(dst, "wb") as f:
            f.write(payload if not callable(payload) else payload(url))

    fetch.log = log
    return fetch


def refuse_fetch(url, dst):
    raise AssertionError(f"fetched {url}")


def test_download_fetches_once_then_reads_the_cache(tmp_path):
    fetch = make_fetcher()
    p1 = pretrained.download("http://x/enc.pkl", root=tmp_path, fetcher=fetch)
    p2 = pretrained.download("http://x/enc.pkl", root=tmp_path, fetcher=fetch)
    assert p1 == p2 == tmp_path / "enc.pkl" and p1.read_bytes() == b"weights"
    assert fetch.log == ["http://x/enc.pkl"]
    assert pretrained.download("http://x/ckpt?dl=1", root=tmp_path, fetcher=fetch).name == "ckpt"
    assert pretrained.download("http://x/ckpt?dl=1", "model.ckpt", root=tmp_path, fetcher=fetch).name == "model.ckpt"
    (tmp_path / "dir.pkl").mkdir()
    with pytest.raises(RuntimeError, match="not a regular file"):
        pretrained.download("http://x/dir.pkl", root=tmp_path, fetcher=fetch)


def test_default_cache_is_the_jax_packages(tmp_path, monkeypatch):
    monkeypatch.setenv("DALLE_PYTORCH_TPU_CACHE", str(tmp_path))
    assert pretrained.default_cache_dir() == jpretrained.default_cache_dir() == tmp_path


TINY = {"encoder": {"w": np.ones((2, 2), np.float32)}, "decoder": {"b": np.arange(3, dtype=np.float32)}}


def test_openai_pretrained_converts_once(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(tovae, "load_openai_vae", lambda e, d: calls.append((e, d)) or TINY)
    fetch = make_fetcher()
    params, cfg = pretrained.load_openai_vae_pretrained(cache_dir=tmp_path, fetcher=fetch)
    assert isinstance(cfg, tovae.OpenAIVAEConfig)
    np.testing.assert_array_equal(params["encoder"]["w"].numpy(), TINY["encoder"]["w"])
    assert len(fetch.log) == 2 and len(calls) == 1 and (tmp_path / "openai_vae_converted.npz").exists()
    params, _ = pretrained.load_openai_vae_pretrained(cache_dir=tmp_path, fetcher=refuse_fetch)
    np.testing.assert_array_equal(params["decoder"]["b"].numpy(), TINY["decoder"]["b"])
    assert len(calls) == 1
    # a torn cache is converted again, from the pickles already fetched
    (tmp_path / "openai_vae_converted.npz").write_bytes(b"torn")
    pretrained.load_openai_vae_pretrained(cache_dir=tmp_path, fetcher=refuse_fetch)
    assert len(calls) == 2


def test_a_cache_the_jax_package_converted_is_read_with_no_fetch(tmp_path, monkeypatch):
    monkeypatch.setattr(jovae, "load_openai_vae", lambda e, d: TINY)
    jpretrained.load_openai_vae_pretrained(cache_dir=tmp_path, fetcher=make_fetcher(), backend=None)
    params, _ = pretrained.load_openai_vae_pretrained(cache_dir=tmp_path, fetcher=refuse_fetch)
    np.testing.assert_array_equal(params["encoder"]["w"].numpy(), TINY["encoder"]["w"])


def _taming_blobs(tmp_path, cfg):
    ckpt_file = tmp_path / "blob.ckpt"
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in make_taming_state_dict(cfg).items()}},
               str(ckpt_file))
    config = yaml.safe_dump({"model": {"params": {
        "n_embed": 32, "embed_dim": 8,
        "ddconfig": {"ch": 8, "ch_mult": [1, 2], "num_res_blocks": 1, "attn_resolutions": [8], "in_channels": 3,
                     "out_ch": 3, "resolution": 16, "z_channels": 8}}}})
    return {pretrained.VQGAN_VAE_URL: ckpt_file.read_bytes(), pretrained.VQGAN_VAE_CONFIG_URL: config.encode()}


def test_vqgan_pretrained_default_download_then_cache(tmp_path):
    jcfg = jvqgan.VQGANConfig(**SMALL)
    blobs = _taming_blobs(tmp_path, jcfg)
    fetch = make_fetcher(lambda url: blobs[url])
    cache = tmp_path / "cache"
    params, cfg = pretrained.load_vqgan_pretrained(cache_dir=cache, fetcher=fetch)
    assert cfg == tvqgan.VQGANConfig(**SMALL) and len(fetch.log) == 2
    assert (cache / pretrained.VQGAN_FILENAME).exists() and (cache / pretrained.VQGAN_CONFIG_FILENAME).exists()
    want = jvqgan.convert_taming_state_dict(make_taming_state_dict(jcfg), jcfg)
    np.testing.assert_array_equal(params["codebook"]["table"].numpy(), want["codebook"]["table"])
    params2, cfg2 = pretrained.load_vqgan_pretrained(cache_dir=cache, fetcher=refuse_fetch)
    assert cfg2 == cfg
    np.testing.assert_array_equal(params2["conv_in"]["w"].numpy(), want["conv_in"]["w"])


def test_vqgan_custom_paths(tmp_path):
    jcfg = jvqgan.VQGANConfig(**SMALL)
    blobs = _taming_blobs(tmp_path, jcfg)
    (tmp_path / "m.ckpt").write_bytes(blobs[pretrained.VQGAN_VAE_URL])
    (tmp_path / "m.yaml").write_bytes(blobs[pretrained.VQGAN_VAE_CONFIG_URL])
    with pytest.raises(ValueError, match="requires its vqgan_config_path"):
        pretrained.load_vqgan_pretrained(str(tmp_path / "m.ckpt"), fetcher=refuse_fetch)
    params, cfg = pretrained.load_vqgan_pretrained(str(tmp_path / "m.ckpt"), str(tmp_path / "m.yaml"),
                                                   fetcher=refuse_fetch)
    ref_params, ref_cfg = jvqgan.load_vqgan(str(tmp_path / "m.ckpt"), jpretrained.parse_taming_yaml(
        str(tmp_path / "m.yaml")))
    assert cfg.to_dict() == ref_cfg.to_dict()
    np.testing.assert_array_equal(params["down"][0]["blocks"][0]["conv1"]["w"],
                                  ref_params["down"][0]["blocks"][0]["conv1"]["w"])


# ---------------------------------------------------------------------------
# the taming yaml subset
# ---------------------------------------------------------------------------

VQGAN_F16_16384 = """model:
  base_learning_rate: 4.5e-06
  target: taming.models.vqgan.VQModel
  params:
    embed_dim: 256
    n_embed: 16384
    monitor: val/rec_loss
    ddconfig:
      double_z: false
      z_channels: 256
      resolution: 256
      in_channels: 3
      out_ch: 3
      ch: 128
      ch_mult:
      - 1
      - 1
      - 2
      - 2
      - 4
      num_res_blocks: 2
      attn_resolutions:
      - 16
      dropout: 0.0
    lossconfig:
      target: taming.modules.losses.vqperceptual.VQLPIPSWithDiscriminator
      params:
        disc_conditional: false
        disc_in_channels: 3
        disc_start: 0
        disc_weight: 0.75
        disc_num_layers: 2
        codebook_weight: 1.0
data:
  target: main.DataModuleFromConfig
  params:
    batch_size: 3
    num_workers: 8
    train:
      target: taming.data.imagenet.ImageNetTrain
      params:
        config:
          size: 256
    validation:
      target: taming.data.imagenet.ImageNetValidation
      params:
        config:
          size: 256
"""

VQGAN_F16_1024 = """model:
  base_learning_rate: 4.5e-06
  target: taming.models.vqgan.VQModel
  params:
    embed_dim: 256
    n_embed: 1024
    ddconfig:
      double_z: false
      z_channels: 256
      resolution: 256
      in_channels: 3
      out_ch: 3
      ch: 128
      ch_mult:
      - 1
      - 1
      - 2
      - 2
      - 4
      num_res_blocks: 2
      attn_resolutions:
      - 16
      dropout: 0.0
    lossconfig:
      target: taming.modules.losses.DummyLoss
"""

GUMBEL_F8 = """model:
  base_learning_rate: 4.5e-06
  target: taming.models.vqgan.GumbelVQ
  params:
    kl_weight: 1.0e-08
    embed_dim: 256
    n_embed: 8192
    monitor: val/rec_loss
    temperature_scheduler_config:
      target: taming.lr_scheduler.LambdaWarmUpCosineScheduler
      params:
        warm_up_steps: 0
        max_decay_steps: 1000001
        lr_start: 0.9
        lr_max: 0.9
        lr_min: 1.0e-06
    ddconfig:
      double_z: false
      z_channels: 256
      resolution: 256
      in_channels: 3
      out_ch: 3
      ch: 128
      ch_mult: [1, 1, 2, 4]
      num_res_blocks: 2
      attn_resolutions: [32]
      dropout: 0.0
    lossconfig:
      target: taming.modules.losses.vqperceptual.DummyLoss
"""

# comments, quoting, YAML 1.1 scalars PyYAML resolves (1e-6 without a dot
# stays a string), null forms, empty flow sequences, a sequence indented
# under its key
ODDITIES = """# a leading comment
model:   # trailing comment
  name: 'it''s quoted'   # a comment after a quoted scalar
  other: "double # not a comment"
  yes_word: yes
  off_word: Off
  tilde: ~
  nothing:
  empty: []
  small: 1e-6
  smaller: 1.5e-7
  negative: -3
  positive: +4
  under_score: 1_000
  dotted: .5
  url: http://example.com/a?b=c
  list:
    - 1.0
    - two
    - false
  flow: [a, 2, 3.5, null]
"""


@pytest.mark.parametrize("text", [VQGAN_F16_16384, VQGAN_F16_1024, GUMBEL_F8, ODDITIES],
                         ids=["f16_16384", "f16_1024", "gumbel_f8", "oddities"])
def test_yaml_reader_equals_safe_load(text, tmp_path):
    assert pretrained.load_yaml(text) == yaml.safe_load(text)
    (tmp_path / "c.yaml").write_text(text)
    assert pretrained.parse_taming_yaml(str(tmp_path / "c.yaml")) == jpretrained.parse_taming_yaml(
        str(tmp_path / "c.yaml"))


def test_the_published_geometry_from_its_yaml():
    config = pretrained.load_yaml(VQGAN_F16_16384)["model"]
    cfg = tvqgan.config_from_taming_dict(config, {"quantize.embedding.weight": None})
    assert cfg == tvqgan.VQGANConfig(n_embed=16384) and cfg.fmap_size == 16


@pytest.mark.parametrize("text", ["a: {b: 1}", "a: &x 1", "a: |\n  text", "- a: 1", "a:\n\tb: 1", "a: [[1]]",
                                  "a: 1\n   b: 2", "a: 'open"])
def test_yaml_reader_raises_outside_its_subset(text):
    with pytest.raises(pretrained.YamlSubsetError):
        pretrained.load_yaml(text)


# ---------------------------------------------------------------------------
# the restricted unpickler
# ---------------------------------------------------------------------------


def _absent_module(name, monkeypatch, source):
    """A module importable while the file is written, absent when it is read."""
    module = types.ModuleType(name)
    exec(source, module.__dict__)
    monkeypatch.setitem(sys.modules, name, module)
    return module


LIGHTNING = """
class AttributeDict(dict):
    pass

class ModelCheckpoint:
    def __init__(self):
        self.best = 1.5
"""

DALL_E = """
import torch, torch.nn as nn

class Conv2d(nn.Module):
    def __init__(self, n_in, n_out, kw):
        super().__init__()
        self.w = nn.Parameter(torch.randn(n_out, n_in, kw, kw))
        self.b = nn.Parameter(torch.zeros(n_out))
        self.kw = kw
        self.device = torch.device("cpu")

class Encoder(nn.Module):
    def __init__(self):
        super().__init__()
        self.blocks = nn.Sequential()
        self.blocks.add_module("input", Conv2d(3, 4, 7))
        self.blocks.add_module("relu", nn.ReLU())
        self.blocks.add_module("output", nn.Sequential())
        self.blocks.output.add_module("conv", Conv2d(4, 8, 1))
        self.register_buffer("steps", torch.tensor(3))
        self.n_hid = 4
"""


def test_a_lightning_checkpoint_whose_classes_are_absent(tmp_path, monkeypatch):
    lightning = _absent_module("fake_lightning", monkeypatch, LIGHTNING)
    state = {"encoder.conv_in.weight": torch.randn(2, 3, 3, 3), "quantize.embedding.weight": torch.randn(4, 2)}
    hyper = lightning.AttributeDict(ddconfig={"ch": 8})
    torch.save({"state_dict": state, "hyper_parameters": hyper, "callbacks": {"ckpt": lightning.ModelCheckpoint()},
                "epoch": 3}, str(tmp_path / "m.ckpt"))
    monkeypatch.delitem(sys.modules, "fake_lightning")
    with pytest.raises(pickle.UnpicklingError):
        torch.load(str(tmp_path / "m.ckpt"), weights_only=True)
    obj = pretrained.load_torch_file(tmp_path / "m.ckpt")
    assert isinstance(obj["callbacks"]["ckpt"], pretrained.Stub) and obj["callbacks"]["ckpt"].best == 1.5
    got = pretrained.state_dict_of(obj)
    assert set(got) == set(state)
    for key in state:
        torch.testing.assert_close(got[key], state[key], rtol=0, atol=0)


def test_a_pickled_module_whose_package_is_absent(tmp_path, monkeypatch):
    dall_e = _absent_module("fake_dall_e", monkeypatch, DALL_E)
    torch.manual_seed(0)
    enc = dall_e.Encoder()
    want = enc.state_dict()
    torch.save(enc, str(tmp_path / "encoder.pkl"))
    monkeypatch.delitem(sys.modules, "fake_dall_e")
    got = pretrained.state_dict_of(pretrained.load_torch_file(tmp_path / "encoder.pkl"))
    assert set(got) == set(want) == {"blocks.input.w", "blocks.input.b", "blocks.output.conv.w",
                                     "blocks.output.conv.b", "steps"}
    for key in want:
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0)


class _Hostile:
    def __init__(self, marker):
        self.marker = marker

    def __reduce__(self):
        import os

        return os.system, (f"touch {self.marker}",)


@pytest.mark.parametrize("layout", ["zip", "raw"])
def test_a_hostile_global_is_refused_and_never_called(tmp_path, layout):
    marker = tmp_path / "ran"
    payload = pickle.dumps({"state_dict": _Hostile(marker)}, protocol=2)
    path = tmp_path / "evil.ckpt"
    if layout == "zip":
        with zipfile.ZipFile(path, "w") as z:
            z.writestr("evil/data.pkl", payload)
            z.writestr("evil/version", "3\n")
    else:
        buf = io.BytesIO()
        pickle.dump(0x1950A86A20F9469CFC6C, buf, protocol=2)  # torch's legacy magic number
        path.write_bytes(buf.getvalue() + payload)
    with pytest.raises(pickle.UnpicklingError, match="posix.system|os.system|not on the allow-list"):
        pretrained.load_torch_file(path)
    assert not marker.exists()
