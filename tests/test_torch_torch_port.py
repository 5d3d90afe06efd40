"""Checkpoints of the original torch implementation through the port's
`models/torch_port.py`, on the CPU.  `tests/torch_port_refs.py` writes the
reference's state dicts from a JAX tree (the inverse of the converters);
the port's converter and the JAX package's give equal trees for
sequential, reversible and shared-id configs (sandwich norms, tied
embeddings, learned positions), the loaded models' logits agree within
1e-4, and whole `dalle.pt` / `vae.pt` files load with each VAE family."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
yaml = pytest.importorskip("yaml")
import jax.numpy as jnp  # noqa: E402

from dalle_pytorch_tpu.models import dalle as jdalle  # noqa: E402
from dalle_pytorch_tpu.models import torch_port as jport  # noqa: E402
from dalle_pytorch_tpu.models import vae as jvae  # noqa: E402
from dalle_pytorch_tpu.models import vqgan as jvqgan  # noqa: E402
from dalle_pytorch_tpu_torch import weights  # noqa: E402
from dalle_pytorch_tpu_torch.cli.common import load_dalle_bundle  # noqa: E402
from dalle_pytorch_tpu_torch.models import dalle as tdalle  # noqa: E402
from dalle_pytorch_tpu_torch.models import torch_port as tport  # noqa: E402
from dalle_pytorch_tpu_torch.models import vae as tvae  # noqa: E402
from taming_fixture import make_taming_state_dict  # noqa: E402
from torch_port_refs import reference_dalle_state_dict, reference_vae_state_dict, write_reference_dalle  # noqa: E402

BASE = dict(dim=32, depth=4, heads=2, dim_head=16, num_text_tokens=30, text_seq_len=7, num_image_tokens=16,
            image_fmap_size=3)
CASES = {
    "sequential": dict(rotary_emb=False, attn_types=("full", "axial_row")),
    "reversible": dict(reversible=True, shift_tokens=True),
    "shared_sandwich_tied": dict(shared_attn_ids=(0, 1, 0, 1), shared_ff_ids=(0, 0, 1, 1), sandwich_norm=True,
                                 stable=True, share_input_output_emb=True, rotary_emb=False),
}
VAE = dict(image_size=16, num_tokens=16, codebook_dim=8, num_layers=2, hidden_dim=8, num_resnet_blocks=1)


def _same(port, ref):
    if isinstance(ref, dict):
        assert set(port) == set(ref), (sorted(port), sorted(ref))
        for k in ref:
            _same(port[k], ref[k])
    elif isinstance(ref, (list, tuple)):
        assert len(port) == len(ref)
        for p, r in zip(port, ref):
            _same(p, r)
    else:
        np.testing.assert_array_equal(np.asarray(port), np.asarray(ref))


def _dalle(case, seed=0):
    kw = dict(BASE, **CASES[case])
    jcfg = jdalle.DALLEConfig(**kw)
    return jcfg, tdalle.DALLEConfig(**kw), jax.device_get(jdalle.init_dalle(jax.random.PRNGKey(seed), jcfg))


@pytest.mark.parametrize("case", list(CASES))
def test_dalle_converter_matches_jax_and_the_logits_agree(case):
    jcfg, tcfg, params = _dalle(case)
    state = reference_dalle_state_dict(params, tcfg, vae_state={"codebook.weight": torch.zeros(2, 2)})
    assert any(".fn.fn." in k for k in state)
    assert any(k.startswith("transformer.layers.blocks.") for k in state) == (case == "reversible")
    tree = tport.convert_dalle_state_dict(state, tcfg)
    ref = jport.convert_dalle_state_dict(state, jcfg)
    _same(tree, ref)
    _same(tree, params)  # the writer is the converter's inverse
    model = weights.load_dalle(tree, tcfg, "cpu")
    rng = np.random.default_rng(1)
    text = rng.integers(1, 30, (2, 7)).astype(np.int32)
    codes = rng.integers(0, 16, (2, 9)).astype(np.int32)
    port = tdalle.forward(model, torch.from_numpy(text).long(), torch.from_numpy(codes).long())
    want = jdalle.forward(ref, jcfg, jnp.asarray(text), jnp.asarray(codes))
    np.testing.assert_allclose(port.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_a_mismatched_tree_is_refused():
    _, tcfg, params = _dalle("sequential")
    state = reference_dalle_state_dict(params, tcfg)
    del state["to_logits.1.bias"]
    with pytest.raises(ValueError, match="structure mismatch"):
        tport.convert_dalle_state_dict(state, tcfg)
    state = reference_dalle_state_dict(params, tcfg)
    state["mystery.weight"] = torch.zeros(1)
    with pytest.raises(KeyError, match="mystery"):
        tport.convert_dalle_state_dict(state, tcfg)


def _vae():
    jcfg = jvae.DiscreteVAEConfig(**VAE)
    vparams = jax.device_get(jvae.init_discrete_vae(jax.random.PRNGKey(5), jcfg))
    return jcfg, tvae.DiscreteVAEConfig(**VAE), vparams


def test_discrete_vae_checkpoint_matches_jax(tmp_path):
    jcfg, tcfg, vparams = _vae()
    state = reference_vae_state_dict(vparams, tcfg)
    _same(tport.convert_discrete_vae_state_dict(state, tcfg), jport.convert_discrete_vae_state_dict(state, jcfg))
    torch.save({"hparams": {**VAE, "temperature": 0.9}, "weights": state}, str(tmp_path / "vae.pt"))
    assert tport.is_torch_checkpoint(tmp_path / "vae.pt") and not tport.is_torch_checkpoint(tmp_path)
    params, cfg = tport.load_reference_vae_checkpoint(str(tmp_path / "vae.pt"))
    ref_params, ref_cfg = jport.load_reference_vae_checkpoint(str(tmp_path / "vae.pt"))
    assert cfg.to_dict() == ref_cfg.to_dict()
    _same(params, ref_params)
    _same(params, vparams)


def test_dalle_checkpoint_with_a_discrete_vae(tmp_path):
    jcfg_v, tcfg_v, vparams = _vae()
    kw = dict(BASE, **CASES["reversible"])
    kw.pop("num_image_tokens"), kw.pop("image_fmap_size")
    jcfg = jdalle.DALLEConfig.from_vae(jcfg_v, **kw)
    tcfg = tdalle.DALLEConfig.from_vae(tcfg_v, **kw)
    params = jax.device_get(jdalle.init_dalle(jax.random.PRNGKey(2), jcfg))
    write_reference_dalle(tmp_path / "dalle.pt", params, tcfg, "DiscreteVAE", VAE,
                          reference_vae_state_dict(vparams, tcfg_v))
    ref = jport.load_reference_dalle_checkpoint(str(tmp_path / "dalle.pt"))
    got = tport.load_reference_dalle_checkpoint(str(tmp_path / "dalle.pt"))
    port_cfg, ref_cfg = dataclasses.asdict(got["config"]), dataclasses.asdict(ref["config"])
    assert got["config"] == tcfg and port_cfg == {k: ref_cfg[k] for k in port_cfg}
    assert got["vae_config"].to_dict() == ref["vae_config"].to_dict() and got["epoch"] == ref["epoch"] == 3
    _same(got["params"], ref["params"])
    _same(got["vae_params"], ref["vae_params"])
    cfg, tree, vae_cfg, vae_tree = load_dalle_bundle(tmp_path / "dalle.pt")
    model, vae = weights.load_dalle_checkpoint(tmp_path / "dalle.pt", "cpu")
    assert model.cfg == cfg and vae.cfg == vae_cfg
    _same(weights.dalle_tree(model.state_dict(), cfg), ref["params"])


TAMING = dict(ch=8, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,), resolution=16, z_channels=8,
              n_embed=32, embed_dim=8)


def test_dalle_checkpoint_with_a_vqgan_needs_its_yaml(tmp_path):
    vq = jvqgan.VQGANConfig(**TAMING)
    taming = {f"model.{k}": torch.from_numpy(v) for k, v in make_taming_state_dict(vq).items()}
    kw = dict(BASE, **CASES["shared_sandwich_tied"])
    kw.pop("num_image_tokens"), kw.pop("image_fmap_size")
    jcfg = jdalle.DALLEConfig.from_vae(vq, **kw)
    params = jax.device_get(jdalle.init_dalle(jax.random.PRNGKey(4), jcfg))
    tcfg = tdalle.DALLEConfig.from_dict(jcfg.to_dict())
    write_reference_dalle(tmp_path / "dalle.pt", params, tcfg, "VQGanVAE", None, taming)
    config = {"model": {"params": {"n_embed": 32, "embed_dim": 8, "ddconfig": {
        k: list(v) if isinstance(v, tuple) else v for k, v in TAMING.items() if k not in ("n_embed", "embed_dim")}}}}
    (tmp_path / "vq.yaml").write_text(yaml.safe_dump(config))
    with pytest.raises(ValueError, match="pass the original yaml"):
        tport.load_reference_dalle_checkpoint(str(tmp_path / "dalle.pt"))
    got = tport.load_reference_dalle_checkpoint(str(tmp_path / "dalle.pt"), taming_config=config["model"])
    ref = jport.load_reference_dalle_checkpoint(str(tmp_path / "dalle.pt"), taming_config=config["model"])
    _same(got["params"], ref["params"])
    _same(got["vae_params"], ref["vae_params"])
    assert got["vae_config"].to_dict() == ref["vae_config"].to_dict()
    model, vae = weights.load_dalle_checkpoint(tmp_path / "dalle.pt", "cpu",
                                               vqgan_config_path=str(tmp_path / "vq.yaml"))
    assert vae.cfg.n_embed == 32 and model.cfg.image_fmap_size == 8 and model.cfg.num_image_tokens == 32


def test_dalle_checkpoint_with_the_openai_vae(tmp_path):
    """The OpenAI dVAE under `vae.enc.*` / `vae.dec.*` (tiny tensors under the
    published names: the converter only moves them), and a checkpoint from
    before `vae_class_name`, which without `vae_params` is the OpenAI one."""
    vae_state = {}
    for side in ("enc", "dec"):
        for name in ["blocks.input", "blocks.output.conv"] + [
                f"blocks.group_{g}.block_{i}.res_path.conv_{j}" for g in range(1, 5) for i in (1, 2)
                for j in range(1, 5)] + [f"blocks.group_{g}.block_1.id_path" for g in range(1, 5)]:
            vae_state[f"{side}.{name}.w"] = torch.randn(3, 2, 1, 1)
            vae_state[f"{side}.{name}.b"] = torch.randn(3)
    jcfg, tcfg, params = _dalle("sequential")
    kw = dict(BASE, **CASES["sequential"])
    kw.pop("num_image_tokens"), kw.pop("image_fmap_size")
    tcfg = tdalle.DALLEConfig(num_image_tokens=8192, image_fmap_size=32, **kw)
    jcfg = jdalle.DALLEConfig(num_image_tokens=8192, image_fmap_size=32, **kw)
    params = jax.device_get(jdalle.init_dalle(jax.random.PRNGKey(6), jcfg))
    for class_name in ("OpenAIDiscreteVAE", None):
        write_reference_dalle(tmp_path / "dalle.pt", params, tcfg, class_name, None, vae_state)
        got = tport.load_reference_dalle_checkpoint(str(tmp_path / "dalle.pt"))
        ref = jport.load_reference_dalle_checkpoint(str(tmp_path / "dalle.pt"))
        assert type(got["vae_config"]).__name__ == "OpenAIVAEConfig" and got["config"] == tcfg
        _same(got["vae_params"], ref["vae_params"])
        _same(got["params"], ref["params"])


def test_train_cli_continues_a_reference_dalle(tmp_path, capsys):
    """`cli.train_dalle --dalle_path dalle.pt` on a torch-reference file:
    the converted weights and VAE train on with a fresh optimizer, and the
    checkpoint it writes is the JAX package's v3."""
    import json

    from dalle_pytorch_tpu.training.checkpoint import load_checkpoint as jax_load
    from dalle_pytorch_tpu_torch.cli import train_dalle as tcli

    jcfg_v, tcfg_v, vparams = _vae()
    kw = dict(BASE, **CASES["sequential"])
    kw.pop("num_image_tokens"), kw.pop("image_fmap_size")
    tcfg = tdalle.DALLEConfig.from_vae(tcfg_v, **kw)
    params = jax.device_get(jdalle.init_dalle(jax.random.PRNGKey(8), jdalle.DALLEConfig.from_vae(jcfg_v, **kw)))
    write_reference_dalle(tmp_path / "ref.pt", params, tcfg, "DiscreteVAE", VAE,
                          reference_vae_state_dict(vparams, tcfg_v), epoch=0)
    out = tmp_path / "continued"
    assert tcli.main(["--dummy_run", "2", "--dalle_path", str(tmp_path / "ref.pt"), "--device", "cpu", "--telemetry", "off",
                      "--dalle_output_file_name", str(out)]) == 0
    printed = capsys.readouterr().out
    assert "fresh optimizer state" in printed
    steps = [json.loads(line) for line in printed.splitlines() if line.startswith('{"step"')]
    assert len(steps) == 2 and all(np.isfinite(s["loss"]) for s in steps)
    trees, meta = jax_load(f"{out}.pt")
    assert meta["vae_class_name"] == "DiscreteVAE" and meta["hparams"]["depth"] == 4
    _same(trees["vae_weights"], vparams)
