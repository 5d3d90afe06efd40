"""Carry the JAX package's weights into the port.

The JAX package keeps parameters as nested dicts/lists of arrays: linear
weights (in, out), convolution kernels HWIO, the transposed convolution as
the flipped kernel of an input-dilated convolution, LayerScale as (1, 1,
dim).  The functions here take such a tree, as `jax.device_get` or
`checkpoint.load_checkpoint` gives it (leaves numpy arrays or CPU tensors),
and return the port's state dicts or modules, in PyTorch's layouts; and back
again (`dalle_tree`, `vae_tree`, `clip_tree`), for the checkpoint writer and for tests that
hold the port's gradients against the JAX package's.
"""
from __future__ import annotations

import zipfile
from pathlib import Path
from typing import Any, Dict, Tuple

import numpy as np
import torch

from dalle_pytorch_tpu_torch.core.device import DeviceLike, resolve_device
from dalle_pytorch_tpu_torch.core.module import conv_transpose_weight, conv_weight, linear_weight
from dalle_pytorch_tpu_torch.models.clip import CLIP, CLIPConfig
from dalle_pytorch_tpu_torch.models.dalle import DALLE, DALLEConfig
from dalle_pytorch_tpu_torch.models.transformer import TransformerConfig, derive_layer_specs
from dalle_pytorch_tpu_torch.models.vae import DiscreteVAE, DiscreteVAEConfig
from dalle_pytorch_tpu_torch.models.vae_registry import config_from_meta

StateDict = Dict[str, torch.Tensor]

# the learned position tables of a DALL-E without rotary
_POSITION_TABLES = ("text_pos", "image_pos_h", "image_pos_w")
# a transformer layer's norms, and its sandwich norms under `sandwich_norm`
_LAYER_NORMS = ("attn_norm", "ff_norm")
_SANDWICH_NORMS = ("attn_norm_out", "ff_norm_out")


def _t(x: Any) -> torch.Tensor:
    if isinstance(x, dict):
        raise NotImplementedError("quantized weights ({'qvalue', 'scale'}) are not ported yet")
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.array(x))  # a copy: jax.device_get gives read-only arrays


def _linear(prefix: str, p: dict) -> StateDict:
    out = {f"{prefix}.weight": linear_weight(_t(p["w"]))}
    if "b" in p:
        out[f"{prefix}.bias"] = _t(p["b"])
    return out


def _norm(prefix: str, p: dict) -> StateDict:
    return {f"{prefix}.scale": _t(p["scale"]), f"{prefix}.bias": _t(p["bias"])}


def _conv(prefix: str, p: dict, transpose: bool = False) -> StateDict:
    convert = conv_transpose_weight if transpose else conv_weight
    out = {f"{prefix}.weight": convert(_t(p["w"]))}
    if "b" in p:
        out[f"{prefix}.bias"] = _t(p["b"])
    return out


def migrate_transformer_layout(tparams: dict, heads: int, dim_head: int) -> dict:
    """A transformer tree in the JAX package's layout from before its round
    5 (qkv columns [q|k|v]-blocked, GEGLU as one `w1` of values then gates)
    -> the current one (head-major qkv columns, `w1` and `w1g`), as the JAX
    `migrate_transformer_layout` does; a current tree (every feed-forward
    has `w1g`) comes back as it is."""
    shared_ff = tparams.get("shared_ff", {})
    if not shared_ff or all("w1g" in ff for ff in shared_ff.values()):
        return tparams
    attn_out = {}
    for aid, attn in tparams["shared_attn"].items():
        w = _t(attn["qkv"]["w"])
        w = w.reshape(w.shape[0], 3, heads, dim_head).transpose(1, 2).reshape(w.shape[0], -1)
        attn_out[aid] = {**attn, "qkv": {**attn["qkv"], "w": w}}
    ff_out = {}
    for fid, ff in shared_ff.items():
        ff = dict(ff)
        w1 = ff.pop("w1")
        w = _t(w1["w"])
        half = w.shape[-1] // 2
        ff["w1"], ff["w1g"] = {"w": w[:, :half]}, {"w": w[:, half:]}
        if "b" in w1:
            b = _t(w1["b"])
            ff["w1"]["b"], ff["w1g"]["b"] = b[:half], b[half:]
        ff_out[fid] = ff
    return {**tparams, "shared_attn": attn_out, "shared_ff": ff_out}


def _transformer_state_dict(prefix: str, tp: dict, tcfg: TransformerConfig) -> StateDict:
    """A transformer tree (current layout) -> the state dict of the port's
    `Transformer` under `prefix`: layer i reads its attention and
    feed-forward weights under its ids (`derive_layer_specs`; str(i) for
    unshared layers), so layers that share an id get the same tensors, and
    its sandwich norms under `sandwich_norm`."""
    specs = derive_layer_specs(tcfg)
    if len(tp["layers"]) != len(specs):
        raise ValueError(f"tree has {len(tp['layers'])} layers, config depth {len(specs)}")
    norms = _LAYER_NORMS + (_SANDWICH_NORMS if tcfg.sandwich_norm else ())
    sd: StateDict = {}
    for spec, layer in zip(specs, tp["layers"]):
        pre = f"{prefix}.layers.{spec.index}"
        attn, ff = tp["shared_attn"][spec.attn_id], tp["shared_ff"][spec.ff_id]
        for name in norms:
            sd.update(_norm(f"{pre}.{name}", layer[name]))
        sd[f"{pre}.attn_scale"] = _t(layer["attn_scale"])
        sd[f"{pre}.ff_scale"] = _t(layer["ff_scale"])
        sd.update(_linear(f"{pre}.attn.qkv", attn["qkv"]))
        sd.update(_linear(f"{pre}.attn.out", attn["out"]))
        for name in ("w1", "w1g", "w2"):
            sd.update(_linear(f"{pre}.ff.{name}", ff[name]))
    return sd


def dalle_state_dict(params: dict, cfg: DALLEConfig) -> StateDict:
    """The JAX package's DALL-E parameter tree (either transformer layout,
    `migrate_transformer_layout`) -> the port's `DALLE` state dict, the keys
    of every layer included (a shared module's under each of its layers)."""
    tp = migrate_transformer_layout(params["transformer"], cfg.heads, cfg.dim_head)
    sd = _transformer_state_dict("transformer", tp, cfg.transformer_config())
    sd.update(_norm("logits_norm", params["logits_norm"]))
    sd.update(_linear("logits_linear", params["logits_linear"]))
    if not cfg.share_input_output_emb:  # tied: the tree has no embedding tables
        sd["text_emb.weight"] = _t(params["text_emb"]["table"])
        sd["image_emb.weight"] = _t(params["image_emb"]["table"])
    if not cfg.rotary_emb:  # learned positions: separate tables, tied or not
        for name in _POSITION_TABLES:
            sd[f"{name}.weight"] = _t(params[name]["table"])
    return sd


def clip_state_dict(params: dict, cfg: CLIPConfig) -> StateDict:
    """The JAX package's CLIP parameter tree -> the port's `CLIP` state dict."""
    sd: StateDict = {}
    for side, tcfg in (("text", cfg.text_transformer_config()), ("visual", cfg.visual_transformer_config())):
        sd.update(_transformer_state_dict(f"{side}_transformer", params[f"{side}_transformer"], tcfg))
        sd.update(_linear(f"to_{side}_latent", params[f"to_{side}_latent"]))
        sd[f"{side}_pos.weight"] = _t(params[f"{side}_pos"]["table"])
    sd["text_emb.weight"] = _t(params["text_emb"]["table"])
    sd.update(_linear("patch_emb", params["patch_emb"]))
    sd["temperature"] = _t(params["temperature"])
    return sd


def vae_state_dict(params: dict, cfg: DiscreteVAEConfig) -> StateDict:
    """The JAX package's DiscreteVAE parameter tree -> the port's state dict."""
    sd: StateDict = {"codebook.weight": _t(params["codebook"]["table"])}
    for i, p in enumerate(params["enc_convs"]):
        sd.update(_conv(f"enc_convs.{i}", p))
    for i, p in enumerate(params["dec_deconvs"]):
        sd.update(_conv(f"dec_deconvs.{i}", p, transpose=True))
    for stack in ("enc_res", "dec_res"):
        for i, block in enumerate(params[stack]):
            for c in ("c1", "c2", "c3"):
                sd.update(_conv(f"{stack}.{i}.{c}", block[c]))
    for name in ("enc_out", "dec_out", "dec_in"):
        if name in params:
            sd.update(_conv(name, params[name]))
    return sd


# ---------------------------------------------------------------------------
# the port -> the JAX package's trees
# ---------------------------------------------------------------------------


def _leaf(t: torch.Tensor) -> torch.Tensor:
    # contiguous first: a transposed linear is laid out on its own device, not on the host
    return t.detach().contiguous().to("cpu")


def _linear_tree(sd: StateDict, prefix: str) -> dict:
    out = {"w": _leaf(sd[f"{prefix}.weight"].t())}
    if f"{prefix}.bias" in sd:
        out["b"] = _leaf(sd[f"{prefix}.bias"])
    return out


def _norm_tree(sd: StateDict, prefix: str) -> dict:
    return {"scale": _leaf(sd[f"{prefix}.scale"]), "bias": _leaf(sd[f"{prefix}.bias"])}


def _conv_tree(sd: StateDict, prefix: str, transpose: bool = False) -> dict:
    w = sd[f"{prefix}.weight"]
    # (I, O, kh, kw) -> flipped HWIO, or (O, I, kh, kw) -> HWIO
    w = w.permute(2, 3, 0, 1).flip(0, 1) if transpose else w.permute(2, 3, 1, 0)
    out = {"w": _leaf(w)}
    if f"{prefix}.bias" in sd:
        out["b"] = _leaf(sd[f"{prefix}.bias"])
    return out


def _transformer_tree(sd: StateDict, prefix: str, tcfg: TransformerConfig) -> dict:
    """The inverse of `_transformer_state_dict`: each attention and
    feed-forward id once, read at the first layer that holds it (the name
    `named_parameters` keeps for a shared tensor)."""
    layers, shared_attn, shared_ff = [], {}, {}
    norms = _LAYER_NORMS + (_SANDWICH_NORMS if tcfg.sandwich_norm else ())
    for spec in derive_layer_specs(tcfg):
        pre = f"{prefix}.layers.{spec.index}"
        layer = {name: _norm_tree(sd, f"{pre}.{name}") for name in norms}
        layer["attn_scale"] = _leaf(sd[f"{pre}.attn_scale"])
        layer["ff_scale"] = _leaf(sd[f"{pre}.ff_scale"])
        layers.append(layer)
        if spec.attn_id not in shared_attn:
            shared_attn[spec.attn_id] = {"qkv": _linear_tree(sd, f"{pre}.attn.qkv"),
                                         "out": _linear_tree(sd, f"{pre}.attn.out")}
        if spec.ff_id not in shared_ff:
            shared_ff[spec.ff_id] = {name: _linear_tree(sd, f"{pre}.ff.{name}") for name in ("w1", "w1g", "w2")}
    return {"layers": layers, "shared_attn": shared_attn, "shared_ff": shared_ff}


def dalle_tree(sd: StateDict, cfg: DALLEConfig) -> dict:
    """The inverse of `dalle_state_dict`: a `DALLE` state dict (or any dict
    of tensors under its parameter names, such as gradients or optimizer
    moments, whose keys may be `named_parameters`' alone) -> the JAX
    package's parameter tree, (in, out) linears, each attention and
    feed-forward id once.  Leaves are detached
    CPU tensors in their own dtype (`.numpy()` gives the JAX package's
    arrays where numpy has the dtype)."""
    tree = {
        "transformer": _transformer_tree(sd, "transformer", cfg.transformer_config()),
        "logits_norm": _norm_tree(sd, "logits_norm"),
        "logits_linear": _linear_tree(sd, "logits_linear"),
    }
    if not cfg.share_input_output_emb:
        tree["text_emb"] = {"table": _leaf(sd["text_emb.weight"])}
        tree["image_emb"] = {"table": _leaf(sd["image_emb.weight"])}
    if not cfg.rotary_emb:
        for name in _POSITION_TABLES:
            tree[name] = {"table": _leaf(sd[f"{name}.weight"])}
    return tree


def clip_tree(sd: StateDict, cfg: CLIPConfig) -> dict:
    """The inverse of `clip_state_dict`."""
    tree = {"text_emb": {"table": _leaf(sd["text_emb.weight"])}, "patch_emb": _linear_tree(sd, "patch_emb"),
            "temperature": _leaf(sd["temperature"])}
    for side, tcfg in (("text", cfg.text_transformer_config()), ("visual", cfg.visual_transformer_config())):
        tree[f"{side}_transformer"] = _transformer_tree(sd, f"{side}_transformer", tcfg)
        tree[f"to_{side}_latent"] = _linear_tree(sd, f"to_{side}_latent")
        tree[f"{side}_pos"] = {"table": _leaf(sd[f"{side}_pos.weight"])}
    return tree


def vae_tree(sd: StateDict, cfg: DiscreteVAEConfig) -> dict:
    """The inverse of `vae_state_dict`."""
    tree = {
        "codebook": {"table": _leaf(sd["codebook.weight"])},
        "enc_convs": [_conv_tree(sd, f"enc_convs.{i}") for i in range(cfg.num_layers)],
        "dec_deconvs": [_conv_tree(sd, f"dec_deconvs.{i}", transpose=True) for i in range(cfg.num_layers)],
        "enc_res": [{c: _conv_tree(sd, f"enc_res.{i}.{c}") for c in ("c1", "c2", "c3")}
                    for i in range(cfg.num_resnet_blocks)],
        "dec_res": [{c: _conv_tree(sd, f"dec_res.{i}.{c}") for c in ("c1", "c2", "c3")}
                    for i in range(cfg.num_resnet_blocks)],
    }
    for name in ("enc_out", "dec_out", "dec_in"):
        if f"{name}.weight" in sd:
            tree[name] = _conv_tree(sd, name)
    return tree


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


def _load(module: torch.nn.Module, sd: StateDict, device) -> torch.nn.Module:
    dtype = next(iter(sd.values())).dtype
    module.load_state_dict(sd, strict=True)
    return module.to(device=device, dtype=dtype).eval().requires_grad_(False)


def load_dalle(params: dict, cfg: DALLEConfig, device: DeviceLike = None) -> DALLE:
    """A `DALLE` holding the JAX tree's weights, in their own dtype."""
    device = resolve_device(device)
    return _load(DALLE(cfg), dalle_state_dict(params, cfg), device)


def load_clip(params: dict, cfg: CLIPConfig, device: DeviceLike = None) -> CLIP:
    """A `CLIP` holding the JAX tree's weights, in their own dtype."""
    device = resolve_device(device)
    return _load(CLIP(cfg), clip_state_dict(params, cfg), device)


def load_vae(params: dict, cfg: DiscreteVAEConfig, device: DeviceLike = None) -> DiscreteVAE:
    device = resolve_device(device)
    return _load(DiscreteVAE(cfg), vae_state_dict(params, cfg), device)


def _is_sharded_checkpoint(path: Path) -> bool:
    """True iff `path` is an orbax sharded checkpoint directory."""
    return path.is_dir() and (path / "state").exists()


def _is_torch_checkpoint(path: Path) -> bool:
    """True for a torch save file (a zip with a `data.pkl` member, or a raw
    pickle), as opposed to the v3 `.npz`, which is a zip without one."""
    try:
        with zipfile.ZipFile(path) as z:
            return any(name.endswith("data.pkl") for name in z.namelist())
    except zipfile.BadZipFile:
        with open(path, "rb") as f:
            return f.read(1) == b"\x80"


def load_dalle_checkpoint(path, device: DeviceLike = None) -> Tuple[DALLE, DiscreteVAE]:
    """The DALL-E and its DiscreteVAE from a JAX package v3 checkpoint (the
    `weights` and `vae_weights` trees, the `hparams`, `vae_class_name` and
    `vae_params` meta), with a note when it was written by another version;
    a tree in the pre-round-5 transformer layout is migrated as it is loaded
    (`migrate_transformer_layout`).  An orbax sharded directory and a
    torch-reference `dalle.pt` exit with what they need."""
    from dalle_pytorch_tpu_torch.checkpoint import load_checkpoint
    from dalle_pytorch_tpu_torch.version import __version__

    path = Path(path)
    if not path.exists():
        raise SystemExit(f"trained DALL-E {path} does not exist")
    if _is_sharded_checkpoint(path):
        raise SystemExit(f"{path} is an orbax sharded checkpoint: reading it needs the port of "
                         "training/checkpoint.py (ROADMAP.md Queue 1 item 8)")
    if _is_torch_checkpoint(path):
        raise SystemExit(f"{path} is a torch-reference checkpoint: converting it needs the port of "
                         "models/torch_port.py (ROADMAP.md Queue 1 item 5)")
    trees, meta = load_checkpoint(str(path))
    if meta.get("version") != __version__:
        print(f"note: checkpoint version {meta.get('version')} != library {__version__}")
    vae_cfg = config_from_meta(meta.get("vae_class_name", "DiscreteVAE"), meta["vae_params"])
    cfg = DALLEConfig.from_dict(meta["hparams"])
    return load_dalle(trees["weights"], cfg, device), load_vae(trees["vae_weights"], vae_cfg, device)
