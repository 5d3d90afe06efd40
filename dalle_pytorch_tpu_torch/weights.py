"""Carry the JAX package's weights into the port.

The JAX package keeps parameters as nested dicts/lists of arrays: linear
weights (in, out), convolution kernels HWIO, the transposed convolution as
the flipped kernel of an input-dilated convolution, LayerScale as (1, 1,
dim).  The functions here take such a tree, as `jax.device_get` or
`checkpoint.load_checkpoint` gives it (leaves numpy arrays or CPU tensors),
and return the port's state dicts or modules, in PyTorch's layouts; and back
again (`dalle_tree`, `vae_tree`), for the checkpoint writer and for tests that
hold the port's gradients against the JAX package's.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from dalle_pytorch_tpu_torch.core.device import DeviceLike, resolve_device
from dalle_pytorch_tpu_torch.core.module import conv_transpose_weight, conv_weight, linear_weight
from dalle_pytorch_tpu_torch.models.dalle import DALLE, DALLEConfig
from dalle_pytorch_tpu_torch.models.vae import DiscreteVAE, DiscreteVAEConfig

StateDict = Dict[str, torch.Tensor]


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


def dalle_state_dict(params: dict, cfg: DALLEConfig) -> StateDict:
    """The JAX package's DALL-E parameter tree -> the port's `DALLE` state
    dict.  Layer i reads its attention and feed-forward weights under id
    str(i): the port's layers are unshared."""
    tp = params["transformer"]
    sd: StateDict = {}
    for i, layer in enumerate(tp["layers"]):
        pre = f"transformer.layers.{i}"
        attn, ff = tp["shared_attn"][str(i)], tp["shared_ff"][str(i)]
        sd.update(_norm(f"{pre}.attn_norm", layer["attn_norm"]))
        sd.update(_norm(f"{pre}.ff_norm", layer["ff_norm"]))
        sd[f"{pre}.attn_scale"] = _t(layer["attn_scale"])
        sd[f"{pre}.ff_scale"] = _t(layer["ff_scale"])
        sd.update(_linear(f"{pre}.attn.qkv", attn["qkv"]))
        sd.update(_linear(f"{pre}.attn.out", attn["out"]))
        for name in ("w1", "w1g", "w2"):
            sd.update(_linear(f"{pre}.ff.{name}", ff[name]))
    if len(tp["layers"]) != cfg.depth:
        raise ValueError(f"tree has {len(tp['layers'])} layers, config depth {cfg.depth}")
    sd.update(_norm("logits_norm", params["logits_norm"]))
    sd.update(_linear("logits_linear", params["logits_linear"]))
    if not cfg.share_input_output_emb:  # tied: the tree has no embedding tables
        sd["text_emb.weight"] = _t(params["text_emb"]["table"])
        sd["image_emb.weight"] = _t(params["image_emb"]["table"])
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
    return t.detach().to("cpu").contiguous()


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


def dalle_tree(sd: StateDict, cfg: DALLEConfig) -> dict:
    """The inverse of `dalle_state_dict`: a `DALLE` state dict (or any dict
    of tensors under its parameter names, such as gradients or optimizer
    moments) -> the JAX package's parameter tree, (in, out) linears, layer
    i's attention and feed-forward under id str(i).  Leaves are detached
    CPU tensors in their own dtype (`.numpy()` gives the JAX package's
    arrays where numpy has the dtype)."""
    layers, shared_attn, shared_ff = [], {}, {}
    for i in range(cfg.depth):
        pre = f"transformer.layers.{i}"
        layers.append({
            "attn_norm": _norm_tree(sd, f"{pre}.attn_norm"),
            "ff_norm": _norm_tree(sd, f"{pre}.ff_norm"),
            "attn_scale": _leaf(sd[f"{pre}.attn_scale"]),
            "ff_scale": _leaf(sd[f"{pre}.ff_scale"]),
        })
        shared_attn[str(i)] = {"qkv": _linear_tree(sd, f"{pre}.attn.qkv"),
                               "out": _linear_tree(sd, f"{pre}.attn.out")}
        shared_ff[str(i)] = {name: _linear_tree(sd, f"{pre}.ff.{name}") for name in ("w1", "w1g", "w2")}
    tree = {
        "transformer": {"layers": layers, "shared_attn": shared_attn, "shared_ff": shared_ff},
        "logits_norm": _norm_tree(sd, "logits_norm"),
        "logits_linear": _linear_tree(sd, "logits_linear"),
    }
    if not cfg.share_input_output_emb:
        tree["text_emb"] = {"table": _leaf(sd["text_emb.weight"])}
        tree["image_emb"] = {"table": _leaf(sd["image_emb.weight"])}
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


def load_vae(params: dict, cfg: DiscreteVAEConfig, device: DeviceLike = None) -> DiscreteVAE:
    device = resolve_device(device)
    return _load(DiscreteVAE(cfg), vae_state_dict(params, cfg), device)


def load_dalle_checkpoint(path: str, device: DeviceLike = None) -> Tuple[DALLE, DiscreteVAE]:
    """The DALL-E and its DiscreteVAE from a JAX package v3 checkpoint (the
    `weights` and `vae_weights` trees, the `hparams` and `vae_params` meta)."""
    from dalle_pytorch_tpu_torch.checkpoint import load_checkpoint

    trees, meta = load_checkpoint(path)
    vae_class = meta.get("vae_class_name", "DiscreteVAE")
    if vae_class != "DiscreteVAE":
        raise NotImplementedError(f"the port decodes with DiscreteVAE only, not {vae_class}")
    vae_cfg = DiscreteVAEConfig.from_dict(meta["vae_params"])
    cfg = DALLEConfig.from_dict(meta["hparams"])
    return load_dalle(trees["weights"], cfg, device), load_vae(trees["vae_weights"], vae_cfg, device)
