"""Checkpoints of the original torch implementation (lucidrains/DALLE-pytorch)
(counterpart of `dalle_pytorch_tpu/models/torch_port.py`).

The converters map the reference module graph's `state_dict` names onto the
JAX package's parameter trees (numpy f32 leaves), which `weights.py` then
loads into the port's modules; so a `dalle.pt` or `vae.pt` trained with the
reference loads here as it loads in the JAX package.

* DiscreteVAE: encoder / decoder `Sequential`s, ResBlock `net.{0,2,4}`, the
  codebook embedding.
* DALLE: text and image embeddings (tied ones alias `to_logits.1`), the
  learned text positions and the axial image positions `weights.{0,1}`,
  `to_logits.{0,1}`; per layer `transformer.layers.layers.{i}.{0|1}` (a
  LayerScale around a PreNorm around the attention or feed-forward, with
  parameter-free `fn` links between), or under reversible execution
  `transformer.layers.blocks.{i}.{f|g}.net`.  The qkv columns are
  [q|k|v]-blocked there and head-major here; the GEGLU's one projection of
  [values|gates] is two here (`w1`, `w1g`).

Layouts: a torch Linear (out, in) -> (in, out); Conv2d (O, I, kh, kw) ->
HWIO; ConvTranspose2d (I, O, kh, kw) -> the spatially flipped HWIO of an
input-dilated conv.
"""
from __future__ import annotations

import dataclasses
import os
import zipfile
from typing import Dict, Optional

import numpy as np
import torch

from dalle_pytorch_tpu_torch.models.dalle import DALLE, DALLEConfig
from dalle_pytorch_tpu_torch.models.transformer import derive_layer_specs
from dalle_pytorch_tpu_torch.models.vae import DiscreteVAEConfig


def _np(v) -> np.ndarray:
    if hasattr(v, "detach"):
        v = v.detach().cpu().float().numpy()
    return np.asarray(v, np.float32)


def _conv(state: Dict, prefix: str) -> dict:
    out = {"w": np.transpose(_np(state[f"{prefix}.weight"]), (2, 3, 1, 0))}  # (O, I, kh, kw) -> HWIO
    if f"{prefix}.bias" in state:
        out["b"] = _np(state[f"{prefix}.bias"])
    return out


def _conv_transpose(state: Dict, prefix: str) -> dict:
    w = np.transpose(_np(state[f"{prefix}.weight"]), (2, 3, 0, 1))[::-1, ::-1]  # (I, O, kh, kw), flipped
    out = {"w": np.ascontiguousarray(w)}
    if f"{prefix}.bias" in state:
        out["b"] = _np(state[f"{prefix}.bias"])
    return out


def convert_discrete_vae_state_dict(state: Dict, cfg: DiscreteVAEConfig) -> dict:
    """The reference DiscreteVAE's state dict -> the JAX package's tree.
    Sequential indices: encoder = [Sequential(conv, relu)] * L + [ResBlock]
    * R + [1x1]; decoder = ([1x1 in] if R) + [ResBlock] * R +
    [Sequential(deconv, relu)] * L + [1x1]."""
    L, R = cfg.num_layers, cfg.num_resnet_blocks

    def res_block(prefix: str) -> dict:
        return {"c1": _conv(state, f"{prefix}.net.0"), "c2": _conv(state, f"{prefix}.net.2"),
                "c3": _conv(state, f"{prefix}.net.4")}

    first = 1 + R if R else 0
    params = {
        "codebook": {"table": _np(state["codebook.weight"])},
        "enc_convs": [_conv(state, f"encoder.{i}.0") for i in range(L)],
        "enc_res": [res_block(f"encoder.{L + j}") for j in range(R)],
        "enc_out": _conv(state, f"encoder.{L + R}"),
        "dec_res": [res_block(f"decoder.{1 + j}") for j in range(R)],
        "dec_deconvs": [_conv_transpose(state, f"decoder.{first + i}.0") for i in range(L)],
        "dec_out": _conv(state, f"decoder.{first + L}"),
    }
    if R:
        params["dec_in"] = _conv(state, "decoder.0")
    return params


def _structure(tree):
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in sorted(tree.items())}
    if isinstance(tree, (list, tuple)):
        return [_structure(v) for v in tree]
    return None


def _expected_structure(cfg: DALLEConfig):
    """The structure of the JAX tree the port's `DALLE` of `cfg` writes
    (`weights.dalle_tree`), from a model on the meta device."""
    from dalle_pytorch_tpu_torch import weights

    with torch.device("meta"):
        names = DALLE(cfg).state_dict()
    return _structure(weights.dalle_tree({k: torch.empty(0, 0) for k in names}, cfg))


def convert_dalle_state_dict(state: Dict, cfg: DALLEConfig) -> dict:
    """The reference DALLE's state dict -> the JAX package's tree: sequential
    or reversible layers, shared ids (a shared branch's tensors written once
    per layer that holds it, equal), sandwich norms, tied embeddings.  The
    `vae.*` entries are skipped.  Raises unless the tree has the structure
    of the port's `dalle_tree` for `cfg`."""
    specs = derive_layer_specs(cfg.transformer_config())
    dim, fmap = cfg.dim, cfg.image_fmap_size
    layers: list = [{} for _ in range(cfg.depth)]
    shared_attn: Dict[str, dict] = {s.attn_id: {} for s in specs}
    shared_ff: Dict[str, dict] = {s.ff_id: {} for s in specs}
    params: dict = {"transformer": {"shared_attn": shared_attn, "shared_ff": shared_ff, "layers": layers}}

    def linear_part(d: dict, field: str, value: np.ndarray):
        d["w" if field == "weight" else "b"] = value.T if field == "weight" else value

    def transformer_leaf(i: int, branch: int, rest: list, key: str):
        spec, kind, layer = specs[i], ("attn" if branch == 0 else "ff"), layers[i]
        val = _np(state[key])
        if rest == ["scale"]:
            layer[f"{kind}_scale"] = val
        elif rest[0] in ("norm", "norm_out") and len(rest) == 2:
            name = f"{kind}_norm" if rest[0] == "norm" else f"{kind}_norm_out"
            layer.setdefault(name, {})["scale" if rest[1] == "weight" else "bias"] = val
        elif rest[:2] == ["to_qkv", "weight"]:
            # [q|k|v]-blocked columns -> head-major [h0: q k v, h1: q k v, ...]
            w = val.T
            w = w.reshape(w.shape[0], 3, cfg.heads, cfg.dim_head).transpose(0, 2, 1, 3).reshape(w.shape[0], -1)
            shared_attn[spec.attn_id]["qkv"] = {"w": np.ascontiguousarray(w)}
        elif rest[:2] == ["to_out", "0"]:
            linear_part(shared_attn[spec.attn_id].setdefault("out", {}), rest[2], val)
        elif rest[:2] == ["net", "0"]:
            # the GEGLU's one [values|gates] projection -> w1 (values), w1g (gates)
            val = val.T if rest[2] == "weight" else val
            half = val.shape[-1] // 2
            field = "w" if rest[2] == "weight" else "b"
            shared_ff[spec.ff_id].setdefault("w1", {})[field] = np.ascontiguousarray(val[..., :half])
            shared_ff[spec.ff_id].setdefault("w1g", {})[field] = np.ascontiguousarray(val[..., half:])
        elif rest[:2] == ["net", "3"]:
            linear_part(shared_ff[spec.ff_id].setdefault("w2", {}), rest[2], val)
        else:
            raise KeyError(f"unrecognized transformer entry: {key} (rest={rest})")

    for key, val in state.items():
        if key.startswith("vae.") or key == "logits_mask":
            continue
        if key in ("text_emb.weight", "image_emb.weight"):
            if not cfg.share_input_output_emb:
                params[key.split(".")[0]] = {"table": _np(val)}
        elif key.startswith(("text_emb.", "image_emb.")):
            continue  # the tied embeddings' aliases of to_logits.1
        elif key == "text_pos_emb.weight":
            params["text_pos"] = {"table": _np(val)}
        elif key in ("image_pos_emb.weights.0", "image_pos_emb.weights.1"):
            params["image_pos_h" if key.endswith("0") else "image_pos_w"] = {"table": _np(val).reshape(fmap, dim)}
        elif key.startswith("to_logits.0."):
            params.setdefault("logits_norm", {})["scale" if key.endswith("weight") else "bias"] = _np(val)
        elif key.startswith("to_logits.1."):
            linear_part(params.setdefault("logits_linear", {}), key.rsplit(".", 1)[1], _np(val))
        elif key.startswith("transformer.layers."):
            parts = key.split(".")
            if parts[2] == "layers":  # SequentialSequence
                i, branch, rest = int(parts[3]), int(parts[4]), parts[5:]
            elif parts[2] == "blocks" and parts[5] == "net":  # ReversibleSequence
                i, branch, rest = int(parts[3]), (0 if parts[4] == "f" else 1), parts[6:]
            else:
                raise KeyError(f"unrecognized transformer container: {key}")
            transformer_leaf(i, branch, [p for p in rest if p != "fn"], key)
        else:
            raise KeyError(f"unrecognized DALLE state entry: {key}")

    got, want = _structure(params), _expected_structure(cfg)
    if got != want:
        raise ValueError(f"converted tree structure mismatch:\n got {got}\nwant {want}")
    return params


# ---------------------------------------------------------------------------
# whole reference checkpoints
# ---------------------------------------------------------------------------


def is_torch_checkpoint(path) -> bool:
    """True for a torch save file (a zip with a `data.pkl` member, or a raw
    pickle), as opposed to the v3 `.npz`, a zip without one, and to a
    sharded checkpoint's directory."""
    path = str(path)
    if os.path.isdir(path):
        return False
    try:
        with zipfile.ZipFile(path) as z:
            return any(name.endswith("data.pkl") for name in z.namelist())
    except zipfile.BadZipFile:
        with open(path, "rb") as f:
            return f.read(1) == b"\x80"


def _filter_kwargs(cls, kwargs: Dict) -> Dict:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in kwargs.items() if k in names}


def _discrete_vae_config(hparams: Optional[Dict]) -> DiscreteVAEConfig:
    hp = _filter_kwargs(DiscreteVAEConfig, dict(hparams or {}))
    if hp.get("normalization") is not None:
        hp["normalization"] = tuple(tuple(x) for x in hp["normalization"])
    return DiscreteVAEConfig(**hp)


def load_reference_vae_checkpoint(path: str):
    """The reference `train_vae.py` checkpoint ({'hparams', 'weights'}) ->
    (JAX tree, `DiscreteVAEConfig`)."""
    from dalle_pytorch_tpu_torch.models.pretrained import load_torch_file

    obj = load_torch_file(path)
    cfg = _discrete_vae_config(obj["hparams"])
    return convert_discrete_vae_state_dict(obj["weights"], cfg), cfg


def dalle_config_from_reference_hparams(hparams: Dict, vae_cfg) -> DALLEConfig:
    """The reference's `dalle_params` -> `DALLEConfig`, the image side from
    the VAE as the reference's DALLE constructor derives it."""
    hp = dict(hparams)
    for k in ("attn_types", "shared_attn_ids", "shared_ff_ids"):
        if hp.get(k) is not None:
            hp[k] = tuple(hp[k])
    if hp.get("attn_types") is None:
        hp["attn_types"] = ("full",)
    hp = _filter_kwargs(DALLEConfig, hp)
    hp.pop("num_image_tokens", None)
    hp.pop("image_fmap_size", None)
    return DALLEConfig.from_vae(vae_cfg, **hp)


def read_reference_dalle(path, vqgan_config_path: Optional[str] = None) -> dict:
    """`load_reference_dalle_checkpoint` of `path`, a VQGanVAE one with its
    taming yaml read from `vqgan_config_path` (the CLIs' flag, which implies
    --taming): the one reader of the format that loading and resuming share."""
    taming_config = None
    if vqgan_config_path:
        from dalle_pytorch_tpu_torch.models.pretrained import parse_taming_yaml

        taming_config = parse_taming_yaml(vqgan_config_path)
    return load_reference_dalle_checkpoint(str(path), taming_config=taming_config)


def load_reference_dalle_checkpoint(path: str, taming_config: Optional[Dict] = None) -> dict:
    """The reference `train_dalle.py` checkpoint ({'hparams', 'vae_params',
    'vae_class_name', 'weights', ...}) -> {params, config, vae_params,
    vae_config, epoch, version}.  The VAE is embedded in the DALL-E's state
    dict under `vae.*`: a DiscreteVAE (config from 'vae_params'), the
    OpenAI dVAE (its fixed config), or a VQGanVAE given `taming_config`,
    the parsed taming yaml the checkpoint does not carry."""
    from dalle_pytorch_tpu_torch.models import openai_vae, vqgan
    from dalle_pytorch_tpu_torch.models.pretrained import load_torch_file

    obj = load_torch_file(path)
    state = obj["weights"]
    if isinstance(state, str):
        raise ValueError("this reference checkpoint is a DeepSpeed auxiliary file without consolidated weights; "
                         "consolidate it with the reference tooling first")
    vae_state = {k[len("vae."):]: v for k, v in state.items() if k.startswith("vae.")}
    dalle_state = {k: v for k, v in state.items() if not k.startswith("vae.")}

    class_name = obj.get("vae_class_name")
    if class_name is None:  # releases before 'vae_class_name': a DiscreteVAE iff vae_params was saved
        class_name = "DiscreteVAE" if obj.get("vae_params") else "OpenAIDiscreteVAE"
    if class_name == "DiscreteVAE":
        vae_cfg = _discrete_vae_config(obj["vae_params"])
        vae_params = convert_discrete_vae_state_dict(vae_state, vae_cfg)
    elif class_name == "OpenAIDiscreteVAE":
        vae_cfg = openai_vae.OpenAIVAEConfig()
        enc = {k[len("enc."):]: v for k, v in vae_state.items() if k.startswith("enc.")}
        dec = {k[len("dec."):]: v for k, v in vae_state.items() if k.startswith("dec.")}
        vae_params = openai_vae.convert_openai_state_dicts(enc, dec)
    elif class_name == "VQGanVAE" and taming_config is not None:
        # the reference's VQGanVAE holds the taming model at self.model
        taming_state = {k[len("model."):]: v for k, v in vae_state.items() if k.startswith("model.")}
        vae_cfg = vqgan.config_from_taming_dict(taming_config, taming_state)
        vae_params = vqgan.convert_taming_state_dict(taming_state, vae_cfg)
    else:
        raise ValueError(f"reference checkpoint uses {class_name}, whose taming config is not stored in the "
                         "checkpoint — pass the original yaml (--vqgan_config_path on the train/generate CLIs, "
                         "or the taming_config argument here)")

    cfg = dalle_config_from_reference_hparams(obj["hparams"], vae_cfg)
    return {"params": convert_dalle_state_dict(dalle_state, cfg), "config": cfg, "vae_params": vae_params,
            "vae_config": vae_cfg, "epoch": obj.get("epoch", 0), "version": obj.get("version")}
