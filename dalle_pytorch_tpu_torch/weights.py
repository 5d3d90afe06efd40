"""Carry the JAX package's weights into the port.

The JAX package keeps parameters as nested dicts/lists of arrays: linear
weights (in, out), convolution kernels HWIO, the transposed convolution as
the flipped kernel of an input-dilated convolution, LayerScale as (1, 1,
dim).  The functions here take such a tree, as `jax.device_get` or
`checkpoint.load_checkpoint` gives it (leaves numpy arrays or CPU tensors),
and return the port's state dicts or modules, in PyTorch's layouts; and back
again (`dalle_tree`, `vae_tree`, `clip_tree`), for the checkpoint writer and for tests that
hold the port's gradients against the JAX package's.  The VAE functions
take any of the three families (`models/vae_registry.py`): the DiscreteVAE,
the taming VQGAN (`vqgan_state_dict` / `vqgan_tree`, the module's names
being taming's) and OpenAI's dVAE (`openai_vae_state_dict` /
`openai_vae_tree`).
"""
from __future__ import annotations

import functools
from pathlib import Path
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from dalle_pytorch_tpu_torch import quantization
from dalle_pytorch_tpu_torch.core.device import DeviceLike, resolve_device
from dalle_pytorch_tpu_torch.core.module import conv_transpose_weight, conv_weight, linear_weight
from dalle_pytorch_tpu_torch.models.clip import CLIP, CLIPConfig
from dalle_pytorch_tpu_torch.models.dalle import DALLE, DALLEConfig
from dalle_pytorch_tpu_torch.models.openai_vae import GROUP_COUNT, N_BLK_PER_GROUP, OpenAIVAE, OpenAIVAEConfig
from dalle_pytorch_tpu_torch.models.transformer import TransformerConfig, derive_layer_specs
from dalle_pytorch_tpu_torch.models.vae import DiscreteVAE
from dalle_pytorch_tpu_torch.models.vqgan import VQGAN, VQGANConfig, has_decoder_attn

StateDict = Dict[str, torch.Tensor]

# the learned position tables of a DALL-E without rotary
_POSITION_TABLES = ("text_pos", "image_pos_h", "image_pos_w")
# a transformer layer's norms, and its sandwich norms under `sandwich_norm`
_LAYER_NORMS = ("attn_norm", "ff_norm")
_SANDWICH_NORMS = ("attn_norm_out", "ff_norm_out")


def _t(x: Any) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    x = np.array(x)  # a copy: jax.device_get gives read-only arrays
    if x.dtype.name == "float8_e4m3fn":  # ml_dtypes' fp8, which torch.from_numpy does not take
        return torch.from_numpy(x.view(np.uint8)).view(quantization.FP8)
    return torch.from_numpy(x)


def _qvalue(x: Any) -> torch.Tensor:
    """A quantized block's values as the port holds them: int8, or fp8 as
    its uint8 bits."""
    q = _t(x)
    return q.view(torch.uint8) if q.dtype == quantization.FP8 else q


def _linear(prefix: str, p: dict) -> StateDict:
    w = p["w"]
    if isinstance(w, dict):  # {"qvalue" (in, out), "scale" (out,)}: a QuantLinear
        out = {f"{prefix}.qvalue": _qvalue(w["qvalue"]).t().contiguous(), f"{prefix}.scale": _t(w["scale"])}
    else:
        out = {f"{prefix}.weight": linear_weight(_t(w))}
    if "b" in p:
        out[f"{prefix}.bias"] = _t(p["b"])
    return out


def _table(prefix: str, p: dict) -> StateDict:
    """An embedding table, or its per-row quantized block (a QuantEmbedding)."""
    t = p["table"]
    if isinstance(t, dict):
        return {f"{prefix}.qvalue": _qvalue(t["qvalue"]), f"{prefix}.scale": _t(t["scale"])}
    return {f"{prefix}.weight": _t(t)}


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
    of every layer included (a shared module's under each of its layers).
    A quantized tree (`quantize_tree`'s `{"qvalue", "scale"}` leaves) gives
    the keys of `QuantLinear` / `QuantEmbedding` (`qvalue` (out, in) or (N,
    dim), `scale`)."""
    tp = migrate_transformer_layout(params["transformer"], cfg.heads, cfg.dim_head)
    sd = _transformer_state_dict("transformer", tp, cfg.transformer_config())
    sd.update(_norm("logits_norm", params["logits_norm"]))
    sd.update(_linear("logits_linear", params["logits_linear"]))
    if not cfg.share_input_output_emb:  # tied: the tree has no embedding tables
        sd.update(_table("text_emb", params["text_emb"]))
        sd.update(_table("image_emb", params["image_emb"]))
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


def vae_state_dict(params: dict, cfg: Any) -> StateDict:
    """The JAX package's VAE parameter tree of any family -> the port's
    state dict of that family's module."""
    if isinstance(cfg, VQGANConfig):
        return vqgan_state_dict(params, cfg)
    if isinstance(cfg, OpenAIVAEConfig):
        return openai_vae_state_dict(params)
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


# The VQGAN and OpenAI trees are walked through a tree of names: the JAX
# package's structure with, at each conv or norm, the port's module prefix.


def _vqgan_names(cfg: VQGANConfig, decoder_attn: bool) -> dict:
    """The JAX VQGAN tree's structure, ("conv" | "gn" | "table", prefix) at
    its leaves' parents: the port's module names, which are taming's."""
    widths = [cfg.ch * m for m in cfg.ch_mult]
    levels = len(widths)

    def res(prefix, cin, cout):
        p = {"norm1": ("gn", f"{prefix}.norm1"), "conv1": ("conv", f"{prefix}.conv1"),
             "norm2": ("gn", f"{prefix}.norm2"), "conv2": ("conv", f"{prefix}.conv2")}
        if cin != cout:
            p["nin_shortcut"] = ("conv", f"{prefix}.nin_shortcut")
        return p

    def attn(prefix):
        return {"norm": ("gn", f"{prefix}.norm"), **{n: ("conv", f"{prefix}.{n}") for n in ("q", "k", "v", "proj_out")}}

    def mid(prefix, c):
        return {"block_1": res(f"{prefix}.block_1", c, c), "attn_1": attn(f"{prefix}.attn_1"),
                "block_2": res(f"{prefix}.block_2", c, c)}

    def level(prefix, cin, w, n_blocks, has_attn):
        p = {"blocks": [res(f"{prefix}.block.{i}", cin if i == 0 else w, w) for i in range(n_blocks)]}
        if has_attn:
            p["attns"] = [attn(f"{prefix}.attn.{i}") for i in range(n_blocks)]
        return p

    tree = {"conv_in": ("conv", "encoder.conv_in"), "down": [], "up": [None] * levels}
    cin, res_now = cfg.ch, cfg.resolution
    for lvl, w in enumerate(widths):
        p = level(f"encoder.down.{lvl}", cin, w, cfg.num_res_blocks, res_now in cfg.attn_resolutions)
        if lvl != levels - 1:
            p["downsample"] = {"conv": ("conv", f"encoder.down.{lvl}.downsample.conv")}
            res_now //= 2
        tree["down"].append(p)
        cin = w
    tree.update(mid=mid("encoder.mid", cin), norm_out=("gn", "encoder.norm_out"),
                conv_out=("conv", "encoder.conv_out"), quant_conv=("conv", "quant_conv"),
                post_quant_conv=("conv", "post_quant_conv"), dec_conv_in=("conv", "decoder.conv_in"),
                dec_mid=mid("decoder.mid", widths[-1]))
    cin = widths[-1]
    for lvl in reversed(range(levels)):
        w = widths[lvl]
        p = level(f"decoder.up.{lvl}", cin, w, cfg.num_res_blocks + 1,
                  decoder_attn and res_now in cfg.attn_resolutions)
        if lvl != 0:
            p["upsample"] = {"conv": ("conv", f"decoder.up.{lvl}.upsample.conv")}
            res_now *= 2
        tree["up"][lvl] = p
        cin = w
    tree.update(dec_norm_out=("gn", "decoder.norm_out"), dec_conv_out=("conv", "decoder.conv_out"))
    if cfg.is_gumbel:
        tree.update(codebook=("table", "quantize.embed"), quant_proj=("conv", "quantize.proj"))
    else:
        tree["codebook"] = ("table", "quantize.embedding")
    return tree


def _openai_names() -> dict:
    def half(side, widths_change):
        groups = []
        for g in range(GROUP_COUNT):
            group = []
            for i in range(N_BLK_PER_GROUP):
                pre = f"{side}.groups.{g}.{i}"
                blk = {f"c{j}": ("conv", f"{pre}.c{j}") for j in range(1, 5)}
                if i == 0 and widths_change[g]:
                    blk["id"] = ("conv", f"{pre}.id")
                group.append(blk)
            groups.append(group)
        return {"input": ("conv", f"{side}.input"), "groups": groups, "output": ("conv", f"{side}.output")}

    # block 0 of each group widens, but the encoder's first (its input conv is n_hid wide already)
    return {"encoder": half("encoder", (False, True, True, True)), "decoder": half("decoder", (True, True, True, True))}


def _names_state_dict(names, params) -> StateDict:
    """The JAX tree `params` laid over `names` -> the port's state dict."""
    if isinstance(names, tuple):
        kind, prefix = names
        if kind == "conv":
            return _conv(prefix, params)
        if kind == "gn":
            return {f"{prefix}.weight": _t(params["scale"]), f"{prefix}.bias": _t(params["bias"])}
        return {f"{prefix}.weight": _t(params["table"])}
    sd: StateDict = {}
    items = names.items() if isinstance(names, dict) else enumerate(names)
    for key, sub in items:
        sd.update(_names_state_dict(sub, params[key]))
    return sd


def vqgan_state_dict(params: dict, cfg: VQGANConfig) -> StateDict:
    """The JAX package's VQGAN tree -> the port's `VQGAN` state dict (the
    decoder's attention blocks where the tree holds them)."""
    return _names_state_dict(_vqgan_names(cfg, has_decoder_attn(params)), params)


def openai_vae_state_dict(params: dict) -> StateDict:
    """The JAX package's OpenAI dVAE tree -> the port's `OpenAIVAE` state dict."""
    return _names_state_dict(_openai_names(), params)


# ---------------------------------------------------------------------------
# the port -> the JAX package's trees
# ---------------------------------------------------------------------------


def _leaf(t: torch.Tensor) -> torch.Tensor:
    # contiguous first: a transposed linear is laid out on its own device, not on the host
    return t.detach().contiguous().to("cpu")


def _quant_leaf(q: torch.Tensor) -> torch.Tensor:
    """A held block as the JAX package's leaf: int8, or fp8 from its bits."""
    return _leaf(quantization._values(q))


def _linear_tree(sd: StateDict, prefix: str) -> dict:
    if f"{prefix}.qvalue" in sd:
        out = {"w": {"qvalue": _quant_leaf(sd[f"{prefix}.qvalue"].t()), "scale": _leaf(sd[f"{prefix}.scale"])}}
    else:
        out = {"w": _leaf(sd[f"{prefix}.weight"].t())}
    if f"{prefix}.bias" in sd:
        out["b"] = _leaf(sd[f"{prefix}.bias"])
    return out


def _table_tree(sd: StateDict, prefix: str) -> dict:
    if f"{prefix}.qvalue" in sd:
        return {"table": {"qvalue": _quant_leaf(sd[f"{prefix}.qvalue"]), "scale": _leaf(sd[f"{prefix}.scale"])}}
    return {"table": _leaf(sd[f"{prefix}.weight"])}


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
        tree["text_emb"] = _table_tree(sd, "text_emb")
        tree["image_emb"] = _table_tree(sd, "image_emb")
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


def vae_tree(sd: StateDict, cfg: Any) -> dict:
    """The inverse of `vae_state_dict`, for any family."""
    if isinstance(cfg, VQGANConfig):
        return vqgan_tree(sd, cfg)
    if isinstance(cfg, OpenAIVAEConfig):
        return openai_vae_tree(sd)
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


def _names_tree(names, sd: StateDict):
    """The port's state dict read through `names` -> the JAX tree."""
    if isinstance(names, tuple):
        kind, prefix = names
        if kind == "conv":
            return _conv_tree(sd, prefix)
        if kind == "gn":
            return {"scale": _leaf(sd[f"{prefix}.weight"]), "bias": _leaf(sd[f"{prefix}.bias"])}
        return {"table": _leaf(sd[f"{prefix}.weight"])}
    if isinstance(names, dict):
        return {key: _names_tree(sub, sd) for key, sub in names.items()}
    return [_names_tree(sub, sd) for sub in names]


def vqgan_tree(sd: StateDict, cfg: VQGANConfig) -> dict:
    """The inverse of `vqgan_state_dict`."""
    decoder_attn = any(k.startswith("decoder.up.") and ".attn." in k for k in sd)
    return _names_tree(_vqgan_names(cfg, decoder_attn), sd)


def openai_vae_tree(sd: StateDict) -> dict:
    """The inverse of `openai_vae_state_dict`."""
    return _names_tree(_openai_names(), sd)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


def _load(build, sd: StateDict, device) -> torch.nn.Module:
    """`build()` constructed on `device` (its own random init there is cheap
    and is overwritten), holding `sd` in the state dict's dtype; where `sd`
    holds quantized blocks, the module's layers are quantized first (fp8
    where the blocks are uint8 bits), so that it takes them."""
    dtype = next(iter(sd.values())).dtype
    with torch.device(device):
        module = build()
    blocks = [v for k, v in sd.items() if k.endswith(".qvalue")]
    if blocks:
        quantization.quantize_tree(module, "fp8" if blocks[0].dtype == torch.uint8 else "int8")
    module.load_state_dict(sd, strict=True)
    return module.to(dtype=dtype).eval().requires_grad_(False)


def load_dalle(params: dict, cfg: DALLEConfig, device: DeviceLike = None) -> DALLE:
    """A `DALLE` holding the JAX tree's weights, in their own dtype."""
    device = resolve_device(device)
    return _load(lambda: DALLE(cfg), dalle_state_dict(params, cfg), device)


def load_clip(params: dict, cfg: CLIPConfig, device: DeviceLike = None) -> CLIP:
    """A `CLIP` holding the JAX tree's weights, in their own dtype."""
    device = resolve_device(device)
    return _load(lambda: CLIP(cfg), clip_state_dict(params, cfg), device)


def load_vae(params: dict, cfg: Any, device: DeviceLike = None) -> torch.nn.Module:
    """The VAE module of `cfg`'s family holding the JAX tree's weights, in
    their own dtype."""
    device = resolve_device(device)
    if isinstance(cfg, VQGANConfig):
        return _load(lambda: VQGAN(cfg, has_decoder_attn(params)), vqgan_state_dict(params, cfg), device)
    if isinstance(cfg, OpenAIVAEConfig):
        return _load(OpenAIVAE, openai_vae_state_dict(params), device)
    return _load(lambda: DiscreteVAE(cfg), vae_state_dict(params, cfg), device)


def load_dalle_bundle(path, allow_legacy_pickle: bool = False, vqgan_config_path: Optional[str] = None):
    """A trained DALL-E checkpoint of any format the port reads -> (DALL-E
    config, its JAX-layout tree, VAE config, the VAE's tree): a v3 `.npz`
    whose `vae_class_name` names any family, a torch-reference `dalle.pt`
    (converted on load; a VQGanVAE one needs its taming yaml,
    `vqgan_config_path`), or a v1/v2 file with `allow_legacy_pickle`.  The
    JAX package's `cli/common.load_dalle_bundle`, which `cli/common.py`
    re-exports.  An orbax sharded directory exits naming ROADMAP.md Queue 1
    item 8."""
    from dalle_pytorch_tpu_torch.checkpoint import is_sharded_checkpoint, load_checkpoint
    from dalle_pytorch_tpu_torch.models import vae_registry
    from dalle_pytorch_tpu_torch.models.torch_port import is_torch_checkpoint, read_reference_dalle
    from dalle_pytorch_tpu_torch.version import __version__

    path = Path(path)
    if not path.exists():
        raise SystemExit(f"trained DALL-E {path} does not exist")
    if is_sharded_checkpoint(path):
        raise SystemExit(f"{path} is an orbax sharded checkpoint: reading it needs the port of "
                         "training/checkpoint.py (ROADMAP.md Queue 1 item 8)")
    if is_torch_checkpoint(path):
        ref = read_reference_dalle(path, vqgan_config_path)
        print(f"loaded reference-format checkpoint (version {ref.get('version')})")
        return ref["config"], ref["params"], ref["vae_config"], ref["vae_params"]
    trees, meta = load_checkpoint(str(path), allow_legacy_pickle=allow_legacy_pickle,
                                  names=("weights", "vae_weights"))
    if meta.get("version") != __version__:
        print(f"note: checkpoint version {meta.get('version')} != library {__version__}")
    vae_cfg = vae_registry.config_from_meta(meta.get("vae_class_name", "DiscreteVAE"), meta["vae_params"])
    return DALLEConfig.from_dict(meta["hparams"]), trees["weights"], vae_cfg, trees["vae_weights"]


def load_dalle_checkpoint(path, device: DeviceLike = None, allow_legacy_pickle: bool = False,
                          vqgan_config_path: Optional[str] = None) -> Tuple[DALLE, torch.nn.Module]:
    """The DALL-E and its VAE, of any family, from any checkpoint that
    `load_dalle_bundle` reads."""
    device = resolve_device(device)
    cfg, params, vae_cfg, vae_params = load_dalle_bundle(path, allow_legacy_pickle, vqgan_config_path)
    return load_dalle(params, cfg, device), load_vae(vae_params, vae_cfg, device)


# ---------------------------------------------------------------------------
# the name map: the port's parameter names -> the JAX package's paths
# ---------------------------------------------------------------------------


class ParamPath(NamedTuple):
    """Where a parameter of the port sits in the JAX package's tree: its
    '/'-joined path, its JAX shape, and whether that is the port's shape
    transposed (a linear weight, (in, out) there and (out, in) here)."""

    path: str
    shape: Tuple[int, ...]
    transposed: bool


def _param_paths(shapes: Dict[str, Tuple[int, ...]], to_tree) -> Dict[str, ParamPath]:
    """Run the tree writer `to_tree` on stand-in tensors that carry each
    parameter's index, and read back where each one landed."""
    names = list(shapes)
    tree = to_tree({n: torch.full((1,) * len(s), float(i)) for i, (n, s) in enumerate(shapes.items())})
    out: Dict[str, ParamPath] = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + [str(k)])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + [str(i)])
        else:
            name = names[int(node.reshape(-1)[0])]
            shape = tuple(shapes[name])
            transposed = path[-1] == "w" and len(shape) == 2
            out[name] = ParamPath("/".join(path), shape[::-1] if transposed else shape, transposed)

    walk(tree, [])
    return out


def _meta_shapes(build) -> Dict[str, Tuple[int, ...]]:
    with torch.device("meta"):
        module = build()
    return {n: tuple(p.shape) for n, p in module.named_parameters()}


@functools.lru_cache(maxsize=8)
def dalle_param_paths(cfg: DALLEConfig) -> Dict[str, ParamPath]:
    """{`DALLE` parameter name (`named_parameters`): its JAX path}, the map
    `dalle_tree` writes by."""
    return _param_paths(_meta_shapes(lambda: DALLE(cfg)), lambda sd: dalle_tree(sd, cfg))


@functools.lru_cache(maxsize=8)
def clip_param_paths(cfg: CLIPConfig) -> Dict[str, ParamPath]:
    """{`CLIP` parameter name: its JAX path}, the map `clip_tree` writes by."""
    return _param_paths(_meta_shapes(lambda: CLIP(cfg)), lambda sd: clip_tree(sd, cfg))
