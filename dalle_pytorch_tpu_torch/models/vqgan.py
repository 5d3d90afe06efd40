"""The taming VQGAN image tokenizer (counterpart of
`dalle_pytorch_tpu/models/vqgan.py`).

The taming-transformers VQModel / GumbelVQ: a conv encoder (GroupNorm +
swish resnet blocks, single-head spatial attention at the configured
resolutions, stride-2 downsampling), a quantizer (the nearest codebook
entry, or the argmax of GumbelVQ's own logits projection) and the mirrored
decoder (nearest-neighbour upsampling).  The modules run NCHW with plain
torch ops and carry taming's parameter names, so `state_dict()` reads like a
taming checkpoint's; the public functions take and return NHWC images, as
the JAX package does.  Pixels map through 2x - 1 in and (clamp + 1) / 2 out.

The numerics follow the JAX package: GroupNorm in f32 with eps 1e-6 over
min(32, c) groups; the downsample pads (0, 1, 0, 1) before its VALID
stride-2 conv; the codebook distance is |z|^2 - 2 z.e + |e|^2, summed in
that order, in f32 (a reordered sum flips near-ties).

`decoder_attn` says whether the decoder holds attention blocks at the
resolutions in `attn_resolutions`, as the published taming decoders do; the
JAX package's random initialisation leaves them out, and its converter
keeps whatever the checkpoint holds, so the module takes either.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from dalle_pytorch_tpu_torch.core.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class VQGANConfig:
    # ddconfig
    ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 1, 2, 2, 4)
    num_res_blocks: int = 2
    attn_resolutions: Tuple[int, ...] = (16,)
    in_channels: int = 3
    out_ch: int = 3
    resolution: int = 256
    z_channels: int = 256
    # quantizer
    n_embed: int = 1024
    embed_dim: int = 256
    is_gumbel: bool = False

    @property
    def num_layers(self) -> int:
        # the reference's f-factor: log2(resolution / attn_resolutions[0])
        f = self.resolution / self.attn_resolutions[0]
        return int(math.log(f) / math.log(2))

    @property
    def num_tokens(self) -> int:
        return self.n_embed

    @property
    def image_size(self) -> int:
        return self.resolution

    @property
    def channels(self) -> int:
        return self.in_channels

    @property
    def fmap_size(self) -> int:
        return self.resolution // (2 ** (len(self.ch_mult) - 1))

    @property
    def image_seq_len(self) -> int:
        return self.fmap_size ** 2

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, meta: dict) -> "VQGANConfig":
        meta = dict(meta)
        meta.pop("class", None)
        for key in ("ch_mult", "attn_resolutions"):
            if meta.get(key) is not None:
                meta[key] = tuple(meta[key])
        return cls(**meta)


# ---------------------------------------------------------------------------
# building blocks (NCHW)
# ---------------------------------------------------------------------------


class GroupNorm(nn.Module):
    """taming's GroupNorm(min(32, c), eps 1e-6), computed in f32 and cast
    back, as the JAX package computes it."""

    def __init__(self, c: int):
        super().__init__()
        self.groups = min(32, c)
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        return F.group_norm(x.float(), self.groups, self.weight.float(), self.bias.float(), 1e-6).to(x.dtype)


def _swish(x):
    return x * torch.sigmoid(x)


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.norm1 = GroupNorm(cin)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.norm2 = GroupNorm(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.nin_shortcut = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x):
        h = self.conv1(_swish(self.norm1(x)))
        h = self.conv2(_swish(self.norm2(h)))
        skip = x if self.nin_shortcut is None else self.nin_shortcut(x)
        return skip + h


class AttnBlock(nn.Module):
    """Single-head attention over the h*w positions (matmul + softmax; the
    scores in f32, as the JAX package takes them)."""

    def __init__(self, c: int):
        super().__init__()
        self.norm = GroupNorm(c)
        self.q, self.k, self.v, self.proj_out = (nn.Conv2d(c, c, 1) for _ in range(4))

    def forward(self, x):
        b, c, hh, ww = x.shape
        h = self.norm(x)
        q = self.q(h).reshape(b, c, hh * ww).transpose(1, 2)
        k = self.k(h).reshape(b, c, hh * ww)
        v = self.v(h).reshape(b, c, hh * ww).transpose(1, 2)
        attn = (torch.bmm(q.float(), k.float()) * (c ** -0.5)).softmax(dim=-1).to(x.dtype)
        h = torch.bmm(attn, v).transpose(1, 2).reshape(b, c, hh, ww)
        return x + self.proj_out(h)


class Downsample(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, stride=2)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class Level(nn.Module):
    """One resolution of the encoder or decoder: resnet blocks, each
    followed by an attention block when the level has them."""

    def __init__(self, cin: int, width: int, n_blocks: int, attn: bool):
        super().__init__()
        self.block = nn.ModuleList()
        for _ in range(n_blocks):
            self.block.append(ResnetBlock(cin, width))
            cin = width
        self.attn = nn.ModuleList(AttnBlock(width) for _ in range(n_blocks)) if attn else None

    def forward(self, h):
        for i, blk in enumerate(self.block):
            h = blk(h)
            if self.attn is not None:
                h = self.attn[i](h)
        return h


class Mid(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.block_1, self.attn_1, self.block_2 = ResnetBlock(c, c), AttnBlock(c), ResnetBlock(c, c)

    def forward(self, h):
        return self.block_2(self.attn_1(self.block_1(h)))


class Encoder(nn.Module):
    def __init__(self, cfg: VQGANConfig):
        super().__init__()
        widths = [cfg.ch * m for m in cfg.ch_mult]
        self.conv_in = nn.Conv2d(cfg.in_channels, cfg.ch, 3, padding=1)
        self.down = nn.ModuleList()
        cin, res = cfg.ch, cfg.resolution
        for lvl, w in enumerate(widths):
            level = Level(cin, w, cfg.num_res_blocks, res in cfg.attn_resolutions)
            if lvl != len(widths) - 1:
                level.downsample = Downsample(w)
                res //= 2
            self.down.append(level)
            cin = w
        self.mid = Mid(cin)
        self.norm_out = GroupNorm(cin)
        self.conv_out = nn.Conv2d(cin, cfg.z_channels, 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for level in self.down:
            h = level(h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        return self.conv_out(_swish(self.norm_out(self.mid(h))))


class Decoder(nn.Module):
    def __init__(self, cfg: VQGANConfig, attn: bool):
        super().__init__()
        widths = [cfg.ch * m for m in cfg.ch_mult]
        levels = len(widths)
        cin = widths[-1]
        self.conv_in = nn.Conv2d(cfg.z_channels, cin, 3, padding=1)
        self.mid = Mid(cin)
        up = [None] * levels
        res = cfg.resolution // 2 ** (levels - 1)
        for lvl in reversed(range(levels)):  # the widest level first
            w = widths[lvl]
            level = Level(cin, w, cfg.num_res_blocks + 1, attn and res in cfg.attn_resolutions)
            if lvl != 0:
                level.upsample = Upsample(w)
                res *= 2
            up[lvl] = level
            cin = w
        self.up = nn.ModuleList(up)
        self.norm_out = GroupNorm(cin)
        self.conv_out = nn.Conv2d(cin, cfg.out_ch, 3, padding=1)

    def forward(self, z):
        h = self.mid(self.conv_in(z))
        for level in reversed(self.up):
            h = level(h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        return self.conv_out(_swish(self.norm_out(h)))


class VectorQuantizer(nn.Module):
    def __init__(self, n_embed: int, embed_dim: int):
        super().__init__()
        self.embedding = nn.Embedding(n_embed, embed_dim)


class GumbelQuantize(nn.Module):
    def __init__(self, z_channels: int, embed_dim: int, n_embed: int):
        super().__init__()
        self.proj = nn.Conv2d(z_channels, n_embed, 1)
        self.embed = nn.Embedding(n_embed, embed_dim)


class VQGAN(nn.Module):
    def __init__(self, cfg: VQGANConfig, decoder_attn: bool = False):
        super().__init__()
        self.cfg, self.decoder_attn = cfg, decoder_attn
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg, decoder_attn)
        self.quant_conv = nn.Conv2d(cfg.z_channels, cfg.embed_dim, 1)
        self.post_quant_conv = nn.Conv2d(cfg.embed_dim, cfg.z_channels, 1)
        if cfg.is_gumbel:
            self.quantize = GumbelQuantize(cfg.z_channels, cfg.embed_dim, cfg.n_embed)
        else:
            self.quantize = VectorQuantizer(cfg.n_embed, cfg.embed_dim)

    @property
    def codebook(self) -> torch.Tensor:
        """(n_embed, embed_dim)."""
        return self.quantize.embed.weight if self.cfg.is_gumbel else self.quantize.embedding.weight


# ---------------------------------------------------------------------------
# the JAX package's functions (NHWC at the boundary)
# ---------------------------------------------------------------------------


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def encode(vae: VQGAN, x: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, C) in [-1, 1] -> the pre-quant z (B, fmap, fmap, embed_dim)."""
    return _nhwc(vae.quant_conv(vae.encoder(_nchw(x))))


def decode_z(vae: VQGAN, z: torch.Tensor) -> torch.Tensor:
    """The post-quant z (B, fmap, fmap, embed_dim) -> images in [-1, 1]."""
    return _nhwc(vae.decoder(vae.post_quant_conv(_nchw(z))))


@torch.no_grad()
def get_codebook_indices(vae: VQGAN, images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) pixels in [0, 1] -> (B, fmap**2) code ids."""
    cfg = vae.cfg
    z = encode(vae, 2.0 * images - 1.0)
    b = z.shape[0]
    if cfg.is_gumbel:
        # GumbelQuantize's own logits projection, after quant_conv (the
        # published gumbel models have embed_dim == z_channels)
        logits = vae.quantize.proj(_nchw(z))
        return logits.argmax(dim=1).reshape(b, -1)
    flat = z.reshape(b, -1, cfg.embed_dim).float()
    emb = vae.codebook.float()
    d = ((flat ** 2).sum(dim=-1, keepdim=True)
         - 2 * torch.einsum("bnd,ed->bne", flat, emb)
         + (emb ** 2).sum(dim=-1)[None, None])
    return d.argmin(dim=-1)


@torch.no_grad()
def decode_indices(vae: VQGAN, img_seq: torch.Tensor) -> torch.Tensor:
    """(B, n) code ids -> (B, H, W, C) images in [0, 1]: the codebook rows,
    the decoder, then (clamp(x, -1, 1) + 1) / 2."""
    b, n = img_seq.shape
    hw = math.isqrt(n)
    z = F.embedding(img_seq, vae.codebook).reshape(b, hw, hw, -1)
    return (decode_z(vae, z).clamp(-1.0, 1.0) + 1.0) * 0.5


# ---------------------------------------------------------------------------
# taming state dicts -> the JAX package's parameter tree (numpy)
# ---------------------------------------------------------------------------


def _np(v) -> np.ndarray:
    if hasattr(v, "detach"):
        v = v.detach().cpu().float().numpy()
    return np.asarray(v, np.float32)


def _cv(state, name):
    return {"w": np.transpose(_np(state[f"{name}.weight"]), (2, 3, 1, 0)), "b": _np(state[f"{name}.bias"])}


def _gn(state, name):
    return {"scale": _np(state[f"{name}.weight"]), "bias": _np(state[f"{name}.bias"])}


def _res(state, prefix):
    p = {"norm1": _gn(state, f"{prefix}.norm1"), "conv1": _cv(state, f"{prefix}.conv1"),
         "norm2": _gn(state, f"{prefix}.norm2"), "conv2": _cv(state, f"{prefix}.conv2")}
    if f"{prefix}.nin_shortcut.weight" in state:
        p["nin_shortcut"] = _cv(state, f"{prefix}.nin_shortcut")
    return p


def _attn(state, prefix):
    return {"norm": _gn(state, f"{prefix}.norm"),
            **{name: _cv(state, f"{prefix}.{name}") for name in ("q", "k", "v", "proj_out")}}


def convert_taming_state_dict(state: Dict, cfg: VQGANConfig) -> Dict:
    """A taming VQModel / GumbelVQ state dict (tensors or arrays) -> the JAX
    package's VQGAN parameter tree, numpy f32 leaves (JAX
    `convert_taming_state_dict`): HWIO kernels, a level's `attns` kept only
    where the checkpoint holds them."""
    levels = len(cfg.ch_mult)

    def level(prefix, n_blocks, res_has_attn):
        p = {"blocks": [], "attns": []}
        for i in range(n_blocks):
            p["blocks"].append(_res(state, f"{prefix}.block.{i}"))
            has = res_has_attn and f"{prefix}.attn.{i}.norm.weight" in state
            p["attns"].append(_attn(state, f"{prefix}.attn.{i}") if has else None)
        if not any(a is not None for a in p["attns"]):
            p.pop("attns")
        return p

    def mid(prefix):
        return {"block_1": _res(state, f"{prefix}.block_1"), "attn_1": _attn(state, f"{prefix}.attn_1"),
                "block_2": _res(state, f"{prefix}.block_2")}

    params: Dict = {
        "conv_in": _cv(state, "encoder.conv_in"), "down": [], "mid": mid("encoder.mid"),
        "norm_out": _gn(state, "encoder.norm_out"), "conv_out": _cv(state, "encoder.conv_out"),
        "quant_conv": _cv(state, "quant_conv"), "post_quant_conv": _cv(state, "post_quant_conv"),
        "dec_conv_in": _cv(state, "decoder.conv_in"), "dec_mid": mid("decoder.mid"), "up": [],
        "dec_norm_out": _gn(state, "decoder.norm_out"), "dec_conv_out": _cv(state, "decoder.conv_out"),
    }
    res = cfg.resolution
    for lvl in range(levels):
        p = level(f"encoder.down.{lvl}", cfg.num_res_blocks, res in cfg.attn_resolutions)
        if lvl != levels - 1:
            p["downsample"] = {"conv": _cv(state, f"encoder.down.{lvl}.downsample.conv")}
            res //= 2
        params["down"].append(p)
    for lvl in range(levels):
        p = level(f"decoder.up.{lvl}", cfg.num_res_blocks + 1, True)
        if lvl != 0:
            p["upsample"] = {"conv": _cv(state, f"decoder.up.{lvl}.upsample.conv")}
        params["up"].append(p)
    if cfg.is_gumbel:
        params["codebook"] = {"table": _np(state["quantize.embed.weight"])}
        params["quant_proj"] = _cv(state, "quantize.proj")
    else:
        params["codebook"] = {"table": _np(state["quantize.embedding.weight"])}
    return params


def config_from_taming_dict(config: dict, state: Dict) -> VQGANConfig:
    """A `VQGANConfig` from a parsed taming yaml (its `model` section or
    that section's `params`) and the state dict, whose keys reveal the
    GumbelVQ variant (JAX `config_from_taming_dict`)."""
    kwargs = {}
    params_cfg = config.get("params", config)
    dd = params_cfg.get("ddconfig", {})
    for k in ("ch", "num_res_blocks", "in_channels", "out_ch", "resolution", "z_channels"):
        if k in dd:
            kwargs[k] = dd[k]
    for k in ("ch_mult", "attn_resolutions"):
        if k in dd:
            kwargs[k] = tuple(dd[k])
    for k in ("n_embed", "embed_dim"):
        if k in params_cfg:
            kwargs[k] = params_cfg[k]
    kwargs["is_gumbel"] = "quantize.embed.weight" in state
    return VQGANConfig(**kwargs)


def load_vqgan(model_path: str, config: Optional[dict]) -> Tuple[Dict, VQGANConfig]:
    """A taming checkpoint (a Lightning `.ckpt` with a `state_dict`, read by
    `pretrained.load_torch_file`) and its parsed yaml -> (the JAX-layout
    tree, its config).  The config is required: the published geometry
    assumed for another checkpoint would mis-convert it."""
    from dalle_pytorch_tpu_torch.models.pretrained import load_torch_file, state_dict_of

    if not config:
        raise ValueError("load_vqgan requires the checkpoint's config dict (parsed from its taming yaml)")
    state = state_dict_of(load_torch_file(model_path))
    cfg = config_from_taming_dict(config, state)
    return convert_taming_state_dict(state, cfg), cfg


def has_decoder_attn(params: Dict) -> bool:
    """Whether a JAX-layout VQGAN tree's decoder holds attention blocks."""
    return any("attns" in level for level in params["up"])


# ---------------------------------------------------------------------------
# random weights with the layout (offline runs and tests)
# ---------------------------------------------------------------------------


@torch.no_grad()
def init_random_like(cfg: VQGANConfig, generator: Optional[torch.Generator] = None, device: DeviceLike = None,
                     decoder_attn: bool = False) -> VQGAN:
    """A VQGAN with seeded random f32 weights, from the JAX package's
    `init_random_like` distributions: convs uniform in ±1/sqrt(k*k*cin) with
    zero biases, GroupNorm ones and zeros, an N(0, 1) codebook."""
    device = resolve_device(device)
    with torch.device(device):
        vae = VQGAN(cfg, decoder_attn)
    for m in vae.modules():
        if isinstance(m, nn.Conv2d):
            bound = m.weight[0].numel() ** -0.5
            m.weight.uniform_(-bound, bound, generator=generator)
            m.bias.zero_()
    vae.codebook.normal_(generator=generator)
    return vae.eval().requires_grad_(False)
