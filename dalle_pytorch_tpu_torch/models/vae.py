"""The discrete VAE image tokenizer, inference side (counterpart of
`dalle_pytorch_tpu/models/vae.py`).

A conv encoder gives per-cell codebook logits; the decoder maps codebook
embeddings back to pixels through transposed convolutions.  Public functions
take and return NHWC images, as the JAX package does; the modules run NCHW
inside.  Training (gumbel-softmax sampling and the loss) comes with the
training slice.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from dalle_pytorch_tpu_torch.core.device import DeviceLike, resolve_device
from dalle_pytorch_tpu_torch.core.module import fan_in_uniform_


@dataclasses.dataclass(frozen=True)
class DiscreteVAEConfig:
    image_size: int = 256
    num_tokens: int = 512
    codebook_dim: int = 512
    num_layers: int = 3
    num_resnet_blocks: int = 0
    hidden_dim: int = 64
    channels: int = 3
    # training-only settings, kept so that a JAX checkpoint's meta loads as is
    smooth_l1_loss: bool = False
    temperature: float = 0.9
    straight_through: bool = False
    reinmax: bool = False
    kl_div_loss_weight: float = 0.0
    # per-channel (means, stds); truncated to `channels`
    normalization: Optional[Tuple[Tuple[float, ...], Tuple[float, ...]]] = (
        (0.5, 0.5, 0.5, 0.0),
        (0.5, 0.5, 0.5, 1.0),
    )

    def __post_init__(self):
        if not math.log2(self.image_size).is_integer():
            raise ValueError("image size must be a power of 2")
        if self.num_layers < 1:
            raise ValueError("number of layers must be >= 1")

    @property
    def fmap_size(self) -> int:
        return self.image_size // (2 ** self.num_layers)

    @property
    def image_seq_len(self) -> int:
        return self.fmap_size ** 2

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, meta: dict) -> "DiscreteVAEConfig":
        meta = dict(meta)
        meta.pop("class", None)
        if meta.get("normalization") is not None:
            meta["normalization"] = tuple(tuple(x) for x in meta["normalization"])
        return cls(**meta)


class ResBlock(nn.Module):
    def __init__(self, chan: int):
        super().__init__()
        self.c1 = nn.Conv2d(chan, chan, 3, padding=1)
        self.c2 = nn.Conv2d(chan, chan, 3, padding=1)
        self.c3 = nn.Conv2d(chan, chan, 1)

    def forward(self, x):
        return self.c3(F.relu(self.c2(F.relu(self.c1(x))))) + x


class DiscreteVAE(nn.Module):
    def __init__(self, cfg: DiscreteVAEConfig):
        super().__init__()
        self.cfg = cfg
        hdim = cfg.hidden_dim
        has_res = cfg.num_resnet_blocks > 0
        self.codebook = nn.Embedding(cfg.num_tokens, cfg.codebook_dim)
        self.enc_convs = nn.ModuleList(
            nn.Conv2d(cfg.channels if i == 0 else hdim, hdim, 4, stride=2, padding=1)
            for i in range(cfg.num_layers)
        )
        self.enc_res = nn.ModuleList(ResBlock(hdim) for _ in range(cfg.num_resnet_blocks))
        self.enc_out = nn.Conv2d(hdim, cfg.num_tokens, 1)
        dec_in = hdim if has_res else cfg.codebook_dim
        self.dec_deconvs = nn.ModuleList(
            nn.ConvTranspose2d(dec_in if i == 0 else hdim, hdim, 4, stride=2, padding=1)
            for i in range(cfg.num_layers)
        )
        self.dec_res = nn.ModuleList(ResBlock(hdim) for _ in range(cfg.num_resnet_blocks))
        self.dec_out = nn.Conv2d(hdim, cfg.channels, 1)
        self.dec_in = nn.Conv2d(cfg.codebook_dim, hdim, 1) if has_res else None


@torch.no_grad()
def init_discrete_vae(
    cfg: DiscreteVAEConfig,
    generator: Optional[torch.Generator] = None,
    device: DeviceLike = None,
) -> DiscreteVAE:
    """A VAE with seeded random float32 weights, from the JAX package's
    distributions: uniform ±1/sqrt(fan_in) convs, an N(0, 1) codebook."""
    device = resolve_device(device)
    with torch.device(device):
        vae = DiscreteVAE(cfg)
    for m in vae.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            fan_in_uniform_(m, generator)
    vae.codebook.weight.normal_(generator=generator)
    return vae.eval().requires_grad_(False)


def _norm_stats(cfg: DiscreteVAEConfig, like: torch.Tensor):
    means = torch.tensor(cfg.normalization[0][: cfg.channels], dtype=like.dtype, device=like.device)
    stds = torch.tensor(cfg.normalization[1][: cfg.channels], dtype=like.dtype, device=like.device)
    return means, stds


def normalize_images(cfg: DiscreteVAEConfig, images: torch.Tensor) -> torch.Tensor:
    """images: (B, H, W, C) in [0, 1]."""
    if cfg.normalization is None:
        return images
    means, stds = _norm_stats(cfg, images)
    return (images - means) / stds


def denormalize_images(cfg: DiscreteVAEConfig, images: torch.Tensor) -> torch.Tensor:
    """The inverse of `normalize_images`, clipped to [0, 1]."""
    if cfg.normalization is not None:
        means, stds = _norm_stats(cfg, images)
        images = images * stds + means
    return images.clamp(0.0, 1.0)


@torch.no_grad()
def encode_logits(vae: DiscreteVAE, images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) pixels -> (B, h, w, num_tokens) codebook logits."""
    x = normalize_images(vae.cfg, images).permute(0, 3, 1, 2)
    for conv in vae.enc_convs:
        x = F.relu(conv(x))
    for res in vae.enc_res:
        x = res(x)
    return vae.enc_out(x).permute(0, 2, 3, 1)


@torch.no_grad()
def decode_embeddings(vae: DiscreteVAE, z: torch.Tensor) -> torch.Tensor:
    """(B, h, w, codebook_dim) -> (B, H, W, C) in normalised pixel space."""
    x = z.permute(0, 3, 1, 2)
    if vae.dec_in is not None:
        x = vae.dec_in(x)
    for res in vae.dec_res:
        x = res(x)
    for deconv in vae.dec_deconvs:
        x = F.relu(deconv(x))
    return vae.dec_out(x).permute(0, 2, 3, 1)


def get_codebook_indices(vae: DiscreteVAE, images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) pixels -> (B, image_seq_len) code indices."""
    logits = encode_logits(vae, images)
    return logits.argmax(dim=-1).reshape(logits.shape[0], -1)


@torch.no_grad()
def decode_indices(vae: DiscreteVAE, img_seq: torch.Tensor) -> torch.Tensor:
    """(B, image_seq_len) code indices -> (B, H, W, C) images."""
    b, n = img_seq.shape
    hw = math.isqrt(n)
    z = vae.codebook(img_seq).reshape(b, hw, hw, vae.cfg.codebook_dim)
    return decode_embeddings(vae, z)
