"""The trainable discrete VAE image tokenizer (counterpart of
`dalle_pytorch_tpu/models/vae.py`).

A conv encoder gives per-cell codebook logits; the decoder maps codebook
embeddings back to pixels through transposed convolutions.  `forward` is the
training forward: a gumbel-softmax sample of the logits (optionally hard,
straight-through, with the ReinMax second-order estimator), its product with
the codebook in f32, the decoder, and the MSE or smooth-L1 reconstruction
loss plus the weighted KL to the uniform prior.  Public functions take and
return NHWC images, as the JAX package does; the modules run NCHW inside,
permuted once at each end.  Only the inference entry points
(`get_codebook_indices`, `decode_indices`) run without a gradient.

The gumbel noise comes from a uniform draw in [1e-20, 1): from a
`torch.Generator`, or injected as `uniform` (tests pass the exact draw of
the JAX package's `jax.random.uniform(key, logits.shape, float32, 1e-20,
1.0)`, since torch cannot reproduce threefry).  `temp` may be a 0-d device
tensor, so that annealing changes no Python value inside a step.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from dalle_pytorch_tpu_torch.core.device import DeviceLike, resolve_device
from dalle_pytorch_tpu_torch.core.module import fan_in_uniform_
from dalle_pytorch_tpu_torch.core.shard import uniform


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

    def forward(self, images, generator=None, uniform=None, return_loss=False, return_recons=False, temp=None):
        return forward(self, images, generator, uniform, return_loss, return_recons, temp)


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


def encode_logits(vae: DiscreteVAE, images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) pixels -> (B, h, w, num_tokens) codebook logits."""
    x = normalize_images(vae.cfg, images).permute(0, 3, 1, 2)
    for conv in vae.enc_convs:
        x = F.relu(conv(x))
    for res in vae.enc_res:
        x = res(x)
    return vae.enc_out(x).permute(0, 2, 3, 1)


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


@torch.no_grad()
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


def codebook_health_from_logits(logits: torch.Tensor, num_tokens: int) -> Dict[str, torch.Tensor]:
    """Codebook statistics of encoder logits (..., num_tokens), as device
    tensors (no host sync): `code_hist`, the hard (argmax) assignment count
    of each entry; `codebook_usage`, the fraction of entries chosen at
    least once; `codebook_perplexity`, exp of the entropy of the mean soft
    assignment (the effective number of codes in use: it falls towards 1
    as the codebook collapses); `codebook_entropy`, the mean entropy of one
    cell's assignment."""
    flat = logits.reshape(-1, num_tokens).float()
    hist = torch.bincount(flat.argmax(dim=-1), minlength=num_tokens)
    p = flat.softmax(dim=-1)
    p_mean = p.mean(dim=0)
    return {
        "code_hist": hist,
        "codebook_usage": (hist > 0).float().mean(),
        "codebook_perplexity": torch.exp(-(p_mean * torch.log(p_mean + 1e-20)).sum()),
        "codebook_entropy": (-(p * torch.log(p + 1e-20)).sum(dim=-1)).mean(),
    }


def gumbel_uniform(shape, generator: Optional[torch.Generator] = None, device=None) -> torch.Tensor:
    """A uniform f32 draw in [1e-20, 1), the range of the JAX package's
    `jax.random.uniform(key, shape, float32, 1e-20, 1.0)`: the port's [0, 1)
    draw (`core/shard.uniform`) with its zeros lifted to 1e-20, so that the noise's double log
    stays finite."""
    return uniform(shape, generator, device).clamp_min_(1e-20)


def gumbel_softmax(logits: torch.Tensor, tau, hard: bool, uniform: torch.Tensor) -> torch.Tensor:
    """softmax((logits + g) / tau) with gumbel noise g = -log(-log(u +
    1e-20)); `hard`: the one-hot of its argmax, with the soft sample's
    gradient (straight-through)."""
    g = -torch.log(-torch.log(uniform.to(logits.dtype) + 1e-20))
    soft = ((logits + g) / tau).softmax(dim=-1)
    if not hard:
        return soft
    one_hot = F.one_hot(soft.argmax(dim=-1), logits.shape[-1]).to(soft.dtype)
    return one_hot + soft - soft.detach()


def _reinmax(one_hot: torch.Tensor, logits: torch.Tensor, tau) -> torch.Tensor:
    """The ReinMax second-order estimator (algorithm 2 of
    arXiv:2304.08612): the hard sample's value with pi2's gradient."""
    one_hot = one_hot.detach()
    pi0 = logits.softmax(dim=-1)
    pi1 = (one_hot + (logits / tau).softmax(dim=-1)) / 2
    pi1 = ((torch.log(pi1.clamp_min(1e-20)) - logits).detach() + logits).softmax(dim=-1)
    pi2 = 2 * pi1 - 0.5 * pi0
    return pi2 - pi2.detach() + one_hot


def forward(
    vae: DiscreteVAE,
    images: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    uniform: Optional[torch.Tensor] = None,
    return_loss: bool = False,
    return_recons: bool = False,
    temp: Union[float, torch.Tensor, None] = None,
):
    """The training forward.  images: (B, H, W, C) in [0, 1].  The gumbel
    noise's uniform draw is `uniform` (the logits' shape, (B, h, w,
    num_tokens)) or, without it, drawn from `generator` on the images'
    device.  `temp` (a float or a 0-d tensor) defaults to the config's
    temperature.  Returns the reconstruction (B, H, W, C) in normalised
    pixel space; with `return_loss` the loss, the reconstruction loss plus
    `kl_div_loss_weight` times the KL to the uniform prior summed over
    batch, cells and classes; with `return_recons` too, (loss,
    reconstruction)."""
    cfg = vae.cfg
    if images.shape[1] != cfg.image_size or images.shape[2] != cfg.image_size:
        raise ValueError(f"input must have the correct image size {cfg.image_size}, got {tuple(images.shape)}")
    logits = encode_logits(vae, images)
    tau = cfg.temperature if temp is None else temp
    if uniform is None:
        if generator is None:
            raise ValueError("gumbel sampling needs a generator or an injected uniform draw")
        uniform = gumbel_uniform(logits.shape, generator, logits.device)
    one_hot = gumbel_softmax(logits, tau, cfg.straight_through, uniform)
    if cfg.straight_through and cfg.reinmax:
        one_hot = _reinmax(one_hot, logits, tau)

    sampled = torch.einsum("bhwn,nd->bhwd", one_hot.float(), vae.codebook.weight.float()).to(one_hot.dtype)
    out = decode_embeddings(vae, sampled)
    if not return_loss:
        return out

    target = normalize_images(cfg, images)
    if cfg.smooth_l1_loss:
        recon = F.smooth_l1_loss(out, target)
    else:
        recon = F.mse_loss(out, target)
    loss = recon
    if cfg.kl_div_loss_weight:  # at weight 0 the term adds 0 to the loss and to every gradient
        # KL(q || uniform), summed over batch, cells and classes: the
        # reference's kl_div(..., 'batchmean') sees a batch of one, so its
        # reduction is the full sum (JAX `models/vae.py` forward)
        log_qy = logits.reshape(logits.shape[0], -1, cfg.num_tokens).log_softmax(dim=-1)
        kl = (log_qy.exp() * (log_qy + math.log(cfg.num_tokens))).sum()
        loss = recon + kl * cfg.kl_div_loss_weight
    if not return_recons:
        return loss
    return loss, out
