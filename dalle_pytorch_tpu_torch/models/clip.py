"""CLIP: contrastive text and image encoders for reranking generations
(counterpart of `dalle_pytorch_tpu/models/clip.py`).

A non-causal text transformer with a masked-mean pooling and a ViT-style
patch transformer, each projected to a unit latent, and a learned
temperature; `forward` gives per-pair scores or the symmetric contrastive
loss.  Images are NHWC.  Both encoders are the port's `Transformer` with
`causal=False` and no rotary positions (learned position tables instead), so
their attention runs the flash forward non-causally, with the text mask as
its key mask.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from dalle_pytorch_tpu_torch.core.device import DeviceLike, resolve_device
from dalle_pytorch_tpu_torch.core.module import fan_in_uniform_
from dalle_pytorch_tpu_torch.models.transformer import (
    Transformer,
    TransformerConfig,
    apply_transformer,
    init_transformer_,
)
from dalle_pytorch_tpu_torch.parallel import tensor_parallel as tp


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    dim_text: int = 512
    dim_image: int = 512
    dim_latent: int = 512
    num_text_tokens: int = 10000
    text_enc_depth: int = 6
    text_seq_len: int = 256
    text_heads: int = 8
    visual_enc_depth: int = 6
    visual_heads: int = 8
    visual_image_size: int = 256
    visual_patch_size: int = 32
    channels: int = 3

    def __post_init__(self):
        if self.visual_image_size % self.visual_patch_size:
            raise ValueError("Image dimensions must be divisible by the patch size.")

    @property
    def num_patches(self) -> int:
        return (self.visual_image_size // self.visual_patch_size) ** 2

    @property
    def patch_dim(self) -> int:
        return self.channels * self.visual_patch_size ** 2

    def text_transformer_config(self) -> TransformerConfig:
        return TransformerConfig(dim=self.dim_text, depth=self.text_enc_depth, seq_len=self.text_seq_len,
                                 causal=False, heads=self.text_heads, rotary_emb=False)

    def visual_transformer_config(self) -> TransformerConfig:
        return TransformerConfig(dim=self.dim_image, depth=self.visual_enc_depth, seq_len=self.num_patches,
                                 causal=False, heads=self.visual_heads, rotary_emb=False)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class CLIP(nn.Module):
    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        self.cfg = cfg
        self.text_emb = nn.Embedding(cfg.num_text_tokens, cfg.dim_text)
        self.text_pos = nn.Embedding(cfg.text_seq_len, cfg.dim_text)
        self.text_transformer = Transformer(cfg.text_transformer_config())
        self.to_text_latent = nn.Linear(cfg.dim_text, cfg.dim_latent, bias=False)
        self.patch_emb = nn.Linear(cfg.patch_dim, cfg.dim_image)
        self.visual_pos = nn.Embedding(cfg.num_patches, cfg.dim_image)
        self.visual_transformer = Transformer(cfg.visual_transformer_config())
        self.to_visual_latent = nn.Linear(cfg.dim_image, cfg.dim_latent, bias=False)
        self.temperature = nn.Parameter(torch.ones(()))

    def forward(self, text, images, text_mask=None, return_loss=False):
        return forward(self, text, images, text_mask, return_loss)


@torch.no_grad()
def init_clip(cfg: CLIPConfig, generator: Optional[torch.Generator] = None, device: DeviceLike = None) -> CLIP:
    """A CLIP with seeded random float32 weights, drawn as the JAX package
    draws them: N(0, 1) embeddings, uniform ±1/sqrt(fan_in) linear layers,
    temperature 1.  `generator` must live on `device`.  Frozen, in eval
    mode."""
    device = resolve_device(device)
    with torch.device(device):
        model = CLIP(cfg)
    for emb in (model.text_emb, model.text_pos, model.visual_pos):
        emb.weight.normal_(generator=generator)
    for tr in (model.text_transformer, model.visual_transformer):
        init_transformer_(tr, generator)
    for lin in (model.to_text_latent, model.patch_emb, model.to_visual_latent):
        fan_in_uniform_(lin, generator)
    return model.eval().requires_grad_(False)


def _patchify(cfg: CLIPConfig, images: torch.Tensor) -> torch.Tensor:
    """(b, H, W, C) -> (b, num_patches, patch_dim) with (p1, p2, c) flattening."""
    b, H, W, C = images.shape
    p = cfg.visual_patch_size
    x = images.reshape(b, H // p, p, W // p, p, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (H // p) * (W // p), p * p * C)


def _unit(latent: torch.Tensor) -> torch.Tensor:
    return latent / torch.linalg.vector_norm(latent, dim=-1, keepdim=True)


def encode_text(model: CLIP, text: torch.Tensor, text_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(b, n) ids -> (b, dim_latent) unit latents; ids outside the vocab are
    clamped into it (the JAX package's `mode="clip"` take).  With a
    `text_mask` ((b, n), True = a token) attention sees only the masked-in
    keys and the pooling averages only those positions."""
    cfg = model.cfg
    emb = model.text_emb(text.clamp(0, cfg.num_text_tokens - 1))
    emb = emb + model.text_pos.weight[: text.shape[1]]
    enc = apply_transformer(model.text_transformer, emb, key_mask=text_mask)
    if text_mask is not None:
        m = text_mask[..., None].to(enc.dtype)
        latent = (enc * m).sum(dim=1) / m.sum(dim=1)
    else:
        latent = enc.mean(dim=1)
    return _unit(model.to_text_latent(latent))


def encode_image(model: CLIP, images: torch.Tensor) -> torch.Tensor:
    """(b, H, W, C) images -> (b, dim_latent) unit latents."""
    emb = model.patch_emb(_patchify(model.cfg, images))
    emb = emb + model.visual_pos.weight[: emb.shape[1]]
    enc = apply_transformer(model.visual_transformer, emb)
    return _unit(model.to_visual_latent(enc.mean(dim=1)))


def forward(model: CLIP, text: torch.Tensor, images: torch.Tensor, text_mask: Optional[torch.Tensor] = None,
            return_loss: bool = False) -> torch.Tensor:
    """Per-pair similarity scores (b,), or the symmetric contrastive loss.
    The loss's similarities and softmax run in f32 whatever the compute
    dtype: under bf16 compute the JAX package's loss is f32 too, its f32
    images promoting the image side.  Under the sharded train step's data
    parallelism the loss is over the global batch, as the JAX package's
    is: each rank gathers every rank's latents (`tensor_parallel.gather_rows`)."""
    tl = encode_text(model, text, text_mask)
    il = encode_image(model, images)
    temp = model.temperature.exp()
    if not return_loss:
        return (tl * il).sum(dim=-1) * temp
    tl, il = tp.gather_rows(tl), tp.gather_rows(il)
    sim = tl.float() @ il.float().t() * temp.float()
    labels = torch.arange(sim.shape[0], device=sim.device)
    return (F.cross_entropy(sim, labels) + F.cross_entropy(sim.t(), labels)) / 2
