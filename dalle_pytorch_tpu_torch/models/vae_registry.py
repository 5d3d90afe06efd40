"""Dispatch over the three VAE families by config type (counterpart of
`dalle_pytorch_tpu/models/vae_registry.py`).

A checkpoint names the VAE it was trained with (`vae_class_name`) beside that
VAE's config (`vae_params`): the trainable `DiscreteVAE`, the taming VQGAN
(`VQGanVAE`) or OpenAI's dVAE (`OpenAIDiscreteVAE`).  Each family's module
carries its config as `.cfg`, and its module of functions exposes
`get_codebook_indices(vae, images)` and `decode_indices(vae, img_seq)` over
NHWC pixels in [0, 1], so the sampler, the engine and the trainer call
through here and never name a family.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from dalle_pytorch_tpu_torch.models import openai_vae as _openai_mod
from dalle_pytorch_tpu_torch.models import vae as _dvae_mod
from dalle_pytorch_tpu_torch.models import vqgan as _vqgan_mod
from dalle_pytorch_tpu_torch.models.openai_vae import OpenAIVAEConfig
from dalle_pytorch_tpu_torch.models.vae import DiscreteVAEConfig
from dalle_pytorch_tpu_torch.models.vqgan import VQGANConfig

_BY_CONFIG = {
    DiscreteVAEConfig: ("DiscreteVAE", _dvae_mod),
    VQGANConfig: ("VQGanVAE", _vqgan_mod),
    OpenAIVAEConfig: ("OpenAIDiscreteVAE", _openai_mod),
}


def vae_class_name(vae_cfg: Any) -> str:
    return _BY_CONFIG[type(vae_cfg)][0]


def vae_module(vae_cfg: Any):
    return _BY_CONFIG[type(vae_cfg)][1]


def get_codebook_indices(vae: torch.nn.Module, images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) pixels in [0, 1] -> (B, image_seq_len) codes."""
    return vae_module(vae.cfg).get_codebook_indices(vae, images)


def decode_indices(vae: torch.nn.Module, img_seq: torch.Tensor) -> torch.Tensor:
    """(B, image_seq_len) codes -> (B, H, W, C) images (`to_display` maps
    them to [0, 1])."""
    return vae_module(vae.cfg).decode_indices(vae, img_seq)


def to_display(vae_cfg: Any, images: torch.Tensor) -> torch.Tensor:
    """Decoded images -> display space [0, 1].  The DiscreteVAE decodes into
    its normalised space, so its normalisation is undone first; the VQGAN
    and OpenAI decoders emit [0, 1] already, and are clipped."""
    if isinstance(vae_cfg, DiscreteVAEConfig):
        return _dvae_mod.denormalize_images(vae_cfg, images)
    if isinstance(vae_cfg, (VQGANConfig, OpenAIVAEConfig)):
        return images.clamp(0.0, 1.0)
    raise TypeError(f"no VAE family for config {type(vae_cfg).__name__}")


def config_from_meta(class_name: str, vae_params_meta: Dict) -> Any:
    """Rebuild the VAE config from checkpoint metadata (`vae_class_name` and
    the config dict saved under `vae_params`; JSON lists become tuples)."""
    if class_name == "DiscreteVAE":
        return DiscreteVAEConfig.from_dict(vae_params_meta)
    if class_name == "VQGanVAE":
        return VQGANConfig.from_dict(vae_params_meta)
    if class_name == "OpenAIDiscreteVAE":
        return OpenAIVAEConfig()
    raise ValueError(f"unknown vae_class_name {class_name!r}")


def config_to_meta(vae_cfg: Any) -> Tuple[str, Dict]:
    return vae_class_name(vae_cfg), vae_cfg.to_dict()
