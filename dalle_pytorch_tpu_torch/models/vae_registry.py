"""Dispatch over the VAE families by config type (counterpart of
`dalle_pytorch_tpu/models/vae_registry.py`).

A checkpoint names the VAE it was trained with (`vae_class_name`) beside that
VAE's config (`vae_params`).  The port has one family, the `DiscreteVAE`; the
taming VQGAN (`VQGanVAE`) and the OpenAI dVAE (`OpenAIDiscreteVAE`) are
named, and refused until they are ported (`ROADMAP.md` Queue 1 item 5).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from dalle_pytorch_tpu_torch.models import vae as _dvae_mod
from dalle_pytorch_tpu_torch.models.vae import DiscreteVAEConfig

_BY_CONFIG = {DiscreteVAEConfig: "DiscreteVAE"}
_WAITING = ("VQGanVAE", "OpenAIDiscreteVAE")


def vae_class_name(vae_cfg: Any) -> str:
    return _BY_CONFIG[type(vae_cfg)]


def to_display(vae_cfg: Any, images: torch.Tensor) -> torch.Tensor:
    """Decoded images -> display space [0, 1].  The DiscreteVAE decodes into
    its normalised space, so its normalisation is undone first."""
    if isinstance(vae_cfg, DiscreteVAEConfig):
        return _dvae_mod.denormalize_images(vae_cfg, images)
    raise TypeError(f"no VAE family for config {type(vae_cfg).__name__}")


def config_from_meta(class_name: str, vae_params_meta: Dict) -> Any:
    """Rebuild the VAE config from checkpoint metadata (`vae_class_name` and
    the config dict saved under `vae_params`)."""
    if class_name == "DiscreteVAE":
        return DiscreteVAEConfig.from_dict(vae_params_meta)
    if class_name in _WAITING:
        raise NotImplementedError(
            f"the port decodes with DiscreteVAE only; {class_name} comes with the model "
            "variants (ROADMAP.md Queue 1 item 5)"
        )
    raise ValueError(f"unknown vae_class_name {class_name!r}")


def config_to_meta(vae_cfg: Any) -> Tuple[str, Dict]:
    return vae_class_name(vae_cfg), vae_cfg.to_dict()
