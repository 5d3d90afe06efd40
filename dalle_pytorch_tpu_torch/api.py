"""Object-style facade (counterpart of `dalle_pytorch_tpu/api.py`):
`DiscreteVAE(...)` and `DALLE(vae=vae, ...)` bundle a config with a module on
one device.  Weights are drawn from a seed in float32, or carried over from
a JAX package parameter tree with `params=`, in the tree's own dtype.

Both run on the first CUDA device unless `device="cpu"` is passed; with no
card and no explicit CPU request they raise.  `DALLE(...)` passes every
other keyword to `DALLEConfig`: the attention types and their pattern knobs
(`attn_types`, `conv_kernel_size`, `conv_dilation`, `sparse_block_size`,
`sparse_per_head`), `attn_grid` and `sparse_decode` among them.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from dalle_pytorch_tpu_torch import weights
from dalle_pytorch_tpu_torch.core.device import DeviceLike, resolve_device
from dalle_pytorch_tpu_torch.models import dalle as _dalle
from dalle_pytorch_tpu_torch.models import sampling as _sampling
from dalle_pytorch_tpu_torch.models import vae as _vae


def _generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


class DiscreteVAE:
    def __init__(self, seed: int = 0, params: Optional[dict] = None, device: DeviceLike = None,
                 **cfg_kwargs):
        self.device = resolve_device(device)
        self.cfg = _vae.DiscreteVAEConfig(**cfg_kwargs)
        if params is not None:
            self.module = weights.load_vae(params, self.cfg, self.device)
        else:
            self.module = _vae.init_discrete_vae(
                self.cfg, _generator(seed, self.device), self.device)

    @property
    def image_size(self) -> int:
        return self.cfg.image_size

    @property
    def num_tokens(self) -> int:
        return self.cfg.num_tokens

    @property
    def num_layers(self) -> int:
        return self.cfg.num_layers

    def get_codebook_indices(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) pixels in [0, 1] -> (B, image_seq_len) codes."""
        return _vae.get_codebook_indices(self.module, images)

    def decode(self, img_seq: torch.Tensor) -> torch.Tensor:
        """(B, image_seq_len) codes -> (B, H, W, C) normalised pixels."""
        return _vae.decode_indices(self.module, img_seq)


class DALLE:
    def __init__(self, *, vae: DiscreteVAE, seed: int = 1, params: Optional[dict] = None,
                 device: DeviceLike = None, **cfg_kwargs):
        self.vae = vae
        self.device = resolve_device(device)
        self.cfg = _dalle.DALLEConfig.from_vae(vae.cfg, **cfg_kwargs)
        if params is not None:
            self.module = weights.load_dalle(params, self.cfg, self.device)
        else:
            self.module = _dalle.init_dalle(
                self.cfg, _generator(seed, self.device), self.device)

    @property
    def text_seq_len(self) -> int:
        return self.cfg.text_seq_len

    @property
    def image_seq_len(self) -> int:
        return self.cfg.image_seq_len

    @property
    def total_seq_len(self) -> int:
        return self.cfg.total_seq_len

    def __call__(self, text: torch.Tensor, image: Optional[torch.Tensor] = None,
                 return_loss: bool = False) -> torch.Tensor:
        """Scoring forward.  image: raw pixels (B, H, W, C) or codes
        (B, image_seq_len)."""
        codes = image
        if image is not None and image.ndim == 4:
            codes = self.vae.get_codebook_indices(image)
        return _dalle.forward(self.module, text, codes, return_loss=return_loss)

    forward = __call__

    def generate_images(self, text: torch.Tensor,
                        generator: Union[int, torch.Generator] = 0,
                        filter_thres: float = 0.5, temperature: float = 1.0,
                        img: Optional[torch.Tensor] = None,
                        num_init_img_tokens: Optional[int] = None,
                        cond_scale: float = 1.0,
                        timings: Optional[dict] = None) -> torch.Tensor:
        """Token ids (b, text_seq_len) -> images (b, H, W, C).  The gumbel
        noise comes from `generator`: a `torch.Generator` on the model's
        device, or a seed for one."""
        if isinstance(generator, int):
            generator = _generator(generator, self.device)
        return _sampling.generate_images(
            self.module, self.vae.module, text, generator,
            filter_thres=filter_thres, temperature=temperature, img=img,
            num_init_img_tokens=num_init_img_tokens, cond_scale=cond_scale,
            timings=timings,
        )
