"""Object-style facade (counterpart of `dalle_pytorch_tpu/api.py`):
`DiscreteVAE(...)`, `OpenAIDiscreteVAE(...)`, `VQGanVAE(...)`,
`DALLE(vae=vae, ...)` and `CLIP(...)` bundle a config with a module on one
device; `DALLE` takes any of the three VAEs.  Weights are drawn from a seed in float32, or
carried over from a JAX package parameter tree with `params=`, in the
tree's own dtype.

All run on the first CUDA device unless `device="cpu"` is passed; with no
card and no explicit CPU request they raise.  `DALLE(...)` passes every
other keyword to `DALLEConfig`: the attention types and their pattern knobs
(`attn_types`, `conv_kernel_size`, `conv_dilation`, `sparse_block_size`,
`sparse_per_head`), `attn_grid`, `attn_vfa`, `sparse_decode`,
`share_input_output_emb` and `rotary_emb` (False: learned text and axial
image positions, the JAX train CLI's default model) among them.
"""
from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch

from dalle_pytorch_tpu_torch import weights
from dalle_pytorch_tpu_torch.core.device import DeviceLike, resolve_device
from dalle_pytorch_tpu_torch.models import clip as _clip
from dalle_pytorch_tpu_torch.models import dalle as _dalle
from dalle_pytorch_tpu_torch.models import openai_vae as _ovae
from dalle_pytorch_tpu_torch.models import pretrained as _pretrained
from dalle_pytorch_tpu_torch.models import sampling as _sampling
from dalle_pytorch_tpu_torch.models import vae as _vae
from dalle_pytorch_tpu_torch.models import vae_registry as _registry
from dalle_pytorch_tpu_torch.models import vqgan as _vqgan


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

    @property
    def channels(self) -> int:
        return self.cfg.channels

    def __call__(self, images: torch.Tensor, generator: Union[int, torch.Generator, None] = None,
                 return_loss: bool = False, return_recons: bool = False, temp=None):
        """The training forward (`models/vae.forward`): (B, H, W, C) pixels
        in [0, 1] -> the reconstruction, the loss, or (loss, reconstruction).
        The gumbel noise comes from `generator`, a `torch.Generator` on the
        module's device or a seed for one (0 when None, as the JAX facade
        takes key 0).  Gradients reach the module's parameters once they
        require them (`vae.module.requires_grad_(True)`)."""
        if not isinstance(generator, torch.Generator):
            generator = _generator(generator or 0, self.device)
        return _vae.forward(self.module, images, generator, return_loss=return_loss, return_recons=return_recons,
                            temp=temp)

    forward = __call__

    def get_codebook_indices(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) pixels in [0, 1] -> (B, image_seq_len) codes."""
        return _vae.get_codebook_indices(self.module, images)

    def decode(self, img_seq: torch.Tensor) -> torch.Tensor:
        """(B, image_seq_len) codes -> (B, H, W, C) normalised pixels."""
        return _vae.decode_indices(self.module, img_seq)


class _PretrainedVAE:
    """What the pretrained families share: the config's geometry, and codes
    to pixels and back through `models/vae_registry.py`."""

    cfg: object
    module: torch.nn.Module

    @property
    def image_size(self) -> int:
        return self.cfg.image_size

    @property
    def num_tokens(self) -> int:
        return self.cfg.num_tokens

    @property
    def num_layers(self) -> int:
        return self.cfg.num_layers

    @property
    def channels(self) -> int:
        return self.cfg.channels

    def get_codebook_indices(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) pixels in [0, 1] -> (B, image_seq_len) codes."""
        return _registry.get_codebook_indices(self.module, images)

    def decode(self, img_seq: torch.Tensor) -> torch.Tensor:
        """(B, image_seq_len) codes -> (B, H, W, C) pixels in [0, 1]."""
        return _registry.decode_indices(self.module, img_seq)


class OpenAIDiscreteVAE(_PretrainedVAE):
    """OpenAI's pretrained dVAE (JAX `api.OpenAIDiscreteVAE`).  With no
    arguments, the pretrained cache (`models/pretrained.py`: the converted
    file, else the published pickles fetched and converted once); the
    published `encoder_path` and `decoder_path` together; or, beyond the
    JAX facade, a JAX-layout tree (`params`) or random weights from `seed`."""

    def __init__(self, encoder_path: Optional[str] = None, decoder_path: Optional[str] = None,
                 params: Optional[dict] = None, seed: Optional[int] = None, device: DeviceLike = None):
        if (encoder_path is None) != (decoder_path is None):
            raise ValueError("provide both encoder_path and decoder_path, or neither")
        self.device = resolve_device(device)
        self.cfg = _ovae.OpenAIVAEConfig()
        if encoder_path is not None:
            params = _ovae.load_openai_vae(encoder_path, decoder_path)
        elif params is None and seed is None:
            params, _ = _pretrained.load_openai_vae_pretrained()
        if params is not None:
            self.module = weights.load_vae(params, self.cfg, self.device)
        else:
            self.module = _ovae.init_random(_generator(seed, self.device), self.device)


class VQGanVAE(_PretrainedVAE):
    """A pretrained taming VQGAN or GumbelVQ (JAX `api.VQGanVAE`): a
    checkpoint (`vqgan_model_path`) with its parsed taming config
    (`vqgan_config`), or with neither the published default through the
    pretrained cache; or, beyond the JAX facade, a JAX-layout tree
    (`params`) or random weights from `seed` (with `decoder_attn`), for a
    `VQGANConfig` (`cfg`)."""

    def __init__(self, vqgan_model_path: Optional[str] = None, vqgan_config: Optional[dict] = None,
                 params: Optional[dict] = None, cfg: Optional[_vqgan.VQGANConfig] = None,
                 seed: Optional[int] = None, decoder_attn: bool = False, device: DeviceLike = None):
        self.device = resolve_device(device)
        if vqgan_model_path is not None:
            params, cfg = _vqgan.load_vqgan(vqgan_model_path, vqgan_config)
        elif vqgan_config is not None:
            raise ValueError("a custom vqgan_config requires its vqgan_model_path")
        elif params is None and seed is None:
            params, cfg = _pretrained.load_vqgan_pretrained()
        self.cfg = cfg if cfg is not None else _vqgan.VQGANConfig()
        if params is not None:
            self.module = weights.load_vae(params, self.cfg, self.device)
        else:
            self.module = _vqgan.init_random_like(self.cfg, _generator(seed, self.device), self.device,
                                                  decoder_attn=decoder_attn)

    @property
    def is_gumbel(self) -> bool:
        return self.cfg.is_gumbel


class DALLE:
    def __init__(self, *, vae: Union[DiscreteVAE, OpenAIDiscreteVAE, VQGanVAE], seed: int = 1,
                 params: Optional[dict] = None, device: DeviceLike = None, **cfg_kwargs):
        self.vae = vae
        self.device = resolve_device(device)
        self.cfg = _dalle.DALLEConfig.from_vae(vae.cfg, **cfg_kwargs)
        if params is not None:
            self.module = weights.load_dalle(params, self.cfg, self.device)
        else:
            self.module = _dalle.init_dalle(
                self.cfg, _generator(seed, self.device), self.device)
        # the CUDA graphs of its decode steps (the JAX facade's ExecutableCache)
        self.decode_graphs = _sampling.decode_graphs(self.module)

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
                        timings: Optional[dict] = None,
                        clip: Optional["CLIP"] = None,
                        graphs: Optional[bool] = None):
        """Token ids (b, text_seq_len) -> images (b, H, W, C), or with a
        `clip`, (images, scores) for reranking.  The gumbel noise comes
        from `generator`: a `torch.Generator` on the model's device, or a
        seed for one.  On the card the decode loop replays CUDA graphs
        from `decode_graphs` unless `graphs=False`."""
        if isinstance(generator, int):
            generator = _generator(generator, self.device)
        return _sampling.generate_images(
            self.module, self.vae.module, text, generator,
            filter_thres=filter_thres, temperature=temperature, img=img,
            num_init_img_tokens=num_init_img_tokens, cond_scale=cond_scale,
            timings=timings, clip=None if clip is None else clip.module, graphs=graphs,
        )

    def generate_texts(self, tokenizer=None, text: Union[str, torch.Tensor, None] = None,
                       generator: Union[int, torch.Generator] = 0, filter_thres: float = 0.5,
                       temperature: float = 1.0,
                       graphs: Optional[bool] = None) -> Tuple[torch.Tensor, Optional[List[str]]]:
        """Complete a prompt: a string (encoded by `tokenizer`), (b, n0) ids,
        or None (a single 0 token).  Returns (ids (b, text_seq_len), their
        decoded texts without the padding ids, or None without a
        tokenizer).  `graphs` as in `generate_images`."""
        if isinstance(text, str):
            if tokenizer is None:
                raise ValueError("a text prompt needs a tokenizer")
            text = torch.tensor([tokenizer.encode(text)], dtype=torch.long, device=self.device)
        if isinstance(generator, int):
            generator = _generator(generator, self.device)
        tokens = _sampling.generate_texts(self.module, text, generator, filter_thres=filter_thres,
                                          temperature=temperature, graphs=graphs)
        texts = None
        if tokenizer is not None:
            cfg = self.cfg
            pad_tokens = set(range(cfg.num_text_tokens_padded - cfg.text_seq_len, cfg.num_text_tokens_padded))
            texts = [tokenizer.decode(t.cpu().numpy(), pad_tokens=pad_tokens) for t in tokens]
        return tokens, texts


class CLIP:
    def __init__(self, seed: int = 2, params: Optional[dict] = None, device: DeviceLike = None, **cfg_kwargs):
        self.device = resolve_device(device)
        self.cfg = _clip.CLIPConfig(**cfg_kwargs)
        if params is not None:
            self.module = weights.load_clip(params, self.cfg, self.device)
        else:
            self.module = _clip.init_clip(self.cfg, _generator(seed, self.device), self.device)

    def __call__(self, text: torch.Tensor, images: torch.Tensor, text_mask: Optional[torch.Tensor] = None,
                 return_loss: bool = False) -> torch.Tensor:
        """(b, text_seq_len) ids and (b, H, W, C) images -> per-pair scores
        (b,), or the symmetric contrastive loss."""
        return _clip.forward(self.module, text, images, text_mask=text_mask, return_loss=return_loss)
