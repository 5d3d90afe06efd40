"""OpenAI's pretrained discrete VAE (counterpart of
`dalle_pytorch_tpu/models/openai_vae.py`).

The published DALL-E dVAE: a 7x7 input conv, 4 groups of 2 residual blocks
(an identity or 1x1 path plus a relu-conv path of 3x3, 3x3, 3x3, 1x1 at a
quarter of the width), max-pool downsampling in the encoder and
nearest-neighbour upsampling in the decoder, a logit-laplace output whose
first 3 channels are the pixels.  The geometry is fixed: 256 px, 8,192
tokens, fmap 32, n_hid 256.  The modules run NCHW with plain torch ops;
the public functions take and return NHWC images.  Pixels map through
`map_pixels` / `unmap_pixels` (eps 0.1).

The JAX decoder feeds the one-hot codes through its 1x1 input conv; here
`decode_indices` gathers that conv's weight columns instead, the same sum
without the (B, 8192, 32, 32) one-hot (`one_hot_input` keeps the one-hot
form for tests).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from dalle_pytorch_tpu_torch.core.device import DeviceLike, resolve_device

LOGIT_LAPLACE_EPS = 0.1
GROUP_COUNT = 4
N_BLK_PER_GROUP = 2
N_HID = 256
VOCAB = 8192
DEC_INIT = 128  # the decoder's input conv width (n_init)
ENC_WIDTHS = (N_HID, 2 * N_HID, 4 * N_HID, 8 * N_HID)
DEC_WIDTHS = (8 * N_HID, 4 * N_HID, 2 * N_HID, N_HID)


class OpenAIVAEConfig:
    """The fixed facts of the OpenAI dVAE."""

    image_size = 256
    num_layers = 3
    num_tokens = VOCAB
    channels = 3
    codebook_dim = None  # the codes live in logit space

    @property
    def fmap_size(self) -> int:
        return self.image_size // (2 ** self.num_layers)

    @property
    def image_seq_len(self) -> int:
        return self.fmap_size ** 2

    def to_dict(self) -> dict:
        return {"class": "OpenAIDiscreteVAE"}

    def __eq__(self, other) -> bool:
        return type(other) is OpenAIVAEConfig

    def __hash__(self) -> int:
        return hash(OpenAIVAEConfig)


def map_pixels(x: torch.Tensor, eps: float = LOGIT_LAPLACE_EPS) -> torch.Tensor:
    return (1 - 2 * eps) * x + eps


def unmap_pixels(x: torch.Tensor, eps: float = LOGIT_LAPLACE_EPS) -> torch.Tensor:
    return ((x - eps) / (1 - 2 * eps)).clamp(0.0, 1.0)


def _conv(cin: int, cout: int, k: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, padding=(k - 1) // 2)


class Block(nn.Module):
    """id path (a 1x1 conv where the width changes) + relu-conv x 4."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        hid = cout // 4
        self.id = _conv(cin, cout, 1) if cin != cout else None
        self.c1, self.c2, self.c3 = _conv(cin, hid, 3), _conv(hid, hid, 3), _conv(hid, hid, 3)
        self.c4 = _conv(hid, cout, 1)

    def forward(self, x):
        idp = x if self.id is None else self.id(x)
        h = self.c1(F.relu(x))
        h = self.c2(F.relu(h))
        h = self.c3(F.relu(h))
        return idp + self.c4(F.relu(h))


class Half(nn.Module):
    """The encoder's or decoder's skeleton: the input conv, 4 groups of
    blocks (resampled between groups), relu and the 1x1 output conv."""

    def __init__(self, widths, k_in: int, cin: int, cout: int, first: int):
        super().__init__()
        self.input = _conv(cin, first, k_in)
        groups, c = [], first
        for w in widths:
            groups.append(nn.ModuleList(Block(c if i == 0 else w, w) for i in range(N_BLK_PER_GROUP)))
            c = w
        self.groups = nn.ModuleList(groups)
        self.output = _conv(widths[-1], cout, 1)

    def body(self, x, resample):
        for g, group in enumerate(self.groups):
            for blk in group:
                x = blk(x)
            if g < GROUP_COUNT - 1:
                x = resample(x)
        return self.output(F.relu(x))


class OpenAIVAE(nn.Module):
    def __init__(self):
        super().__init__()
        self.cfg = OpenAIVAEConfig()
        self.encoder = Half(ENC_WIDTHS, 7, 3, VOCAB, ENC_WIDTHS[0])
        self.decoder = Half(DEC_WIDTHS, 1, VOCAB, 6, DEC_INIT)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def encoder_logits(vae: OpenAIVAE, images: torch.Tensor) -> torch.Tensor:
    """(B, 256, 256, 3) in [0, 1] -> logits (B, 32, 32, 8192)."""
    enc = vae.encoder
    x = enc.input(_nchw(map_pixels(images)))
    return _nhwc(enc.body(x, lambda t: F.max_pool2d(t, 2)))


def _decode_from_input(vae: OpenAIVAE, x: torch.Tensor) -> torch.Tensor:
    """The decoder after its input conv: NCHW (B, 128, 32, 32) -> (B, 256,
    256, 3) in [0, 1]."""
    x = vae.decoder.body(x, lambda t: F.interpolate(t, scale_factor=2.0, mode="nearest"))
    return unmap_pixels(torch.sigmoid(_nhwc(x)[..., :3]))


def one_hot_input(vae: OpenAIVAE, img_seq: torch.Tensor) -> torch.Tensor:
    """The JAX form of the decoder's input: the one-hot codes (B, 8192, h,
    w) through the 1x1 input conv."""
    b, n = img_seq.shape
    hw = math.isqrt(n)
    z = F.one_hot(img_seq, VOCAB).to(vae.decoder.input.weight.dtype).reshape(b, hw, hw, VOCAB)
    return vae.decoder.input(_nchw(z))


def gathered_input(vae: OpenAIVAE, img_seq: torch.Tensor) -> torch.Tensor:
    """The same as `one_hot_input`: the input conv's weight column of each
    code, plus its bias."""
    b, n = img_seq.shape
    hw = math.isqrt(n)
    conv = vae.decoder.input
    cols = F.embedding(img_seq, conv.weight[:, :, 0, 0].t()) + conv.bias
    return _nchw(cols.reshape(b, hw, hw, -1))


@torch.no_grad()
def get_codebook_indices(vae: OpenAIVAE, images: torch.Tensor) -> torch.Tensor:
    """(B, 256, 256, 3) in [0, 1] -> (B, 1024) codes: the logits' argmax."""
    logits = encoder_logits(vae, images)
    return logits.argmax(dim=-1).reshape(images.shape[0], -1)


@torch.no_grad()
def decode_indices(vae: OpenAIVAE, img_seq: torch.Tensor) -> torch.Tensor:
    """(B, 1024) codes -> (B, 256, 256, 3) images in [0, 1]."""
    return _decode_from_input(vae, gathered_input(vae, img_seq))


# ---------------------------------------------------------------------------
# OpenAI state dicts -> the JAX package's parameter tree (numpy)
# ---------------------------------------------------------------------------


def _np(v) -> np.ndarray:
    if hasattr(v, "detach"):
        v = v.detach().cpu().float().numpy()
    return np.asarray(v, np.float32)


def _convert_conv(state: Dict, prefix: str) -> Dict:
    """A conv of the `dall_e` modules (`{prefix}.w` / `.b`) or a plain one
    (`.weight` / `.bias`), (O, I, kh, kw) -> HWIO."""
    for wkey, bkey in ((f"{prefix}.w", f"{prefix}.b"), (f"{prefix}.weight", f"{prefix}.bias")):
        if wkey in state:
            return {"w": np.transpose(_np(state[wkey]), (2, 3, 1, 0)), "b": _np(state[bkey]).reshape(-1)}
    raise KeyError(f"no conv weights under {prefix}")


def _convert_half(state: Dict) -> Dict:
    """One half from the `dall_e` names: blocks.input, blocks.group_{g}.
    block_{i}.{id_path|res_path.conv_N}, blocks.output.conv (or
    blocks.output)."""
    groups = []
    for g in range(GROUP_COUNT):
        group = []
        for i in range(N_BLK_PER_GROUP):
            prefix = f"blocks.group_{g + 1}.block_{i + 1}"
            blk = {f"c{j}": _convert_conv(state, f"{prefix}.res_path.conv_{j}") for j in range(1, 5)}
            if f"{prefix}.id_path.w" in state or f"{prefix}.id_path.weight" in state:
                blk["id"] = _convert_conv(state, f"{prefix}.id_path")
            group.append(blk)
        groups.append(group)
    try:
        out = _convert_conv(state, "blocks.output.conv")
    except KeyError:
        out = _convert_conv(state, "blocks.output")
    return {"input": _convert_conv(state, "blocks.input"), "groups": groups, "output": out}


def convert_openai_state_dicts(encoder_state: Dict, decoder_state: Dict) -> Dict:
    """The two `dall_e` state dicts (tensors or arrays) -> the JAX package's
    {"encoder", "decoder"} tree, numpy f32 leaves."""
    return {"encoder": _convert_half(encoder_state), "decoder": _convert_half(decoder_state)}


def load_openai_vae(encoder_path: str, decoder_path: str) -> Dict:
    """The published `encoder.pkl` / `decoder.pkl` (pickled `dall_e`
    modules, read by `pretrained.load_torch_file` without that package) ->
    the JAX-layout tree."""
    from dalle_pytorch_tpu_torch.models.pretrained import load_torch_file, state_dict_of

    return convert_openai_state_dicts(state_dict_of(load_torch_file(encoder_path)),
                                      state_dict_of(load_torch_file(decoder_path)))


@torch.no_grad()
def init_random(generator: Optional[torch.Generator] = None, device: DeviceLike = None) -> OpenAIVAE:
    """A dVAE with seeded random f32 weights, from the JAX package's
    `init_random_like` distributions: convs uniform in ±1/sqrt(k*k*cin),
    zero biases."""
    device = resolve_device(device)
    with torch.device(device):
        vae = OpenAIVAE()
    for m in vae.modules():
        if isinstance(m, nn.Conv2d):
            bound = m.weight[0].numel() ** -0.5
            m.weight.uniform_(-bound, bound, generator=generator)
            m.bias.zero_()
    return vae.eval().requires_grad_(False)
