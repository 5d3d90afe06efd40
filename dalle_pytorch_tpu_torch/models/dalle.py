"""The text -> image autoregressive DALL-E model (counterpart of
`dalle_pytorch_tpu/models/dalle.py`).

A joint text + image vocabulary with a unique padding id per text position,
<bos> prepended, rotary positions, logits masked so that text positions
predict text and image positions predict image, and the (text + 7·img)/8
weighted cross-entropy.  The model works on image *codes*; the VAE that turns
pixels into codes is composed by the caller.  The forward is differentiable:
the training step takes its gradient (`parallel/train_step.py`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from dalle_pytorch_tpu_torch.core.device import DeviceLike, resolve_device
from dalle_pytorch_tpu_torch.core.module import LayerNorm, fan_in_uniform_
from dalle_pytorch_tpu_torch.models.transformer import (
    Transformer,
    TransformerConfig,
    apply_transformer,
    init_transformer_,
)

# execution knobs of the JAX package's config that do not change what the
# model computes (layer scan, XLA-or-Pallas choice, sharding axes): a
# checkpoint's hparams carry them, the port ignores them.  The pattern knobs
# (conv_kernel_size, conv_dilation, sparse_block_size, sparse_per_head) are
# real fields: they define the attention pattern.
_EXECUTION_ONLY = (
    "scan_layers", "attn_kernel", "seq_shard_axis", "pipeline_axis",
    "pp_interleave", "pp_num_micro",
)


@dataclasses.dataclass(frozen=True)
class DALLEConfig:
    dim: int
    depth: int
    num_text_tokens: int = 10000  # raw text vocab; per-position pad ids are reserved on top
    text_seq_len: int = 256
    heads: int = 8
    dim_head: int = 64
    reversible: bool = False
    attn_dropout: float = 0.0
    ff_dropout: float = 0.0
    attn_types: Tuple[str, ...] = ("full",)
    loss_img_weight: float = 7.0
    stable: bool = False
    sandwich_norm: bool = False
    shift_tokens: bool = True
    rotary_emb: bool = True
    shared_attn_ids: Optional[Tuple[int, ...]] = None
    shared_ff_ids: Optional[Tuple[int, ...]] = None
    share_input_output_emb: bool = False
    execution: Optional[str] = None
    remat_policy: str = "full"
    num_image_tokens: int = 512
    image_fmap_size: int = 32
    # the pattern knobs and the flash grid (TransformerConfig)
    conv_kernel_size: int = 5
    conv_dilation: int = 1
    sparse_block_size: int = 16
    sparse_per_head: bool = False
    attn_grid: str = "auto"
    attn_vfa: bool = False
    sparse_decode: bool = True

    def __post_init__(self):
        unsupported = [
            name for name, bad in (
                ("reversible", self.reversible),
                ("rotary_emb=False", not self.rotary_emb),
                ("share_input_output_emb", self.share_input_output_emb),
            ) if bad
        ]
        if unsupported:
            raise NotImplementedError(
                f"the PyTorch port does not run {', '.join(unsupported)} yet"
            )
        self.transformer_config()  # raises on the transformer settings it lacks

    @property
    def num_text_tokens_padded(self) -> int:
        return self.num_text_tokens + self.text_seq_len

    @property
    def image_seq_len(self) -> int:
        return self.image_fmap_size ** 2

    @property
    def total_seq_len(self) -> int:
        return self.text_seq_len + self.image_seq_len

    @property
    def total_tokens(self) -> int:
        return self.num_text_tokens_padded + self.num_image_tokens

    def transformer_config(self) -> TransformerConfig:
        return TransformerConfig(
            dim=self.dim,
            depth=self.depth,
            seq_len=self.total_seq_len,
            causal=True,
            heads=self.heads,
            dim_head=self.dim_head,
            attn_dropout=self.attn_dropout,
            ff_dropout=self.ff_dropout,
            attn_types=self.attn_types,
            image_fmap_size=self.image_fmap_size,
            stable=self.stable,
            sandwich_norm=self.sandwich_norm,
            shift_tokens=self.shift_tokens,
            rotary_emb=self.rotary_emb,
            shared_attn_ids=self.shared_attn_ids,
            shared_ff_ids=self.shared_ff_ids,
            execution=self.execution or "sequential",
            remat_policy=self.remat_policy,
            conv_kernel_size=self.conv_kernel_size,
            conv_dilation=self.conv_dilation,
            sparse_block_size=self.sparse_block_size,
            sparse_per_head=self.sparse_per_head,
            attn_grid=self.attn_grid,
            attn_vfa=self.attn_vfa,
            sparse_decode=self.sparse_decode,
        )

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, hparams: dict) -> "DALLEConfig":
        """Rebuild from the JAX package's `to_dict` (a checkpoint's `hparams`):
        json lists become tuples, execution-only knobs are dropped."""
        out = {k: v for k, v in hparams.items() if k not in _EXECUTION_ONLY}
        for k in ("attn_types", "shared_attn_ids", "shared_ff_ids"):
            if out.get(k) is not None:
                out[k] = tuple(out[k])
        return cls(**out)

    @classmethod
    def from_vae(cls, vae_cfg, **kwargs) -> "DALLEConfig":
        fmap = vae_cfg.image_size // (2 ** vae_cfg.num_layers)
        return cls(num_image_tokens=vae_cfg.num_tokens, image_fmap_size=fmap, **kwargs)


class DALLE(nn.Module):
    def __init__(self, cfg: DALLEConfig):
        super().__init__()
        self.cfg = cfg
        self.transformer = Transformer(cfg.transformer_config())
        self.logits_norm = LayerNorm(cfg.dim)
        self.logits_linear = nn.Linear(cfg.dim, cfg.total_tokens)
        self.text_emb = nn.Embedding(cfg.num_text_tokens_padded, cfg.dim)
        self.image_emb = nn.Embedding(cfg.num_image_tokens, cfg.dim)

    @property
    def dtype(self) -> torch.dtype:
        """The weight dtype: activations and the decode cache run in it."""
        return self.logits_linear.weight.dtype

    def forward(self, text, image_codes=None, return_loss=False, null_cond_prob=0.0,
                generator=None):
        return forward(self, text, image_codes, return_loss, null_cond_prob, generator)


@torch.no_grad()
def init_dalle(
    cfg: DALLEConfig,
    generator: Optional[torch.Generator] = None,
    device: DeviceLike = None,
) -> DALLE:
    """A DALL-E with seeded random float32 weights, drawn as the JAX package
    draws them: uniform ±1/sqrt(fan_in) for linear layers, N(0, 1) embeddings,
    LayerScale by depth.  `generator` must live on `device`.  The model comes
    frozen, in eval mode, for serving; a trainer unfreezes its own."""
    device = resolve_device(device)
    with torch.device(device):
        model = DALLE(cfg)
    init_transformer_(model.transformer, generator)
    fan_in_uniform_(model.logits_linear, generator)
    for emb in (model.text_emb, model.image_emb):
        emb.weight.normal_(generator=generator)
    return model.eval().requires_grad_(False)


# ---------------------------------------------------------------------------
# embedding helpers (shared with the sampler)
# ---------------------------------------------------------------------------


def remap_and_bos(cfg: DALLEConfig, text: torch.Tensor) -> torch.Tensor:
    """Clamp ids into the raw vocab, give padding (id 0) a unique
    per-position id, then prepend <bos> = 0."""
    text = text.clamp(0, cfg.num_text_tokens - 1)
    text_range = torch.arange(cfg.text_seq_len, device=text.device) + (
        cfg.num_text_tokens_padded - cfg.text_seq_len
    )
    text = torch.where(text == 0, text_range[: text.shape[1]], text)
    return F.pad(text, (1, 0), value=0)


def embed_text_ids(model: DALLE, text_ids: torch.Tensor) -> torch.Tensor:
    """text_ids: (b, n) post-remap ids incl. bos."""
    return model.text_emb(text_ids)


def embed_image_codes(model: DALLE, codes: torch.Tensor) -> torch.Tensor:
    """codes: (b, m) image code ids, clipped into the codebook as the JAX
    package's `mode="clip"` take does.  Positions come from rotary, so no
    position table is added."""
    return model.image_emb(codes.clamp(0, model.cfg.num_image_tokens - 1))


def logits_mask_slice(cfg: DALLEConfig, n: int, device=None) -> torch.Tensor:
    """(n, total_tokens) bool; True = forbidden."""
    seq = torch.arange(n, device=device)[:, None]
    tok = torch.arange(cfg.total_tokens, device=device)[None, :]
    in_text_vocab = tok < cfg.num_text_tokens_padded
    return ((seq >= cfg.text_seq_len) & in_text_vocab) | ((seq < cfg.text_seq_len) & ~in_text_vocab)


def to_logits(model: DALLE, x: torch.Tensor) -> torch.Tensor:
    return model.logits_linear(model.logits_norm(x))


# ---------------------------------------------------------------------------
# forward / loss
# ---------------------------------------------------------------------------


def forward(
    model: DALLE,
    text: torch.Tensor,
    image_codes: Optional[torch.Tensor] = None,
    return_loss: bool = False,
    null_cond_prob: float = 0.0,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Training and scoring forward.  text: (b, text_seq_len) ids, 0 =
    padding; image_codes: (b, image_seq_len) VAE codes.  Returns the masked
    logits (b, n, total_tokens) or the weighted CE loss.

    `generator` draws the null-conditioning mask (each caption is blanked
    with probability `null_cond_prob`, for classifier-free guidance) and
    then the transformer's dropout masks; without it neither is drawn."""
    cfg = model.cfg
    if text.shape[-1] != cfg.text_seq_len:
        raise ValueError(f"text length {text.shape[-1]} != text_seq_len {cfg.text_seq_len}")
    if null_cond_prob > 0.0:
        if generator is None:
            raise ValueError("null_cond_prob needs a generator")
        null = torch.rand(text.shape[0], generator=generator, device=generator.device) < null_cond_prob
        text = text * (~null).to(text.device, text.dtype)[:, None]
    text_ids = remap_and_bos(cfg, text)
    tokens = embed_text_ids(model, text_ids)
    if image_codes is not None and image_codes.numel() > 0:
        tokens = torch.cat([tokens, embed_image_codes(model, image_codes)], dim=1)
    # the final token has nothing left to predict
    tokens = tokens[:, : cfg.total_seq_len]
    n = tokens.shape[1]

    out = apply_transformer(model.transformer, tokens, generator=generator)
    logits = to_logits(model, out)
    logits = logits.masked_fill(
        logits_mask_slice(cfg, n, logits.device)[None], torch.finfo(logits.dtype).min
    )
    if not return_loss:
        return logits

    if image_codes is None:
        raise ValueError("the loss needs image codes")
    labels = torch.cat([text_ids[:, 1:], image_codes + cfg.num_text_tokens_padded], dim=1)
    logits32 = logits.float()
    token_ll = logits32.gather(-1, labels[..., None])[..., 0] - torch.logsumexp(logits32, dim=-1)
    loss_text = -token_ll[:, : cfg.text_seq_len].mean()
    loss_img = -token_ll[:, cfg.text_seq_len:].mean()
    return (loss_text + cfg.loss_img_weight * loss_img) / (cfg.loss_img_weight + 1)
