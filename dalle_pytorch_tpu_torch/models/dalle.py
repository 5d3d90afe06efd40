"""The text -> image autoregressive DALL-E model (counterpart of
`dalle_pytorch_tpu/models/dalle.py`).

A joint text + image vocabulary with a unique padding id per text position,
<bos> prepended, rotary positions or learned ones (`rotary_emb=False`: a
text position table and the image's axial table, summed rows and columns),
logits masked so that text positions predict text and image positions
predict image, and the (text + 7·img)/8 weighted cross-entropy.  Under
`stable` the embeddings enter the transformer as `0.1·t + 0.9·t.detach()`
and its output is divided by its max over the channels (`divide_max`).  With
`share_input_output_emb` the text and image embedding tables are the rows
of the logits weight (the tied flagship layout): no embedding modules, and
the weight's gradient sums its three uses.  The model works on image
*codes*; the VAE that turns pixels into codes is composed by the caller.
The forward is differentiable: the training step takes its gradient
(`parallel/train_step.py`).

Under the sharded step's tensor parallelism (`parallel/tensor_parallel.py`)
the logits weight and bias hold this rank's contiguous part of the
vocabulary: the logits are vocab-parallel, the cross-entropy takes its
log-sum-exp and the label's logit with one sum over tp each, and the tied
tables are vocab-parallel embeddings (each rank looks up the ids it holds,
the rows summed over tp).

Under the sharded step's sequence parallelism (`seq_shard_axis`), each sp
rank embeds, runs and scores its own positions of the sequence: the logits
are masked by global position, and the loss is the rank's part of the
global one (its text and image log-likelihoods summed over the global
counts), so that the sp ranks' losses and gradients sum to the
one-process ones; the text/image boundary may fall inside any rank's part.
Under the pipeline (`pipeline_axis`), stage 0 embeds, the stages run their
layers (`parallel/pipeline.py`), and the last stage computes the logits and
the loss; the other stages return a 0-d zero that carries the backward to
their layers.  `forward` is `embed`, the stack and `head`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from dalle_pytorch_tpu_torch import quantization
from dalle_pytorch_tpu_torch.core import shard as shard_mod
from dalle_pytorch_tpu_torch.core.device import DeviceLike, resolve_device
from dalle_pytorch_tpu_torch.core.module import LayerNorm, fan_in_uniform_
from dalle_pytorch_tpu_torch.models.transformer import (
    Transformer,
    TransformerConfig,
    apply_transformer,
    check_pipeline,
    init_transformer_,
    stage_runner,
)
from dalle_pytorch_tpu_torch.ops.stable import divide_max
from dalle_pytorch_tpu_torch.parallel import tensor_parallel as tp
from dalle_pytorch_tpu_torch.parallel.pipeline import pipeline

# the execution knob of the JAX package's config that the port has no
# counterpart of (it unrolls its layers): a checkpoint's hparams carry it,
# the port ignores it.  The mesh knobs (attn_kernel, seq_shard_axis,
# pipeline_axis, pp_num_micro, pp_interleave) and the pattern knobs
# (conv_kernel_size, conv_dilation, sparse_block_size, sparse_per_head) are
# real fields.
_EXECUTION_ONLY = ("scan_layers",)


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
    # the mesh knobs (TransformerConfig): inert without a sharded step
    attn_kernel: str = "auto"
    seq_shard_axis: Optional[str] = None
    pipeline_axis: Optional[str] = None
    pp_interleave: int = 1
    pp_num_micro: Optional[int] = None

    def __post_init__(self):
        self.transformer_config()  # raises on an invalid transformer setting

    @property
    def resolved_execution(self) -> str:
        """`execution`, or when it is None "reversible" under `reversible`
        and "sequential" otherwise, as the JAX package resolves it."""
        if self.execution is not None:
            return self.execution
        return "reversible" if self.reversible else "sequential"

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
            execution=self.resolved_execution,
            remat_policy=self.remat_policy,
            conv_kernel_size=self.conv_kernel_size,
            conv_dilation=self.conv_dilation,
            sparse_block_size=self.sparse_block_size,
            sparse_per_head=self.sparse_per_head,
            attn_grid=self.attn_grid,
            attn_vfa=self.attn_vfa,
            sparse_decode=self.sparse_decode,
            attn_kernel=self.attn_kernel,
            seq_shard_axis=self.seq_shard_axis,
            pipeline_axis=self.pipeline_axis,
            pp_num_micro=self.pp_num_micro,
            pp_interleave=self.pp_interleave,
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
        if not cfg.share_input_output_emb:
            self.text_emb = nn.Embedding(cfg.num_text_tokens_padded, cfg.dim)
            self.image_emb = nn.Embedding(cfg.num_image_tokens, cfg.dim)
        if not cfg.rotary_emb:  # learned positions; separate parameters under the tie too
            self.text_pos = nn.Embedding(cfg.text_seq_len + 1, cfg.dim)
            self.image_pos_h = nn.Embedding(cfg.image_fmap_size, cfg.dim)
            self.image_pos_w = nn.Embedding(cfg.image_fmap_size, cfg.dim)

    @property
    def dtype(self) -> torch.dtype:
        """The weight dtype (a quantized model's scale dtype): activations
        and the decode cache run in it."""
        return quantization.weight_dtype(self)

    @property
    def device(self) -> torch.device:
        return self.logits_linear.bias.device

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
    draws them: uniform ±1/sqrt(fan_in) for linear layers, N(0, 1) embeddings
    (none when they are tied to the logits weight) and position tables,
    LayerScale by depth.
    `generator` must live on `device`.  The model comes frozen, in eval
    mode, for serving; a trainer unfreezes its own."""
    device = resolve_device(device)
    with torch.device(device):
        model = DALLE(cfg)
    init_transformer_(model.transformer, generator)
    fan_in_uniform_(model.logits_linear, generator)
    tables = [] if cfg.share_input_output_emb else [model.text_emb, model.image_emb]
    if not cfg.rotary_emb:
        tables += [model.text_pos, model.image_pos_h, model.image_pos_w]
    for emb in tables:
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


def _table_rows(model: DALLE, ids: torch.Tensor, image: bool) -> torch.Tensor:
    """The text or image embedding rows at `ids`.  Under the tie the table
    is the logits weight's text or image rows (a view, so the gradient
    reaches the weight).  A quantized table or tied weight dequantizes only
    the gathered rows."""
    cfg = model.cfg
    ntp = cfg.num_text_tokens_padded
    if cfg.share_input_output_emb:
        lin = model.logits_linear
        if isinstance(lin, quantization.QuantLinear):
            return lin.rows(ids, ntp if image else 0)
        shard = shard_mod.current()
        if shard.tp:  # vocab-parallel: this rank's rows [start, start + held) of the table
            held = lin.weight.shape[0]
            local = ids + (ntp if image else 0) - shard.tp_rank * held
            mine = (local >= 0) & (local < held)
            rows = F.embedding(local.clamp(0, held - 1), lin.weight) * mine[..., None].to(lin.weight.dtype)
            return tp.reduce_from_tp(rows)
        return F.embedding(ids, lin.weight[ntp:] if image else lin.weight[:ntp])
    emb = model.image_emb if image else model.text_emb
    if isinstance(emb, quantization.QuantEmbedding):
        return emb.rows(ids)
    return F.embedding(ids, emb.weight)


def embed_text_ids(model: DALLE, text_ids: torch.Tensor, positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """text_ids: (b, n) post-remap ids incl. bos.  Under the tie the table is
    the logits weight's first num_text_tokens_padded rows, a view, so the
    gradient reaches the weight.  Without rotary the rows of `text_pos` at
    `positions` are added: 0..n-1 by default, else a long tensor that
    broadcasts against (b, n) (a decode step's device offset), clamped into
    the table as the JAX package's clip-mode take does."""
    cfg = model.cfg
    emb = _table_rows(model, text_ids, image=False)
    if cfg.rotary_emb:
        return emb
    if positions is None:
        positions = torch.arange(text_ids.shape[1], device=text_ids.device)
    return emb + F.embedding(positions.clamp(0, cfg.text_seq_len), model.text_pos.weight)


def _image_pos_rows(model: DALLE, idx: torch.Tensor) -> torch.Tensor:
    """The axial table's rows at raster positions `idx` (any shape): row
    idx // fmap of `image_pos_h` plus column idx % fmap of `image_pos_w`,
    the same sums `image_pos_table` holds."""
    fmap = model.cfg.image_fmap_size
    return F.embedding(idx // fmap, model.image_pos_h.weight) + F.embedding(idx % fmap, model.image_pos_w.weight)


def image_pos_table(model: DALLE) -> Optional[torch.Tensor]:
    """(image_seq_len, dim) axial position embeddings (the JAX package's
    `image_pos_table`: h repeated, plus w tiled), or None under rotary."""
    cfg = model.cfg
    if cfg.rotary_emb:
        return None
    return _image_pos_rows(model, torch.arange(cfg.image_seq_len, device=model.image_pos_h.weight.device))


def embed_image_codes(model: DALLE, codes: torch.Tensor, start: Optional[torch.Tensor] = None) -> torch.Tensor:
    """codes: (b, m) image code ids, clipped into the codebook as the JAX
    package's `mode="clip"` take does; under the tie the table is the
    logits weight's image rows.  Without rotary the codes sit at raster
    positions start..start+m-1 and their axial rows are added: `start` is
    None (0), a long device scalar (a decode loop's position) or (b,) (one
    per lane), clamped so the m positions fit, as the JAX package's
    `dynamic_slice` clamps its start.  A tensor, never a Python int, so a
    captured step reads the position from the device."""
    cfg = model.cfg
    emb = _table_rows(model, codes.clamp(0, cfg.num_image_tokens - 1), image=True)
    if cfg.rotary_emb:
        return emb
    m = codes.shape[1]
    idx = torch.arange(m, device=codes.device)
    if start is not None:
        idx = start.clamp(0, cfg.image_seq_len - m).reshape(-1, 1) + idx
    return emb + _image_pos_rows(model, idx)


def logits_mask_slice(cfg: DALLEConfig, n: int, device=None, vocab: Optional[slice] = None,
                      start: int = 0) -> torch.Tensor:
    """(n, total_tokens) bool, True = forbidden, for the positions start ..
    start + n - 1; with `vocab`, those columns alone."""
    seq = start + torch.arange(n, device=device)[:, None]
    vocab = vocab or slice(0, cfg.total_tokens)
    tok = torch.arange(vocab.start, vocab.stop, device=device)[None, :]
    in_text_vocab = tok < cfg.num_text_tokens_padded
    return ((seq >= cfg.text_seq_len) & in_text_vocab) | ((seq < cfg.text_seq_len) & ~in_text_vocab)


def to_logits(model: DALLE, x: torch.Tensor) -> torch.Tensor:
    """The logits (this rank's vocabulary columns under tensor
    parallelism, the norm's output entering them through Megatron's f)."""
    return model.logits_linear(tp.copy_to_tp(model.logits_norm(x)))


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
    then the transformer's dropout masks; without it neither is drawn.

    Under sequence sharding the logits are this rank's positions' and the
    loss its part of the global loss; under the pipeline only the loss
    runs, and a stage other than the last returns a 0-d zero."""
    cfg = model.cfg
    if text.shape[-1] != cfg.text_seq_len:
        raise ValueError(f"text length {text.shape[-1]} != text_seq_len {cfg.text_seq_len}")
    if null_cond_prob > 0.0:
        if generator is None:
            raise ValueError("null_cond_prob needs a generator")
        null = shard_mod.uniform(text.shape[:1], generator, generator.device) < null_cond_prob
        text = text * (~null).to(text.device, text.dtype)[:, None]
    text_ids = remap_and_bos(cfg, text)
    shard = shard_mod.current()
    if cfg.pipeline_axis is not None:
        check_pipeline(model.transformer.cfg)
    if cfg.pipeline_axis is not None and shard.pp:
        if not return_loss:
            raise ValueError("the pipeline runs the training loss alone: call forward with return_loss=True")
        first, last = shard.pp_rank == 0, shard.pp_rank == shard.pp_size - 1
        tokens = embed(model, text_ids, image_codes) if first else None
        n = min(text_ids.shape[1] + (0 if image_codes is None else image_codes.shape[1]), cfg.total_seq_len)
        params, run = stage_runner(model.transformer, generator)
        lin = model.logits_linear.weight
        out = pipeline(run, tokens, params, text.shape[0], (_seq_part(cfg, n)[1], cfg.dim), shard.pp_ranks,
                       shard.pp_rank, cfg.pp_num_micro, cfg.pp_interleave, lin.dtype, lin.device)
        if not last:
            return out
    else:
        tokens = embed(model, text_ids, image_codes)
        out = apply_transformer(model.transformer, tokens, generator=generator)
    return head(model, out, text_ids, image_codes, return_loss)


def _seq_part(cfg: DALLEConfig, n: int) -> Tuple[int, int]:
    """(first global position, length) of this rank's part of a sequence of
    n: all of it, or under sequence sharding its sp rank's part, which must
    be the one the step publishes (`ShardContext.seq_start`)."""
    shard = shard_mod.current()
    if cfg.seq_shard_axis is None or not shard.sp:
        return 0, n
    if n % shard.sp_size:
        raise ValueError(f"a sequence of {n} does not split over sp {shard.sp_size}")
    n_loc = n // shard.sp_size
    if shard.seq_start != shard.sp_rank * n_loc:
        raise ValueError(f"sp rank {shard.sp_rank} holds positions from {shard.seq_start}, not "
                         f"{shard.sp_rank * n_loc}: the step shards a sequence of {cfg.total_seq_len}")
    return shard.seq_start, n_loc


def embed(model: DALLE, text_ids: torch.Tensor, image_codes: Optional[torch.Tensor]) -> torch.Tensor:
    """The transformer's input: the text and image embeddings (the final
    token dropped: it has nothing left to predict), blended under `stable`;
    under sequence sharding this rank's positions."""
    cfg = model.cfg
    tokens = embed_text_ids(model, text_ids)
    if image_codes is not None and image_codes.numel() > 0:
        tokens = torch.cat([tokens, embed_image_codes(model, image_codes)], dim=1)
    tokens = tokens[:, : cfg.total_seq_len]
    start, n = _seq_part(cfg, tokens.shape[1])
    if n != tokens.shape[1]:
        tokens = tokens[:, start:start + n]
    if cfg.stable:  # the gradient reaches the embeddings scaled by alpha
        alpha = 0.1
        tokens = tokens * alpha + tokens.detach() * (1 - alpha)
    return tokens


def head(model: DALLE, out: torch.Tensor, text_ids: torch.Tensor, image_codes: Optional[torch.Tensor],
         return_loss: bool) -> torch.Tensor:
    """The transformer's output to masked logits, or to the weighted
    cross-entropy; under sequence sharding at this rank's positions, the
    loss its part of the global one."""
    cfg = model.cfg
    if cfg.stable:
        out = divide_max(out)
    n_img = 0 if image_codes is None else image_codes.shape[1]
    start, n = _seq_part(cfg, min(text_ids.shape[1] + n_img, cfg.total_seq_len))
    shard = shard_mod.current()
    # this rank's columns of the vocabulary under tensor parallelism
    vocab = tp.local_slice(cfg.total_tokens, shard.tp_rank, shard.tp_size) if shard.tp else None
    logits = to_logits(model, out)
    logits = logits.masked_fill(
        logits_mask_slice(cfg, n, logits.device, vocab, start)[None], torch.finfo(logits.dtype).min
    )
    if not return_loss:
        return tp.gather_from_tp(logits)

    if image_codes is None:
        raise ValueError("the loss needs image codes")
    labels = torch.cat([text_ids[:, 1:], image_codes + cfg.num_text_tokens_padded], dim=1)
    n_labels = labels.shape[1]
    labels = labels[:, start:start + n]
    logits32 = logits.float()
    if vocab is None:
        token_ll = logits32.gather(-1, labels[..., None])[..., 0] - torch.logsumexp(logits32, dim=-1)
    else:
        token_ll = _vocab_parallel_ll(logits32, labels, vocab)
    if n == n_labels:
        loss_text = -token_ll[:, : cfg.text_seq_len].mean()
        loss_img = -token_ll[:, cfg.text_seq_len:].mean()
    else:  # this rank's part: its positions' sums over the global counts
        split = min(max(cfg.text_seq_len - start, 0), n)
        b = token_ll.shape[0]
        loss_text = -token_ll[:, :split].sum() / (b * cfg.text_seq_len)
        loss_img = -token_ll[:, split:].sum() / (b * (n_labels - cfg.text_seq_len))
    return (loss_text + cfg.loss_img_weight * loss_img) / (cfg.loss_img_weight + 1)


def _vocab_parallel_ll(logits32: torch.Tensor, labels: torch.Tensor, vocab: slice) -> torch.Tensor:
    """log softmax(logits)[label] from this rank's vocabulary columns: the
    max over tp (no gradient), the sum of exponentials and the label's
    logit (zero on the ranks that do not hold it) each summed over tp."""
    peak = tp.max_over_tp(logits32.detach().amax(dim=-1))
    sumexp = tp.reduce_from_tp((logits32 - peak[..., None]).exp().sum(-1))
    local = labels - vocab.start
    mine = (local >= 0) & (local < vocab.stop - vocab.start)
    picked = logits32.gather(-1, local.clamp(0, vocab.stop - vocab.start - 1)[..., None])[..., 0]
    picked = tp.reduce_from_tp(torch.where(mine, picked, torch.zeros_like(picked)))
    return picked - peak - sumexp.log()
