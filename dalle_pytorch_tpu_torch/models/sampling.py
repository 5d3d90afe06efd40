"""Autoregressive image sampling (counterpart of
`dalle_pytorch_tpu/models/sampling.py`).

The prompt (bos + text, plus primer codes when priming) is consumed by one
prefill pass that fills the KV cache; the image codes then come one by one
from cached decode steps.  Classifier-free guidance runs as a doubled batch
`[cond; null]` through one network evaluation per step.  The image loop is a
Python loop (the JAX package's `lax.scan`).  `generate_images` can rerank
through CLIP; `generate_texts` completes a prompt in the text region.

`noise_override` feeds pre-drawn gumbel noise of shape (n_gen, b,
total_tokens) in place of the generator's: torch cannot reproduce JAX's
threefry streams, so code-for-code parity with the JAX package runs under
shared noise.
"""
from __future__ import annotations

import time
from typing import Optional

import torch

from dalle_pytorch_tpu_torch.models import clip as clip_mod
from dalle_pytorch_tpu_torch.models import dalle as dalle_mod
from dalle_pytorch_tpu_torch.models import vae as vae_mod
from dalle_pytorch_tpu_torch.models.dalle import DALLE
from dalle_pytorch_tpu_torch.models.transformer import apply_transformer, decode_step, init_cache, prefill
from dalle_pytorch_tpu_torch.ops.sampling import gumbel_sample, top_k_filter

DEFAULT_PRIME_FRACTION = 0.4375  # OpenAI used 14 * 32 initial tokens to prime


def _logits_at(model: DALLE, out_last: torch.Tensor, position: int) -> torch.Tensor:
    """Masked vocab logits (b, total_tokens) from the transformer output
    (b, 1, dim) at sequence `position`: the mask row is the producing
    position."""
    cfg = model.cfg
    logits = dalle_mod.to_logits(model, out_last)[:, 0]
    tok = torch.arange(cfg.total_tokens, device=logits.device)
    if position >= cfg.text_seq_len:
        forbidden = tok < cfg.num_text_tokens_padded
    else:
        forbidden = tok >= cfg.num_text_tokens_padded
    return logits.masked_fill(forbidden[None], torch.finfo(logits.dtype).min)


def _cfg_combine(logits: torch.Tensor, cond_scale: float) -> torch.Tensor:
    """[cond; null] stacked logits -> guided logits."""
    b = logits.shape[0] // 2
    cond, null = logits[:b], logits[b:]
    return null + (cond - null) * cond_scale


@torch.no_grad()
def _prefill_phase(model: DALLE, text, primer_codes, prime_len: int, cond_scale: float):
    """CFG batch doubling, bos + text (+ primer) embedding and the KV-cache
    prefill.  Returns (cache, logits for the first generated position)."""
    cfg = model.cfg
    if cond_scale != 1.0:
        text = torch.cat([text, torch.zeros_like(text)], dim=0)
        if primer_codes is not None:
            primer_codes = torch.cat([primer_codes, primer_codes], dim=0)
    text_ids = dalle_mod.remap_and_bos(cfg, text)
    tokens = dalle_mod.embed_text_ids(model, text_ids)
    if prime_len > 0:
        if primer_codes is None:
            raise ValueError("prime_len > 0 needs primer_codes")
        tokens = torch.cat([tokens, dalle_mod.embed_image_codes(model, primer_codes)], dim=1)
    n_pre = tokens.shape[1]
    cache = init_cache(cfg.transformer_config(), tokens.shape[0], dtype=model.dtype,
                       device=tokens.device)
    out, cache = prefill(model.transformer, tokens, cache)
    return cache, _logits_at(model, out[:, -1:], n_pre - 1)


@torch.no_grad()
def _decode_phase(
    model: DALLE,
    cache: dict,
    last_logits: torch.Tensor,
    generator: Optional[torch.Generator],
    filter_thres: float,
    temperature: float,
    cond_scale: float,
    primer_codes: Optional[torch.Tensor],
    prime_len: int,
    noise_override: Optional[torch.Tensor],
) -> torch.Tensor:
    """The image loop from a prefilled cache; `primer_codes` is the
    un-doubled primer.  Returns (b, image_seq_len) codes, primer included."""
    cfg = model.cfg
    guided = cond_scale != 1.0
    n_gen = cfg.image_seq_len - prime_len
    if n_gen <= 0:
        raise ValueError("the primer must be shorter than the image sequence")

    def sample_token(logits, noise):
        if guided:
            logits = _cfg_combine(logits, cond_scale)
        filtered = top_k_filter(logits, thres=filter_thres)
        if noise is not None:
            tok = torch.argmax(filtered / temperature + noise, dim=-1)
        else:
            tok = gumbel_sample(filtered, generator, temperature=temperature)
        return (tok - cfg.num_text_tokens_padded).clamp(0, cfg.num_image_tokens - 1)

    code = sample_token(last_logits, None if noise_override is None else noise_override[0])
    codes = [code]
    for step in range(1, n_gen):
        feed = torch.cat([code, code]) if guided else code
        x = dalle_mod.embed_image_codes(model, feed[:, None])
        out, cache = decode_step(model.transformer, x, cache)
        logits = _logits_at(model, out, cache["offset"] - 1)
        code = sample_token(logits, None if noise_override is None else noise_override[step])
        codes.append(code)
    codes = torch.stack(codes, dim=1)
    if prime_len > 0:
        codes = torch.cat([primer_codes, codes], dim=1)
    return codes


@torch.no_grad()
def sample_image_codes(
    model: DALLE,
    text: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    filter_thres: float = 0.5,
    temperature: float = 1.0,
    cond_scale: float = 1.0,
    primer_codes: Optional[torch.Tensor] = None,
    prime_len: int = 0,
    noise_override: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """text: (b, text_seq_len) raw ids (0 = pad); primer_codes: optional
    (b, prime_len) codes.  Returns (b, image_seq_len) image codes."""
    cache, last_logits = _prefill_phase(model, text, primer_codes, prime_len, cond_scale)
    return _decode_phase(
        model, cache, last_logits, generator, filter_thres, temperature,
        cond_scale, primer_codes, prime_len, noise_override,
    )


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def generate_images(
    model: DALLE,
    vae: "vae_mod.DiscreteVAE",
    text: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    filter_thres: float = 0.5,
    temperature: float = 1.0,
    img: Optional[torch.Tensor] = None,
    num_init_img_tokens: Optional[int] = None,
    cond_scale: float = 1.0,
    noise_override: Optional[torch.Tensor] = None,
    timings: Optional[dict] = None,
    clip: Optional["clip_mod.CLIP"] = None,
):
    """Sample codes and decode them through the VAE.  img: optional (b, H,
    W, C) pixels in [0, 1] whose first codes prime the image.  Returns
    (b, H, W, C) images in the VAE's normalised pixel space, as the JAX
    package does; with a `clip`, (images, scores): CLIP's score of each
    image against its text, for reranking.  With a `timings` dict, the
    device is synchronised after each phase and `prefill_s`, `decode_s`,
    `vae_s` (and `clip_s`) are written into it."""
    cfg = model.cfg
    text = text[:, : cfg.text_seq_len]
    primer, prime_len = None, 0
    if img is not None:
        prime_len = (num_init_img_tokens if num_init_img_tokens is not None
                     else int(DEFAULT_PRIME_FRACTION * cfg.image_seq_len))
        if not 0 <= prime_len < cfg.image_seq_len:
            raise ValueError(f"prime_len {prime_len} must lie in [0, {cfg.image_seq_len})")
        if prime_len:
            primer = vae_mod.get_codebook_indices(vae, img)[:, :prime_len]

    clock = time.perf_counter
    t0 = clock()
    cache, last_logits = _prefill_phase(model, text, primer, prime_len, cond_scale)
    if timings is not None:
        _sync(text.device)
        timings["prefill_s"] = clock() - t0
        t0 = clock()
    codes = _decode_phase(
        model, cache, last_logits, generator, filter_thres, temperature,
        cond_scale, primer, prime_len, noise_override,
    )
    if timings is not None:
        _sync(text.device)
        timings["decode_s"] = clock() - t0
        t0 = clock()
    images = vae_mod.decode_indices(vae, codes)
    if timings is not None:
        _sync(text.device)
        timings["vae_s"] = clock() - t0
        t0 = clock()
    if clip is None:
        return images
    scores = clip_mod.forward(clip, text, images)
    if timings is not None:
        _sync(text.device)
        timings["clip_s"] = clock() - t0
    return images, scores


@torch.no_grad()
def generate_texts(
    model: DALLE,
    text: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    filter_thres: float = 0.5,
    temperature: float = 1.0,
    use_cache: bool = True,
    noise_override: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Text completion: no bos and no pad remap.  text: (b, n0) prompt ids
    (a single 0 token when None).  Returns (b, text_seq_len) ids.

    use_cache=True prefills the prompt (causal, n0 long) and then takes one
    cached `decode_step` per token (`text_only`: the token shift is the
    identity in the text region); use_cache=False runs the whole
    text_seq_len window through the transformer again for every token.  Both
    consume the same noise: `noise_override` (text_seq_len - n0, b,
    total_tokens), one row per generated token, in place of `generator`'s."""
    cfg = model.cfg
    device = model.logits_linear.weight.device
    if text is None:
        text = torch.zeros((1, 1), dtype=torch.long, device=device)
    text = text.long()
    b, n0 = text.shape
    ts = cfg.text_seq_len
    if n0 >= ts:
        return text[:, :ts]

    def embed(ids):
        # ids out of the table are clamped into it (the JAX package's clip-mode take)
        return dalle_mod.embed_text_ids(model, ids.clamp(0, cfg.num_text_tokens_padded - 1))

    def sample(logits, step):
        filtered = top_k_filter(logits, thres=filter_thres)
        if noise_override is not None:
            return torch.argmax(filtered / temperature + noise_override[step], dim=-1)
        return gumbel_sample(filtered, generator, temperature=temperature)

    if not use_cache:
        buf = torch.zeros((b, ts), dtype=torch.long, device=text.device)
        buf[:, :n0] = text
        for cur in range(n0, ts):
            out = apply_transformer(model.transformer, embed(buf))
            buf[:, cur] = sample(_logits_at(model, out[:, cur - 1:cur], cur - 1), cur - n0)
        return buf

    cache = init_cache(cfg.transformer_config(), b, dtype=model.dtype, device=text.device)
    out, cache = prefill(model.transformer, embed(text), cache)
    tok = sample(_logits_at(model, out[:, -1:], n0 - 1), 0)
    generated = [tok]
    for step in range(1, ts - n0):
        out, cache = decode_step(model.transformer, embed(tok[:, None]), cache, text_only=True)
        tok = sample(_logits_at(model, out, cache["offset"] - 1), step)
        generated.append(tok)
    return torch.cat([text, torch.stack(generated, dim=1)], dim=1)
