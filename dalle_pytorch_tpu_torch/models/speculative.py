"""Self-speculative decoding (counterpart of
`dalle_pytorch_tpu/models/speculative.py`): a shallow prefix of the same
network drafts, the rest of it verifies.

A round drafts `k` tokens through layers [0, d) of the stack (the model's
own final norm and logits on the layer-d hidden are the draft head), then
continues layers [d, depth) from each stored layer-d hidden and runs one
more full pass on the last draft token (the bonus position), and accepts
the longest prefix on which draft and full model agree plus one token:
each round advances a in [1, k + 1] positions.

Exactness (the default): a position's gumbel noise is a function of the
position, not of the order the positions are visited in.  The port draws
it from a table filled, before the rounds, in the order a sequential loop
draws it (`serving/lanes.LaneState.fill_noise`, the `DecodeLoop` noise
buffer), so every emitted token is the one the sequential loop emits at
any temperature; with injected noise the codes equal the JAX package's
sequential `sample_image_codes(noise_override=)`.  `stochastic=True` (the
fused sampler only) accepts a draft token with probability min(1, p / q)
and resamples the first rejection from max(p - q, 0), drawing its uniforms
and the resample's noise from the generator: the sequential distribution,
not its stream.

Rollback: a rejected position's KV column is never read (every read masks
j <= offset, and the next write overwrites it); the token-shift rings are
the only state a rejected position corrupts, and each round restores the
slots it wrote past the accepted length from a snapshot of those slots
taken at its start (`_rollback_rings_`).  Positions past the end of the
sequence clamp to seq_len - 1; only rejected positions write there.

`validate_spec` refuses reversible execution (the twin streams have no
single hidden at layer d), depth < 2, and k + 1 > image_fmap_size with
token shift (a round's ring writes must not wrap onto themselves).

The engine's rounds (`engine_spec_draft`, `engine_spec_verify`) run over
its paged pool with per-lane acceptance; the fused sampler's
(`fused_draft`, `fused_verify`, driven by `models/sampling.DecodeLoop`)
over the dense cache with lockstep acceptance (the batch's least).  Each
round is static, so on the card each half is captured in a CUDA graph;
the host reads the advance once a round.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from dalle_pytorch_tpu_torch.models import dalle as dalle_mod
from dalle_pytorch_tpu_torch.models.paged import paged_decode_step
from dalle_pytorch_tpu_torch.models.transformer import TransformerConfig, decode_step
from dalle_pytorch_tpu_torch.ops.sampling import gumbel_noise, top_k_filter

# ---------------------------------------------------------------------------
# settings
# ---------------------------------------------------------------------------


def resolve_draft_layers(depth: int, spec_draft_layers: Optional[int]) -> int:
    """The drafter's depth: the first half of the stack by default."""
    d = depth // 2 if spec_draft_layers is None else int(spec_draft_layers)
    if not 1 <= d < depth:
        raise ValueError(f"spec_draft_layers={d} must satisfy 1 <= d < depth ({depth})")
    return d


def validate_spec(tcfg: TransformerConfig, spec_k: int, spec_draft_layers: Optional[int]) -> Tuple[int, int]:
    """(k, d) for the transformer config; ValueError for a configuration
    speculation cannot run on, with the JAX package's messages."""
    k = int(spec_k)
    if k < 1:
        raise ValueError(f"spec_k={k} must be >= 1 (0 disables speculation)")
    if tcfg.depth < 2:
        raise ValueError("speculative decoding needs depth >= 2 (the drafter is a strict prefix of the stack)")
    if tcfg.execution == "reversible":
        raise ValueError("speculative decoding requires sequential execution; reversible twin-stream layers "
                         "cannot be split at the draft boundary")
    if tcfg.shift_tokens and k + 1 > tcfg.image_fmap_size:
        raise ValueError(f"spec_k={k} too large for image_fmap_size={tcfg.image_fmap_size}: a round writes k+1 "
                         "token-shift ring slots and must not wrap within one round")
    return k, resolve_draft_layers(tcfg.depth, spec_draft_layers)


# ---------------------------------------------------------------------------
# ring rollback
# ---------------------------------------------------------------------------


def _ring_slots(cfg: TransformerConfig, offsets: torch.Tensor, n: int) -> torch.Tensor:
    """(..., n) ring slots of positions offsets + i, i < n, clamped into the
    sequence."""
    i = torch.arange(n, device=offsets.device)
    return ((offsets[..., None] + i).clamp(max=cfg.seq_len - 1) - cfg.text_len) % cfg.image_fmap_size


def _snapshot(ring: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """A ring's (S, fmap, 2, q) entries at the (S, n) `slots`."""
    return ring[torch.arange(ring.shape[0], device=ring.device)[:, None], slots]


def _rollback_rings_(ring: torch.Tensor, old: torch.Tensor, slots: torch.Tensor, a: torch.Tensor) -> None:
    """Restore in place the ring slots a round wrote at positions i >= a
    (per row `a`, (S,)) from `old` (`_snapshot` at the round's start).
    Where positions share a slot (clamped past the end), the last one
    decides, as restoring them one by one in order would; every write to a
    shared slot then carries one value."""
    lanes = torch.arange(ring.shape[0], device=ring.device)[:, None]
    n = slots.shape[1]
    same = slots[:, :, None] == slots[:, None, :]
    last = torch.where(same, torch.arange(n, device=ring.device), -1).amax(dim=-1)  # (S, n)
    revert = (last >= a[:, None])[..., None, None]
    ring[lanes, slots] = torch.where(revert, old, ring[lanes, slots])


def _restore_ring_slots(new_rb: torch.Tensor, old_rb: torch.Tensor, slots: torch.Tensor,
                        a: torch.Tensor) -> torch.Tensor:
    """The JAX helper's semantics, functionally: a copy of `new_rb` (b,
    fmap, 2, q) whose `slots` (n,) at positions i >= a (a scalar) hold
    `old_rb`'s."""
    b = new_rb.shape[0]
    slots = slots.expand(b, -1)
    out = new_rb.clone()
    _rollback_rings_(out, _snapshot(old_rb, slots), slots, a.expand(b))
    return out


def rollback_cache_rings(new_layers, old_layers, slots: torch.Tensor, a: torch.Tensor, tcfg: TransformerConfig):
    """The fused sampler's ring rollback, functionally: one slot vector and
    one advance for the batch.  KV entries are left as they are."""
    if not tcfg.shift_tokens:
        return new_layers
    return [dict(nl, **{name: _restore_ring_slots(nl[name], ol[name], slots, a)
                        for name in ("shift_attn", "shift_ff")})
            for nl, ol in zip(new_layers, old_layers)]


def rollback_slot_rings(new_rings, old_rings, slots: torch.Tensor, a: torch.Tensor, tcfg: TransformerConfig):
    """The engine's ring rollback, functionally: per-lane slots (S, k + 1)
    and advance (S,)."""
    if new_rings is None:
        return None
    out = []
    for nl, ol in zip(new_rings["layers"], old_rings["layers"]):
        layer = {}
        for name in ("shift_attn", "shift_ff"):
            layer[name] = nl[name].clone()
            _rollback_rings_(layer[name], _snapshot(ol[name], slots), slots, a)
        out.append(layer)
    return {"layers": out}


def _ring_tensors(layers) -> List[torch.Tensor]:
    return [layer[name] for layer in layers for name in ("shift_attn", "shift_ff")]


# ---------------------------------------------------------------------------
# the engine's round (paged pool, per-lane acceptance)
# ---------------------------------------------------------------------------


class EngineSpecState:
    """The buffers of the engine's rounds: the drafts (k, S), the layer-d
    hiddens (k, S, 1, dim), each ring's snapshot at the round's slots, and
    the advance of the last round (S,)."""

    def __init__(self, engine, k: int, d: int):
        self.k, self.d = k, d
        dev, S, dim = engine.device, engine.ecfg.num_slots, engine.cfg.dim
        self.drafts = torch.zeros((k, S), dtype=torch.long, device=dev)
        self.hiddens = torch.zeros((k, S, 1, dim), dtype=engine.model.dtype, device=dev)
        self.advance = torch.zeros(S, dtype=torch.long, device=dev)
        rings = [] if engine.rings is None else _ring_tensors(engine.rings["layers"])
        self.old = [torch.zeros((S, k + 1, *r.shape[2:]), dtype=r.dtype, device=dev) for r in rings]


def _lane_codes(engine, out: torch.Tensor, rows: torch.Tensor):
    """The engine's emit pipeline on a round's position: masked logits, the
    table's noise rows `rows`, `sample_lanes` with the screen, the
    poison lane and the degrade cap.  Returns (codes (S,), bad (S,))."""
    from dalle_pytorch_tpu_torch.models import sampling as sampling_mod
    from dalle_pytorch_tpu_torch.serving.lanes import sample_lanes

    model, lanes = engine.model, engine.lanes
    logits = sampling_mod._logits_at(model, out, image=True)
    return sample_lanes(model, logits, lanes.settings(), engine.ecfg.filter_thres,
                        lanes.table_rows(rows, logits.dtype), engine.active, lanes.poison_lane, lanes.cand_cap,
                        engine.ecfg.degraded_filter_thres)


def _engine_pass(engine, x: torch.Tensor, offsets: torch.Tensor, **layer_range) -> torch.Tensor:
    return paged_decode_step(engine.model.transformer, x, engine.kv, engine.block_tables, offsets, engine.rings,
                             engine.ecfg.block_size, **layer_range)


@torch.no_grad()
def engine_spec_draft(engine) -> None:
    """Draft k codes a lane through layers [0, d), writing those layers'
    KV columns and rings in place, and keep each position's layer-d hidden
    for the verification.  Snapshots the ring slots the round writes."""
    spec, tcfg = engine.spec, engine.tcfg
    k, seq = spec.k, tcfg.seq_len
    if engine.rings is not None:
        slots = _ring_slots(tcfg, engine.offsets, k + 1)
        for old, ring in zip(spec.old, _ring_tensors(engine.rings["layers"])):
            old.copy_(_snapshot(ring, slots))
    prev = engine.prev_code
    for i in range(k):
        off = (engine.offsets + i).clamp(max=seq - 1)
        x = dalle_mod.embed_image_codes(engine.model, prev[:, None], engine.img_prev + i)
        out = _engine_pass(engine, x, off, layer_stop=spec.d)
        code, _ = _lane_codes(engine, out, engine.img_prev + 1 + i)
        spec.drafts[i] = code
        spec.hiddens[i] = out
        prev = code


@torch.no_grad()
def engine_spec_verify(engine) -> None:
    """Score the draft positions with the full model and advance each lane
    by its own a: layers [d, depth) from the stored hiddens, one full pass
    on the last draft (the bonus position), a = the leading matches + 1,
    capped to the codes the lane still needs, 0 for an idle lane.  Writes
    the accepted codes, the nonfinite flags of the positions taken, the
    rolled-back rings and the advance (`spec.advance`)."""
    spec, tcfg, n_gen = engine.spec, engine.tcfg, engine.n_gen
    k, seq = spec.k, tcfg.seq_len
    offsets, img_prev = engine.offsets, engine.img_prev
    vs, bads = [], []
    for i in range(k):
        out = _engine_pass(engine, spec.hiddens[i], (offsets + i).clamp(max=seq - 1), layer_start=spec.d)
        code, bad = _lane_codes(engine, out, img_prev + 1 + i)
        vs.append(code)
        bads.append(bad)
    x = dalle_mod.embed_image_codes(engine.model, spec.drafts[k - 1][:, None], img_prev + k)
    out = _engine_pass(engine, x, (offsets + k).clamp(max=seq - 1))
    code, bad = _lane_codes(engine, out, img_prev + 1 + k)
    vs.append(code)
    bads.append(bad)
    v, badstack = torch.stack(vs), torch.stack(bads)  # (k + 1, S)

    match = (spec.drafts == v[:k]).long()
    a = torch.cumprod(match, dim=0).sum(dim=0) + 1
    a = a.index_select(0, engine.lanes.feed_src)  # a pair advances together
    a = torch.minimum(a, (n_gen - 1 - img_prev).clamp(min=0))
    a = torch.where(engine.active, a, torch.zeros_like(a))
    steps = torch.arange(k + 1, device=a.device)[:, None]
    engine.poisoned |= (badstack & (steps < a[None])).any(dim=0)

    lanes = torch.arange(a.shape[0], device=a.device)
    for i in range(k + 1):
        at = (img_prev + 1 + i).clamp(0, n_gen - 1)
        engine.codes[lanes, at] = torch.where(i < a, v[i], engine.codes[lanes, at])
    last = v[(a - 1).clamp(0, k), lanes]
    engine.prev_code.copy_(torch.where(a > 0, last, engine.prev_code))
    if engine.rings is not None:
        slots = _ring_slots(tcfg, offsets, k + 1)
        for old, ring in zip(spec.old, _ring_tensors(engine.rings["layers"])):
            _rollback_rings_(ring, old, slots, a)
    offsets.add_(a)
    img_prev.add_(a)
    spec.advance.copy_(a)


# ---------------------------------------------------------------------------
# the fused sampler's round (dense cache, lockstep acceptance)
# ---------------------------------------------------------------------------


class FusedSpecState:
    """A `DecodeLoop`'s round buffers: drafts (k, b), draft tokens before the
    shift (k, b), layer-d hiddens (k, rows, 1, dim), the draft
    distributions (k, b, V) for `stochastic`, the ring snapshots, the
    cache offset the round starts at, and the round's scalar advance."""

    def __init__(self, loop, k: int, d: int, stochastic: bool, dim: int, total_tokens: int, dtype):
        dev = loop.step.device
        n_rows, b = loop.codes.shape
        rows = loop.cache["layers"][0]["k"].shape[0]
        self.k, self.d, self.stochastic = k, d, stochastic
        self.drafts = torch.zeros((k, b), dtype=torch.long, device=dev)
        self.tokens = torch.zeros((k, b), dtype=torch.long, device=dev)
        self.hiddens = torch.zeros((k, rows, 1, dim), dtype=dtype, device=dev)
        self.qdists = torch.zeros((k, b, total_tokens), device=dev) if stochastic else None
        layers = loop.cache["layers"]
        rings = _ring_tensors(layers) if "shift_attn" in layers[0] else []
        self.old = [torch.zeros((r.shape[0], k + 1, *r.shape[2:]), dtype=r.dtype, device=dev) for r in rings]
        self.offset = torch.zeros((), dtype=torch.long, device=dev)
        self.advance = torch.zeros((), dtype=torch.long, device=dev)

    def buffers(self):
        yield from (t for t in (self.drafts, self.tokens, self.hiddens, self.qdists, self.offset, self.advance)
                    if t is not None)
        yield from self.old


def _fused_logits(loop, model, out: torch.Tensor) -> torch.Tensor:
    """Guided (under CFG), top-k-filtered logits of a fused pass."""
    from dalle_pytorch_tpu_torch.models import sampling as sampling_mod

    logits = sampling_mod._logits_at(model, out, image=True)
    if loop.guided:
        logits = sampling_mod._cfg_combine(logits, loop.cond_scale)
    return top_k_filter(logits, thres=loop.filter_thres)


def _fused_pass(loop, model, x: torch.Tensor, offset: torch.Tensor, **layer_range) -> torch.Tensor:
    """One decode pass of the loop's cache at `offset` (its offset set
    there, advanced by the pass and set again by the next)."""
    loop.cache["offset"].copy_(offset)
    out, _ = decode_step(model.transformer, x, loop.cache, **layer_range)
    return out


def _fused_embed(loop, model, codes: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
    """The codes' embedding (doubled under CFG) at the image position of
    cache position `offset`."""
    cfg = model.cfg
    feed = torch.cat([codes, codes]) if loop.guided else codes
    start = None if cfg.rotary_emb else offset - (cfg.text_seq_len + 1)
    return dalle_mod.embed_image_codes(model, feed[:, None], start)


def _code_of(model, tok: torch.Tensor) -> torch.Tensor:
    cfg = model.cfg
    return (tok - cfg.num_text_tokens_padded).clamp(0, cfg.num_image_tokens - 1)


@torch.no_grad()
def fused_draft(loop, model) -> None:
    """Draft k codes through layers [0, d) from the loop's state (its cache
    offset at the fed token, `step` the index of the next code), reading
    the noise table's rows step + i."""
    spec, cfg = loop.spec, model.transformer.cfg
    k, seq = spec.k, cfg.seq_len
    off0 = loop.cache["offset"].clone()
    spec.offset.copy_(off0)
    if spec.old:
        slots = _ring_slots(cfg, off0.expand(spec.old[0].shape[0]), k + 1)
        for old, ring in zip(spec.old, _ring_tensors(loop.cache["layers"])):
            old.copy_(_snapshot(ring, slots))
    n_rows = loop.noise.shape[0]
    prev = loop.prev
    for i in range(k):
        off = (off0 + i).clamp(max=seq - 1)
        out = _fused_pass(loop, model, _fused_embed(loop, model, prev, off), off, layer_stop=spec.d)
        scaled = _fused_logits(loop, model, out) / loop.temperature
        noise = loop.noise.index_select(0, (loop.step + i).clamp(max=n_rows - 1).view(1))[0]
        tok = torch.argmax(scaled + noise, dim=-1)
        if spec.stochastic:
            spec.qdists[i] = torch.softmax(scaled.float(), dim=-1)
        spec.tokens[i] = tok
        spec.drafts[i] = prev = _code_of(model, tok)
        spec.hiddens[i] = out


@torch.no_grad()
def fused_verify(loop, model, generator: Optional[torch.Generator] = None) -> None:
    """Verify the draft with the full model and advance the whole batch by
    its least accepted length (lockstep: the cache has one offset), capped
    to the codes left.  Deterministic: a position is accepted while every
    row's draft equals the full model's code under the same noise row.
    Stochastic: row r accepts draft i with probability min(1, p / q)
    (`generator`'s uniforms), the batch advances by the least accepted
    count m plus one, and position m takes each row's residual resample, the
    draft it accepted there, or the bonus."""
    spec, cfg = loop.spec, model.transformer.cfg
    k, seq = spec.k, cfg.seq_len
    n_rows, n_gen = loop.noise.shape[0], loop.codes.shape[0]
    off0, rel = spec.offset, loop.step
    vlogits = []
    for i in range(k):
        out = _fused_pass(loop, model, spec.hiddens[i], (off0 + i).clamp(max=seq - 1), layer_start=spec.d)
        vlogits.append(_fused_logits(loop, model, out) / loop.temperature)
    off = (off0 + k).clamp(max=seq - 1)
    out = _fused_pass(loop, model, _fused_embed(loop, model, spec.drafts[k - 1], off), off)
    vlogits.append(_fused_logits(loop, model, out) / loop.temperature)

    def noise_row(i):
        return loop.noise.index_select(0, (rel + i).clamp(max=n_rows - 1).view(1))[0]

    if not spec.stochastic:
        emit = torch.stack([_code_of(model, torch.argmax(vlogits[i] + noise_row(i), dim=-1)) for i in range(k + 1)])
        match = (spec.drafts == emit[:k]).all(dim=1).long()
        a = torch.cumprod(match, dim=0).sum() + 1
    else:
        b = spec.drafts.shape[1]
        bonus = _code_of(model, torch.argmax(vlogits[k] + noise_row(k), dim=-1))
        accs, resamples = [], []
        for i in range(k):
            p = torch.softmax(vlogits[i].float(), dim=-1)
            q = spec.qdists[i]
            px = p.gather(1, spec.tokens[i][:, None])[:, 0]
            qx = q.gather(1, spec.tokens[i][:, None])[:, 0]
            u = torch.rand(b, generator=generator, device=p.device)
            accs.append((u * qx < px).long())
            resid = torch.log((p - q).clamp(min=0.0).clamp(min=1e-20))
            resamples.append(_code_of(model, torch.argmax(resid + gumbel_noise(resid.shape, generator, resid.dtype,
                                                                               resid.device), dim=-1)))
        lvec = torch.cumprod(torch.stack(accs), dim=0).sum(dim=0)  # (b,)
        m = lvec.min()
        rstack = torch.stack(resamples + [bonus])
        dpad = torch.cat([spec.drafts, bonus[None]])
        final = torch.where(lvec == m, rstack.index_select(0, m.view(1))[0], dpad.index_select(0, m.view(1))[0])
        emit = torch.cat([spec.drafts, torch.zeros_like(bonus)[None]])
        emit.index_copy_(0, m.view(1), final[None])
        a = m + 1
    a = torch.minimum(a, n_gen - rel)
    for i in range(k + 1):
        at = (rel + i).clamp(max=n_gen - 1).view(1)
        cur = loop.codes.index_select(0, at)[0]
        loop.codes.index_copy_(0, at, torch.where(i < a, emit[i], cur)[None])
    if spec.old:
        rows = spec.old[0].shape[0]
        slots = _ring_slots(cfg, off0.expand(rows), k + 1)
        for old, ring in zip(spec.old, _ring_tensors(loop.cache["layers"])):
            _rollback_rings_(ring, old, slots, a.expand(rows))
    loop.cache["offset"].copy_(off0 + a)
    loop.prev.copy_(emit.index_select(0, (a - 1).view(1))[0])
    loop.step.add_(a)
    spec.advance.copy_(a)
