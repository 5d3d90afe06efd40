"""Autoregressive image sampling (counterpart of
`dalle_pytorch_tpu/models/sampling.py`).

The prompt (bos + text, plus primer codes when priming) is consumed by one
prefill pass that fills the KV cache; the image codes then come one by one
from cached decode steps.  Classifier-free guidance runs as a doubled batch
`[cond; null]` through one network evaluation per step.  `generate_images`
can rerank through CLIP; `generate_texts` completes a prompt in the text
region.

Both loops run one static step (`DecodeLoop.advance`): the same ops on the
same buffers at every position, with the offset, the previous token, the
step index and the temperature on the device.  Eagerly, a Python loop calls
it; on the card a CUDA graph captures it once and is replayed
(`DecodeGraphs`, the counterpart of the JAX package's `ExecutableCache` and
its scanned loop).  `graphs=None` replays graphs on the card and runs
eagerly on the CPU; `graphs=False` runs the step eagerly on the card too.

`noise_override` feeds pre-drawn gumbel noise of shape (n_gen, b,
total_tokens) in place of the generator's: torch cannot reproduce JAX's
threefry streams, so code-for-code parity with the JAX package runs under
shared noise.
"""
from __future__ import annotations

import itertools
import time
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from dalle_pytorch_tpu_torch.models import clip as clip_mod
from dalle_pytorch_tpu_torch.models import dalle as dalle_mod
from dalle_pytorch_tpu_torch.models import vae_registry
from dalle_pytorch_tpu_torch.models.dalle import DALLE
from dalle_pytorch_tpu_torch.models.transformer import apply_transformer, decode_step, init_cache, prefill
from dalle_pytorch_tpu_torch.ops.sampling import gumbel_noise, gumbel_sample, top_k_filter
from dalle_pytorch_tpu_torch.ops.stable import divide_max

DEFAULT_PRIME_FRACTION = 0.4375  # OpenAI used 14 * 32 initial tokens to prime
# eager steps on a side stream before a capture: cuBLAS handles, workspaces
# and the allocator's blocks are set up there, not inside the graph
WARMUP_STEPS = 2


def _logits_at(model: DALLE, out_last: torch.Tensor, image: bool) -> torch.Tensor:
    """Masked vocab logits (b, total_tokens) from the transformer output
    (b, 1, dim) at a position of the image region (`image`) or of the text
    region: the producing position's mask row, which is the same within a
    region.  Under `stable` the output is divided by its max first, as the
    training forward does."""
    cfg = model.cfg
    if cfg.stable:
        out_last = divide_max(out_last)
    logits = dalle_mod.to_logits(model, out_last)[:, 0]
    tok = torch.arange(cfg.total_tokens, device=logits.device)
    forbidden = tok < cfg.num_text_tokens_padded if image else tok >= cfg.num_text_tokens_padded
    return logits.masked_fill(forbidden[None], torch.finfo(logits.dtype).min)


def _cfg_combine(logits: torch.Tensor, cond_scale: float) -> torch.Tensor:
    """[cond; null] stacked logits -> guided logits."""
    b = logits.shape[0] // 2
    cond, null = logits[:b], logits[b:]
    return null + (cond - null) * cond_scale


def _logit_stats(filtered: torch.Tensor) -> torch.Tensor:
    """[logit max, mean entropy] of the sampling distributions `filtered`
    (b, V: the guided, top-k-filtered logits), in f32.  Filtered entries
    (-inf, p = 0) are masked before p * log p, as the JAX package does:
    0 * -inf is NaN, not the 0 the entropy identity needs."""
    f32 = filtered.float()
    p = torch.softmax(f32, dim=-1)
    plog = torch.where(torch.isfinite(f32), p * f32, torch.zeros_like(f32))
    entropy = torch.logsumexp(f32, dim=-1) - plog.sum(dim=-1)
    return torch.stack([f32.max(), entropy.mean()])


@torch.no_grad()
def _prefill_phase(model: DALLE, text, primer_codes, prime_len: int, cond_scale: float,
                   cache: Optional[dict] = None):
    """CFG batch doubling, bos + text (+ primer) embedding and the KV-cache
    prefill, into `cache` when given (a loop's, zeroed), else a new one.
    Returns (cache, logits for the first generated position)."""
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
    if cache is None:
        cache = init_cache(cfg.transformer_config(), tokens.shape[0], dtype=model.dtype, device=tokens.device)
    out, cache = prefill(model.transformer, tokens, cache)
    return cache, _logits_at(model, out[:, -1:], image=True)


class Mode(NamedTuple):
    """What a decode loop's step reads besides its buffers: `noise`, the
    row of the `noise_override` buffer at the step index in place of the
    generator's gumbel noise; `stats`, whether it records the logit max
    and mean entropy of its sampling distribution; `spec`, (k, d,
    stochastic) for speculative rounds in place of the step (their noise
    from the buffer, filled from the generator first when no noise is
    given)."""

    noise: bool
    stats: bool
    spec: Optional[Tuple[int, int, bool]] = None


class DecodeLoop:
    """One decode loop's buffers and its static step.

    image: the image loop (CFG as a doubled batch at `cond_scale`, tokens
    shifted and clamped into the codebook), else the text loop (text-only
    steps, ids as sampled).  The buffers, all on the model's device: the KV
    cache and shift rings (`cache`, 2 * batch rows under CFG), the previous
    token `prev` (batch,), the step index `step` (), the `temperature` (),
    the sampled tokens `codes` (n_rows, batch), and, once a mode asks for
    them (`prepare`), the float32 `noise` (n_rows, batch, total_tokens) and
    `stats` (2, n_rows).  A buffer is never replaced: a captured graph
    holds its address."""

    def __init__(self, model: DALLE, image: bool, batch: int, n_rows: int, cond_scale: float = 1.0,
                 filter_thres: float = 0.5):
        cfg = model.cfg
        device = model.device
        self.image, self.cond_scale, self.filter_thres = image, float(cond_scale), float(filter_thres)
        self.guided = image and self.cond_scale != 1.0
        rows = 2 * batch if self.guided else batch
        self.cache = init_cache(cfg.transformer_config(), rows, dtype=model.dtype, device=device)
        self.prev = torch.zeros(batch, dtype=torch.long, device=device)
        self.step = torch.zeros((), dtype=torch.long, device=device)
        self.temperature = torch.ones((), device=device)
        self.codes = torch.zeros((n_rows, batch), dtype=torch.long, device=device)
        self.noise: Optional[torch.Tensor] = None
        self.stats: Optional[torch.Tensor] = None
        self.spec = None  # speculative round buffers (`models/speculative.FusedSpecState`)
        self._total_tokens, self._dim, self._dtype = cfg.total_tokens, cfg.dim, model.dtype
        model.transformer.prepare_decode(device)

    def prepare(self, mode: Mode) -> None:
        """Allocate the buffers `mode` reads, once."""
        from dalle_pytorch_tpu_torch.models.speculative import FusedSpecState

        n_rows, batch = self.codes.shape
        if (mode.noise or mode.spec) and self.noise is None:
            self.noise = torch.zeros((n_rows, batch, self._total_tokens), device=self.step.device)
        if mode.stats and self.stats is None:
            self.stats = torch.zeros((2, n_rows), device=self.step.device)
        if mode.spec and self.spec is None:  # a loop serves one spec setting (`image_loop` keys it)
            self.spec = FusedSpecState(self, *mode.spec, self._dim, self._total_tokens, self._dtype)

    def buffers(self):
        for layer in self.cache["layers"]:
            yield from layer.values()
        yield from (t for t in (self.cache["offset"], self.prev, self.step, self.temperature, self.codes,
                                self.noise, self.stats) if t is not None)
        if self.spec is not None:
            yield from self.spec.buffers()

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.buffers())

    def reset(self) -> None:
        """Zero the cache, the rings, the offset and the state: a fresh
        loop's buffers (the first image row's shift reads zeros from the
        rings)."""
        for t in self.buffers():
            if t is not self.temperature:
                t.zero_()
        self.temperature.fill_(1.0)

    def sample(self, model: DALLE, logits: torch.Tensor, generator: Optional[torch.Generator], mode: Mode) -> None:
        """Sample the token of step `step` from its masked logits (guided
        under CFG, top-k filtered, over the temperature, plus gumbel noise),
        write it into `codes` and `prev`, and advance the step."""
        cfg = model.cfg
        if self.guided:
            logits = _cfg_combine(logits, self.cond_scale)
        filtered = top_k_filter(logits, thres=self.filter_thres)
        scaled = filtered / self.temperature
        if mode.noise:
            noise = self.noise.index_select(0, self.step.view(1))[0]
        else:
            noise = gumbel_noise(scaled.shape, generator, scaled.dtype, scaled.device)
        tok = torch.argmax(scaled + noise, dim=-1)
        if self.image:
            tok = (tok - cfg.num_text_tokens_padded).clamp(0, cfg.num_image_tokens - 1)
        at = self.step.view(1)
        self.codes.index_copy_(0, at, tok[None])
        if mode.stats:
            self.stats.index_copy_(1, at, _logit_stats(filtered)[:, None])
        self.prev.copy_(tok)
        self.step.add_(1)

    def advance(self, model: DALLE, generator: Optional[torch.Generator], mode: Mode) -> None:
        """One decode step: embed `prev` (doubled under CFG), run every layer
        at the cache's offset, mask the logits and sample.  The same ops at
        every step: the eager loop calls it, a CUDA graph captures it."""
        cfg = model.cfg
        # the fed token's position is the cache's offset, on the device
        # (learned positions only; rotary reads it inside the layers)
        offset = None if cfg.rotary_emb else self.cache["offset"]
        if self.image:
            feed = torch.cat([self.prev, self.prev]) if self.guided else self.prev
            start = None if offset is None else offset - (cfg.text_seq_len + 1)
            x = dalle_mod.embed_image_codes(model, feed[:, None], start)
        else:
            # ids out of the table are clamped into it (the JAX package's clip-mode take)
            ids = self.prev[:, None].clamp(0, cfg.num_text_tokens_padded - 1)
            x = dalle_mod.embed_text_ids(model, ids, None if offset is None else offset.view(1))
        out, _ = decode_step(model.transformer, x, self.cache, text_only=not self.image)
        self.sample(model, _logits_at(model, out, self.image), generator, mode)

    @torch.no_grad()
    def run(self, model: DALLE, first_logits: torch.Tensor, n_gen: int, generator: Optional[torch.Generator],
            temperature: float, noise_override: Optional[torch.Tensor], mode: Mode,
            graph: Optional["torch.cuda.CUDAGraph"] = None, timings: Optional[dict] = None):
        """The loop from a prefilled cache: the first token from
        `first_logits`, then n_gen - 1 steps, eager or as replays of
        `graph` (a capture of `advance` in `mode`).  Returns (tokens (b,
        n_gen), {"logit_max", "entropy_mean"} or None).  In a `spec` mode
        the steps are speculative rounds (`run_spec`)."""
        if mode.spec:
            return self.run_spec(model, first_logits, n_gen, generator, temperature, noise_override, graph,
                                 timings=timings)
        self.step.zero_()
        self.temperature.fill_(temperature)
        if mode.noise:
            self.noise[:n_gen].copy_(noise_override[:n_gen])
        self.sample(model, first_logits, generator, mode)
        for _ in range(n_gen - 1):
            if graph is None:
                self.advance(model, generator, mode)
            else:
                graph.replay()
        codes = self.codes[:n_gen].t().clone()
        if not mode.stats:
            return codes, None
        stats = self.stats[:, :n_gen]
        return codes, {"logit_max": stats[0].max(), "entropy_mean": stats[1].sum() / n_gen}

    def fill_noise(self, model: DALLE, n_gen: int, generator: Optional[torch.Generator],
                   noise_override: Optional[torch.Tensor]) -> None:
        """The noise buffer's first n_gen rows: `noise_override`'s, or one
        (batch, total_tokens) draw of `generator` a row, as the sequential
        loop draws a step's noise."""
        if noise_override is not None:
            self.noise[:n_gen].copy_(noise_override[:n_gen])
            return
        for row in range(n_gen):
            self.noise[row] = gumbel_noise(self.noise.shape[1:], generator, model.dtype, self.step.device)

    @torch.no_grad()
    def run_spec(self, model: DALLE, first_logits: torch.Tensor, n_gen: int, generator: Optional[torch.Generator],
                 temperature: float, noise_override: Optional[torch.Tensor], graphs=None,
                 round_generator: Optional[torch.Generator] = None, timings: Optional[dict] = None,
                 filled: bool = False):
        """The speculative loop from a prefilled cache: the noise buffer
        takes `noise_override`, or n_gen draws of `generator` in the order
        the sequential loop draws them; the first token from `first_logits`
        (row 0); then rounds (`models/speculative.fused_draft`,
        `fused_verify`), eager or as replays of `graphs` (their captures),
        until n_gen codes exist, the host reading the step once a round.
        `round_generator` draws the stochastic rounds' uniforms (default
        `generator`); `filled`: the buffer is filled already.  Returns
        (tokens (b, n_gen), None); a `timings` dict gets spec_rounds, and
        draft_s and verify_s (synchronised)."""
        from dalle_pytorch_tpu_torch.models.speculative import fused_draft, fused_verify

        device = self.step.device
        self.step.zero_()
        self.temperature.fill_(temperature)
        if not filled:
            self.fill_noise(model, n_gen, generator, noise_override)
        self.sample(model, first_logits, None, Mode(noise=True, stats=False))
        rounds, draft_s, verify_s = 0, 0.0, 0.0
        gen = generator if round_generator is None else round_generator
        timed = timings is not None
        while int(self.step) < n_gen:
            t0 = time.perf_counter()
            if graphs is None:
                fused_draft(self, model)
            else:
                graphs[0].replay()
            t1 = _clock(device, timed)
            if graphs is None:
                fused_verify(self, model, gen)
            else:
                graphs[1].replay()
            t2 = _clock(device, timed)
            rounds, draft_s, verify_s = rounds + 1, draft_s + t1 - t0, verify_s + t2 - t1
        if timed:
            timings.update(spec_rounds=rounds, draft_s=draft_s, verify_s=verify_s)
        return self.codes[:n_gen].t().clone(), None


class _Entry:
    """A `DecodeGraphs` entry: a loop's static buffers, its captured steps
    by mode (with the gather-branch layer-steps each makes), the generator
    registered with them, and the addresses of the weights they read."""

    def __init__(self, loop: DecodeLoop, signature: tuple):
        self.loop = loop
        self.graphs: Dict[Mode, Tuple["torch.cuda.CUDAGraph", int]] = {}
        self.generator = torch.Generator(device=loop.step.device)
        self.signature = signature

    def run(self, model, first_logits, n_gen, generator, temperature, noise_override, mode, timings=None):
        """`DecodeLoop.run` through the graph of `mode`.  The gumbel noise
        comes from the entry's registered generator, set to `generator`'s
        state (the device's default one when None) first and copied back
        after, so the caller's generator advances as the eager loop's
        would.  A spec mode fills its noise buffer from `generator` itself
        and gives the registered one to its rounds."""
        graph, gathers = self.graphs[mode]
        source = None
        if not mode.noise or mode.spec:
            device = self.loop.step.device
            source = generator if generator is not None else torch.cuda.default_generators[
                device.index if device.index is not None else torch.cuda.current_device()]
        if mode.spec:
            spec_timings = {} if timings is None else timings
            self.loop.fill_noise(model, n_gen, source, noise_override)
            self.generator.set_state(source.get_state())
            out = self.loop.run_spec(model, first_logits, n_gen, None, temperature, None, graph, self.generator,
                                     spec_timings, filled=True)
            source.set_state(self.generator.get_state())
            decode_step.gathers += gathers * spec_timings["spec_rounds"]
            return out
        if source is not None:
            self.generator.set_state(source.get_state())
        out = self.loop.run(model, first_logits, n_gen, self.generator, temperature, noise_override, mode, graph)
        if source is not None:
            source.set_state(self.generator.get_state())
        decode_step.gathers += gathers * (n_gen - 1)
        return out


@torch.no_grad()
def _capture(model: DALLE, entry: _Entry, mode: Mode, pool) -> Tuple[object, int]:
    """Warm `advance` up on a side stream, then capture it into a graph in
    `pool`; returns (graph, the gather-branch layer-steps one step makes).
    A spec mode captures its round instead, as two graphs (the draft, the
    verification; the pair stands in the graph's place) and counts a
    round's gather-branch layer-steps.  The warm-up really runs: it writes
    the entry's buffers (reset after) and draws from the entry's generator
    (whose state each call sets).  `decode_step.gathers` keeps its value:
    neither counts as a step."""
    from dalle_pytorch_tpu_torch.models.speculative import fused_draft, fused_verify

    loop, device = entry.loop, entry.loop.step.device
    if mode.spec:
        parts = (lambda: fused_draft(loop, model), lambda: fused_verify(loop, model, entry.generator))
    else:
        parts = (lambda: loop.advance(model, entry.generator, mode),)
    gathers = decode_step.gathers
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for _ in range(WARMUP_STEPS):
            loop.reset()
            for part in parts:
                part()
    torch.cuda.current_stream(device).wait_stream(side)
    loop.reset()
    graphs = []
    before = decode_step.gathers
    draws = mode.spec[2] if mode.spec else not mode.noise  # the generator: the step's noise, stochastic rounds
    for part in parts:
        graph = torch.cuda.CUDAGraph()
        if draws:
            graph.register_generator_state(entry.generator)
        with torch.cuda.graph(graph, pool=pool):
            part()
        graphs.append(graph)
    per_step = decode_step.gathers - before
    decode_step.gathers = gathers
    return (tuple(graphs) if mode.spec else graphs[0]), per_step


class DecodeGraphs:
    """CUDA graphs of the decode step, the counterpart of the JAX package's
    `ExecutableCache`: entries keyed by (batch, cond_scale, prime_len,
    filter_thres) for the image loop and (batch, filter_thres) for the text
    loop, with the model's dtype and device; the temperature and the
    generator stay dynamic.  Each entry owns a loop's static buffers, into
    which the eager prefill writes, and one captured step per mode (noise
    override or generator; logit stats or not); all graphs share one memory
    pool.  `hits` and `misses` count calls that found their graph and calls
    that captured it (the JAX package's `gen/exec_cache_hits` /
    `misses`).  A failed capture or replay raises: there is no eager
    fallback.  An entry whose model's weights moved since its capture is
    captured anew."""

    def __init__(self):
        self._entries: Dict[tuple, _Entry] = {}
        self._pool = None
        self.hits = 0
        self.misses = 0

    def entries(self) -> Dict[tuple, _Entry]:
        return dict(self._entries)

    def clear(self) -> None:
        self._entries.clear()

    def entry(self, model: DALLE, key: tuple, make_loop: Callable[[], DecodeLoop], mode: Mode) -> _Entry:
        """The entry of `key`, its graph of `mode` captured (a miss) or
        found (a hit)."""
        key = key + (model.dtype, model.device)
        signature = tuple(t.data_ptr() for t in itertools.chain(model.parameters(), model.buffers()))
        entry = self._entries.get(key)
        if entry is None or entry.signature != signature:
            entry = self._entries[key] = _Entry(make_loop(), signature)
        if mode in entry.graphs:
            self.hits += 1
            return entry
        self.misses += 1
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        entry.loop.prepare(mode)
        entry.graphs[mode] = _capture(model, entry, mode, self._pool)
        return entry


def decode_graphs(model: DALLE) -> DecodeGraphs:
    """The model's own `DecodeGraphs`, made at first use."""
    graphs = getattr(model, "_decode_graphs", None)
    if graphs is None:
        graphs = model._decode_graphs = DecodeGraphs()
    return graphs


def _graphs_on(model: DALLE, graphs: Optional[bool]) -> bool:
    """Whether a call replays CUDA graphs: by default where the model is on
    the card; True on a CPU model raises."""
    on_card = model.device.type == "cuda"
    if graphs and not on_card:
        raise ValueError("graphs=True needs the model on a CUDA device")
    return on_card if graphs is None else bool(graphs)


def _loop(model: DALLE, key: tuple, make_loop: Callable[[], DecodeLoop], mode: Mode, graphs: Optional[bool]):
    """(loop, its run): replayed, the model's `decode_graphs` entry of
    `key`, reset; eager, a fresh loop."""
    if _graphs_on(model, graphs):
        entry = decode_graphs(model).entry(model, key, make_loop, mode)
        entry.loop.reset()
        return entry.loop, entry.run
    loop = make_loop()
    loop.prepare(mode)
    return loop, loop.run


def image_loop(model: DALLE, batch: int, cond_scale: float, prime_len: int, filter_thres: float, mode: Mode,
               graphs: Optional[bool] = None):
    """(loop, run) of the image loop after a prefill of prime_len primer
    codes: `_prefill_phase` fills `loop.cache`, then `run(model,
    first_logits, n_gen, generator, temperature, noise_override, mode)`
    samples the codes.  `graphs` as in `sample_image_codes`."""
    n_gen = model.cfg.image_seq_len - prime_len
    return _loop(model, ("image", batch, float(cond_scale), prime_len, float(filter_thres), mode.spec),
                 lambda: DecodeLoop(model, True, batch, n_gen, cond_scale, filter_thres), mode, graphs)


def text_loop(model: DALLE, batch: int, filter_thres: float, mode: Mode, graphs: Optional[bool] = None):
    """(loop, run) of the text loop; its buffers hold a whole text_seq_len,
    so that one entry serves every prompt length."""
    ts = model.cfg.text_seq_len
    return _loop(model, ("text", batch, float(filter_thres)),
                 lambda: DecodeLoop(model, False, batch, ts, filter_thres=filter_thres), mode, graphs)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _clock(device: torch.device, synchronise: bool) -> float:
    """The host clock, after a synchronise when asked."""
    if synchronise:
        _sync(device)
    return time.perf_counter()


def _lap(timings: Optional[dict], key: str, device: torch.device, t0: float) -> float:
    """With a `timings` dict, synchronise and record the seconds since t0
    under `key`; returns the clock."""
    if timings is not None:
        _sync(device)
        timings[key] = time.perf_counter() - t0
    return time.perf_counter()


def _spec_mode(model: DALLE, spec_k: int, spec_draft_layers: Optional[int], spec_stochastic: bool,
               noise_override, return_logit_stats: bool) -> Optional[Tuple[int, int, bool]]:
    """A spec mode's (k, d, stochastic) (`speculative.validate_spec`), or
    None for spec_k 0."""
    if not spec_k:
        return None
    from dalle_pytorch_tpu_torch.models.speculative import validate_spec

    if return_logit_stats:
        raise ValueError("return_logit_stats is not recorded under speculative decoding (spec_k > 0)")
    if spec_stochastic and noise_override is not None:
        raise ValueError("spec_stochastic draws from the generator; it takes no noise_override")
    return (*validate_spec(model.cfg.transformer_config(), spec_k, spec_draft_layers), bool(spec_stochastic))


@torch.no_grad()
def _sample_codes(model: DALLE, text, generator, filter_thres, temperature, cond_scale, primer_codes, prime_len,
                  noise_override, return_logit_stats, graphs, timings, spec=None):
    """Prefill, then the image loop (replayed or eager); writes capture_s
    (replayed only), prefill_s and decode_s into `timings` (and a spec
    mode's spec_rounds, draft_s, verify_s).  Returns (codes (b,
    image_seq_len) with the primer, stats or None)."""
    cfg = model.cfg
    n_gen = cfg.image_seq_len - prime_len
    if n_gen <= 0:
        raise ValueError("the primer must be shorter than the image sequence")
    b, device = text.shape[0], text.device
    mode = Mode(noise_override is not None, return_logit_stats, spec)

    t0 = time.perf_counter()
    loop, run = image_loop(model, b, cond_scale, prime_len, filter_thres, mode, graphs)
    if _graphs_on(model, graphs):
        t0 = _lap(timings, "capture_s", device, t0)
    _, last_logits = _prefill_phase(model, text, primer_codes, prime_len, cond_scale, loop.cache)
    t0 = _lap(timings, "prefill_s", device, t0)
    codes, stats = run(model, last_logits, n_gen, generator, temperature, noise_override, mode, timings=timings)
    if prime_len > 0:
        codes = torch.cat([primer_codes, codes], dim=1)
    _lap(timings, "decode_s", device, t0)
    return codes, stats


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
    return_logit_stats: bool = False,
    graphs: Optional[bool] = None,
    timings: Optional[dict] = None,
    spec_k: int = 0,
    spec_draft_layers: Optional[int] = None,
    spec_stochastic: bool = False,
):
    """text: (b, text_seq_len) raw ids (0 = pad); primer_codes: optional
    (b, prime_len) codes.  Returns (b, image_seq_len) image codes; with
    return_logit_stats, (codes, {"logit_max", "entropy_mean"}) over the
    guided, top-k-filtered sampling distributions of every step.  graphs:
    None replays CUDA graphs on the card (the model's `decode_graphs`) and
    runs eagerly on the CPU; False runs eagerly; True needs the card.  A
    `timings` dict gets prefill_s, decode_s and, replayed, capture_s (the
    call's warm-up and capture; 0 on a hit).

    spec_k > 0 decodes by self-speculative rounds (`models/speculative`):
    spec_k tokens drafted through the first `spec_draft_layers` layers
    (default half the depth), verified by the full stack, the exact prefix
    accepted.  The codes equal spec_k=0's under the same generator or
    noise at any temperature; `spec_stochastic` accepts by rejection
    sampling instead (the same distribution, another stream).  spec_k=0 is
    the sequential loop and its graphs."""
    spec = _spec_mode(model, spec_k, spec_draft_layers, spec_stochastic, noise_override, return_logit_stats)
    codes, stats = _sample_codes(model, text, generator, filter_thres, temperature, cond_scale, primer_codes,
                                 prime_len, noise_override, return_logit_stats, graphs, timings, spec)
    return (codes, stats) if return_logit_stats else codes


@torch.no_grad()
def generate_images(
    model: DALLE,
    vae: torch.nn.Module,
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
    graphs: Optional[bool] = None,
    spec_k: int = 0,
    spec_draft_layers: Optional[int] = None,
    spec_stochastic: bool = False,
):
    """Sample codes and decode them through the VAE, of any family
    (`vae_registry`).  img: optional (b, H, W, C) pixels in [0, 1] whose
    first codes prime the image.  Returns (b, H, W, C) images as the VAE
    decodes them (the DiscreteVAE's in its normalised pixel space), as the
    JAX package does; with a `clip`, (images, scores): CLIP's score of each
    image against its text, for reranking.  `graphs` and the spec settings
    as in `sample_image_codes`.  With a `timings` dict, the device is
    synchronised after each phase and `prefill_s`, `decode_s`, `vae_s`
    (`clip_s`, and replayed, `capture_s`; speculative, `spec_rounds`,
    `draft_s`, `verify_s`) are written into it."""
    cfg = model.cfg
    spec = _spec_mode(model, spec_k, spec_draft_layers, spec_stochastic, noise_override, False)
    text = text[:, : cfg.text_seq_len]
    primer, prime_len = None, 0
    if img is not None:
        prime_len = (num_init_img_tokens if num_init_img_tokens is not None
                     else int(DEFAULT_PRIME_FRACTION * cfg.image_seq_len))
        if not 0 <= prime_len < cfg.image_seq_len:
            raise ValueError(f"prime_len {prime_len} must lie in [0, {cfg.image_seq_len})")
        if prime_len:
            primer = vae_registry.get_codebook_indices(vae, img)[:, :prime_len]

    codes, _ = _sample_codes(model, text, generator, filter_thres, temperature, cond_scale, primer, prime_len,
                             noise_override, False, graphs, timings, spec)
    t0 = time.perf_counter()
    images = vae_registry.decode_indices(vae, codes)
    t0 = _lap(timings, "vae_s", text.device, t0)
    if clip is None:
        return images
    scores = clip_mod.forward(clip, text, images)
    _lap(timings, "clip_s", text.device, t0)
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
    graphs: Optional[bool] = None,
) -> torch.Tensor:
    """Text completion: no bos and no pad remap.  text: (b, n0) prompt ids
    (a single 0 token when None).  Returns (b, text_seq_len) ids.

    use_cache=True prefills the prompt (causal, n0 long) and then runs the
    text loop of `DecodeLoop` (`text_only` steps: the token shift is the
    identity in the text region), replayed from the model's `decode_graphs`
    as `graphs` says (see `sample_image_codes`; one entry serves every
    prompt length); use_cache=False runs the whole text_seq_len window
    through the transformer again for every token.  Both consume the same
    noise: `noise_override` (text_seq_len - n0, b, total_tokens), one row
    per generated token, in place of `generator`'s."""
    cfg = model.cfg
    device = model.device
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

    if not use_cache:
        buf = torch.zeros((b, ts), dtype=torch.long, device=text.device)
        buf[:, :n0] = text
        for cur in range(n0, ts):
            out = apply_transformer(model.transformer, embed(buf))
            filtered = top_k_filter(_logits_at(model, out[:, cur - 1:cur], image=False), thres=filter_thres)
            if noise_override is not None:
                buf[:, cur] = torch.argmax(filtered / temperature + noise_override[cur - n0], dim=-1)
            else:
                buf[:, cur] = gumbel_sample(filtered, generator, temperature=temperature)
        return buf

    mode = Mode(noise_override is not None, False)
    loop, run = text_loop(model, b, filter_thres, mode, graphs)
    out, _ = prefill(model.transformer, embed(text), loop.cache)
    ids, _ = run(model, _logits_at(model, out[:, -1:], image=False), ts - n0, generator, temperature,
                 noise_override, mode)
    return torch.cat([text, ids], dim=1)
