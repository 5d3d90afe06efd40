"""The continuous-batching generation engine (counterpart of
`dalle_pytorch_tpu/serving/engine.py`).

A long-lived loop over the sampler's prefill and decode step: each `poll()`
(1) admits queued prompts into free lanes: the prompt runs through the
model's `_prefill_phase` (the flash forward kernels on the card), its first
code is sampled, and its dense cache is scattered into the shared paged
block pool and the lane's token-shift rings; (2) runs ONE paged decode step
for every lane (`models/paged.paged_decode_step`), sequences at their own
positions under one static shape; (3) evicts finished requests: pulls their
codes, frees their blocks and decodes the images through the VAE.

On the card the decode step is captured once per engine in a CUDA graph and
replayed on every poll.  The capture happens when the engine is built,
while every lane is idle, so its warm-up steps write only the trash block
and idle lanes.  `graphs=False` runs the same step eagerly; a failed
capture or replay raises (there is no eager fallback, as in
`models/sampling.DecodeGraphs`).

Randomness is per request.  A request's codes equal those of a batch-1
`sample_image_codes` call with the same text and settings whose generator
has the request's seed, or whose `noise_override` is the request's noise,
whatever slot it takes and whoever shares the batch: each lane draws its
gumbel noise from its own `torch.Generator`, reseeded at admission and
registered with the graph, one (1, total_tokens) draw a token, as the
batch-1 loop draws it.  A guided request (cond_scale != 1) holds two lanes,
its [cond] and [null] sequences (`serving/lanes.py`).

The host synchronises at admission (the first code exists: TTFT) and at
eviction (the finished codes); the steady decode loop only launches.

What changes what the card computes:
- `quantize_kv="int8"`: the pool holds int8 k/v with per-token bf16 scales
  (`models/paged.py`); a model quantized by `quantization.quantize_tree`
  runs its products on weights dequantized on use.
- `spec_k > 0`: each poll runs one self-speculative round in place of the
  step (`models/speculative.engine_spec_draft`, `engine_spec_verify`), the
  draft and the verification each captured in a graph; a lane advances by
  its own accepted length, which the host reads once a round.  A lane's
  noise comes from its table row of the position, filled at admission from
  the request's seed in a batch-1 loop's draw order, so the codes equal
  those of the sequential engine.
- The nonfinite screen: a lane whose guided logits turn nonfinite is
  flagged (`serving/lanes.py`); at eviction a flagged request is decoded
  again from a new prefill, up to `poison_max_retries` times, then ends
  "poisoned", while the lanes beside it go on as they were.
  `--inject_fault poison-request@N` (`training/resilience.py`) makes one
  in-flight request's logits NaN on every step of every retry; `flood@N`
  submits a burst of synthetic requests.

Telemetry, SLO monitoring, trace capture, the request journal, the fleet,
the degrade ladder, prefix accounting and the pool's flight recorder are
not ported (ROADMAP.md Queue 1 item 6).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from dalle_pytorch_tpu_torch import quantization as quant_mod
from dalle_pytorch_tpu_torch.models import dalle as dalle_mod
from dalle_pytorch_tpu_torch.models import sampling as sampling_mod
from dalle_pytorch_tpu_torch.models import speculative as spec_mod
from dalle_pytorch_tpu_torch.models import vae_registry
from dalle_pytorch_tpu_torch.models.dalle import DALLE
from dalle_pytorch_tpu_torch.models.paged import (
    init_slot_rings,
    paged_blocks_per_seq,
    paged_decode_step,
    write_prefill_to_pool,
)
from dalle_pytorch_tpu_torch.models.transformer import init_cache
from dalle_pytorch_tpu_torch.serving.kv_pool import BlockPool
from dalle_pytorch_tpu_torch.serving.lanes import LaneState, sample_lanes
from dalle_pytorch_tpu_torch.serving.scheduler import AdmissionController, AdmissionRefused, Request, RequestQueue
from dalle_pytorch_tpu_torch.training import resilience


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Serving settings.  `num_slots` counts lanes (a guided request takes
    two).  `num_blocks` defaults to exactly `num_slots` full sequences;
    size it smaller to make the pool the admission bottleneck.
    `noise_override` keeps a (num_slots, image_seq_len, total_tokens) f32
    buffer so that requests may bring their own gumbel noise; speculation
    (`spec_k` > 0, `spec_draft_layers` default half the depth) keeps it
    always.  `quantize_kv`: None or "int8".  `poison_max_retries`: the
    re-decodes of a request whose lanes turned nonfinite before it ends
    "poisoned"."""

    num_slots: int = 4
    block_size: int = 32
    num_blocks: Optional[int] = None
    max_queue: int = 64
    headroom_frac: float = 0.92
    filter_thres: float = 0.9
    noise_override: bool = False
    quantize_kv: Optional[str] = None
    poison_max_retries: int = 2
    spec_k: int = 0
    spec_draft_layers: Optional[int] = None

    def __post_init__(self):
        quant_mod.kv_bytes_per_elem(self.quantize_kv, 1, 1)  # an unknown kind raises ValueError
        if self.spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {self.spec_k}")
        if self.spec_draft_layers is not None and not self.spec_k:
            raise ValueError("spec_draft_layers needs speculation: set spec_k > 0")
        if self.num_slots < 1:
            raise ValueError(f"num_slots must be at least 1, got {self.num_slots}")


class GenerationEngine:
    """The engine over `model` (a `DALLE` on its device) and, unless None,
    `vae` for the images.  `graphs`: None replays a CUDA graph of the decode
    step on the card and runs it eagerly on the CPU; False runs it eagerly;
    True needs the card.  `usage_fn` overrides the memory-usage reading of
    the headroom gate."""

    def __init__(self, model: DALLE, vae: Optional[torch.nn.Module] = None,
                 engine_cfg: EngineConfig = EngineConfig(), usage_fn: Optional[Callable[[], Optional[float]]] = None,
                 graphs: Optional[bool] = None):
        cfg = model.cfg
        if cfg.image_seq_len < 2:
            raise ValueError("the engine needs at least 2 image tokens")
        self.model, self.vae, self.cfg, self.ecfg = model, vae, cfg, engine_cfg
        self.tcfg = cfg.transformer_config()
        self.device = model.device
        self.n_pre = cfg.text_seq_len + 1  # bos + text
        self.n_gen = cfg.image_seq_len
        S = engine_cfg.num_slots
        num_blocks = engine_cfg.num_blocks
        if num_blocks is None:
            num_blocks = S * paged_blocks_per_seq(self.tcfg, engine_cfg.block_size)
        k_d = None
        if engine_cfg.spec_k:
            k_d = spec_mod.validate_spec(self.tcfg, engine_cfg.spec_k, engine_cfg.spec_draft_layers)
        self.pool = BlockPool(self.tcfg, num_blocks, engine_cfg.block_size, dtype=model.dtype,
                              quant=engine_cfg.quantize_kv)
        self.queue = RequestQueue(max_depth=engine_cfg.max_queue)
        self.admission = AdmissionController(self.pool, headroom_frac=engine_cfg.headroom_frac, usage_fn=usage_fn,
                                             device=self.device)
        dev = self.device
        self.kv = self.pool.device_pool(dev)
        self.rings = init_slot_rings(self.tcfg, S, model.dtype, dev)
        self.block_tables = torch.zeros((S, self.pool.blocks_per_seq), dtype=torch.long, device=dev)
        self.offsets = torch.zeros(S, dtype=torch.long, device=dev)
        self.prev_code = torch.zeros(S, dtype=torch.long, device=dev)
        self.img_prev = torch.zeros(S, dtype=torch.long, device=dev)  # index of the last code made
        self.codes = torch.zeros((S, self.n_gen), dtype=torch.long, device=dev)
        self.active = torch.zeros(S, dtype=torch.bool, device=dev)
        self.poisoned = torch.zeros(S, dtype=torch.bool, device=dev)  # nonfinite logits since admission
        noise_rows = self.n_gen if engine_cfg.noise_override or k_d else 0
        self.lanes = LaneState(S, cfg.total_tokens, dev, noise_rows)
        self._all_lanes = torch.arange(S, device=dev)
        self._free_lanes: List[int] = list(range(S))
        self._inflight: List[Request] = []
        self._next_id = 0
        self._iter = 0
        self._flood_rng = np.random.RandomState(0)
        self._poison_lane_host = -1
        self.decode_steps = 0
        self.counts = {"poison_retries": 0, "quarantined": 0, "poison_injected": 0, "flood_injected": 0,
                       "spec_rounds": 0, "spec_request_rounds": 0, "spec_accepted_tokens": 0,
                       "spec_rejected_tokens": 0}
        self.spec_draft_s = self.spec_round_s = 0.0
        self.spec = None if k_d is None else spec_mod.EngineSpecState(self, *k_d)
        model.transformer.prepare_decode(dev)
        self.graph = None
        self.spec_graphs = None
        if sampling_mod._graphs_on(model, graphs):
            if self.spec is None:
                self.graph = self._capture(self._step)
            else:
                pool = torch.cuda.graph_pool_handle()
                self.spec_graphs = tuple(self._capture(part, pool) for part in (
                    lambda: spec_mod.engine_spec_draft(self), lambda: spec_mod.engine_spec_verify(self)))

    # ------------------------------------------------------------- the step
    @torch.no_grad()
    def _step(self) -> None:
        """One paged decode step for every lane: embed each lane's previous
        code, run the layers at the lanes' offsets, sample, and advance the
        active lanes.  The same ops at every step, on buffers that are never
        replaced: a CUDA graph captures it."""
        model = self.model
        # each lane's code sits at its own raster position, `img_prev`
        x = dalle_mod.embed_image_codes(model, self.prev_code[:, None], self.img_prev)
        out = paged_decode_step(model.transformer, x, self.kv, self.block_tables, self.offsets, self.rings,
                                self.ecfg.block_size)
        logits = sampling_mod._logits_at(model, out, image=True)
        noise = self.lanes.draw(None, self.img_prev + 1, logits.dtype)
        code, bad = sample_lanes(model, logits, self.lanes.settings(), self.ecfg.filter_thres, noise, self.active,
                                 self.lanes.poison_lane)
        self.poisoned |= bad
        act = self.active
        made = self.img_prev + act.long()
        at = made.clamp(0, self.n_gen - 1)
        kept = self.codes[self._all_lanes, at]
        self.codes[self._all_lanes, at] = torch.where(act, code, kept)
        self.offsets.add_(act.long())
        self.prev_code.copy_(torch.where(act, code, self.prev_code))
        self.img_prev.copy_(made)

    @torch.no_grad()
    def _capture(self, step, pool=None) -> "torch.cuda.CUDAGraph":
        """Warm `step` (the decode step, or a half of the speculative round)
        up on a side stream, then capture it, with every lane's generator
        registered with the graph.  Every lane is idle: the warm-up writes
        only the trash block, idle lanes' rings and generators, all of
        which an admission sets anew (an idle lane's round advances by 0)."""
        dev = self.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(sampling_mod.WARMUP_STEPS):
                step()
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        for gen in self.lanes.generators:
            graph.register_generator_state(gen)
        with torch.cuda.graph(graph, pool=pool):
            step()
        return graph

    # ------------------------------------------------------------ requests
    def _make_request(self, text, seed, temperature, cond_scale, noise, deadline_s, retries_left) -> Request:
        text = np.asarray(text, np.int64).reshape(self.cfg.text_seq_len)
        if noise is not None:
            noise = torch.as_tensor(noise, dtype=torch.float32)
            want = (self.n_gen, self.cfg.total_tokens)
            if tuple(noise.shape) != want:
                raise ValueError(f"noise must have shape {want}, got {tuple(noise.shape)}")
            if self.lanes.noise is None:
                raise ValueError("a request with noise needs EngineConfig(noise_override=True)")
        req = Request(id=self._next_id, text=text, seed=self._next_id if seed is None else int(seed),
                      temperature=float(temperature), cond_scale=float(cond_scale), noise=noise,
                      deadline_s=None if deadline_s is None else float(deadline_s))
        if retries_left is not None:
            req.retries_left = int(retries_left)
        self._next_id += 1
        return req

    def _shed(self, req: Request, err: AdmissionRefused) -> None:
        self.admission.note_refusal(err.reason, kind=err.kind)
        req.phases["queue_wait"] = time.monotonic() - req.arrival_t
        req.outcome = "shed"

    def submit(self, text, seed: Optional[int] = None, temperature: float = 1.0, cond_scale: float = 1.0,
               noise=None, deadline_s: Optional[float] = None,
               retries_left: Optional[int] = None) -> Request:
        """Enqueue one prompt: `text` (text_seq_len,) raw ids; `seed` the
        request's generator seed (default: the request id); `noise`
        (image_seq_len, total_tokens) in place of the draws.  Raises
        AdmissionRefused when the queue is full or the request can never fit
        the pool."""
        req = self._make_request(text, seed, temperature, cond_scale, noise, deadline_s, retries_left)
        try:
            self.admission.screen_submit(req)
            self.queue.push(req)
        except AdmissionRefused as e:
            self._shed(req, e)
            raise
        return req

    def submit_when_able(self, text, seed: Optional[int] = None, temperature: float = 1.0,
                         cond_scale: float = 1.0, noise=None, deadline_s: Optional[float] = None, retries_left: Optional[int] = None) -> Request:
        """`submit` for batch callers: a full queue waits (the engine polls
        until there is room) instead of refusing.  A request that can never
        fit the pool still refuses."""
        req = self._make_request(text, seed, temperature, cond_scale, noise, deadline_s, retries_left)
        try:
            self.admission.screen_submit(req)
        except AdmissionRefused as e:
            self._shed(req, e)
            raise
        while len(self.queue) >= self.queue.max_depth:
            self.poll()  # a full queue implies work in flight, so this makes progress
        self.queue.push(req)
        return req

    @property
    def busy(self) -> bool:
        """Work pending: queued or in-flight requests."""
        return bool(len(self.queue) or self._inflight)

    @property
    def free_slots(self) -> int:
        """Lanes free now."""
        return len(self._free_lanes)

    def poll(self) -> List[Request]:
        """One iteration: an armed flood or poison fault, admissions, one
        decode step (or speculative round), evictions.  Returns the requests
        completed in it (codes, and images with a VAE)."""
        self._iter += 1
        self._poll_flood()
        if self._inflight and resilience.take_poison_fault(self._iter):
            victim = self._inflight[0]
            victim.poison_victim = True
            self.counts["poison_injected"] += 1
            print(f"[chaos] poison-request: request {victim.id} poisoned: NaN decode logits until its retry budget "
                  "burns", flush=True)
        self._admit_ready()
        self._track_poison_lane()
        if self._inflight:
            self._decode_once()
        return self._evict_finished()

    def _poll_flood(self) -> None:
        """An armed flood fault's burst of synthetic requests; refusals are
        the drill's success mode."""
        n = resilience.take_flood_fault(self._iter)
        if n:
            print(f"[chaos] flood: injecting {n} synthetic requests", flush=True)
        for _ in range(n):
            text = self._flood_rng.randint(1, self.cfg.num_text_tokens, size=(self.cfg.text_seq_len,))
            try:
                self.submit(text)
                self.counts["flood_injected"] += 1
            except AdmissionRefused:
                pass

    def _track_poison_lane(self) -> None:
        """Point the NaN injection at the victim request's [cond] lane
        wherever it sits now (its lanes change across retries); -1 when no
        victim is in flight."""
        lane = next((r.lanes[0] for r in self._inflight if r.poison_victim and r.lanes), -1)
        if lane != self._poison_lane_host:
            self._poison_lane_host = lane
            self.lanes.poison_lane.fill_(lane)

    def run_until_idle(self, max_iters: Optional[int] = None) -> List[Request]:
        """poll() until the queue and the lanes drain; all completions."""
        out: List[Request] = []
        iters = 0
        while self.busy:
            out.extend(self.poll())
            iters += 1
            if max_iters is not None and iters >= max_iters:
                break
        return out

    def generate(self, texts, seeds=None, temperature: float = 1.0, cond_scale: float = 1.0,
                 noises=None) -> List[Request]:
        """Submit every row of `texts` (b, text_seq_len), row i with seed
        `seeds[i]` (default i) or noise `noises[i]`, and run to completion.
        Returns the requests in submission order."""
        texts = np.asarray(texts)
        reqs = []
        for i in range(texts.shape[0]):
            reqs.append(self.submit_when_able(
                texts[i], seed=seeds[i] if seeds is not None else i, temperature=temperature,
                cond_scale=cond_scale, noise=None if noises is None else noises[i]))
        self.run_until_idle()
        return reqs

    def drain(self) -> List[Dict[str, Any]]:
        """Stop serving and export every unfinished request so that another
        engine can serve it again: its prompt, seed or noise and settings,
        and the codes accepted so far.  A request's codes are a function of
        these alone, so a resubmission reproduces the exported prefix.
        Drained requests end "deferred"; their lanes and blocks are freed."""
        exports: List[Dict[str, Any]] = []

        def export(req: Request, codes: Optional[np.ndarray]) -> Dict[str, Any]:
            return {"text": req.text, "seed": req.seed, "noise": req.noise, "temperature": req.temperature,
                    "cond_scale": req.cond_scale, "codes_done": req.codes_done,
                    "codes": codes, "origin_id": req.id, "deadline_s": req.deadline_s,
                    "retries_left": req.retries_left}

        now = time.monotonic()
        while self.queue.peek() is not None:
            req = self.queue.pop()
            req.phases["queue_wait"] = now - req.arrival_t
            exports.append(export(req, None))
            req.outcome = "deferred"
        lanes: List[int] = []
        for req in self._inflight:
            req.phases["decode"] = now - req.admitted_t
            exports.append(export(req, self.codes[req.lanes[0], :req.codes_done].cpu().numpy().copy()))
            req.outcome = "deferred"
            self._release(req)
            lanes.extend(req.lanes)
        self._inflight = []
        self._reset_lanes(lanes)
        return exports

    def close(self) -> None:
        """Give every queued and in-flight request the outcome "deferred"."""
        now = time.monotonic()
        while self.queue.peek() is not None:
            req = self.queue.pop()
            req.phases["queue_wait"] = now - req.arrival_t
            req.outcome = "deferred"
        for req in self._inflight:
            req.phases["decode"] = now - req.admitted_t
            req.outcome = "deferred"
        self._inflight = []

    # ----------------------------------------------------------- internals
    def _admit_ready(self) -> None:
        while True:
            req = self.queue.peek()
            if req is None:
                return
            reason, _ = self.admission.may_admit_ex(req, free_lanes=len(self._free_lanes),
                                                    in_flight=len(self._inflight))
            if reason is not None:
                req.deferrals += 1
                self.admission.note_deferral(reason)
                return
            self._do_admit(self.queue.pop())
            self.admission.note_flow()

    @torch.no_grad()
    def _do_admit(self, req: Request) -> None:
        """Prefill the prompt, sample its first code, and arm its lanes."""
        t_pop = time.monotonic()
        req.phases["queue_wait"] = t_pop - req.arrival_t
        lanes = [self._free_lanes.pop(0) for _ in range(req.lanes_needed)]
        req.lanes = lanes
        tables = np.stack([self.pool.alloc_table(owner=(req.id << 1) | i) for i in range(len(lanes))])
        model, dev = self.model, self.device
        t_dispatch = time.monotonic()
        req.phases["admission"] = t_dispatch - t_pop

        self.lanes.arm(lanes, req.temperature, req.cond_scale, req.seed, req.noise)
        if self.spec is not None and req.noise is None:
            self.lanes.fill_noise(lanes[0], req.seed)
        text = torch.as_tensor(req.text[None], device=dev)
        cache = init_cache(dataclasses.replace(self.tcfg, seq_len=self.n_pre), len(lanes), dtype=model.dtype,
                           device=dev)
        cache, logits = sampling_mod._prefill_phase(model, text, None, 0, req.cond_scale, cache)
        noise = self.lanes.draw(lanes, torch.zeros(len(lanes), dtype=torch.long, device=dev), logits.dtype)
        code, _ = sample_lanes(model, logits, self.lanes.settings(lanes), self.ecfg.filter_thres, noise)

        idx = torch.tensor(lanes, device=dev)
        tables_t = torch.as_tensor(tables, device=dev)
        write_prefill_to_pool(self.tcfg, self.kv, tables_t, cache["layers"], self.n_pre, self.ecfg.block_size)
        if self.rings is not None:
            for ring, layer in zip(self.rings["layers"], cache["layers"]):
                for name in ("shift_attn", "shift_ff"):
                    ring[name][idx] = layer[name].to(ring[name].dtype)
        self.block_tables[idx] = tables_t
        self.codes[idx, 0] = code
        self.prev_code[idx] = code
        self.offsets[idx] = self.n_pre
        self.img_prev[idx] = 0
        self.active[idx] = True
        self._inflight.append(req)
        req.codes_done = 1  # the first code came with the prefill
        sampling_mod._sync(dev)  # the first code exists: time to first token
        now = time.monotonic()
        req.admitted_t = now
        req.ttft_s = now - req.arrival_t
        req.phases["prefill"] = now - t_dispatch

    def _decode_once(self) -> None:
        if self.spec is not None:
            self._spec_decode_once()
            return
        if self.graph is not None:
            self.graph.replay()
        else:
            self._step()
        self.decode_steps += 1
        for req in self._inflight:
            req.codes_done += 1

    def _spec_decode_once(self) -> None:
        """One speculative round: the draft, then the verification, then
        each request advanced by its lanes' accepted length, read once (the
        round's one host sync; a second one between the halves times the
        draft's share)."""
        k = self.spec.k
        t0 = time.perf_counter()
        if self.spec_graphs is not None:
            self.spec_graphs[0].replay()
        else:
            spec_mod.engine_spec_draft(self)
        sampling_mod._sync(self.device)
        t1 = time.perf_counter()
        if self.spec_graphs is not None:
            self.spec_graphs[1].replay()
        else:
            spec_mod.engine_spec_verify(self)
        advance = self.spec.advance.tolist()
        t2 = time.perf_counter()
        accepted = 0
        for req in self._inflight:
            adv = advance[req.lanes[0]]
            req.codes_done += adv
            req.spec_rounds += 1
            req.spec_accepted += adv
            accepted += adv
        self.decode_steps += 1
        self.counts["spec_rounds"] += 1
        self.counts["spec_request_rounds"] += len(self._inflight)
        self.counts["spec_accepted_tokens"] += accepted
        self.counts["spec_rejected_tokens"] += max((k + 1) * len(self._inflight) - accepted, 0)
        self.spec_draft_s += t1 - t0
        self.spec_round_s += t2 - t0

    def spec_state(self) -> Dict[str, Any]:
        """The speculative accounting: rounds, codes accepted and rejected,
        codes a request gained a round, and the draft's share of the
        rounds' wall time."""
        c = self.counts
        return {"spec_k": self.spec.k if self.spec else 0, "draft_layers": self.spec.d if self.spec else None,
                "rounds": c["spec_rounds"], "accepted_tokens": c["spec_accepted_tokens"],
                "rejected_tokens": c["spec_rejected_tokens"],
                "accepted_tokens_per_round": (c["spec_accepted_tokens"] / c["spec_request_rounds"]
                                              if c["spec_request_rounds"] else None),
                "draft_time_frac": self.spec_draft_s / self.spec_round_s if self.spec_round_s else None}

    def quantization_state(self) -> Dict[str, Any]:
        """The weight and KV storage dtypes and the analytic dequant work of
        one decode step, beside the step's matmul work."""
        wk = quant_mod.weight_quant_kind(self.model)
        over = quant_mod.dequant_overhead_flops(self.tcfg, self.pool.quant, wk, self.ecfg.num_slots,
                                                emb_rows=self.cfg.total_tokens + self.cfg.num_image_tokens)
        return {"weight_dtype": wk or str(self.model.dtype).replace("torch.", ""),
                "kv_dtype": self.pool.quant or str(self.pool.dtype).replace("torch.", ""),
                "weight_bytes": quant_mod.tree_weight_bytes(self.model), "pool_bytes": self.pool.bytes(),
                "dequant_flops_per_step": over["dequant_flops_per_step"],
                "dequant_frac_of_step": round(over["dequant_frac_of_step"], 6)}

    def _release(self, req: Request) -> None:
        for i in range(len(req.lanes)):
            self.pool.free_table((req.id << 1) | i)
        self._free_lanes.extend(req.lanes)

    def _reset_lanes(self, lanes: List[int]) -> None:
        if not lanes:
            return
        idx = torch.tensor(lanes, device=self.device)
        self.active[idx] = False
        self.poisoned[idx] = False
        self.block_tables[idx] = 0
        self.offsets[idx] = 0
        self.img_prev[idx] = 0

    @torch.no_grad()
    def _evict_finished(self) -> List[Request]:
        """Finish the requests whose codes are all made.  A request whose
        lanes turned nonfinite is retried from a new prefill (at the head of
        the queue) while it has retries left, else it ends "poisoned"; the
        flags are read at this sync, which the codes' pull needs anyway.
        Returns the completed ones."""
        done = [r for r in self._inflight if r.codes_done >= self.n_gen]
        if not done:
            return done
        t_evict = time.monotonic()
        self._inflight = [r for r in self._inflight if r.codes_done < self.n_gen]
        flags = self.poisoned.cpu()
        lanes: List[int] = []
        healthy: List[Request] = []
        for req in done:
            req.phases["decode"] = t_evict - req.admitted_t
            if not bool(flags[req.lanes].any()):
                req.codes = self.codes[req.lanes[0]].cpu().numpy().copy()  # a copy: the lane is reused
                healthy.append(req)
            self._release(req)
            lanes.extend(req.lanes)
            req.latency_s = time.monotonic() - req.arrival_t
        self._reset_lanes(lanes)
        for req in done:
            if req in healthy:
                continue
            if req.poison_retries < self.ecfg.poison_max_retries:
                req.poison_retries += 1
                req.codes_done, req.lanes, req.admitted_t = 0, None, None
                self.queue.requeue(req)
                self.counts["poison_retries"] += 1
            else:
                req.phases["evict"] = max(req.latency_s - sum(req.phases.values()), 0.0)
                req.outcome = "poisoned"
                self.counts["quarantined"] += 1
        self._track_poison_lane()
        for req in healthy:
            if self.vae is not None:
                t0 = time.perf_counter()
                codes = torch.as_tensor(req.codes[None], device=self.device)
                req.images = vae_registry.decode_indices(self.vae, codes).cpu()
                req.phases["vae_decode"] = time.perf_counter() - t0
                req.latency_s = time.monotonic() - req.arrival_t
            req.phases["evict"] = max(req.latency_s - sum(req.phases.values()), 0.0)
            req.outcome = "completed"
        return healthy
