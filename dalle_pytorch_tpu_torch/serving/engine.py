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

Admission is two halves: `prefill_handoff` (the prefill and the first
code: the flash forward kernels on the card) and the ingest (the dense
prefix scattered into the pool, the lanes armed).  A disaggregated fleet
(`serving/fleet.py`) runs the first half in its `PrefillWorker` and hands
the prefix over; a fused admission runs the same function in the engine.
The request's first noise row comes from a fresh generator with its seed
(or from its noise), and its lanes' generators start where that draw
left it, so the two paths give the same codes.

The fleet's surface: `replica_id` (set by the router), `wedge` (the
stall-replica drill: poll() does nothing for a while, the engine stays
alive), `attach_journal` (every accepted request journaled before submit
returns, every terminal outcome acknowledged: `_finish_record`),
`attach_degrade` (the ladder shapes each submit; a capped lane samples
from `degraded_filter_thres`'s candidates; speculation stops at rung 2),
`attach_slo` (the SLO monitor and the status file at each window's close,
every `telemetry_every` polls), the pool's flight recorder and its gauges
(`pool_observability`), and the prefix accounting (`prefix_redundancy`).
Counts go into the process's metrics registry under the JAX package's
names; `counts` is a view of the engine's counters there.  In a fleet the
router numbers each replica's requests apart (`number_requests`), so an
unseeded request's seed and journal uid are the fleet's own.  Telemetry
spans and trace events come with ROADMAP.md Queue 1 item 8.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import signal
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

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
from dalle_pytorch_tpu_torch.observability import metrics as obs_metrics
from dalle_pytorch_tpu_torch.observability import tracing
from dalle_pytorch_tpu_torch.observability.pool import PoolGauges
from dalle_pytorch_tpu_torch.ops.sampling import gumbel_noise
from dalle_pytorch_tpu_torch.serving.kv_pool import BlockPool, PoolFlightRecorder
from dalle_pytorch_tpu_torch.serving.lanes import LaneState, request_settings, sample_lanes
from dalle_pytorch_tpu_torch.serving.scheduler import AdmissionController, AdmissionRefused, Request, RequestQueue
from dalle_pytorch_tpu_torch.training import resilience

# outcomes that acknowledge a journaled request
_ACKED = ("completed", "shed", "poisoned", "requeue_exhausted")
# the engine's counters in the registry, `serving/<name>`, that `counts` shows
_COUNTS = ("poison_retries", "quarantined", "poison_injected", "flood_injected", "spec_rounds", "spec_request_rounds",
           "spec_accepted_tokens", "spec_rejected_tokens")


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
    "poisoned".  `degraded_filter_thres`: the top-k threshold of a lane
    admitted at the degrade ladder's cap_candidates rung or above.
    `telemetry_every`: polls a window (the SLO monitor's evaluation, the
    status file, the window gauges).  `pool_recorder`: the pool's flight
    recorder, a ring of `pool_recorder_capacity` events (off: the pool's
    hooks are one `is None` test)."""

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
    degraded_filter_thres: float = 0.98
    telemetry_every: int = 32
    pool_recorder: bool = True
    pool_recorder_capacity: int = 4096

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
        self._pool_gauges = None
        if engine_cfg.pool_recorder:
            rec = PoolFlightRecorder(capacity=engine_cfg.pool_recorder_capacity)
            self.pool.recorder = rec
            self._pool_gauges = PoolGauges(num_blocks=self.pool.num_blocks, block_size=engine_cfg.block_size,
                                           blocks_per_seq=self.pool.blocks_per_seq)
            rec.on_event = self._pool_gauges.observe
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
        self._id_step = 1
        self._iter = 0
        self._flood_rng = np.random.RandomState(0)
        self._poison_lane_host = -1
        self.decode_steps = 0
        self._counts_base = {n: obs_metrics.counter(f"serving/{n}").value for n in _COUNTS}
        self.spec_draft_s = self.spec_round_s = 0.0
        # the fleet's hooks: the router sets `replica_id`; a disaggregated
        # fleet sets `prefill_backend` (its PrefillWorker); the journal and
        # the ladder are attached; `_stall_until` wedges poll()
        self.replica_id: Optional[int] = None
        self.prefill_backend = None
        self.journal = None
        self.degrade = None
        self.degrade_observe = True
        self._stall_until = 0.0
        self._slo = None
        self._status_path: Optional[str] = None
        self._phase = "idle"
        self._phase_acc = {"admit": 0.0, "dispatch": 0.0, "evict": 0.0}
        self._win = {"decode_steps": 0, "lane_tokens": 0, "spec_rounds": 0, "spec_accepted": 0, "spec_draft_s": 0.0,
                     "spec_total_s": 0.0}
        self._win_t = time.monotonic()
        # prefix accounting: each admitted prompt's hash, and the prefill KV
        # bytes a prefix cache would save (the null lane's, repeated prompts')
        self._prefix_seen: Dict[str, int] = {}
        self._prefix = {"admissions": 0, "repeats": 0, "repeat_bytes": 0.0, "null_bytes": 0.0, "total_bytes": 0.0}
        self.spec = None if k_d is None else spec_mod.EngineSpecState(self, *k_d)
        model.transformer.prepare_decode(dev)
        self.graph = None
        self.spec_graphs = None
        self._graph_pool = None
        if sampling_mod._graphs_on(model, graphs):
            if self.spec is None:
                self.graph = self._capture(self._step)
            else:
                # the rounds; the sequential step that the degrade ladder runs in
                # their place is captured into the same pool by attach_degrade
                self._graph_pool = torch.cuda.graph_pool_handle()
                self.spec_graphs = tuple(self._capture(part, self._graph_pool) for part in (
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
                                 self.lanes.poison_lane, self.lanes.cand_cap, self.ecfg.degraded_filter_thres)
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
    def _make_request(self, text, seed, temperature, cond_scale, noise, deadline_s, retries_left, synthetic,
                      replayed) -> Request:
        text = np.asarray(text, np.int64).reshape(self.cfg.text_seq_len)
        if noise is not None:
            if self.journal is not None:
                raise ValueError("a request with noise cannot be journaled (a replay would need its noise): submit "
                                 "it with a seed, or serve without a journal")
            noise = torch.as_tensor(noise, dtype=torch.float32)
            want = (self.n_gen, self.cfg.total_tokens)
            if tuple(noise.shape) != want:
                raise ValueError(f"noise must have shape {want}, got {tuple(noise.shape)}")
            if self.lanes.noise is None:
                raise ValueError("a request with noise needs EngineConfig(noise_override=True)")
        req = Request(id=self._next_id, text=text, seed=self._next_id if seed is None else int(seed),
                      temperature=float(temperature), cond_scale=float(cond_scale), noise=noise,
                      deadline_s=None if deadline_s is None else float(deadline_s), synthetic=synthetic,
                      replayed=replayed)
        if retries_left is not None:
            req.retries_left = int(retries_left)
        req.replica = self.replica_id
        tracing.journey_uid(req)
        self._next_id += self._id_step
        return req

    def _screen(self, req: Request) -> None:
        """The degrade ladder's shaping and admission's screen; a refusal
        is counted, recorded "shed" and raised."""
        try:
            if self.degrade is not None:
                self.degrade.shape_request(req)
            self.admission.screen_submit(req)
        except AdmissionRefused as e:
            self._shed(req, e)
            raise

    def _shed(self, req: Request, err: AdmissionRefused) -> None:
        obs_metrics.counter("serving/refused").inc()
        self.admission.note_refusal(err.reason, kind=err.kind)
        req.phases["queue_wait"] = time.monotonic() - req.arrival_t
        self._finish_record(req, "shed")

    def _accepted(self, req: Request) -> Request:
        obs_metrics.counter("serving/submitted").inc()
        if self.journal is not None:
            self.journal.accepted(req)  # the durability point: fsynced before submit returns
        return req

    def submit(self, text, seed: Optional[int] = None, temperature: float = 1.0, cond_scale: float = 1.0,
               noise=None, deadline_s: Optional[float] = None, retries_left: Optional[int] = None,
               synthetic: bool = False, replayed: bool = False) -> Request:
        """Enqueue one prompt: `text` (text_seq_len,) raw ids; `seed` the
        request's generator seed (default: the request id); `noise`
        (image_seq_len, total_tokens) in place of the draws.  Raises
        AdmissionRefused when the queue is full, the request can never fit
        the pool or the degrade ladder refuses it; with a journal attached,
        the request is journaled before this returns."""
        req = self._make_request(text, seed, temperature, cond_scale, noise, deadline_s, retries_left, synthetic,
                                 replayed)
        self._screen(req)
        try:
            self.queue.push(req)
        except AdmissionRefused as e:
            self._shed(req, e)
            raise
        return self._accepted(req)

    def submit_when_able(self, text, seed: Optional[int] = None, temperature: float = 1.0,
                         cond_scale: float = 1.0, noise=None, deadline_s: Optional[float] = None,
                         retries_left: Optional[int] = None, synthetic: bool = False,
                         replayed: bool = False) -> Request:
        """`submit` for batch callers: a full queue waits (the engine polls
        until there is room) instead of refusing.  A request that can never
        fit the pool still refuses."""
        req = self._make_request(text, seed, temperature, cond_scale, noise, deadline_s, retries_left, synthetic,
                                 replayed)
        self._screen(req)
        waited = False
        while len(self.queue) >= self.queue.max_depth:
            if not waited:
                obs_metrics.counter("serving/submit_waits").inc()
                waited = True
            self.poll()  # a full queue implies work in flight, so this makes progress
        self.queue.push(req)
        return self._accepted(req)

    @property
    def busy(self) -> bool:
        """Work pending: queued or in-flight requests."""
        return bool(len(self.queue) or self._inflight)

    @property
    def free_slots(self) -> int:
        """Lanes free now."""
        return len(self._free_lanes)

    def wedge(self, seconds: float) -> None:
        """The stall-replica drill: poll() does nothing for `seconds`; the
        engine keeps its queue and its lanes, but its iteration count stops."""
        self._stall_until = time.monotonic() + float(seconds)
        obs_metrics.counter("serving/wedged").inc()

    @property
    def stalled(self) -> bool:
        return bool(self._stall_until and time.monotonic() < self._stall_until)

    def number_requests(self, first: int, step: int) -> None:
        """Number this engine's requests first, first + step, ...: the
        router gives replica r of N the ids r, r + N, ..., so that an
        unseeded request's seed (its id) and its journal uid are the
        fleet's own."""
        self._next_id, self._id_step = int(first), int(step)
        self._skip_journaled_seeds()

    def _skip_journaled_seeds(self) -> None:
        """Move the next id past every seed the journal holds (keeping its
        place in the numbering), so that an unseeded request after a
        restart does not take the uid of one journaled before it."""
        behind = 0 if self.journal is None else self.journal.next_free_seed() - self._next_id
        if behind > 0:
            self._next_id += -(-behind // self._id_step) * self._id_step

    def attach_journal(self, journal) -> None:
        """Journal every accepted request and acknowledge every terminal
        outcome (`serving/journal.RequestJournal`)."""
        self.journal = journal
        self._skip_journaled_seeds()

    def attach_degrade(self, ladder, observe: bool = True) -> None:
        """Shape every submit by `ladder`; with `observe`, feed it this
        engine's queue fraction once a poll (a fleet observes it instead).
        A speculative engine on the card captures here the sequential step
        that rung 2 runs in place of its rounds: attach before serving."""
        if self.spec_graphs is not None and self.graph is None:
            if self.busy:
                raise RuntimeError("attach the degrade ladder before serving: its step is captured while every "
                                   "lane is idle")
            self.graph = self._capture(self._step, self._graph_pool)
        self.degrade = ladder
        self.degrade_observe = observe

    def attach_slo(self, monitor, status_path: Optional[str] = None) -> None:
        """Evaluate `monitor` (an `observability/slo.SloMonitor`, or None)
        and write `status_path` atomically at each window's close."""
        self._slo = monitor
        self._status_path = status_path

    @property
    def counts(self) -> Dict[str, int]:
        """A view of the registry's `serving/<name>` counters since this
        engine was built (the replicas of a fleet share them)."""
        return {n: int(obs_metrics.counter(f"serving/{n}").value - base) for n, base in self._counts_base.items()}

    def _count(self, name: str, n: int = 1) -> None:
        obs_metrics.counter(f"serving/{name}").inc(n)

    def poll(self) -> List[Request]:
        """One iteration: an armed fault, the degrade ladder's sample,
        admissions, one decode step (or speculative round), evictions, and
        every `telemetry_every` polls a window's close.  Returns the
        requests completed in it (codes, and images with a VAE).  A wedged
        engine returns at once."""
        if self._stall_until:
            if time.monotonic() < self._stall_until:
                return []
            self._stall_until = 0.0
        self._iter += 1
        self._poll_flood()
        if self.replica_id is None and resilience.take_kill_fleet_fault(self._iter):
            # one engine's crash drill: killed here with no cleanup (a fleet fires it from its own poll)
            print(f"[chaos] kill-fleet: SIGKILL of the whole process at engine iteration {self._iter}", flush=True)
            os.kill(os.getpid(), signal.SIGKILL)
        if self.degrade is not None and self.degrade_observe:
            self.degrade.observe(len(self.queue) / max(self.queue.max_depth, 1), slo=self._slo)
        if self._inflight and resilience.take_poison_fault(self._iter):
            victim = self._inflight[0]
            victim.poison_victim = True
            self._count("poison_injected")
            print(f"[chaos] poison-request: request {victim.id} poisoned: NaN decode logits until its retry budget "
                  "burns", flush=True)
        self._phase = "admit"
        t0 = time.monotonic()
        self._admit_ready()
        self._track_poison_lane()
        t1 = time.monotonic()
        self._phase_acc["admit"] += t1 - t0
        if self._inflight:
            self._phase = "dispatch"
            self._decode_once()
        t2 = time.monotonic()
        self._phase_acc["dispatch"] += t2 - t1
        self._phase = "evict"
        done = self._evict_finished()
        self._phase_acc["evict"] += time.monotonic() - t2
        self._phase = "idle"
        if self.ecfg.telemetry_every and self._iter % self.ecfg.telemetry_every == 0:
            self._window_event()
        return done

    def _poll_flood(self) -> None:
        """An armed flood fault's burst of synthetic requests; refusals are
        the drill's success mode."""
        n = resilience.take_flood_fault(self._iter)
        if n:
            print(f"[chaos] flood: injecting {n} synthetic requests", flush=True)
        for _ in range(n):
            text = self._flood_rng.randint(1, self.cfg.num_text_tokens, size=(self.cfg.text_seq_len,))
            try:
                self.submit(text, synthetic=True)
                self._count("flood_injected")
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
                    "cond_scale": req.cond_scale, "synthetic": req.synthetic, "codes_done": req.codes_done,
                    "codes": codes, "origin_id": req.id, "origin_replica": self.replica_id,
                    "deadline_s": req.deadline_s, "retries_left": req.retries_left}

        now = time.monotonic()
        while self.queue.peek() is not None:
            req = self.queue.pop()
            req.phases["queue_wait"] = now - req.arrival_t
            exports.append(export(req, None))
            self._finish_record(req, "deferred")
        lanes: List[int] = []
        for req in self._inflight:
            req.phases["decode"] = now - req.admitted_t
            exports.append(export(req, self.codes[req.lanes[0], :req.codes_done].cpu().numpy().copy()))
            self._finish_record(req, "deferred")
            self._release(req)
            lanes.extend(req.lanes)
        self._inflight = []
        self._reset_lanes(lanes)
        obs_metrics.counter("serving/drained").inc(len(exports))
        self._window_event()
        return exports

    def memory_ledger(self, capacity_bytes: Optional[float] = None) -> Dict[str, Any]:
        """The serving path's HBM ledger (JAX `GenerationEngine.memory_ledger`):
        the weights, the paged pool at rest (the trash block included; an
        int8 pool at 1 + 2/dim_head bytes an element) and the transient
        one-layer view the paged step gathers per lane
        (`observability/memory.sampling_memory_ledger`)."""
        from dalle_pytorch_tpu_torch.observability import memory as memory_mod

        pool = {"num_blocks": self.pool.num_blocks + 1, "block_size": self.ecfg.block_size,
                "num_slots": self.ecfg.num_slots}
        if self.pool.quant:
            pool["kv_quant"] = self.pool.quant
        return memory_mod.sampling_memory_ledger(self.cfg, self.ecfg.num_slots, self.model,
                                                 capacity_bytes=capacity_bytes, paged_pool=pool,
                                                 device=self.device)

    def close(self) -> None:
        """Give every queued and in-flight request the outcome "deferred"
        (a journaled one stays open for the next replay) and close the
        window."""
        now = time.monotonic()
        while self.queue.peek() is not None:
            req = self.queue.pop()
            req.phases["queue_wait"] = now - req.arrival_t
            self._finish_record(req, "deferred")
        for req in self._inflight:
            req.phases["decode"] = now - req.admitted_t
            self._finish_record(req, "deferred")
        self._inflight = []
        self._window_event()

    def release(self) -> None:
        """Free the device state of an engine that will serve no more (a
        lost replica): its graphs, pool, rings and lane buffers."""
        self.graph = self.spec_graphs = self._graph_pool = None
        self.kv = self.rings = None
        self.lanes.noise = None
        self.spec = None

    def _finish_record(self, req: Request, outcome: str) -> None:
        """The request's one terminal outcome.  A terminal outcome
        acknowledges its journal entry; the first acknowledgement wins, and
        a duplicate (a hedged copy, a replay racing a completion) is
        counted by the journal."""
        req.outcome = outcome
        if self.journal is not None and outcome in _ACKED:
            self.journal.ack(req, outcome)

    def phase_state(self) -> Dict[str, Any]:
        """Where the engine is: its iteration, the poll phase it is in, the
        queue, the free lanes and every in-flight request's progress."""
        return {"iter": self._iter, "phase": self._phase, "queue_depth": len(self.queue),
                "free_lanes": len(self._free_lanes),
                "inflight": [{"id": r.id, "codes_done": r.codes_done, "lanes": r.lanes,
                              "phases": {k: round(v, 3) for k, v in r.phases.items()}} for r in self._inflight]}

    # ----------------------------------------------------------- internals
    def _admit_ready(self) -> None:
        while True:
            req = self.queue.peek()
            if req is None:
                return
            reason, kind = self.admission.may_admit_ex(req, free_lanes=len(self._free_lanes),
                                                       in_flight=len(self._inflight))
            if reason is not None:
                req.deferrals += 1
                self.admission.note_deferral(reason)
                rec = self.pool.recorder
                if rec is not None:
                    rec.record("defer", req=req.id, defer_kind=kind, lanes_needed=req.lanes_needed,
                               blocks_needed=req.lanes_needed * self.pool.blocks_per_seq, free=self.pool.free_blocks,
                               free_lanes=len(self._free_lanes), replica=self.replica_id)
                return
            self._do_admit(self.queue.pop())
            self.admission.note_flow()

    @torch.no_grad()
    def _do_admit(self, req: Request) -> None:
        """Allocate the request's lanes and blocks, take its prefill and
        first code (from the fleet's prefill worker, or made here by the
        same `prefill_handoff`), and ingest them."""
        t_pop = time.monotonic()
        req.phases["queue_wait"] = t_pop - req.arrival_t
        lanes = [self._free_lanes.pop(0) for _ in range(req.lanes_needed)]
        req.lanes = lanes
        phash = hashlib.sha1(req.text.tobytes()).hexdigest()[:12]
        rec = self.pool.recorder
        if rec is not None:
            rec.ctx = {"req": req.id, "journey": tracing.journey_uid(req), "lanes": req.lanes_needed,
                       "guided": req.guided, "prefix_hash": phash, "replica": self.replica_id}
        tables = np.stack([self.pool.alloc_table(owner=(req.id << 1) | i) for i in range(len(lanes))])
        if rec is not None:
            rec.ctx = None
        t_dispatch = time.monotonic()
        req.phases["admission"] = t_dispatch - t_pop
        if self.prefill_backend is not None:
            handoff = self.prefill_backend.prefill(req)
        else:
            handoff = prefill_handoff(self.model, req, self.ecfg.filter_thres, self.ecfg.degraded_filter_thres)
        self._ingest(req, lanes, tables, handoff)
        self._inflight.append(req)
        req.codes_done = 1  # the first code came with the prefill
        sampling_mod._sync(self.device)  # the first code exists: time to first token
        now = time.monotonic()
        req.admitted_t = now
        req.ttft_s = now - req.arrival_t
        req.phases["prefill"] = now - t_dispatch
        obs_metrics.counter("serving/admitted").inc()
        obs_metrics.histogram("serving/ttft_s").observe(req.ttft_s)
        self._publish_lanes()
        self._note_prefix(req, phash)

    def _ingest(self, req: Request, lanes: List[int], tables: np.ndarray, handoff: Dict[str, Any]) -> None:
        """The second half of admission, on the handoff of either path:
        the dense prefix into the lanes' blocks and rings, the first code,
        and the lanes armed (their generators where the first draw left
        the request's; a speculative engine's noise table filled)."""
        dev = self.device
        idx = torch.tensor(lanes, device=dev)
        tables_t = torch.as_tensor(tables, device=dev)
        layers, code = handoff["layers"], handoff["code"]
        write_prefill_to_pool(self.tcfg, self.kv, tables_t, layers, self.n_pre, self.ecfg.block_size)
        if self.rings is not None:
            for ring, layer in zip(self.rings["layers"], layers):
                for name in ("shift_attn", "shift_ff"):
                    ring[name][idx] = layer[name].to(ring[name].dtype)
        self.lanes.arm(lanes, req.temperature, req.cond_scale, req.seed, req.noise, cap=req.degrade_rung >= 2,
                       rng_state=handoff["rng_state"])
        if self.spec is not None and req.noise is None:
            self.lanes.fill_noise(lanes[0], req.seed)
        self.block_tables[idx] = tables_t
        self.codes[idx, 0] = code
        self.prev_code[idx] = code
        self.offsets[idx] = self.n_pre
        self.img_prev[idx] = 0
        self.active[idx] = True

    def _note_prefix(self, req: Request, h: str) -> None:
        """Prefix accounting for one admission: the prefill KV bytes of its
        lanes, those of the null lane (the same for every guided request)
        and those of a prompt seen before (hedges, requeues, replays)."""
        per_lane = self.pool.prefix_bytes(self.n_pre)
        p = self._prefix
        p["admissions"] += 1
        p["total_bytes"] += per_lane * req.lanes_needed
        if req.guided:
            p["null_bytes"] += per_lane
        if h in self._prefix_seen:
            p["repeats"] += 1
            p["repeat_bytes"] += per_lane
        self._prefix_seen[h] = self._prefix_seen.get(h, 0) + 1
        obs_metrics.gauge("prefix/duplicate_bytes").set(p["null_bytes"] + p["repeat_bytes"])
        obs_metrics.gauge("prefix/repeat_hit_frac").set(p["repeats"] / p["admissions"])

    def prefix_redundancy(self) -> Dict[str, Any]:
        """How many prefill KV bytes a prefix cache would have saved: the
        null lanes' (`null_lane_bytes`) and repeated prompts'."""
        p = self._prefix
        dup, total = p["null_bytes"] + p["repeat_bytes"], p["total_bytes"]
        return {"admissions": p["admissions"], "unique_prefixes": len(self._prefix_seen),
                "repeat_hits": p["repeats"],
                "repeat_hit_frac": p["repeats"] / p["admissions"] if p["admissions"] else 0.0,
                "null_lane_bytes": p["null_bytes"], "repeat_prefill_bytes": p["repeat_bytes"],
                "duplicate_bytes": dup, "prefill_bytes": total, "duplicate_frac": dup / total if total else 0.0}

    def _decode_once(self) -> None:
        if self.spec is not None and not (self.degrade is not None and self.degrade.suppress_spec):
            self._spec_decode_once()
            return
        if self.graph is not None:
            self.graph.replay()
        else:
            self._step()
        self.decode_steps += 1
        obs_metrics.counter("serving/decode_steps").inc()
        obs_metrics.counter("serving/decode_lane_tokens").inc(len(self._inflight))
        self._win["decode_steps"] += 1
        self._win["lane_tokens"] += len(self._inflight)
        for req in self._inflight:
            req.codes_done += 1
            if self.journal is not None and req.codes_done % self.journal.progress_every == 0:
                self.journal.progress(req)

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
        accepted = lane_tokens = 0
        every = self.journal.progress_every if self.journal is not None else 0
        for req in self._inflight:
            adv = advance[req.lanes[0]]
            old = req.codes_done
            req.codes_done += adv
            req.spec_rounds += 1
            req.spec_accepted += adv
            accepted += adv
            lane_tokens += adv * len(req.lanes)
            for i in range(len(req.lanes)):  # the host's commit point: the verified prefix
                self.pool.truncate_slot((req.id << 1) | i, self.n_pre + req.codes_done - 1)
            if every and adv and old // every != req.codes_done // every:
                self.journal.progress(req)
        self.decode_steps += 1
        self._count("spec_rounds")
        self._count("spec_request_rounds", len(self._inflight))
        self._count("spec_accepted_tokens", accepted)
        self._count("spec_rejected_tokens", max((k + 1) * len(self._inflight) - accepted, 0))
        obs_metrics.counter("serving/decode_steps").inc()
        obs_metrics.counter("serving/decode_lane_tokens").inc(lane_tokens)
        w = self._win
        w["decode_steps"] += 1
        w["lane_tokens"] += lane_tokens
        w["spec_rounds"] += len(self._inflight)
        w["spec_accepted"] += accepted
        w["spec_draft_s"] += t1 - t0
        w["spec_total_s"] += t2 - t0
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

    def pool_observability(self) -> Dict[str, Any]:
        """The pool's free-list state, and with the recorder on its gauges'
        summary (block lifetimes, reserved-but-unused blocks, footprints,
        the overcommit forecast) and its drops."""
        out = self.pool.summary()
        if self._pool_gauges is not None:
            out.update(self._pool_gauges.summary())
            out["recorder_dropped"] = self.pool.recorder.dropped
        return out

    def _window_event(self) -> None:
        """Close a window: the poll-phase split, the goodput (lane-codes made
        against every lane busy every step) and speculation gauges, the
        pool gauges, the SLO monitor's evaluation and the status file."""
        now = time.monotonic()
        elapsed = max(now - self._win_t, 1e-9)
        w = self._win
        ideal = w["decode_steps"] * self.ecfg.num_slots
        for k, v in self._phase_acc.items():
            obs_metrics.gauge(f"serving/phase_{k}_s").set(v)
        if ideal:
            obs_metrics.gauge("serving/goodput_frac").set(w["lane_tokens"] / ideal)
        obs_metrics.gauge("serving/lane_tokens_per_s").set(w["lane_tokens"] / elapsed)
        if w["spec_rounds"]:
            obs_metrics.gauge("spec/accepted_tokens_per_step").set(w["spec_accepted"] / w["spec_rounds"])
            if w["spec_total_s"] > 0:
                obs_metrics.gauge("spec/draft_time_frac").set(w["spec_draft_s"] / w["spec_total_s"])
        self._phase_acc = dict.fromkeys(self._phase_acc, 0.0)
        self._win = dict.fromkeys(w, 0)
        self._win_t = now
        if self._pool_gauges is not None:
            self._pool_gauges.publish(dropped=self.pool.recorder.dropped)
        if self._slo is not None:
            self._slo.observe(self._iter)
        if self._status_path:
            self._write_status()

    def _write_status(self) -> None:
        from dalle_pytorch_tpu_torch.observability.slo import write_status_json

        payload: Dict[str, Any] = self._slo.status() if self._slo is not None else {}
        payload["serving"] = {"iter": self._iter, "replica": self.replica_id, "queue_depth": len(self.queue),
                              "active_lanes": self.ecfg.num_slots - len(self._free_lanes),
                              "inflight": len(self._inflight), "pool_occupancy_frac": self.pool.occupancy_frac,
                              "pool_free_blocks": self.pool.free_blocks}
        payload["pool"] = self.pool_observability()
        payload["quantization"] = self.quantization_state()
        write_status_json(self._status_path, payload)

    def _publish_lanes(self) -> None:
        obs_metrics.gauge("serving/active_lanes").set(self.ecfg.num_slots - len(self._free_lanes))
        obs_metrics.gauge("serving/pool_occupancy_frac").set(self.pool.occupancy_frac)
        obs_metrics.gauge("serving/pool_free_blocks").set(self.pool.free_blocks)

    def _release(self, req: Request) -> None:
        # a lane wrote the prefix and one column a code fed back (the last code made is never fed)
        written = self.n_pre + max(req.codes_done - 1, 0)
        for i in range(len(req.lanes)):
            self.pool.free_table((req.id << 1) | i, written_tokens=written)
        self._free_lanes.extend(req.lanes)

    def _reset_lanes(self, lanes: List[int]) -> None:
        if not lanes:
            return
        idx = torch.tensor(lanes, device=self.device)
        self.active[idx] = False
        self.poisoned[idx] = False
        self.lanes.cand_cap[idx] = False
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
                self._count("poison_retries")
            else:
                req.phases["evict"] = max(req.latency_s - sum(req.phases.values()), 0.0)
                self._count("quarantined")
                self._finish_record(req, "poisoned")
        self._track_poison_lane()
        for req in healthy:
            if self.vae is not None:
                t0 = time.perf_counter()
                codes = torch.as_tensor(req.codes[None], device=self.device)
                req.images = vae_registry.decode_indices(self.vae, codes).cpu()
                req.phases["vae_decode"] = time.perf_counter() - t0
                req.latency_s = time.monotonic() - req.arrival_t
            req.phases["evict"] = max(req.latency_s - sum(req.phases.values()), 0.0)
            obs_metrics.counter("serving/completed").inc()
            obs_metrics.histogram("serving/request_s").observe(req.latency_s)
            self._finish_record(req, "completed")
        self._publish_lanes()
        return healthy


def first_noise(req: Request, total_tokens: int, device: torch.device,
                dtype: torch.dtype) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The gumbel noise (1, total_tokens) of a request's first code and the
    state its generator is left in: one draw from a fresh generator with
    the request's seed, as a batch-1 loop draws its first token's, or the
    first row of the request's noise (the state then None: its lanes read
    their rows from the table)."""
    if req.noise is not None:
        return req.noise[:1].to(device), None
    gen = torch.Generator(device=device).manual_seed(req.seed)
    row = gumbel_noise((1, total_tokens), gen, dtype, device)
    return row, gen.get_state()


@torch.no_grad()
def prefill_handoff(model: DALLE, req: Request, filter_thres: float,
                    degraded_filter_thres: float = 0.98) -> Dict[str, Any]:
    """The first half of an admission, which needs only the model and the
    request: the prompt's prefill (the flash forward kernels on the card)
    into a dense cache of its lanes ([cond] or [cond, null]) and the first
    code, sampled as the engine's lanes sample (guidance, top-k capped
    at the degrade ladder's rung 2, temperature, the request's first
    noise).  Returns the handoff: the cache's layers, the code (a 0-d
    tensor), the lanes and the generator state the lanes continue from."""
    cfg = model.cfg
    n_lanes = req.lanes_needed
    dev = model.device
    tcfg = dataclasses.replace(cfg.transformer_config(), seq_len=cfg.text_seq_len + 1)
    cache = init_cache(tcfg, n_lanes, dtype=model.dtype, device=dev)
    text = torch.as_tensor(req.text[None], device=dev)
    cache, logits = sampling_mod._prefill_phase(model, text, None, 0, req.cond_scale, cache)
    noise, state = first_noise(req, cfg.total_tokens, dev, logits.dtype)
    cap = torch.full((n_lanes,), req.degrade_rung >= 2, dtype=torch.bool, device=dev)
    code, _ = sample_lanes(model, logits, request_settings(n_lanes, req.temperature, req.cond_scale, dev),
                           filter_thres, noise.expand(n_lanes, -1), cand_cap=cap,
                           degraded_filter_thres=degraded_filter_thres)
    return {"layers": cache["layers"], "code": code[0], "lanes": n_lanes, "rng_state": state}
