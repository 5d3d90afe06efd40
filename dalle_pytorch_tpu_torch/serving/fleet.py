"""The serving fleet (counterpart of `dalle_pytorch_tpu/serving/fleet.py`):
N engine replicas behind the router, with disaggregated prefill and
service through the loss of a replica.

- **Replicas.**  `ServingFleet` builds N `GenerationEngine`s over one model:
  on one card they share the `DALLE` module and its weights, and each has
  its own pool, lanes and CUDA graph.  The router (`serving/router.py`)
  places each request by live load.  The fleet has the engine's surface
  (submit, poll, busy, run_until_idle, generate, drain through
  `kill_replica`), so the loadgen and `cli/serve.py` drive either.
- **Disaggregation.**  `PrefillWorker` runs the first half of admission,
  `engine.prefill_handoff` (the prompt's prefill on the flash forward
  kernels, and the first code), and hands the dense prefix, the first code
  and the request's generator state to the decode replica, whose ingest
  scatters them into its pool: the same two functions a fused admission
  runs, so the same codes.  The handoff is priced as a comms row
  (`observability/comms.prefill_handoff_row`) and counted
  (`serving/handoff_bytes`).
- **Loss.**  `kill_replica(i)` (or an armed `kill-replica@N:IDX`) drains
  replica i, requeues its requests on the others (each request's codes are
  a function of its payload, so the survivors make the same ones), and
  frees its pool and graph.  `kill-fleet@N` kills the process (the journal
  replays it); `stall-replica@N:IDX` wedges a replica, alive.

A worker on another device mesh, and moving the survivors' weights after
a loss (`reshard_on_kill`), need the port's `parallel/reshard`, which
comes with ROADMAP.md Queue 1 item 7; they raise naming it.
"""
from __future__ import annotations

import dataclasses
import os
import signal
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from dalle_pytorch_tpu_torch.observability import comms as comms_mod
from dalle_pytorch_tpu_torch.observability import metrics as obs_metrics
from dalle_pytorch_tpu_torch.serving.engine import EngineConfig, GenerationEngine, prefill_handoff
from dalle_pytorch_tpu_torch.serving.router import Router
from dalle_pytorch_tpu_torch.serving.scheduler import Request
from dalle_pytorch_tpu_torch.training import resilience

_ITEM7 = "parallel/reshard, which comes with ROADMAP.md Queue 1 item 7"


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """The fleet's settings over one `EngineConfig` for every replica.
    `stall_wedge_s`: how long the stall drill wedges its replica; the rest
    are the router's breaker, hedge and requeue budgets.  The loss drill is
    armed as a fault, `kill-replica@N:IDX` (`training/resilience.py`)."""

    replicas: int = 2
    disaggregate: bool = False
    engine: EngineConfig = EngineConfig()
    reshard_on_kill: bool = False
    stall_wedge_s: float = 3.0
    stall_after_s: float = 1.0
    probe_after_s: float = 1.0
    hedge_frac: float = 0.5
    requeue_budget_s: float = 30.0

    def __post_init__(self):
        if self.replicas < 1:
            raise ValueError(f"replicas must be at least 1, got {self.replicas}")
        if self.reshard_on_kill:
            raise NotImplementedError(f"reshard_on_kill needs {_ITEM7}")


class PrefillWorker:
    """The first half of admission as a worker of its own: `prefill(req)`
    runs `prefill_handoff` on `model` (the one the replicas serve, on the
    same card) and returns the handoff a decode replica ingests; an int8
    pool's handoff is quantized here (per-token scales make quantizing
    before or after the move equal).  One worker serves every replica."""

    def __init__(self, model, filter_thres: float = 0.9, degraded_filter_thres: float = 0.98,
                 quantize_kv: Optional[str] = None, mesh=None):
        if mesh is not None:
            raise NotImplementedError(f"a prefill worker on another mesh needs {_ITEM7}")
        self.model = model
        self.cfg = model.cfg
        self.tcfg = model.cfg.transformer_config()
        self.filter_thres = filter_thres
        self.degraded_filter_thres = degraded_filter_thres
        self.quantize_kv = None if quantize_kv == "none" else quantize_kv
        self.n_pre = self.cfg.text_seq_len + 1
        self.itemsize = torch.empty((), dtype=model.dtype).element_size()
        self.last_handoff: Optional[Dict[str, Any]] = None

    def handoff_row(self, lanes: int = 1) -> Dict[str, Any]:
        """The comms row of one admission's handoff: the KV prefix and,
        with token shift, both rings' tails (lanes, fmap, 2, dim // 4) a
        layer."""
        t = self.tcfg
        ring = (2.0 * t.depth * lanes * t.image_fmap_size * 2 * (t.dim // 4) * self.itemsize
                if t.shift_tokens else 0.0)
        return comms_mod.prefill_handoff_row(t, self.n_pre, lanes, self.itemsize, ring_bytes=ring,
                                             kv_quant=self.quantize_kv)

    def prefill(self, req: Request) -> Dict[str, Any]:
        handoff = prefill_handoff(self.model, req, self.filter_thres, self.degraded_filter_thres)
        if self.quantize_kv:
            from dalle_pytorch_tpu_torch.quantization import quantize_cache_layers

            handoff["layers"] = quantize_cache_layers(handoff["layers"])
        row = self.handoff_row(handoff["lanes"])
        handoff["comms_row"] = row
        obs_metrics.counter("serving/handoff_requests").inc()
        obs_metrics.counter("serving/handoff_bytes").inc(row["bytes_per_step"])
        self.last_handoff = handoff
        return handoff


class ServingFleet:
    """N replicas behind the router, with the engine's surface."""

    def __init__(self, model, vae=None, fleet_cfg: FleetConfig = FleetConfig(), usage_fn=None, on_alarm=None,
                 graphs: Optional[bool] = None):
        self.cfg = model.cfg
        self.fcfg = fleet_cfg
        ecfg = fleet_cfg.engine
        self.engines: List[GenerationEngine] = [
            GenerationEngine(model, vae, engine_cfg=ecfg, usage_fn=usage_fn, graphs=graphs)
            for _ in range(fleet_cfg.replicas)]
        self.router = Router(self.engines, on_alarm=on_alarm, stall_after_s=fleet_cfg.stall_after_s,
                             probe_after_s=fleet_cfg.probe_after_s, hedge_frac=fleet_cfg.hedge_frac,
                             requeue_budget_s=fleet_cfg.requeue_budget_s)
        self.prefill_worker: Optional[PrefillWorker] = None
        if fleet_cfg.disaggregate:
            self.prefill_worker = PrefillWorker(model, ecfg.filter_thres, ecfg.degraded_filter_thres,
                                                ecfg.quantize_kv)
            for eng in self.engines:
                eng.prefill_backend = self.prefill_worker
        self._iter = 0
        self.journal = None
        self._degrade = None

    # ----------------------------------------------------------- durability
    def attach_journal(self, journal) -> None:
        """One journal for the fleet: every replica journals and acks into
        it, and the router acks its requeue_exhausted requests there."""
        self.journal = journal
        self.router.journal = journal
        for eng in self.engines:
            eng.attach_journal(journal)

    def attach_degrade(self, ladder) -> None:
        """One ladder: every replica shapes its submits by it, and the
        fleet alone observes the pressure (the largest queue fraction of
        the live replicas)."""
        self._degrade = ladder
        for eng in self.engines:
            eng.attach_degrade(ladder, observe=False)

    def attach_slo(self, monitor, status_path: Optional[str] = None) -> None:
        """The SLO monitor and the status file ride the first live
        replica's windows (the monitor reads the process's registry)."""
        self.router.alive()[0].engine.attach_slo(monitor, status_path=status_path)

    # ------------------------------------------------------ engine surface
    def submit(self, text, seed: Optional[int] = None, temperature: float = 1.0, cond_scale: float = 1.0,
               noise=None, deadline_s=None, retries_left=None, synthetic: bool = False,
               replayed: bool = False) -> Request:
        return self.router.submit(text, seed=seed, temperature=temperature, cond_scale=cond_scale, noise=noise,
                                  deadline_s=deadline_s, retries_left=retries_left, synthetic=synthetic,
                                  replayed=replayed)

    def submit_when_able(self, text, seed: Optional[int] = None, temperature: float = 1.0, cond_scale: float = 1.0,
                         noise=None, deadline_s=None, retries_left=None, synthetic: bool = False,
                         replayed: bool = False) -> Request:
        return self.router.submit_when_able(text, seed=seed, temperature=temperature, cond_scale=cond_scale,
                                            noise=noise, deadline_s=deadline_s, retries_left=retries_left,
                                            synthetic=synthetic, replayed=replayed)

    @property
    def busy(self) -> bool:
        return self.router.busy

    @property
    def engine(self) -> GenerationEngine:
        """The first live replica (what a report reads one engine's state
        from)."""
        return self.router.alive()[0].engine

    def poll(self) -> List[Request]:
        """One fleet iteration: the armed drills (kill-fleet, stall-replica,
        kill-replica), the degrade ladder's sample, a poll of every live
        replica, the router's gauges."""
        self._iter += 1
        if resilience.take_kill_fleet_fault(self._iter):
            # the crash drill: no drain, no records, no acks; only the journal survives
            print(f"[chaos] kill-fleet: SIGKILL of the whole process at fleet iteration {self._iter}", flush=True)
            os.kill(os.getpid(), signal.SIGKILL)
        sidx = resilience.take_stall_replica_fault(self._iter)
        if sidx is not None and sidx < len(self.engines):
            print(f"[chaos] stall-replica: wedging replica {sidx} for {self.fcfg.stall_wedge_s}s at fleet "
                  f"iteration {self._iter}", flush=True)
            self.engines[sidx].wedge(self.fcfg.stall_wedge_s)
        idx = resilience.take_kill_replica_fault(self._iter)
        if idx is not None:
            self.kill_replica(idx)
        if self._degrade is not None:
            frac = max((len(r.engine.queue) / max(r.engine.queue.max_depth, 1) for r in self.router.alive()),
                       default=0.0)
            self._degrade.observe(frac, slo=self.engine._slo)
        done = self.router.poll()
        self.router.publish_gauges()
        return done

    def run_until_idle(self, max_iters: Optional[int] = None) -> List[Request]:
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
        """Submit every row of `texts` (seed `seeds[i]`, default i, or noise
        `noises[i]`), polling the whole fleet between submits, and run to
        completion.  Returns the requests in submission order (a requeued
        request's completion is its new hop's)."""
        texts = np.asarray(texts)
        reqs = []
        for i in range(texts.shape[0]):
            reqs.append(self.submit_when_able(texts[i], seed=seeds[i] if seeds is not None else i,
                                              temperature=temperature, cond_scale=cond_scale,
                                              noise=None if noises is None else noises[i]))
            self.poll()  # a blocking submit polls only its replica
        self.run_until_idle()
        return reqs

    def close(self) -> None:
        for r in self.router.alive():
            r.engine.close()

    # ---------------------------------------------------------- preemption
    def kill_replica(self, idx: int, reason: str = "killed") -> List[Request]:
        """Lose replica `idx`: drain it and requeue its work through the
        router, move the SLO monitor off it, and free its pool and graphs.
        The last live replica is never killed."""
        if len(self.router.alive()) <= 1:
            print(f"[fleet] refusing to kill replica {idx}: it is the last one alive", flush=True)
            return []
        print(f"[chaos] kill-replica: draining replica {idx} at fleet iteration {self._iter}", flush=True)
        requeued = self.router.mark_lost(idx, reason=reason)
        dead = self.engines[idx]
        if dead._slo is not None or dead._status_path:
            self.engine.attach_slo(dead._slo, dead._status_path)
            dead.attach_slo(None)
        dead.release()
        return requeued

    # ------------------------------------------------------- observability
    @property
    def pool(self):
        """The first live replica's pool (each replica has its own)."""
        return self.engine.pool

    def prefix_redundancy(self) -> Dict[str, Any]:
        """The replicas' prefix accounting summed (each hashes its own
        prompts, so a repeat across replicas is not counted)."""
        parts = [e.prefix_redundancy() for e in self.engines]
        out: Dict[str, Any] = {k: sum(p[k] for p in parts) for k in (
            "admissions", "unique_prefixes", "repeat_hits", "null_lane_bytes", "repeat_prefill_bytes",
            "duplicate_bytes", "prefill_bytes")}
        out["repeat_hit_frac"] = out["repeat_hits"] / out["admissions"] if out["admissions"] else 0.0
        out["duplicate_frac"] = out["duplicate_bytes"] / out["prefill_bytes"] if out["prefill_bytes"] else 0.0
        return out

    def pool_observability(self) -> Dict[str, Any]:
        """Each replica's pool section, the sums that add across pools, and
        the largest high-water fraction."""
        per = [e.pool_observability() for e in self.engines]
        return {"replicas": per,
                "reserved_unused_blocks": sum(p.get("reserved_unused_blocks") or 0 for p in per),
                "recorder_dropped": sum(p.get("recorder_dropped") or 0 for p in per),
                "high_water_frac_max": max(p["high_water"] / p["num_blocks"] if p["num_blocks"] else 0.0
                                           for p in per)}
