"""Poisson load generator for the serving engine (counterpart of the JAX
package's `tools/loadgen.py`).

K independent request streams, each with exponential gaps at `rate`
requests a second, merged into one arrival schedule (the JAX tool's, draw
for draw, for the same seed).  `run` walks the wall clock: due requests are
submitted (refusals counted: shedding load is a measured outcome), the
engine is polled, and each completed request's TTFT and latency go into the
report, whose percentiles are exact (numpy over the records).  Its keys are
the JAX report's: journey percentiles (`ttft_*`, `latency_*`: a logical
request's hops, requeues and hedged copies, grouped by content uid) and
per-hop ones (`hop_*`), equal on one engine without requeues.  A fleet
(`serving/fleet.py`) is driven as an engine is.

As a command, against a synthetic model on the card (`--device cpu` for the
CPU):

    python -m dalle_pytorch_tpu_torch.tools.loadgen --requests 8 --rate 2 --streams 2
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from dalle_pytorch_tpu_torch.serving.scheduler import AdmissionRefused


def _journey_key(r) -> Any:
    """What groups a logical request's hops: its content uid (the same for
    a requeue, a hedged copy and a replay), else the object itself."""
    return getattr(r, "journal_uid", None) or getattr(r, "trace_uid", None) or getattr(r, "hedge_uid", None) or id(r)


class PoissonLoadGen:
    def __init__(self, n_requests: int, rate: float, streams: int = 2, seed: int = 0):
        if n_requests <= 0 or rate <= 0 or streams <= 0:
            raise ValueError(f"n_requests, rate and streams must be positive, got {n_requests}, {rate}, {streams}")
        rng = np.random.RandomState(seed)
        per_stream = -(-n_requests // streams)
        arrivals = []
        for s in range(streams):
            t = np.cumsum(rng.exponential(1.0 / rate, size=per_stream))
            arrivals.extend((float(ti), s) for ti in t)
        arrivals.sort()
        self.arrivals = arrivals[:n_requests]
        self.streams = streams

    def run(self, engine, make_request: Callable[[int], Dict[str, Any]],
            max_wall_s: Optional[float] = None) -> Dict[str, Any]:
        """Drive `engine` (or a fleet) through the schedule; `make_request(i)`
        gives the i-th arrival's submit() keywords.  A flood drill's
        synthetic requests are kept out of the report's numbers.  Returns
        the report."""
        completed: List[Any] = []
        submitted: List[Any] = []
        synthetic_done = 0
        refused = 0
        idx = 0
        t0 = time.monotonic()
        while idx < len(self.arrivals) or engine.busy:
            now = time.monotonic() - t0
            if max_wall_s is not None and now > max_wall_s:
                break
            while idx < len(self.arrivals) and self.arrivals[idx][0] <= now:
                try:
                    submitted.append(engine.submit(**make_request(idx)))
                except AdmissionRefused:
                    refused += 1
                idx += 1
            if engine.busy:
                for r in engine.poll():
                    if getattr(r, "synthetic", False):
                        synthetic_done += 1
                    else:
                        completed.append(r)
            elif idx < len(self.arrivals):
                time.sleep(min(max(self.arrivals[idx][0] - now, 0.0), 0.02))
        elapsed = time.monotonic() - t0
        report = self.report(completed, refused, elapsed, submitted=submitted)
        report["synthetic_completed"] = synthetic_done
        return report

    def report(self, completed: List[Any], refused: int, elapsed_s: float,
               submitted: Optional[List[Any]] = None) -> Dict[str, Any]:
        """TTFT, queue wait and latency percentiles, completions, refusals
        and images/s.  The TTFT and latency percentiles are a journey's:
        its hops (the submitted requests and the completions, which alone
        carry a requeue's or a hedge's hop) grouped by content uid, from
        the first hop's arrival to the first token anywhere and to the
        first completion; the `hop_*` ones are each completion's own."""
        ttfts = np.asarray([r.ttft_s for r in completed if r.ttft_s is not None])
        lats = np.asarray([r.latency_s for r in completed if r.latency_s is not None])
        qwaits = np.asarray([r.phases["queue_wait"] for r in completed
                             if getattr(r, "phases", None) and "queue_wait" in r.phases])
        accepts = np.asarray([r.accepted_tokens_per_step for r in completed
                              if getattr(r, "accepted_tokens_per_step", None) is not None])

        def pct(a, q):
            return float(np.percentile(a, q)) if a.size else None

        hops: Dict[Any, Dict[str, Any]] = {}
        for r in list(submitted or []) + list(completed):
            if getattr(r, "synthetic", False):
                continue
            arr = getattr(r, "arrival_t", None) or 0.0
            j = hops.setdefault(_journey_key(r), {"arrival": arr, "first": [], "final": []})
            j["arrival"] = min(j["arrival"], arr)
            if getattr(r, "ttft_s", None) is not None:
                j["first"].append(arr + r.ttft_s)
            if getattr(r, "latency_s", None) is not None:
                j["final"].append(arr + r.latency_s)
        done = [j for j in hops.values() if j["final"]]
        j_ttfts = np.asarray([min(j["first"]) - j["arrival"] for j in done if j["first"]])
        j_lats = np.asarray([min(j["final"]) - j["arrival"] for j in done])
        n = len(completed)
        spec = {}
        if accepts.size:
            spec = {"accepted_tokens_per_step_p50": pct(accepts, 50),
                    "accepted_tokens_per_step_mean": float(accepts.mean()),
                    "accepted_tokens_per_step_min": float(accepts.min())}
        return {
            "requests_completed": n,
            "requests_refused": refused,
            "journeys_completed": len(done),
            "streams": self.streams,
            "elapsed_s": round(elapsed_s, 4),
            "ttft_p50_s": pct(j_ttfts, 50),
            "ttft_p99_s": pct(j_ttfts, 99),
            "queue_wait_p50_s": pct(qwaits, 50),
            "queue_wait_p99_s": pct(qwaits, 99),
            "latency_p50_s": pct(j_lats, 50),
            "latency_p99_s": pct(j_lats, 99),
            "hop_ttft_p50_s": pct(ttfts, 50),
            "hop_ttft_p99_s": pct(ttfts, 99),
            "hop_latency_p50_s": pct(lats, 50),
            "hop_latency_p99_s": pct(lats, 99),
            # a replica runs on one card, and the fleet's replicas share it
            "images_per_sec_per_chip": (n / elapsed_s if elapsed_s > 0 else None),
            **spec,
        }


def synthetic_request_maker(cfg, seed: int = 0, temperature: float = 1.0, cond_scale: float = 1.0,
                            zipf_s: Optional[float] = None, prompt_pool: int = 16, deadline_s: Optional[float] = None,
                            retries: Optional[int] = None):
    """submit() keywords for random prompts: fresh ones, or with `zipf_s`
    Zipf(zipf_s)-distributed draws from a fixed pool of `prompt_pool`
    prompts (the JAX tool's prompts for the same seed).  The i-th request's
    seed is seed * 100003 + i; `deadline_s` and `retries` attach the
    router's deadline and requeue budget to every request."""
    rng = np.random.RandomState(seed)
    pool = weights = None
    if zipf_s is not None:
        if zipf_s <= 0 or prompt_pool <= 0:
            raise ValueError(f"zipf_s and prompt_pool must be positive, got {zipf_s}, {prompt_pool}")
        pool = rng.randint(1, cfg.num_text_tokens, size=(prompt_pool, cfg.text_seq_len))
        ranks = np.arange(1, prompt_pool + 1, dtype=np.float64)
        weights = ranks ** -zipf_s
        weights /= weights.sum()

    def make(i: int) -> Dict[str, Any]:
        if pool is None:
            text = rng.randint(1, cfg.num_text_tokens, size=(cfg.text_seq_len,))
        else:
            text = pool[rng.choice(len(pool), p=weights)]
        kw = {"text": text, "seed": seed * 100003 + i, "temperature": temperature, "cond_scale": cond_scale}
        if deadline_s is not None:
            kw["deadline_s"] = deadline_s
        if retries is not None:
            kw["retries_left"] = retries
        return kw

    return make


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Poisson load against a synthetic serving engine")
    parser.add_argument("--requests", type=int, default=8)
    parser.add_argument("--rate", type=float, default=2.0, help="requests a second per stream")
    parser.add_argument("--streams", type=int, default=2)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--zipf", type=float, default=None, metavar="S",
                        help="draw prompts Zipf(S)-distributed from a fixed pool")
    parser.add_argument("--prompt_pool", type=int, default=16, help="distinct prompts in the --zipf pool")
    parser.add_argument("--slots", type=int, default=4)
    parser.add_argument("--block_size", type=int, default=16)
    parser.add_argument("--dim", type=int, default=64)
    parser.add_argument("--depth", type=int, default=2)
    parser.add_argument("--image_fmap_size", type=int, default=8)
    parser.add_argument("--json", action="store_true")
    parser.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    import torch

    from dalle_pytorch_tpu_torch.core.device import resolve_device
    from dalle_pytorch_tpu_torch.models import dalle as dalle_mod
    from dalle_pytorch_tpu_torch.serving.engine import EngineConfig, GenerationEngine

    device = resolve_device(args.device)
    # dim_head 32 at the default width: the card's kernels take head dims 32, 64 and 128
    cfg = dalle_mod.DALLEConfig(dim=args.dim, depth=args.depth, num_text_tokens=256, text_seq_len=16,
                                heads=max(args.dim // 32, 1), dim_head=32, num_image_tokens=256,
                                image_fmap_size=args.image_fmap_size)
    model = dalle_mod.init_dalle(cfg, torch.Generator(device=device).manual_seed(0), device)
    engine = GenerationEngine(model, engine_cfg=EngineConfig(num_slots=args.slots, block_size=args.block_size))
    gen = PoissonLoadGen(args.requests, args.rate, streams=args.streams, seed=args.seed)
    report = gen.run(engine, synthetic_request_maker(cfg, seed=args.seed, zipf_s=args.zipf,
                                                     prompt_pool=args.prompt_pool))
    if args.json:
        print(json.dumps(report))
    else:
        for k, v in report.items():
            print(f"{k:>26}: {v}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
