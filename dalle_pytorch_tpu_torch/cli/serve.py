"""The generation service (counterpart of `dalle_pytorch_tpu/cli/serve.py`):
a continuous-batching engine (`serving/engine.py`) fed by one of two
traffic sources.

    python -m dalle_pytorch_tpu_torch.cli.serve --dalle_path dalle.pt --prompts prompts.txt
    python -m dalle_pytorch_tpu_torch.cli.serve --synthetic --loadgen 8 --rate 2 --streams 2

* `--prompts FILE` (`-` for stdin): one prompt a line, each submitted
  through the engine (a full queue waits); images land under
  `--outputs_dir/<prompt>/N.png`, as the generate CLI writes them.
* `--loadgen N`: N random requests in `--streams` Poisson streams of
  `--rate` requests a second each (`tools/loadgen.py`).

The run ends with a report (TTFT and latency p50/p99, images/s, refusals,
the pool's state) printed and, with `--report_json`, written as JSON.  The
model is a v3 checkpoint (`--dalle_path`) or a seeded random one
(`--synthetic` with the model flags; it has no VAE, so it writes no
images).  It runs on the card unless `--device cpu` is given.  Request i's
generator seed is `--seed` + i.

`--quantize_weights int8|fp8` quantizes the loaded model's matmul weights
and embedding tables (`quantization.quantize_tree`; a checkpoint already
quantized is served as it is), `--quantize_kv int8` stores the KV pool as
int8 with per-token scales, `--spec_k K` decodes by self-speculative rounds
of K drafted codes through the first `--spec_draft_layers` layers (default
half the depth), and `--inject_fault poison-request@N` / `flood@N:COUNT`
run the engine's two drills.  The report carries `quantization` (the
storage dtypes, weight and pool bytes, the dequant work of a step), the
speculative accounting under `--spec_k`, and the quarantine's counts.

The fleet (`serving/fleet.py`): `--replicas N` serves through N engines
behind the router (one card: they share the model's weights), and
`--disaggregate` runs each admission's prefill in a prefill worker that
hands the prefix over.  `--inject_fault kill-replica@N[:IDX]` loses a
replica mid-run (its requests requeue on the others),
`stall-replica@N[:IDX]` wedges one (the router's breaker opens, and
requests past `--hedge_frac` of `--deadline_s` are hedged),
`kill-fleet@N` kills the process.  `--journal DIR` journals every accepted
request (`serving/journal.py`) and replays, at start, those a crash left
unacknowledged; with no other traffic the journal is the traffic.
`--degrade` arms the degrade ladder, `--slo_*` the SLO monitor
(`observability/slo.py`), `--status_json PATH` its status file; the pool's
flight recorder is on unless `--no_pool_recorder`.  The report reads the
process's metrics registry, counted from the run's start, under the JAX
report's keys.  At start it prints the paged pool's HBM ledger
(`engine.memory_ledger()`).  The serving telemetry flags exit naming
ROADMAP.md Queue 1 item 8.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from dalle_pytorch_tpu_torch import quantization as quant_mod
from dalle_pytorch_tpu_torch import weights
from dalle_pytorch_tpu_torch.cli.generate import get_tokenizer
from dalle_pytorch_tpu_torch.cli.png import write_png
from dalle_pytorch_tpu_torch.core.device import resolve_device
from dalle_pytorch_tpu_torch.models import dalle as dalle_mod
from dalle_pytorch_tpu_torch.models import vae_registry
from dalle_pytorch_tpu_torch.observability import memory as memory_mod
from dalle_pytorch_tpu_torch.observability import metrics as obs_metrics
from dalle_pytorch_tpu_torch.observability.slo import SloMonitor, SloTargets
from dalle_pytorch_tpu_torch.serving.engine import EngineConfig, GenerationEngine
from dalle_pytorch_tpu_torch.tools.loadgen import PoissonLoadGen, synthetic_request_maker
from dalle_pytorch_tpu_torch.training import resilience

_ITEM8 = "ROADMAP.md Queue 1 item 8"
# flag -> what it needs that the port does not have yet, and where ROADMAP.md lists it
_WAITING = {
    "telemetry": f"serving telemetry ({_ITEM8})",
    "telemetry_every": f"serving telemetry ({_ITEM8})",
    "telemetry_heartbeat_s": f"serving telemetry ({_ITEM8})",
    "profile_on_alarm": f"serving telemetry ({_ITEM8})",
}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="DALL-E generation service")
    src = parser.add_argument_group("model")
    src.add_argument("--dalle_path", type=str, default=None,
                     help="a v3 checkpoint (any VAE family), a torch-reference dalle.pt, or with "
                          "--allow_legacy_pickle a pre-v3 file")
    src.add_argument("--allow_legacy_pickle", action="store_true",
                     help="permit loading pre-v3 (pickled-treedef) checkpoints: trusted sources only")
    src.add_argument("--vqgan_config_path", type=str, default=None,
                     help="taming config yaml for a reference VQGanVAE checkpoint")
    src.add_argument("--synthetic", action="store_true", help="serve a seeded random model (no checkpoint)")
    src.add_argument("--dim", type=int, default=64)
    src.add_argument("--depth", type=int, default=2)
    src.add_argument("--heads", type=int, default=2)
    src.add_argument("--dim_head", type=int, default=32, help="the card's kernels take 32, 64 and 128")
    src.add_argument("--text_seq_len", type=int, default=16)
    src.add_argument("--num_text_tokens", type=int, default=256)
    src.add_argument("--num_image_tokens", type=int, default=256)
    src.add_argument("--image_fmap_size", type=int, default=8)

    eng = parser.add_argument_group("engine")
    eng.add_argument("--slots", type=int, default=4, help="decode lanes (a guided request uses 2)")
    eng.add_argument("--block_size", type=int, default=64, help="KV pool block size in tokens")
    eng.add_argument("--num_blocks", type=int, default=None, help="KV pool size (default: slots x blocks a sequence)")
    eng.add_argument("--max_queue", type=int, default=64)
    eng.add_argument("--headroom_frac", type=float, default=0.92,
                     help="defer admissions above this device-memory usage fraction")
    eng.add_argument("--quantize_weights", choices=["none", "int8", "fp8"], default="none",
                     help="quantize the loaded model's weights (quantization.quantize_tree)")
    eng.add_argument("--quantize_kv", choices=["none", "int8"], default="none",
                     help="store the KV pool as int8 with per-token scales")
    eng.add_argument("--spec_k", type=int, default=0,
                     help="self-speculative decoding: codes drafted a round (0: the sequential step)")
    eng.add_argument("--spec_draft_layers", type=int, default=None,
                     help="layers of the draft prefix (default depth // 2), in [1, depth)")
    eng.add_argument("--inject_fault", type=str, default=None,
                     help="poison-request@N, flood@N[:COUNT], kill-replica@N[:IDX], stall-replica@N[:IDX] or "
                          "kill-fleet@N: a drill at iteration N")
    eng.add_argument("--replicas", type=int, default=1, help="engine replicas behind the router (one card)")
    eng.add_argument("--disaggregate", action="store_true",
                     help="run prefill in a prefill worker that hands the prefix to the decode replicas")
    eng.add_argument("--no_pool_recorder", action="store_true", help="turn the pool's flight recorder off")
    eng.add_argument("--pool_recorder_capacity", type=int, default=4096,
                     help="the recorder's ring, in events (overflow drops the oldest, counted)")

    slo = parser.add_argument_group("slo")
    slo.add_argument("--slo_ttft_p99", type=float, default=None, help="p99 time-to-first-token target, seconds")
    slo.add_argument("--slo_latency_p99", type=float, default=None, help="p99 request latency target, seconds")
    slo.add_argument("--slo_images_per_sec", type=float, default=None, help="completed images a second, floor")
    slo.add_argument("--slo_shed_rate", type=float, default=None, help="refused over arrivals, ceiling (0..1)")
    slo.add_argument("--status_json", type=str, default=None,
                     help="a status file rewritten atomically at every window's close")

    dur = parser.add_argument_group("durability")
    dur.add_argument("--journal", type=str, default=None,
                     help="request journal directory: accepted requests survive a crash and are replayed at start")
    dur.add_argument("--deadline_s", type=float, default=None,
                     help="a deadline on loadgen requests; past --hedge_frac of it on a stalled replica, hedged")
    dur.add_argument("--retries", type=int, default=3, help="requeue budget of a request")
    dur.add_argument("--degrade", action="store_true",
                     help="arm the degrade ladder (no CFG, capped candidates, short prompts, shed)")
    dur.add_argument("--degrade_enter_s", type=float, default=0.5, help="sustained pressure before a rung up")
    dur.add_argument("--degrade_exit_s", type=float, default=2.0, help="sustained calm before a rung down")
    dur.add_argument("--stall_wedge_s", type=float, default=3.0, help="how long stall-replica wedges its replica")
    dur.add_argument("--stall_after_s", type=float, default=1.0,
                     help="breaker: a busy replica without progress this long opens")
    dur.add_argument("--hedge_frac", type=float, default=0.5,
                     help="hedge a request off a stalled replica past this share of its deadline")
    dur.add_argument("--requeue_budget_s", type=float, default=30.0,
                     help="give up requeueing a lost replica's request after this long (requeue_exhausted)")

    traffic = parser.add_argument_group("traffic")
    traffic.add_argument("--prompts", type=str, default=None, help="a file of prompts, one a line; - for stdin")
    traffic.add_argument("--loadgen", type=int, default=0, help="N synthetic requests under Poisson arrivals")
    traffic.add_argument("--rate", type=float, default=2.0, help="requests a second per stream")
    traffic.add_argument("--streams", type=int, default=2)
    traffic.add_argument("--zipf", type=float, default=None, metavar="S",
                         help="loadgen prompts Zipf(S)-distributed from a fixed pool")
    traffic.add_argument("--prompt_pool", type=int, default=16)
    traffic.add_argument("--top_k", type=float, default=0.9, help="filter threshold (0.5-1.0)")
    traffic.add_argument("--temperature", type=float, default=1.0)
    traffic.add_argument("--cond_scale", type=float, default=1.0)
    traffic.add_argument("--seed", type=int, default=0)

    parser.add_argument("--outputs_dir", type=str, default="./outputs")
    parser.add_argument("--no_vae", action="store_true", help="return codes only")
    parser.add_argument("--report_json", type=str, default=None)
    parser.add_argument("--bpe_path", type=str, default=None)
    parser.add_argument("--chinese", action="store_true")
    parser.add_argument("--hug", action="store_true")
    parser.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")

    waiting = parser.add_argument_group("not ported yet (each exits with the ROADMAP.md item that brings it)")
    for flag in _WAITING:
        waiting.add_argument(f"--{flag}", type=str, default=None)
    return parser


def _refuse_waiting_flags(args) -> None:
    for flag, machinery in _WAITING.items():
        if getattr(args, flag) not in (None, False, "none"):
            raise SystemExit(f"--{flag}: {machinery} is not ported yet")


def _build_model(args, device):
    """(model, vae or None)."""
    if args.dalle_path:
        return weights.load_dalle_checkpoint(args.dalle_path, device, allow_legacy_pickle=args.allow_legacy_pickle,
                                             vqgan_config_path=args.vqgan_config_path)
    if not args.synthetic:
        raise SystemExit("provide --dalle_path or --synthetic")
    cfg = dalle_mod.DALLEConfig(dim=args.dim, depth=args.depth, heads=args.heads, dim_head=args.dim_head,
                                num_text_tokens=args.num_text_tokens, text_seq_len=args.text_seq_len,
                                num_image_tokens=args.num_image_tokens, image_fmap_size=args.image_fmap_size)
    return dalle_mod.init_dalle(cfg, torch.Generator(device=device).manual_seed(args.seed), device), None


def main(argv=None) -> dict:
    """Run the service on `argv`; returns the report."""
    args = build_parser().parse_args(argv)
    _refuse_waiting_flags(args)
    if not (args.loadgen or args.prompts or args.journal):
        raise SystemExit("provide --loadgen N or --prompts FILE (or --journal DIR to replay it)")
    injector = None
    if args.inject_fault:
        injector = resilience.FaultInjector(resilience.parse_fault(args.inject_fault)).install()
    start = {k: v["total"] for k, v in obs_metrics.REGISTRY.snapshot(reset_window=False).items()
             if v["kind"] == "counter"}

    def counted(name):
        """The run's count: the counter less its value at the start."""
        return obs_metrics.counter(name).value - start.get(name, 0.0)

    device = resolve_device(args.device)
    model, vae = _build_model(args, device)
    if args.no_vae:
        vae = None
    if args.quantize_weights != "none":
        if quant_mod.tree_is_quantized(model):
            print(f"[serving] checkpoint weights already quantized ({quant_mod.weight_quant_kind(model)})")
        else:
            plain_bytes = quant_mod.tree_weight_bytes(model, itemsize=2)
            quant_mod.quantize_tree(model, args.quantize_weights)
            reduction = plain_bytes / quant_mod.tree_weight_bytes(model, itemsize=2)
            print(f"[serving] weights quantized to {args.quantize_weights}: {reduction:.2f}x at-rest reduction vs "
                  "bf16 storage")
    engine_cfg = EngineConfig(
        num_slots=args.slots, block_size=args.block_size, num_blocks=args.num_blocks, max_queue=args.max_queue,
        headroom_frac=args.headroom_frac, filter_thres=args.top_k,
        quantize_kv=None if args.quantize_kv == "none" else args.quantize_kv, spec_k=args.spec_k,
        spec_draft_layers=args.spec_draft_layers, pool_recorder=not args.no_pool_recorder,
        pool_recorder_capacity=args.pool_recorder_capacity)
    if args.replicas > 1 or args.disaggregate:
        from dalle_pytorch_tpu_torch.serving.fleet import FleetConfig, ServingFleet

        engine = ServingFleet(model, vae, FleetConfig(
            replicas=args.replicas, disaggregate=args.disaggregate, engine=engine_cfg,
            stall_wedge_s=args.stall_wedge_s, stall_after_s=args.stall_after_s, hedge_frac=args.hedge_frac,
            requeue_budget_s=args.requeue_budget_s))
        one = engine.engine
    else:
        engine = one = GenerationEngine(model, vae, engine_cfg)
    journal = ladder = None
    if args.journal:
        from dalle_pytorch_tpu_torch.serving.journal import RequestJournal

        journal = RequestJournal(args.journal)
        engine.attach_journal(journal)
    if args.degrade:
        from dalle_pytorch_tpu_torch.serving.degrade import DegradeConfig, DegradeLadder

        ladder = DegradeLadder(DegradeConfig(enter_after_s=args.degrade_enter_s, exit_after_s=args.degrade_exit_s),
                               text_seq_len=model.cfg.text_seq_len)
        engine.attach_degrade(ladder)
    targets = SloTargets(ttft_p99_s=args.slo_ttft_p99, latency_p99_s=args.slo_latency_p99,
                         images_per_sec_floor=args.slo_images_per_sec, shed_rate_ceiling=args.slo_shed_rate)
    monitor = SloMonitor(targets) if targets.any() else None
    if monitor is not None or args.status_json:
        engine.attach_slo(monitor, status_path=args.status_json)
    print(f"[serving] paged pool: {one.pool.num_blocks} blocks of {args.block_size} tokens "
          f"(+1 trash), {one.pool.bytes() / 2 ** 30:.3f} GiB ({one.pool.quant or 'float'}); {args.slots} lanes"
          + (f" a replica, {args.replicas} replicas" if engine is not one else ""))
    print("[serving] paged-pool ledger" + (" (one replica's; the replicas share the weights)"
                                           if engine is not one else "") + ":")
    print(memory_mod.format_ledger(one.memory_ledger()), flush=True)
    replayed = []
    try:
        if journal is not None:
            replayed = _replay_journal(engine, journal, args.retries)
        if args.loadgen or args.prompts:
            report = _run_traffic(args, engine, model, vae, counted)
        else:  # a restart that only replays: the journal is the traffic
            report = {"requests_completed": sum(1 for r in replayed if r.codes is not None),
                      "pool_blocks": engine.pool.num_blocks}
    finally:
        engine.close()
        if journal is not None:
            journal.close()  # what was queued or in flight stays open for the next replay
        if injector is not None:
            injector.uninstall()
    if journal is not None:
        report["journal_replayed"] = len(replayed)
        report["journal_replay_completed"] = sum(1 for r in replayed if r.codes is not None)
        for k, v in journal.stats().items():
            report[f"journal_{k}"] = v
        report["journal_duplicate_acks"] = counted("journal/duplicate_acks")
    if ladder is not None:
        report["degrade_rung"] = ladder.rung
        report["degrade_max_rung"] = ladder.max_rung_seen
        report["degrade_rungs_entered"] = dict(ladder.rungs_entered)
    if monitor is not None:
        report["slo_alarms"] = monitor.alarms_total
    print("[serving] report:")
    for k, v in report.items():
        print(f"  {k:>26}: {v}")
    if args.report_json:
        Path(args.report_json).write_text(json.dumps(report))
    return report


def _replay_journal(engine, journal, retries: int) -> list:
    """Submit again every request the journal holds unacknowledged (a
    crashed run's), and serve them before new traffic: a request's codes
    are a function of its text, seed and settings, so the replay gives the
    codes the crashed run was making."""
    payloads = journal.replay()
    if not payloads:
        return []
    print(f"[journal] replaying {len(payloads)} unacknowledged request(s) from {journal.path}", flush=True)
    reqs = [engine.submit_when_able(p["text"], seed=p["seed"], temperature=p["temperature"],
                                    cond_scale=p["cond_scale"], deadline_s=p["deadline_s"],
                                    retries_left=p["retries_left"] if p["retries_left"] is not None else retries,
                                    synthetic=p["synthetic"], replayed=True) for p in payloads]
    engine.run_until_idle()
    print(f"[journal] replay complete: {sum(1 for r in reqs if r.codes is not None)}/{len(reqs)} finished",
          flush=True)
    return reqs


def _run_traffic(args, engine, model, vae, counted) -> dict:
    cfg = model.cfg
    if args.loadgen:
        gen = PoissonLoadGen(args.loadgen, args.rate, streams=args.streams, seed=args.seed)
        report = gen.run(engine, synthetic_request_maker(
            cfg, seed=args.seed, temperature=args.temperature, cond_scale=args.cond_scale,
            zipf_s=args.zipf, prompt_pool=args.prompt_pool, deadline_s=args.deadline_s, retries=args.retries))
    else:
        tokenizer = get_tokenizer(args)
        source = sys.stdin if args.prompts == "-" else open(args.prompts)
        with source:
            lines = [ln.strip() for ln in source.read().splitlines() if ln.strip()]
        t0 = time.monotonic()
        reqs = []
        for i, prompt in enumerate(lines):
            toks = tokenizer.tokenize(prompt, cfg.text_seq_len, truncate_text=True)
            reqs.append(engine.submit_when_able(np.asarray(toks)[0], seed=args.seed + i,
                                                temperature=args.temperature, cond_scale=args.cond_scale))
        engine.run_until_idle()
        elapsed = time.monotonic() - t0
        done = [r for r in reqs if r.codes is not None]
        if vae is not None:
            _save_images(args, vae, reqs, lines)
        report = PoissonLoadGen(max(len(lines), 1), 1.0).report(done, refused=0, elapsed_s=elapsed)
    one = engine.engine if hasattr(engine, "router") else engine
    report["pool_blocks"] = engine.pool.num_blocks
    report["refused_total"] = counted("serving/refused")
    report["backpressure_alarms"] = counted("serving_backpressure_alarms")
    report["decode_steps"] = counted("serving/decode_steps")
    report["pool"] = engine.pool_observability()
    report["prefix_redundancy"] = engine.prefix_redundancy()
    report["quantization"] = one.quantization_state()
    for key in ("quarantined", "poison_retries", "flood_injected"):
        report[key] = counted(f"serving/{key}")
    if args.spec_k:
        rounds, accepted = counted("serving/spec_rounds"), counted("serving/spec_accepted_tokens")
        report["spec"] = dict(one.spec_state(), rounds=rounds, accepted_tokens=accepted,
                              rejected_tokens=counted("serving/spec_rejected_tokens"))
    if hasattr(engine, "router"):  # the fleet: replicas, the router, the handoff
        report["replicas"] = len(engine.engines)
        report["replicas_alive"] = len(engine.router.alive())
        report["replicas_lost"] = counted("router/replicas_lost")
        report["requeued_total"] = counted("router/requeued")
        report["router_shed"] = counted("router/shed")
        report["breaker_opens"] = counted("router/breaker_open")
        report["breaker_recoveries"] = counted("router/breaker_closed")
        report["hedged"] = counted("router/hedged")
        report["hedge_duplicates"] = counted("router/hedge_duplicates")
        report["requeue_exhausted"] = counted("router/requeue_exhausted")
        if engine.prefill_worker is not None:
            report["handoff_requests"] = counted("serving/handoff_requests")
            report["handoff_bytes"] = counted("serving/handoff_bytes")
    return report


def _save_images(args, vae, reqs, prompts) -> None:
    outputs_dir = Path(args.outputs_dir)
    counts = {}
    for req, prompt in zip(reqs, prompts):
        if req.images is None:
            continue
        out_dir = outputs_dir / prompt.replace(" ", "_")[:100]
        out_dir.mkdir(parents=True, exist_ok=True)
        n = counts.get(out_dir, len(list(out_dir.glob("*.png"))))
        counts[out_dir] = n + 1
        arr = (np.clip(vae_registry.to_display(vae.cfg, req.images).numpy()[0], 0, 1) * 255).astype(np.uint8)
        write_png(out_dir / f"{n}.png", arr.squeeze())


if __name__ == "__main__":
    main()
