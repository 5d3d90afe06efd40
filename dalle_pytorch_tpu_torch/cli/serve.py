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

The JAX service's fleet, journal, degrade ladder, telemetry and SLO flags,
and its other fault kinds, exit with a message naming the `ROADMAP.md` item
that brings them.
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
from dalle_pytorch_tpu_torch.serving.engine import EngineConfig, GenerationEngine
from dalle_pytorch_tpu_torch.tools.loadgen import PoissonLoadGen, synthetic_request_maker
from dalle_pytorch_tpu_torch.training import resilience

_ITEM6 = "ROADMAP.md Queue 1 item 6"
_ITEM8 = "ROADMAP.md Queue 1 item 8"
# flag -> what it needs that the port does not have yet, and where ROADMAP.md lists it
_WAITING = {
    "replicas": f"the serving fleet and its router ({_ITEM6})",
    "disaggregate": f"prefill/decode disaggregation ({_ITEM6})",
    "stall_wedge_s": f"the serving fleet and its router ({_ITEM6})",
    "stall_after_s": f"the serving fleet and its router ({_ITEM6})",
    "hedge_frac": f"the serving fleet and its router ({_ITEM6})",
    "requeue_budget_s": f"the serving fleet and its router ({_ITEM6})",
    "deadline_s": f"the serving fleet and its router ({_ITEM6})",
    "retries": f"the serving fleet and its router ({_ITEM6})",
    "journal": f"the request journal ({_ITEM6})",
    "degrade": f"the degrade ladder ({_ITEM6})",
    "degrade_enter_s": f"the degrade ladder ({_ITEM6})",
    "degrade_exit_s": f"the degrade ladder ({_ITEM6})",
    "no_pool_recorder": f"the pool flight recorder ({_ITEM6})",
    "pool_recorder_capacity": f"the pool flight recorder ({_ITEM6})",
    "slo_ttft_p99": f"the SLO monitor ({_ITEM6})",
    "slo_latency_p99": f"the SLO monitor ({_ITEM6})",
    "slo_images_per_sec": f"the SLO monitor ({_ITEM6})",
    "slo_shed_rate": f"the SLO monitor ({_ITEM6})",
    "status_json": f"the SLO monitor's status file ({_ITEM6})",
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
                     help="poison-request@N or flood@N[:COUNT]: the engine's drills at its iteration N")

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
        if flag in ("disaggregate", "degrade", "no_pool_recorder"):
            waiting.add_argument(f"--{flag}", action="store_true")
        else:
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
    if not (args.loadgen or args.prompts):
        raise SystemExit("provide --loadgen N or --prompts FILE")
    injector = None
    if args.inject_fault:
        injector = resilience.FaultInjector(resilience.parse_fault(args.inject_fault)).install()
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
    engine = GenerationEngine(model, vae, EngineConfig(
        num_slots=args.slots, block_size=args.block_size, num_blocks=args.num_blocks, max_queue=args.max_queue,
        headroom_frac=args.headroom_frac, filter_thres=args.top_k,
        quantize_kv=None if args.quantize_kv == "none" else args.quantize_kv, spec_k=args.spec_k,
        spec_draft_layers=args.spec_draft_layers))
    print(f"[serving] paged pool: {engine.pool.num_blocks} blocks of {args.block_size} tokens "
          f"(+1 trash), {engine.pool.bytes() / 2 ** 30:.3f} GiB ({engine.pool.quant or 'float'}); {args.slots} lanes")
    try:
        report = _run_traffic(args, engine, model, vae)
    finally:
        engine.close()
        if injector is not None:
            injector.uninstall()
    print("[serving] report:")
    for k, v in report.items():
        print(f"  {k:>26}: {v}")
    if args.report_json:
        Path(args.report_json).write_text(json.dumps(report))
    return report


def _run_traffic(args, engine: GenerationEngine, model, vae) -> dict:
    cfg = model.cfg
    if args.loadgen:
        gen = PoissonLoadGen(args.loadgen, args.rate, streams=args.streams, seed=args.seed)
        report = gen.run(engine, synthetic_request_maker(
            cfg, seed=args.seed, temperature=args.temperature, cond_scale=args.cond_scale,
            zipf_s=args.zipf, prompt_pool=args.prompt_pool))
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
    report["pool_blocks"] = engine.pool.num_blocks
    report["refused_total"] = engine.admission.counts["refused"]
    report["backpressure_alarms"] = engine.admission.counts["backpressure_alarms"]
    report["decode_steps"] = engine.decode_steps
    report["pool"] = engine.pool.summary()
    report["quantization"] = engine.quantization_state()
    for key in ("quarantined", "poison_retries", "flood_injected"):
        report[key] = engine.counts[key]
    if args.spec_k:
        report["spec"] = engine.spec_state()
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
