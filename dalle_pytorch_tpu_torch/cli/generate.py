"""Generate images from a trained DALL-E (counterpart of
`dalle_pytorch_tpu/cli/generate.py`).

    python -m dalle_pytorch_tpu_torch.cli.generate --dalle_path dalle.pt --text "a cat|a dog" [--device cpu]

Loads a v3 checkpoint ({hparams, vae_params, weights, vae_weights,
vae_class_name, version}), splits the prompts on '|', optionally completes
each prompt first (`--gentxt`), samples `--num_images` images per prompt in
`--batch_size` chunks and writes them as `{i}.png` into
`<outputs_dir>/<prompt with spaces as underscores, 100 characters>/`.  It
runs on the card unless `--device cpu` is given.  The gumbel noise comes
from one `torch.Generator` seeded with `--seed`; the images are not the JAX
package's bits (its threefry streams are not reproduced).

`--engine` samples through the continuous-batching serving engine
(`serving/engine.py`, `--engine_slots` lanes, `--engine_block_size`-token
KV blocks): one request an image, image j of the run (over all prompts)
seeded with `--seed` + j, so that a run of one image gives the codes of the
same run without `--engine`.  The checkpoint may be a v3 `.npz` whose VAE
is any of the three families (the DiscreteVAE, the taming VQGAN, OpenAI's
dVAE), a torch-reference `dalle.pt` (with `--vqgan_config_path` when its
VAE is a VQGanVAE), or a pre-v3 file under `--allow_legacy_pickle`
(`weights.load_dalle_bundle`); `--taming` and `--vqgan_model_path` are
accepted and change nothing, as in the JAX CLI (the checkpoint names its
VAE and holds its weights).  `--spec_k K` decodes by self-speculative rounds
(K codes drafted through the first `--spec_draft_layers` layers, default
half the depth), through `generate_images` or through `--engine`; the
images are the ones the run gives without it.  An out-of-memory error
writes `oom_report_sampling_*.txt` under `--outputs_dir` (the sampling
ledger: the weights, the per-lane KV cache, the logits; the allocator's
stats; what to change) and exits 77 (`resilience.EXIT_OOM`), as the JAX
CLI does.
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from dalle_pytorch_tpu_torch import weights
from dalle_pytorch_tpu_torch.cli.common import warn_vocab_mismatch
from dalle_pytorch_tpu_torch.cli.png import write_png
from dalle_pytorch_tpu_torch.core.device import resolve_device
from dalle_pytorch_tpu_torch.data import tokenizer as tokenizer_mod
from dalle_pytorch_tpu_torch.models import vae_registry
from dalle_pytorch_tpu_torch.models.sampling import _sync, generate_images, generate_texts
from dalle_pytorch_tpu_torch.observability import memory as memory_mod
from dalle_pytorch_tpu_torch.observability import telemetry
from dalle_pytorch_tpu_torch.serving.engine import EngineConfig, GenerationEngine

def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Generate images from a trained DALL-E")
    parser.add_argument("--dalle_path", type=str, required=True)
    parser.add_argument("--text", type=str, required=True, help="prompt(s), | separated")
    parser.add_argument("--num_images", type=int, default=128)
    parser.add_argument("--batch_size", type=int, default=4)
    parser.add_argument("--top_k", type=float, default=0.9, help="filter threshold (0.5-1.0)")
    parser.add_argument("--temperature", type=float, default=1.0)
    parser.add_argument("--cond_scale", type=float, default=1.0, help="classifier-free guidance scale")
    parser.add_argument("--outputs_dir", type=str, default="./outputs")
    parser.add_argument("--gentxt", action="store_true", help="complete the prompt with DALL-E first")
    parser.add_argument("--taming", action="store_true",
                        help="the checkpoint's VAE is a taming VQGAN (reference-format checkpoints need its yaml "
                             "via --vqgan_config_path)")
    parser.add_argument("--vqgan_config_path", type=str, default=None,
                        help="taming config yaml for a reference VQGanVAE checkpoint")
    parser.add_argument("--vqgan_model_path", type=str, default=None,
                        help="unused (weights are embedded in the checkpoint); accepted for parity")
    parser.add_argument("--chinese", action="store_true")
    parser.add_argument("--hug", action="store_true")
    parser.add_argument("--bpe_path", type=str, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--allow_legacy_pickle", action="store_true",
                        help="permit loading pre-v3 (pickled-treedef) checkpoints: trusted sources only")
    parser.add_argument("--engine", action="store_true",
                        help="sample through the continuous-batching serving engine")
    parser.add_argument("--engine_slots", type=int, default=4, help="decode lanes for --engine")
    parser.add_argument("--engine_block_size", type=int, default=64, help="KV pool block size (tokens) for --engine")
    parser.add_argument("--spec_k", type=int, default=0,
                        help="self-speculative decoding: tokens drafted per round (0 disables)")
    parser.add_argument("--spec_draft_layers", type=int, default=None,
                        help="draft-prefix depth (default depth // 2)")
    parser.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    return parser


def get_tokenizer(args):
    if args.chinese:
        return _adapter(tokenizer_mod.ChineseTokenizer, "chinese", "transformers")
    if args.hug:
        return _adapter(tokenizer_mod.HugTokenizer, "hug", "tokenizers", args.bpe_path)
    if args.bpe_path is not None:
        if Path(args.bpe_path).suffix == ".json":
            return _adapter(tokenizer_mod.HugTokenizer, "bpe_path", "tokenizers", args.bpe_path)
        return _adapter(tokenizer_mod.YttmTokenizer, "bpe_path", "youtokentome", args.bpe_path)
    return tokenizer_mod.tokenizer


def _adapter(cls, flag: str, package: str, *args):
    try:
        return cls(*args)
    except ImportError as e:
        raise SystemExit(f"--{flag}: {cls.__name__} needs the {package} package ({e})") from e


def _add(timings: Optional[dict], key: str, seconds: float) -> None:
    if timings is not None:
        timings[key] = timings.get(key, 0.0) + seconds


def main(argv=None, timings: Optional[dict] = None) -> List[Path]:
    """Run the CLI on `argv`; returns the written PNG paths.  A `timings`
    dict gathers the seconds of each phase over the run: load_s, tokenize_s,
    gentxt_s, prefill_s, decode_s, vae_s and png_s (the device is
    synchronised after each)."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)

    t0 = time.perf_counter()
    model, vae = weights.load_dalle_checkpoint(args.dalle_path, device, allow_legacy_pickle=args.allow_legacy_pickle,
                                               vqgan_config_path=args.vqgan_config_path)
    dalle_cfg, vae_cfg = model.cfg, vae.cfg
    _sync(device)
    _add(timings, "load_s", time.perf_counter() - t0)

    t0 = time.perf_counter()
    tokenizer = get_tokenizer(args)
    _add(timings, "tokenize_s", time.perf_counter() - t0)
    warn_vocab_mismatch(dalle_cfg.num_text_tokens, tokenizer)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    outputs_dir = Path(args.outputs_dir)
    # the sampling ledger: the weights, the KV cache of each lane (two a
    # prompt under classifier-free guidance), the logits — what an OOM
    # report needs (the cache is linear in --batch_size, the usual lever)
    lanes = args.batch_size * (2 if args.cond_scale != 1.0 else 1)
    mem_ledger = memory_mod.sampling_memory_ledger(dalle_cfg, lanes, model, device=device)
    where = {"phase": "sampling", "ledger": mem_ledger,
             "context": {"batch_size": args.batch_size, "num_images": args.num_images, "cond_scale": args.cond_scale}}
    with telemetry.oom_exit(str(outputs_dir), where, device=device, advice="shrink --batch_size"):
        return _generate_all(args, device, model, vae, tokenizer, generator, outputs_dir, timings)


def _generate_all(args, device, model, vae, tokenizer, generator, outputs_dir: Path,
                  timings: Optional[dict]) -> List[Path]:
    dalle_cfg, vae_cfg = model.cfg, vae.cfg
    engine = None
    if args.engine:
        engine = GenerationEngine(model, vae, EngineConfig(num_slots=args.engine_slots,
                                                           block_size=args.engine_block_size,
                                                           filter_thres=args.top_k, spec_k=args.spec_k,
                                                           spec_draft_layers=args.spec_draft_layers))
    ts = dalle_cfg.text_seq_len

    paths: List[Path] = []
    for raw_text in args.text.split("|"):
        raw_text = raw_text.strip()
        if args.gentxt:
            t0 = time.perf_counter()
            prompt_ids = tokenizer.tokenize(raw_text, ts, truncate_text=True)
            _add(timings, "tokenize_s", time.perf_counter() - t0)
            t0 = time.perf_counter()
            n0 = int((prompt_ids[0] != 0).sum())
            prompt = torch.from_numpy(prompt_ids[:, :max(n0, 1)]).to(device)
            completed = generate_texts(model, prompt, generator)
            pad_tokens = set(range(dalle_cfg.num_text_tokens_padded - ts, dalle_cfg.num_text_tokens_padded))
            raw_text = tokenizer.decode(completed[0].cpu().numpy(), pad_tokens=pad_tokens)
            _add(timings, "gentxt_s", time.perf_counter() - t0)
            print(f"completed text: {raw_text}")

        t0 = time.perf_counter()
        text_tokens = np.repeat(tokenizer.tokenize(raw_text, ts, truncate_text=True), args.num_images, axis=0)
        _add(timings, "tokenize_s", time.perf_counter() - t0)

        out_dir = outputs_dir / raw_text.replace(" ", "_")[:100]
        out_dir.mkdir(parents=True, exist_ok=True)
        produced = 0
        for i in range(0, args.num_images, args.batch_size):
            chunk = torch.from_numpy(text_tokens[i:i + args.batch_size]).to(device)
            phases = {} if timings is not None else None
            if engine is not None:
                t0 = time.perf_counter()
                first = len(paths)
                reqs = engine.generate(chunk.cpu().numpy(), seeds=[args.seed + first + j for j in range(len(chunk))],
                                       temperature=args.temperature, cond_scale=args.cond_scale)
                images = torch.cat([r.images for r in reqs])
                _add(timings, "engine_s", time.perf_counter() - t0)
            else:
                images = generate_images(model, vae, chunk, generator,
                                         filter_thres=args.top_k, temperature=args.temperature,
                                         cond_scale=args.cond_scale, timings=phases, spec_k=args.spec_k,
                                         spec_draft_layers=args.spec_draft_layers)
            for key, seconds in (phases or {}).items():
                _add(timings, key, seconds)
            t0 = time.perf_counter()
            # display space (the reference's save_image(normalize=True)):
            # the DiscreteVAE decodes into its normalised space, the others into [0, 1]
            images = vae_registry.to_display(vae_cfg, images).cpu().numpy()
            for img in images:
                arr = (np.clip(img, 0, 1) * 255).astype(np.uint8)
                fp = out_dir / f"{produced}.png"
                write_png(fp, arr.squeeze())
                paths.append(fp)
                produced += 1
            _add(timings, "png_s", time.perf_counter() - t0)
        print(f"created {produced} images at {out_dir}")
    return paths


if __name__ == "__main__":
    main()
