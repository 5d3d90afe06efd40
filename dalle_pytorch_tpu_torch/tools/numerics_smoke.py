"""At-scale numerics smoke of the JAX package's flagship training recipe
(counterpart of `tools/numerics_smoke.py`).

Runs N real optimization steps at flagship width with the whole low-memory
recipe: bf16 compute, bf16 gradients, bf16 parameter storage with
stochastic rounding, Adafactor, `flash_qkv` remat, on a fixed set of 4
batches cycled, and asserts that the loss falls (the mean of the last 4
recorded losses under 0.95 times the first).  On memorisable data the loss
falls only if the updates really accumulate in the bf16 weights.

Prints one JSON line: the config, the device, the first loss, the mean of
the last four recorded, `decreased`, wall_s and the loss every 5 steps.
Exit 1 on an error, 2 when the loss did not fall.

    python -m dalle_pytorch_tpu_torch.tools.numerics_smoke               # flagship width, the card
    python -m dalle_pytorch_tpu_torch.tools.numerics_smoke --dim 128 --depth 2 --steps 40 --device cpu
"""
from __future__ import annotations

import argparse
import json
import time

import torch


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dim", type=int, default=1152)
    ap.add_argument("--depth", type=int, default=8,
                    help="depth 8 keeps the smoke short while the width (where the numerics live) "
                         "stays flagship")
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--dim_head", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--policy", default="flash_qkv")
    ap.add_argument("--param_dtype", default="bfloat16", choices=["float32", "bfloat16"])
    ap.add_argument("--text_tokens", type=int, default=10000)
    ap.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from torch.func import functional_call

    from dalle_pytorch_tpu_torch.core.device import resolve_device
    from dalle_pytorch_tpu_torch.models.dalle import DALLEConfig, init_dalle
    from dalle_pytorch_tpu_torch.optim.adafactor import Adafactor
    from dalle_pytorch_tpu_torch.parallel.train_step import StepSettings, make_train_step

    small = args.dim < 512  # a CPU check of the harness
    try:
        device = resolve_device(args.device)
        cfg = DALLEConfig(
            dim=args.dim, depth=args.depth, heads=args.heads, dim_head=args.dim_head,
            num_text_tokens=args.text_tokens,
            text_seq_len=64 if small else 256,
            num_image_tokens=512 if small else 8192,
            image_fmap_size=8 if small else 32,
            attn_types=("full", "axial_row", "axial_col", "conv_like"),
            shift_tokens=True, rotary_emb=True,
            execution="remat", remat_policy=args.policy,
            share_input_output_emb=True,
        )
        model = init_dalle(cfg, torch.Generator(device=device).manual_seed(0), device).train()

        def loss_fn(params, batch, generator):
            return functional_call(model, params, (batch["text"], batch["image_codes"]), {"return_loss": True})

        settings = StepSettings(
            compute_dtype=torch.bfloat16,
            grad_dtype=torch.bfloat16,
            param_dtype=torch.bfloat16 if args.param_dtype == "bfloat16" else None,
        )
        init_fn, step_fn = make_train_step(loss_fn, Adafactor(args.lr), settings)
        state = init_fn(dict(model.named_parameters()))

        # a small fixed dataset of 4 batches, cycled: the loss on memorisable
        # data falls if and only if the updates accumulate in the bf16 weights
        batches = []
        for i in range(4):
            gen = torch.Generator().manual_seed(100 + i)
            batches.append({
                "text": torch.randint(0, cfg.num_text_tokens, (args.batch, cfg.text_seq_len), generator=gen).to(device),
                "image_codes": torch.randint(0, cfg.num_image_tokens, (args.batch, cfg.image_seq_len),
                                             generator=gen).to(device),
            })

        t0 = time.perf_counter()
        losses = []
        for i in range(args.steps):
            state, m = step_fn(state, batches[i % len(batches)])
            if i % 5 == 0 or i == args.steps - 1:
                losses.append((i, round(float(m["loss"]), 4)))
        dt = time.perf_counter() - t0
    except Exception as e:
        print(json.dumps({"config": vars(args), "error": str(e)[:300]}))
        raise SystemExit(1)

    first = losses[0][1]
    tail = [v for _, v in losses[-4:]]
    last = sum(tail) / len(tail)
    decreased = last < first * 0.95
    print(json.dumps({
        "config": vars(args),
        "backend": device.type,
        "steps": args.steps,
        "loss_first": first,
        "loss_last_mean4": round(last, 4),
        "decreased": bool(decreased),
        "wall_s": round(dt, 1),
        "loss_curve": losses,
    }))
    if not decreased:
        raise SystemExit(2)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
