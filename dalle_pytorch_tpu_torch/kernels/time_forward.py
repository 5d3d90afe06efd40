"""Times the dense flash forward kernel on the card.

For each training shape (bh 64, n 1280, d 64, and the flagship's bh 32,
n 1280, d 128; causal, no mask, no key padding) and dtype, prints one JSON
line: the mean of CUDA-event timings over `--reps` back-to-back launches,
taken `--rounds` times after a warm-up, with the card's name and power limit.
To compare two versions of the kernel on one card, run it from both
checkouts in one session, in the order A, B, B, A:

    python -m dalle_pytorch_tpu_torch.kernels.time_forward [--reps 200] [--rounds 5]
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import torch

SHAPES = ((64, 16, 1280, 64), (32, 8, 1280, 128))  # (bh, h, n, d)


def _events_ms(fn, reps: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_forward: no CUDA device is available")
    from dalle_pytorch_tpu_torch.kernels import flash_attention as fa

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    dev = torch.device("cuda")
    for dtype in (torch.bfloat16, torch.float32):
        for bh, h, n, d in SHAPES:
            g = torch.Generator(device=dev).manual_seed(n + d)
            q, k, v = (torch.randn(bh, n, d, generator=g, device=dev).to(dtype) for _ in range(3))

            def kernel():
                return fa.flash_fwd(q, k, v, h=h, causal=True)

            for _ in range(10):
                kernel()
            torch.cuda.synchronize()
            rounds = [_events_ms(kernel, args.reps) for _ in range(args.rounds)]
            print(json.dumps({"kernel": "flash_fwd", "dtype": str(dtype).replace("torch.", ""), "bh": bh,
                              "n": n, "d": d, "causal": True, "ms_median": statistics.median(rounds),
                              "ms_rounds": rounds, "reps": args.reps, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
