"""Times the f32 dense backward kernels (dq with delta, dk/dv) on the card,
for one or more copies of the kernel sources.

Each `--csrc` directory (a copy of `kernels/csrc`, default the package's own)
is built in a process of its own, so that variants of a body can be held
against each other on one card; give them in the order A, B, B, A.  For each
it prints one JSON line: the registers and stack frame of every f32 dq and
dk/dv instantiation (a stack frame there is spilled registers: those bodies
call no function), the largest error of dq, dk and dv over the reference's
max at a few shapes (rows that see no key, a pattern, both grids: whether
they agree bit for bit), and, at the training shapes (bh 64, n 1280, d 64
and the flagship's bh 32, n 1280, d 128; causal), the median over `--rounds`
of CUDA-event means over `--reps` back-to-back launches of each kernel, with
the card's name and power limit:

    python -m dalle_pytorch_tpu_torch.kernels.time_backward [--csrc DIR ...] [--reps 50] [--rounds 5]
"""
from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

SHAPES = ((64, 16, 1280, 64), (32, 8, 1280, 128))  # (bh, h, n, d)
CHECKS = ((257, None, True), (705, "axial_row", False), (1280, "sparse_per_head", True))  # (n, pattern, dead rows)


def _events_ms(fn, reps: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _resources(build) -> dict:
    """registers and stack bytes of each f32 dq and dk/dv instantiation"""
    tool = Path(build._nvcc()).with_name("cuobjdump")
    out = {}
    for name in ("flash_bwd", "flash_compact"):
        text = subprocess.run([str(tool), "-res-usage", str(build.library_path(name))], capture_output=True,
                              text=True, timeout=120).stdout
        for mangled, reg, stack in re.findall(r"Function (\S+):\s*REG:(\d+) STACK:(\d+)", text):
            hit = re.search(r"(flash_bwd_dq_kernel|flash_dq_compact_kernel|flash_bwd_dkv_kernel|"
                            r"flash_dkv_compact_kernel)IfLi(\d+)E", mangled)
            if hit:
                out[f"{hit.group(1)} d{hit.group(2)}"] = (int(reg), int(stack))
    return out


def _errors(fa, masks, dev) -> dict:
    """largest error of dq, dk, dv over the reference's max, and whether the
    two grids agree bit for bit, at CHECKS for each head dim"""
    out = {}
    for d in (32, 64, 128):
        for n, kind, dead in CHECKS:
            b, h = 2, 4
            g = torch.Generator(device=dev).manual_seed(n + d)
            q, k, v, do = (torch.randn(b * h, n, d, generator=g, device=dev) for _ in range(4))
            kmask = None
            if dead:
                kmask = (torch.rand(b, n, generator=g, device=dev) > 0.2).to(torch.int32)
                kmask[-1] = 0
                kmask[0, :40] = 0
            mask = None
            if kind is not None:
                full = (masks.build_block_sparse_mask(1280, 32, heads=h) if kind == "sparse_per_head"
                        else masks.build_pattern_mask(kind, 1280, 32))
                mask = full[..., :n, :n].contiguous().to(dev)
            grads = []
            for grid in ("dense", "compact") if kind else ("auto",):
                tables = fa.pattern_tables(mask, n, d, True, grid=grid, device=dev) if kind else None
                out_, lse = fa.flash_fwd(q, k, v, h=h, mask=mask, key_mask=kmask, grid=grid, tables=tables)
                grads.append(fa.flash_bwd(q, k, v, out_, lse, do, h=h, mask=mask, key_mask=kmask, grid=grid,
                                          tables=tables))
            torch.cuda.synchronize()
            ref = fa.flash_attention_backward_reference(q, k, v, out_, lse, do, h, True, d ** -0.5, mask, kmask)
            err = max((a - r).abs().max().item() / r.abs().max().item() for a, r in zip(grads[0], ref))
            out[f"d{d} n{n} {kind}"] = (err, all(torch.equal(a, c) for a, c in zip(grads[0], grads[-1])))
    return out


def _child(csrc: str, build_dir: str, reps: int, rounds: int) -> None:
    from dalle_pytorch_tpu_torch.kernels import build

    build.CSRC, build.BUILD_DIR = Path(csrc), Path(build_dir)
    from dalle_pytorch_tpu_torch.kernels import flash_attention as fa
    from dalle_pytorch_tpu_torch.ops import masks

    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()
    dev = torch.device("cuda")
    times = {}
    for bh, h, n, d in SHAPES:
        g = torch.Generator(device=dev).manual_seed(1)
        q, k, v, do = (torch.randn(bh, n, d, generator=g, device=dev) for _ in range(4))
        out, lse = fa.flash_fwd(q, k, v, h=h)
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        delta = torch.empty_like(lse)
        scale = d ** -0.5

        def dq_kernel():
            fa._call("flash_bwd_dq", q, (q, k, v, do, out, lse, None, None, None, dq, delta), h, True, scale)

        def dkv_kernel():
            fa._call("flash_bwd_dkv", q, (q, k, v, do, lse, delta, None, None, None, dk, dv), h, True, scale)

        for name, fn in (("dq", dq_kernel), ("dkv", dkv_kernel)):
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
            times[f"{name} bh{bh} d{d}"] = statistics.median(_events_ms(fn, reps) for _ in range(rounds))
    print(json.dumps({"csrc": csrc, "resources": _resources(build), "errors": _errors(fa, masks, dev),
                      "ms": times, "reps": reps, "rounds": rounds}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csrc", action="append", help="a copy of kernels/csrc (repeatable; default the package's)")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--child", nargs=2, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_backward: no CUDA device is available")
    if args.child:
        _child(*args.child, args.reps, args.rounds)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed", flush=True)
    dirs = args.csrc or [str(Path(__file__).resolve().parent / "csrc")]
    with tempfile.TemporaryDirectory() as tmp:
        for i, csrc in enumerate(dirs):
            subprocess.run([sys.executable, "-m", "dalle_pytorch_tpu_torch.kernels.time_backward", "--reps",
                            str(args.reps), "--rounds", str(args.rounds), "--child", str(Path(csrc).resolve()),
                            str(Path(tmp) / f"build{i}")], check=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
