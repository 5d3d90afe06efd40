"""Masked bf16 attention at n 257 on the card, forward and backward, for
running under `compute-sanitizer --tool memcheck`:

    python -m dalle_pytorch_tpu_torch.kernels.memcheck --build
    PYTORCH_NO_CUDA_MEMORY_CACHING=1 compute-sanitizer --tool memcheck \\
        python -m dalle_pytorch_tpu_torch.kernels.memcheck

The first line builds the kernels outside the tool.  With PyTorch's caching
allocator off every tensor is an allocation of its own, so a read past the
end of the pattern mask reads outside any allocation, which memcheck
reports.  At n 257 the mask's n * n bytes are not a multiple of 16, and the
bf16 bodies' 16-byte copies of the last pattern row reach up to 15 bytes
past them.  The wrappers run on the dense and the compacted grid, with a
shared (n, n) and a per-head (h, n, n) mask, and hand the kernels the mask
with the 16 bytes of slack `_device_mask` gives it.
"""
from __future__ import annotations

import argparse

import torch

from dalle_pytorch_tpu_torch.kernels import build
from dalle_pytorch_tpu_torch.kernels import flash_attention as fa
from dalle_pytorch_tpu_torch.ops import masks


def _masks(n: int, h: int):
    return {"axial_row": masks.build_pattern_mask("axial_row", n, 16).bool(),
            "sparse_per_head": masks.build_block_sparse_mask(n, 16, heads=h).bool()}


def run(n: int = 257, d: int = 64, h: int = 2) -> None:
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(n)
    q, k, v, do = (torch.randn(h, n, d, generator=g, device=dev).bfloat16() for _ in range(4))
    for kind, mask in _masks(n, h).items():
        for grid in ("dense", "compact"):
            m = mask.to(dev)
            t = fa.pattern_tables(m, n, d, grid=grid, device=dev)
            out, lse = fa.flash_fwd(q, k, v, h=h, mask=m, grid=grid, tables=t)
            fa.flash_bwd(q, k, v, out, lse, do, h=h, mask=m, grid=grid, tables=t)
            torch.cuda.synchronize()
            print(f"{kind} {grid}: ran", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--build", action="store_true", help="build the kernels and exit")
    args = ap.parse_args()
    if args.build:
        print(build.build_all())
        return
    if not torch.cuda.is_available():
        raise SystemExit("memcheck: no CUDA device is available")
    run()


if __name__ == "__main__":
    main()
