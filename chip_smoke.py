#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds each
against its plain PyTorch version on the card (the flash forward, and the
backward's dq and dk/dv kernels, on the dense grid and, for static attention
patterns, on the compacted grid, which must equal the dense grid with the
same mask bit for bit), drives the serving path at the full width of the
12-layer DALL-E (dim 1024, 16 heads, seq 1280, OpenAI-dVAE geometry, seeded
random weights) through `DALLE.generate_images`, runs the scoring forward at
n = 1280, checks a small model's sampling on the card against the same model
on the CPU, trains the full-width model (f32 and bf16 compute, then
rematerialised), holds a small model's train steps on the card against the
CPU, and runs the training CLI's dummy run.  Then the same for the README's
pattern-attention model (depth 16 cycling full, axial_row, axial_col and
conv_like): generation plain and primed, a decode profile, card-vs-CPU
parity of a small pattern model, and training.  Each path runs with every
launch counter set to 0 just before it and read just after.

Every phase prints one JSON line; any failure raises and exits non-zero.  The
last two lines are the kernel table and `{"ok": true, "device": {...}}`.  It
exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.

Comparisons run with TF32 off: `torch.backends.cudnn.allow_tf32 = False`
and matmul precision "highest", so float32 means float32 on both sides.
"""
from __future__ import annotations

import functools
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}  # f32 FMA units; bf16 tensor cores
TOLERANCE = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
LSE_TOLERANCE = 1e-4

FULL = dict(dim=1024, depth=12, heads=16, dim_head=64, num_text_tokens=10000, text_seq_len=256,
            attn_types=("full",), rotary_emb=True, shift_tokens=True)
FULL_VAE = dict(image_size=256, num_tokens=8192, num_layers=3)
# the README quick-start model: pattern attention, depth 16 (each type 4 times)
SLICE = dict(FULL, depth=16, attn_types=("full", "axial_row", "axial_col", "conv_like"))
PATTERNS = ("axial_row", "axial_col", "conv_like", "sparse", "sparse_per_head")

# kernels-line name -> (wrapper in kernels/flash_attention.py, its counter);
# flash_fwd_masked counts the flash_fwd launches that took a pattern
COUNTERS = {
    "flash_fwd": ("flash_fwd", "launches"),
    "flash_fwd_masked": ("flash_fwd", "masked_launches"),
    "flash_dq": ("flash_bwd", "dq_launches"),
    "flash_dkv": ("flash_bwd", "dkv_launches"),
    "flash_fwd_compact": ("flash_fwd_compact", "launches"),
    "flash_dq_compact": ("flash_bwd_compact", "dq_launches"),
    "flash_dkv_compact": ("flash_bwd_compact", "dkv_launches"),
}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def time_ms(fn, reps: int) -> float:
    """Mean device time of fn over `reps` launches, CUDA events, after warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def flash_bound_ms(bh, n, d, dtype, causal, padded, b):
    """The least time for the attention forward: each input read once and
    each output written once over the memory rate, against the two matrix
    products over the dtype's peak; the larger of the two."""
    esize = torch.tensor([], dtype=dtype).element_size()
    nbytes = 4 * bh * n * d * esize + bh * n * 4 + (b * n * 4 if padded else 0)
    pairs = n * (n + 1) // 2 if causal else n * n
    flops = 4 * bh * pairs * d
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def backward_bound_ms(bh, n, d, dtype, causal, padded, b, products, outputs):
    """The least time for one backward kernel: its inputs (q, k, v, do,
    lse, delta, the key mask) read once and its `outputs` (bh, n, d)
    tensors written once over the memory rate, against its `products`
    n x n x d matrix products (2 flops a multiply-add) over the dtype's
    peak; the larger of the two."""
    esize = torch.tensor([], dtype=dtype).element_size()
    nbytes = (4 + outputs) * bh * n * d * esize + 2 * bh * n * 4 + (b * n * 4 if padded else 0)
    pairs = n * (n + 1) // 2 if causal else n * n
    flops = products * 2 * bh * pairs * d
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def pattern_bound_ms(bh, n, d, dtype, live_per_bh, tile, products, row_tensors, tile_tensors, row_floats):
    """The least time for one pattern kernel over its live tiles: the
    tensors it reads or writes once per row (`row_tensors` (bh, n, d) ones
    and `row_floats` (bh, n) f32 ones), the `tile_tensors` it reads once per
    live (tile[0] x tile[1]) tile, over the memory rate, against its
    `products` matrix products over the live tiles' elements (2 flops a
    multiply-add) over the dtype's peak; the larger of the two."""
    esize = torch.tensor([], dtype=dtype).element_size()
    tq, tk = tile
    nbytes = (row_tensors * bh * n * d * esize + row_floats * bh * n * 4
              + tile_tensors * bh * live_per_bh * tk * d * esize)
    flops = products * 2 * bh * live_per_bh * tq * tk * d
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def reset_launches(fa) -> None:
    for wrapper, counter in COUNTERS.values():
        setattr(getattr(fa, wrapper), counter, 0)


def read_launches(fa) -> dict:
    return {name: getattr(getattr(fa, wrapper), counter) for name, (wrapper, counter) in COUNTERS.items()}


def launches_per_step(cfg, execution):
    """The launches one training step makes, from the layer cycle: a 'full'
    layer takes the dense grid without a mask; at n = 1280, d = 64
    `axial_col` takes the dense grid with its mask (it kills no tile),
    `axial_row` and `conv_like` the compacted grid.  Remat runs each
    forward twice."""
    fwd = 2 if execution == "remat" else 1
    types = [cfg.attn_types[i % len(cfg.attn_types)] for i in range(cfg.depth)]
    full = types.count("full")
    masked = types.count("axial_col")
    compact = types.count("axial_row") + types.count("conv_like")
    check(full + masked + compact == cfg.depth, f"no expected launches for the layer cycle {cfg.attn_types}")
    return {"flash_fwd": fwd * (full + masked), "flash_fwd_masked": fwd * masked, "flash_dq": full + masked,
            "flash_dkv": full + masked, "flash_fwd_compact": fwd * compact, "flash_dq_compact": compact,
            "flash_dkv_compact": compact}


def device_profile(fn) -> list:
    """(kernel name, device ms, count) of one call of fn, by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    return sorted(rows, key=lambda r: -r[1])


def sdpa_backend(fn) -> str:
    """Which scaled_dot_product_attention backend fn ran, from its kernels."""
    names = " ".join(name.lower() for name, _, _ in device_profile(fn))
    for pattern, backend in (("cudnn", "cudnn"), ("flash", "flash"), ("fmha", "efficient"),
                             ("mem_eff", "efficient")):
        if pattern in names:
            return backend
    return "math"


def phase_environment(build):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    t0 = time.perf_counter()
    compile_s = build.build_all()
    emit("environment", device=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda, python=sys.version.split()[0],
         kernel_compile_s=compile_s, build_s=time.perf_counter() - t0,
         tf32="off (cudnn.allow_tf32=False, matmul precision highest)")


def phase_kernel_vs_plain(fa):
    """flash_fwd against flash_attention_reference at the slice's shapes."""
    dev = torch.device("cuda")
    cases = [  # (name, b, h, n, d, causal, padded)
        ("prefill", 4, 16, 257, 64, True, False),  # 2 prompts x CFG, bos + 256 text
        ("forward", 2, 16, 1280, 64, True, False),  # scoring forward, batch 2
        ("padded_noncausal", 2, 16, 300, 64, False, True),
        ("train", 4, 16, 1280, 64, True, False),  # the training step, batch 4
    ]
    results = []
    for dtype in (torch.float32, torch.bfloat16):
        for name, b, h, n, d, causal, padded in cases:
            g = torch.Generator(device=dev).manual_seed(n)
            q, k, v = (torch.randn(b * h, n, d, generator=g, device=dev).to(dtype) for _ in range(3))
            kmask = None
            if padded:
                kmask = (torch.rand(b, n, generator=g, device=dev) > 0.2).to(torch.int32)
                kmask[0, :16] = 0  # rows that see no key at all
            out, lse = fa.flash_fwd(q, k, v, h=h, causal=causal, key_mask=kmask)
            torch.cuda.synchronize()
            ref_out, ref_lse = fa.flash_attention_reference(q, k, v, h, causal, d ** -0.5, None, kmask)
            err = (out.float() - ref_out.float()).abs().max().item()
            lse_err = (lse - ref_lse).abs().max().item()
            check(err <= TOLERANCE[dtype] and lse_err <= LSE_TOLERANCE,
                  f"flash_fwd {name} {dtype}: max abs err {err}, lse err {lse_err}")

            q4, k4, v4 = (t.view(b, h, n, d) for t in (q, k, v))
            sdpa_mask = None if kmask is None else (kmask > 0)[:, None, None, :]
            reps = 20 if n >= 1000 else 50
            kernel_ms = time_ms(lambda: fa.flash_fwd(q, k, v, h=h, causal=causal, key_mask=kmask), reps)
            plain_ms = time_ms(
                lambda: fa.flash_attention_reference(q, k, v, h, causal, d ** -0.5, None, kmask), reps)
            library_ms = time_ms(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=sdpa_mask, is_causal=causal and sdpa_mask is None), reps)
            bound_ms, bound_by = flash_bound_ms(b * h, n, d, dtype, causal, padded, b)
            row = dict(case=name, dtype=str(dtype).replace("torch.", ""), bh=b * h, n=n, d=d,
                       causal=causal, key_padding=padded, max_abs_err=err, lse_err=lse_err,
                       tolerance=TOLERANCE[dtype], ms=kernel_ms, plain_ms=plain_ms,
                       library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
            emit("kernel_vs_plain", kernel="flash_fwd", **row)
            results.append(row)
    return results


def phase_backward_vs_plain(fa):
    """flash_bwd's two kernels against flash_attention_backward_reference at
    the training shape, the ragged prefill length and a padded non-causal
    case whose second batch masks every key (rows that see no key).  The
    error is max abs error over the reference's max abs value.  The library
    time is SDPA forward + backward minus SDPA forward, same inputs."""
    dev = torch.device("cuda")
    cases = [  # (name, b, h, n, d, causal, padded)
        ("train", 4, 16, 1280, 64, True, False),
        ("prefill", 4, 16, 257, 64, True, False),
        ("padded_noncausal", 2, 16, 300, 64, False, True),
    ]
    results = []
    for dtype in (torch.float32, torch.bfloat16):
        for name, b, h, n, d, causal, padded in cases:
            g = torch.Generator(device=dev).manual_seed(n + 1)
            q, k, v, do = (torch.randn(b * h, n, d, generator=g, device=dev).to(dtype) for _ in range(4))
            kmask = None
            if padded:
                kmask = (torch.rand(b, n, generator=g, device=dev) > 0.2).to(torch.int32)
                kmask[-1] = 0  # every row of the last batch sees no key
            scale = d ** -0.5
            out, lse = fa.flash_fwd(q, k, v, h=h, causal=causal, key_mask=kmask)
            grads = fa.flash_bwd(q, k, v, out, lse, do, h=h, causal=causal, key_mask=kmask)
            torch.cuda.synchronize()
            ref = fa.flash_attention_backward_reference(q, k, v, out, lse, do, h, causal, scale, None, kmask)
            err = {}
            for gname, port, r in zip(("dq", "dk", "dv"), grads, ref):
                abs_err = (port.float() - r.float()).abs().max().item()
                err[gname] = (abs_err, abs_err / r.float().abs().max().item())
                check(err[gname][1] <= TOLERANCE[dtype],
                      f"flash_bwd {gname} {name} {dtype}: error {err[gname][1]} over the reference's max")

            delta = fa._delta(out, lse, do, v)
            dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
            reps = 20 if n >= 1000 else 50
            dq_ms = time_ms(lambda: fa._call("flash_bwd_dq", q, (q, k, v, do, lse, delta, kmask, None, None, dq),
                                             h, causal, scale), reps)
            dkv_ms = time_ms(lambda: fa._call("flash_bwd_dkv", q, (q, k, v, do, lse, delta, kmask, None, None,
                                                                   dk, dv), h, causal, scale), reps)
            bwd_ms = time_ms(lambda: fa.flash_bwd(q, k, v, out, lse, do, h=h, causal=causal, key_mask=kmask),
                             reps)
            plain_ms = time_ms(lambda: fa.flash_attention_backward_reference(
                q, k, v, out, lse, do, h, causal, scale, None, kmask), reps)

            q4, k4, v4 = (t.view(b, h, n, d).detach().requires_grad_(True) for t in (q, k, v))
            do4 = do.view(b, h, n, d)
            sdpa_mask = None if kmask is None else (kmask > 0)[:, None, None, :]

            def sdpa_fwd():
                return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=sdpa_mask,
                                                      is_causal=causal and sdpa_mask is None)

            def sdpa_fwd_bwd():
                return torch.autograd.grad(sdpa_fwd(), (q4, k4, v4), do4)

            library_ms = time_ms(sdpa_fwd_bwd, reps) - time_ms(sdpa_fwd, reps)
            dq_bound, dq_by = backward_bound_ms(b * h, n, d, dtype, causal, padded, b, 3, 1)
            dkv_bound, dkv_by = backward_bound_ms(b * h, n, d, dtype, causal, padded, b, 4, 2)
            row = dict(case=name, dtype=str(dtype).replace("torch.", ""), bh=b * h, n=n, d=d, causal=causal,
                       key_padding=padded, tolerance=TOLERANCE[dtype],
                       **{f"{gname}_max_abs_err": e[0] for gname, e in err.items()},
                       **{f"{gname}_err_over_ref_max": e[1] for gname, e in err.items()},
                       dq_ms=dq_ms, dkv_ms=dkv_ms, flash_bwd_ms=bwd_ms, plain_ms=plain_ms,
                       library_bwd_ms=library_ms, sdpa_backend=sdpa_backend(sdpa_fwd_bwd),
                       dq_bound_ms=dq_bound, dq_bound_by=dq_by, dkv_bound_ms=dkv_bound, dkv_bound_by=dkv_by)
            emit("kernel_vs_plain", kernel="flash_dq+flash_dkv", **row)
            results.append(row)
    return results


def pattern_mask(masks, kind, n, h):
    """The slice's (n, n) pattern, or (h, n, n) for per-head 'sparse', at
    seq 1280 on the 32 x 32 map."""
    if kind == "sparse":
        return masks.build_block_sparse_mask(n, 32)
    if kind == "sparse_per_head":
        return masks.build_block_sparse_mask(n, 32, heads=h)
    return masks.build_pattern_mask(kind, n, 32)


def phase_sparse_kernel_vs_plain(fa, masks):
    """For each pattern at bh 64, n 1280, d 64 and bh 32, n 1280, d 128, in
    f32 and bf16: forward, dq and dk/dv on the dense grid with the mask and
    on the compacted grid (torch.equal, bit for bit), both against the plain
    versions (forward: max abs error; backward: over the reference's max),
    and their times against the bound over the live tiles, the plain
    versions and SDPA with the boolean mask pattern & causal (forward, and
    forward + backward - forward for the backward)."""
    dev = torch.device("cuda")
    results = []
    for b, h, d in ((4, 16, 64), (4, 8, 128)):
        n, bh, scale = 1280, b * h, d ** -0.5
        for dtype in (torch.float32, torch.bfloat16):
            for kind in PATTERNS:
                mask = pattern_mask(masks, kind, n, h).to(dev)
                tabs = {grid: fa.pattern_tables(mask, n, d, grid=grid, device=dev) for grid in ("dense", "compact")}
                td, tc = tabs["dense"], tabs["compact"]
                g = torch.Generator(device=dev).manual_seed(d + len(kind))
                q, k, v, do = (torch.randn(bh, n, d, generator=g, device=dev).to(dtype) for _ in range(4))
                res = {}
                for grid, t in tabs.items():
                    out, lse = fa.flash_fwd(q, k, v, h=h, mask=mask, grid=grid, tables=t)
                    res[grid] = (out, lse, *fa.flash_bwd(q, k, v, out, lse, do, h=h, mask=mask, grid=grid, tables=t))
                torch.cuda.synchronize()
                bit_equal = all(torch.equal(a, c) for a, c in zip(res["dense"], res["compact"]))
                check(bit_equal, f"{kind} d {d} {dtype}: the compacted grid differs from the dense grid")
                out, lse, dq, dk, dv = res["dense"]
                ref_out, ref_lse = fa.flash_attention_reference(q, k, v, h, True, scale, mask)
                err = (out.float() - ref_out.float()).abs().max().item()
                lse_err = (lse - ref_lse).abs().max().item()
                check(err <= TOLERANCE[dtype] and lse_err <= LSE_TOLERANCE,
                      f"{kind} d {d} {dtype} forward: max abs err {err}, lse err {lse_err}")
                ref = fa.flash_attention_backward_reference(q, k, v, out, lse, do, h, True, scale, mask)
                bwd_err = {}
                for gname, port, r in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
                    abs_err = (port.float() - r.float()).abs().max().item()
                    bwd_err[gname] = (abs_err, abs_err / r.float().abs().max().item())
                    check(bwd_err[gname][1] <= TOLERANCE[dtype],
                          f"{kind} d {d} {dtype} {gname}: error {bwd_err[gname][1]} over the reference's max")

                # each kernel alone, through its entry point, as the wrappers call it
                m, mh = fa._device_mask(q, mask, h)
                delta = fa._delta(out, lse, do, v)
                o, l_ = torch.empty_like(q), torch.empty_like(lse)
                gq, gk, gv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
                calls = {
                    "fwd_dense": ("flash_fwd", (q, k, v, None, m, td.live_rows, o, l_), 0, td.row_tile),
                    "fwd_compact": ("flash_fwd_compact", (q, k, v, None, m, tc.row_ptr, tc.col, o, l_),
                                    tc.col.shape[1], tc.row_tile),
                    "dq_dense": ("flash_bwd_dq", (q, k, v, do, lse, delta, None, m, td.live_rows, gq), 0, td.row_tile),
                    "dq_compact": ("flash_dq_compact", (q, k, v, do, lse, delta, None, m, tc.row_ptr, tc.col, gq),
                                   tc.col.shape[1], tc.row_tile),
                    "dkv_dense": ("flash_bwd_dkv", (q, k, v, do, lse, delta, None, m, td.live_cols, gk, gv), 0,
                                  td.col_tile),
                    "dkv_compact": ("flash_dkv_compact",
                                    (q, k, v, do, lse, delta, None, m, tc.col_ptr, tc.row, gk, gv),
                                    tc.row.shape[1], tc.col_tile),
                }
                ms = {}
                for key, (entry, ptrs, tab_len, tile) in calls.items():
                    heads = (td if key.endswith("dense") else tc).heads
                    ms[key] = time_ms(lambda: fa._call(entry, q, ptrs, h, True, scale, mh, heads, tab_len, tile), 10)
                plain_fwd_ms = time_ms(lambda: fa.flash_attention_reference(q, k, v, h, True, scale, mask), 10)
                plain_bwd_ms = time_ms(lambda: fa.flash_attention_backward_reference(
                    q, k, v, out, lse, do, h, True, scale, mask), 10)
                causal = torch.ones(n, n, dtype=torch.bool, device=dev).tril()
                sdpa_mask = (mask & causal) if mask.ndim == 2 else (mask & causal)[None]
                q4, k4, v4 = (t.view(b, h, n, d).detach().requires_grad_(True) for t in (q, k, v))

                def sdpa_fwd():
                    return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=sdpa_mask)

                def sdpa_fwd_bwd():
                    return torch.autograd.grad(sdpa_fwd(), (q4, k4, v4), do.view(b, h, n, d))

                sdpa_ms = time_ms(sdpa_fwd, 10)
                sdpa_bwd_ms = time_ms(sdpa_fwd_bwd, 10) - sdpa_ms
                # live tiles per (batch, head), at each kernel's tile
                live_fwd, live_dkv = tc.live_tiles / tc.heads, tc.live_tiles_dkv / tc.heads
                bound = {
                    "fwd": pattern_bound_ms(bh, n, d, dtype, live_fwd, tc.row_tile, 2, 2, 2, 1),
                    "dq": pattern_bound_ms(bh, n, d, dtype, live_fwd, tc.row_tile, 3, 3, 2, 2),
                    "dkv": pattern_bound_ms(bh, n, d, dtype, live_dkv, tc.col_tile[::-1], 4, 4, 2, 2),
                }
                row = dict(pattern=kind, dtype=str(dtype).replace("torch.", ""), bh=bh, h=h, n=n, d=d,
                           grid_auto="compact" if fa.pattern_tables(mask, n, d, device=dev).compact else "dense",
                           live_tiles=live_fwd, causal_tiles=tc.causal_tiles / tc.heads,
                           live_tiles_dkv=live_dkv, causal_tiles_dkv=tc.causal_tiles_dkv / tc.heads,
                           row_tile=tc.row_tile, col_tile=tc.col_tile, bit_equal=bit_equal,
                           max_abs_err=err, lse_err=lse_err, tolerance=TOLERANCE[dtype],
                           **{f"{gname}_max_abs_err": e[0] for gname, e in bwd_err.items()},
                           **{f"{gname}_err_over_ref_max": e[1] for gname, e in bwd_err.items()},
                           **{f"{key}_ms": value for key, value in ms.items()},
                           plain_fwd_ms=plain_fwd_ms, plain_bwd_ms=plain_bwd_ms, sdpa_fwd_ms=sdpa_ms,
                           sdpa_bwd_ms=sdpa_bwd_ms,
                           **{f"{key}_bound_ms": value[0] for key, value in bound.items()},
                           **{f"{key}_bound_by": value[1] for key, value in bound.items()})
                emit("sparse_kernel_vs_plain", **row)
                results.append(row)
    return results


def generate(fa, dalle, text, cond_scale, img=None):
    """One timed `generate_images` call with every launch counter set to 0
    just before it; returns (its numbers, its launches)."""
    from dalle_pytorch_tpu_torch.models.sampling import DEFAULT_PRIME_FRACTION

    cfg = dalle.cfg
    timings = {}
    reset_launches(fa)
    t0 = time.perf_counter()
    images = dalle.generate_images(text, 3, cond_scale=cond_scale, img=img, timings=timings)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = read_launches(fa)
    check(tuple(images.shape) == (2, 256, 256, 3), f"images of shape {tuple(images.shape)}")
    check(bool(torch.isfinite(images).all()), "non-finite pixels")
    dense_and_compact = launches["flash_fwd"] + launches["flash_fwd_compact"]
    check(dense_and_compact == cfg.depth, f"{dense_and_compact} forward launches for one prefill of depth {cfg.depth}")
    prime_len = 0 if img is None else int(DEFAULT_PRIME_FRACTION * cfg.image_seq_len)
    return dict(cond_scale=cond_scale, primed=img is not None, prefill_s=timings["prefill_s"],
                decode_s=timings["decode_s"], vae_s=timings["vae_s"], total_s=total_s, images_per_s=2 / total_s,
                prefill_len=cfg.text_seq_len + 1 + prime_len,
                decode_tokens_per_s=2 * (cfg.image_seq_len - prime_len) / timings["decode_s"],
                launches=launches), launches


def phase_slice(fa, port):
    """The serving path at full width: generate_images with and without CFG."""
    vae = port.DiscreteVAE(seed=0, **FULL_VAE)
    dalle = port.DALLE(vae=vae, seed=1, **FULL)
    cfg = dalle.cfg
    n_params = sum(p.numel() for p in dalle.module.parameters())
    text = torch.randint(1, cfg.num_text_tokens, (2, cfg.text_seq_len),
                         generator=torch.Generator().manual_seed(2)).cuda()
    text[1, 200:] = 0  # a padded prompt
    runs, total = [], {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for cond_scale in (3.0, 1.0):
        run, launches = generate(fa, dalle, text, cond_scale)
        check(launches["flash_fwd"] == cfg.depth, f"{launches} for one prefill of depth {cfg.depth}")
        runs.append(run)
        total = {key: total.get(key, 0) + value for key, value in launches.items()}
    emit("slice_generate", params=n_params, seq_len=cfg.total_seq_len, vocab=cfg.total_tokens, runs=runs,
         peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    return dalle, text, total


def phase_sparse_generate(fa, tr, port):
    """The serving path of the README's pattern model at full width: two
    prompts (one padded), once with CFG 3.0 (prefill n = 257: every pattern
    row still sees all text, so no tile dies and the pattern layers take the
    dense grid with their masks) and once primed with an image at the
    default prime fraction (448 codes, prefill n = 705: axial_row and
    conv_like kill tiles and take the compacted forward).  Decode gathers
    the keys each pattern row permits."""
    vae = port.DiscreteVAE(seed=0, **FULL_VAE)
    dalle = port.DALLE(vae=vae, seed=1, **SLICE)
    cfg = dalle.cfg
    n_params = sum(p.numel() for p in dalle.module.parameters())
    text = torch.randint(1, cfg.num_text_tokens, (2, cfg.text_seq_len),
                         generator=torch.Generator().manual_seed(12)).cuda()
    text[1, 180:] = 0  # a padded prompt
    pixels = torch.rand(2, vae.image_size, vae.image_size, 3, generator=torch.Generator().manual_seed(13)).cuda()
    pattern_layers = sum(t != "full" for t in cfg.attn_types) * cfg.depth // len(cfg.attn_types)
    runs, total = [], {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for cond_scale, img in ((3.0, None), (1.0, pixels)):
        tr.decode_step.gathers = 0
        run, launches = generate(fa, dalle, text, cond_scale, img)
        gathers = tr.decode_step.gathers
        check(gathers > 0 and gathers % pattern_layers == 0,
              f"{gathers} gather-branch decode steps for {pattern_layers} pattern layers")
        check(launches["flash_fwd_masked"] > 0, f"no masked dense forward in the prefill: {launches}")
        if img is not None:
            check(launches["flash_fwd_compact"] > 0, f"the primed prefill launched no compacted forward: {launches}")
        run.update(gather_decode_layer_steps=gathers)
        runs.append(run)
        total = {key: total.get(key, 0) + value for key, value in launches.items()}
    emit("sparse_generate", params=n_params, seq_len=cfg.total_seq_len, vocab=cfg.total_tokens,
         attn_types=cfg.attn_types, depth=cfg.depth, runs=runs,
         peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    return dalle, text, total


def phase_decode_profile(dalle, text, sampling, phase="decode_profile", steps=32):
    """Where a decode step's time goes: the last `steps` decode steps of a
    CFG generation (primed so that only they remain), under torch.profiler.
    The device's busy share is its summed kernel time over the window's wall
    time; null where the profiler records no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg, model = dalle.cfg, dalle.module
    prime_len = cfg.image_seq_len - steps
    primer = torch.randint(0, cfg.num_image_tokens, (text.shape[0], prime_len),
                           generator=torch.Generator().manual_seed(5)).cuda()
    cache, last_logits = sampling._prefill_phase(model, text, primer, prime_len, 3.0)
    gen = torch.Generator(device=text.device).manual_seed(6)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:  # device events only: least host overhead
        t0 = time.perf_counter()
        sampling._decode_phase(model, cache, last_logits, gen, 0.5, 1.0, 3.0, primer, prime_len, None)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    device_s = sum(e.self_device_time_total for e in kernels) / 1e6
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    launches = sum(e.count for e in kernels)
    emit(phase, steps=steps, window_s=wall_s, step_ms=wall_s / steps * 1e3,
         device_kernel_s=device_s or None,
         device_busy_share=(device_s / wall_s) if device_s else None,
         device_kernel_launches=launches, launches_per_step=launches / steps,
         top_kernels=[dict(name=e.key[:80], device_ms=e.self_device_time_total / 1e3, count=e.count)
                      for e in top],
         note="profiled window: the tracer's host overhead slows the steps")


def phase_forward(fa, dalle, text):
    """The scoring forward at n = 1280, batch 2: logits and the loss."""
    cfg = dalle.cfg
    codes = torch.randint(0, cfg.num_image_tokens, (2, cfg.image_seq_len),
                          generator=torch.Generator().manual_seed(4)).cuda()
    reset_launches(fa)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = dalle(text, codes)
    loss = dalle(text, codes, return_loss=True)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = fa.flash_fwd.launches
    check(tuple(logits.shape) == (2, cfg.total_seq_len, cfg.total_tokens), f"logits {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()) and bool(torch.isfinite(loss)), "non-finite logits or loss")
    check(launches == 2 * cfg.depth, f"{launches} flash_fwd launches for two forwards of depth {cfg.depth}")
    emit("slice_forward", n=cfg.total_seq_len, batch=2, loss=loss.item(), two_forwards_s=elapsed,
         flash_fwd_launches=launches)


SMALL = dict(dim=256, depth=2, heads=4, dim_head=64, num_text_tokens=100, text_seq_len=63,
             attn_types=("full",), rotary_emb=True, shift_tokens=True)
SMALL_VAE = dict(image_size=64, num_tokens=128, num_layers=3)
# a small pattern model: text 63 + a 16 x 16 map (n = 319), where axial_row
# and conv_like kill tiles and take the compacted grid
SMALL_SPARSE = dict(SMALL, depth=4, attn_types=SLICE["attn_types"])
SMALL_SPARSE_VAE = dict(image_size=128, num_tokens=128, num_layers=3)


def phase_parity(fa, port, sampling, phase="slice_parity", small=SMALL, vae_kwargs=SMALL_VAE, prime_len=0):
    """A small model samples on the card (kernel) and on the CPU (plain
    version) under the same gumbel noise; with `prime_len`, from a primed
    prefix."""
    vae_cpu = port.DiscreteVAE(seed=0, device="cpu", **vae_kwargs)
    cpu = port.DALLE(vae=vae_cpu, seed=5, device="cpu", **small)
    gpu = port.DALLE(vae=vae_cpu, seed=5, device="cpu", **small)
    gpu.module.cuda()
    cfg = cpu.cfg
    rng = np.random.default_rng(6)
    text = torch.from_numpy(rng.integers(1, cfg.num_text_tokens, (2, cfg.text_seq_len)))
    primer = torch.from_numpy(rng.integers(0, cfg.num_image_tokens, (2, prime_len))) if prime_len else None
    noise = torch.from_numpy(rng.gumbel(size=(cfg.image_seq_len - prime_len, 2, cfg.total_tokens)).astype(np.float32))

    def on(device):
        return None if primer is None else primer.to(device)

    _, logits_cpu = sampling._prefill_phase(cpu.module, text, primer, prime_len, 3.0)
    reset_launches(fa)
    _, logits_gpu = sampling._prefill_phase(gpu.module, text.cuda(), on("cuda"), prime_len, 3.0)
    prefill_launches = read_launches(fa)
    logit_err = (logits_gpu.cpu() - logits_cpu).abs().max().item()
    check(logit_err <= 1e-4, f"prefill logits differ by {logit_err}")

    codes_cpu = sampling.sample_image_codes(cpu.module, text, cond_scale=3.0, primer_codes=primer,
                                            prime_len=prime_len, noise_override=noise)
    codes_gpu = sampling.sample_image_codes(gpu.module, text.cuda(), cond_scale=3.0, primer_codes=on("cuda"),
                                            prime_len=prime_len, noise_override=noise.cuda()).cpu()
    agree = (codes_cpu == codes_gpu).float().mean().item()
    check(agree >= 0.99, f"only {agree:.4f} of the codes agree between card and CPU")
    emit(phase, prefill_logits_max_abs_err=logit_err, tolerance=1e-4, codes_agree=agree,
         codes=int(codes_cpu.numel()), prime_len=prime_len, prefill_launches=prefill_launches)
    return prefill_launches


def phase_train(fa, port, phase, model_kwargs, steps):
    """The training path at full width: pixels through the frozen VAE, the
    DALL-E loss, backward through the flash kernels, clipping, the guard and
    Adam, on one repeated batch of 4: `steps` steps in f32 compute, as many
    in bf16 compute (the same model, a fresh Adam), then 2 rematerialised
    steps of a fresh remat model.  One more step of each compute dtype runs
    under the profiler for the device-time breakdown.  Each run's launches
    per step must match the layer cycle (`launches_per_step`)."""
    import dataclasses

    from dalle_pytorch_tpu_torch.cli.train_dalle import dalle_loss_fn
    from dalle_pytorch_tpu_torch.models.dalle import DALLEConfig, init_dalle
    from dalle_pytorch_tpu_torch.parallel.train_step import StepSettings, make_train_step

    dev = torch.device("cuda")
    vae = port.DiscreteVAE(seed=0, **FULL_VAE)
    cfg = DALLEConfig.from_vae(vae.cfg, **model_kwargs)
    rng = np.random.default_rng(8)
    text = torch.from_numpy(rng.integers(1, cfg.num_text_tokens, (4, cfg.text_seq_len))).to(dev)
    text[3, 200:] = 0  # a padded caption
    pixels = torch.from_numpy(rng.random((4, vae.image_size, vae.image_size, 3), dtype=np.float32)).to(dev)
    batch = {"text": text, "image": pixels}
    adam = functools.partial(torch.optim.Adam, lr=3e-4, betas=(0.9, 0.999), eps=1e-8)

    def new_model(execution=None):
        model = init_dalle(dataclasses.replace(cfg, execution=execution),
                           torch.Generator(device=dev).manual_seed(1), dev)
        return model.train().requires_grad_(True)

    def run(model, dtype, steps, profile=True):
        init_fn, step_fn = make_train_step(dalle_loss_fn(model, vae.module, dtype), adam,
                                           StepSettings(compute_dtype=dtype, clip_grad_norm=0.5))
        state = init_fn(dict(model.named_parameters()))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches(fa)
        losses, norms, secs = [], [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        launches = read_launches(fa)
        name = str(dtype).replace("torch.", "") + ("_remat" if model.cfg.execution == "remat" else "")
        check(all(np.isfinite(losses)), f"{name}: non-finite loss {losses}")
        per_step = {key: value / steps for key, value in launches.items()}
        want = launches_per_step(cfg, model.cfg.execution)
        check(per_step == want, f"{name}: launches per step {per_step}, the layer cycle gives {want}")
        step_s = statistics.median(secs[1:]) if steps > 2 else secs[-1]
        out = dict(losses=losses, grad_norms=norms, step_s=step_s, first_step_s=secs[0], steps_s=secs,
                   tokens_per_s=4 * cfg.total_seq_len / step_s,
                   peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30, launches_per_step=per_step)
        if profile:
            rows = device_profile(lambda: step_fn(state, batch))
            total = sum(ms for _, ms, _ in rows)
            ours = {key: sum(ms for kname, ms, _ in rows if f"{key}_kernel" in kname)
                    for key in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "flash_fwd_compact",
                                "flash_dq_compact", "flash_dkv_compact")}
            out["profile"] = dict(device_ms=total, flash_ms=ours, flash_share=sum(ours.values()) / total,
                                  top=[dict(name=kname[:90], device_ms=ms, count=c) for kname, ms, c in rows[:8]])
        return out, launches

    model = new_model()
    f32, f32_launches = run(model, torch.float32, steps)
    check(f32["losses"][-1] < f32["losses"][0], f"f32 loss did not fall: {f32['losses']}")
    bf16, bf16_launches = run(model, torch.bfloat16, steps)
    check(bf16["losses"][-1] < bf16["losses"][0], f"bf16 loss did not fall: {bf16['losses']}")
    n_params = sum(p.numel() for p in model.parameters())
    del model
    torch.cuda.empty_cache()
    remat, _ = run(new_model("remat"), torch.float32, 2, profile=False)
    torch.cuda.empty_cache()
    emit(phase, params=n_params, seq_len=cfg.total_seq_len, vocab=cfg.total_tokens, batch=4,
         depth=cfg.depth, attn_types=cfg.attn_types, float32=f32, bfloat16=bf16, remat_float32=remat,
         peak_memory_gib={"sequential_float32": f32["peak_memory_gib"], "remat_float32": remat["peak_memory_gib"]})
    return {key: f32_launches[key] + bf16_launches[key] for key in f32_launches}


def phase_train_parity(fa, port, phase="train_parity", small=SMALL, vae_kwargs=SMALL_VAE):
    """A small model takes the same 3 train steps (Adam 3e-4, clip 0.5) on
    the card, through the kernels, and on the CPU, through the plain
    versions.  Loss and grad norm agree to 1e-4 relative each step."""
    import copy

    from torch.func import functional_call

    from dalle_pytorch_tpu_torch.models.dalle import DALLEConfig, init_dalle
    from dalle_pytorch_tpu_torch.parallel.train_step import StepSettings, make_train_step

    vae_cpu = port.DiscreteVAE(seed=0, device="cpu", **vae_kwargs)
    cfg = DALLEConfig.from_vae(vae_cpu.cfg, **small)
    cpu = init_dalle(cfg, torch.Generator().manual_seed(5), "cpu").train().requires_grad_(True)
    gpu = copy.deepcopy(cpu).cuda()
    rng = np.random.default_rng(9)
    batches = [{"text": torch.from_numpy(rng.integers(0, cfg.num_text_tokens, (2, cfg.text_seq_len))),
                "codes": torch.from_numpy(rng.integers(0, cfg.num_image_tokens, (2, cfg.image_seq_len)))}
               for _ in range(3)]

    def run(model, device):
        def loss_fn(params, batch, generator):
            return functional_call(model, params, (batch["text"], batch["codes"]), {"return_loss": True})

        init_fn, step_fn = make_train_step(loss_fn, functools.partial(torch.optim.Adam, lr=3e-4),
                                           StepSettings(clip_grad_norm=0.5))
        state = init_fn(dict(model.named_parameters()))
        out = []
        for batch in batches:
            state, metrics = step_fn(state, {key: x.to(device) for key, x in batch.items()})
            out.append((float(metrics["loss"]), float(metrics["grad_norm"])))
        return out

    ref = run(cpu, "cpu")
    reset_launches(fa)
    got = run(gpu, "cuda")
    launches = read_launches(fa)
    agree = sum(all(abs(g - r) <= 1e-4 * abs(r) for g, r in zip(gs, rs)) for gs, rs in zip(got, ref))
    param_diff = max((a.detach().cpu() - b.detach()).abs().max().item()
                     for a, b in zip(gpu.parameters(), cpu.parameters()))
    print(f"{phase}: {agree} of {len(batches)} steps agree (loss and grad norm to 1e-4 relative)", flush=True)
    emit(phase, steps=len(batches), steps_agree=agree, tolerance=1e-4, cpu=ref, card=got,
         max_param_diff_after=param_diff, n=cfg.total_seq_len, launches=launches)
    check(agree == len(batches), f"only {agree} of {len(batches)} train steps agree between card and CPU")
    return launches


def phase_train_cli(weights, checkpoint):
    """`python -m dalle_pytorch_tpu_torch.cli.train_dalle --dummy_run 4` in
    a subprocess; its checkpoint loads back through the port's reader."""
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "dalle"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "dalle_pytorch_tpu_torch.cli.train_dalle", "--dummy_run", "4",
             "--dalle_output_file_name", str(out)],
            capture_output=True, text=True, cwd=ROOT, timeout=300,
        )
        seconds = time.perf_counter() - t0
        check(proc.returncode == 0, f"train_dalle exited {proc.returncode}:\n{proc.stderr[-4000:]}")
        steps = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith('{"step"')]
        losses = [s["loss"] for s in steps]
        check(len(steps) == 4 and all(np.isfinite(losses)), f"train_dalle steps {steps}")
        trees, meta = checkpoint.load_checkpoint(f"{out}.pt")
        model, vae = weights.load_dalle_checkpoint(f"{out}.pt")
        text = torch.randint(0, model.cfg.num_text_tokens, (1, model.cfg.text_seq_len), device="cuda")
        with torch.no_grad():
            check(bool(torch.isfinite(model(text)).all()), "the trained checkpoint gives non-finite logits")
    emit("train_cli", rc=proc.returncode, losses=losses, seconds=seconds, trees=sorted(trees),
         global_step=meta["global_step"])


def pattern_readings(sparse, kernel):
    """A kernel's readings at bh 64, n 1280, d 64, f32, one per pattern, from
    `sparse_kernel_vs_plain` (every shape and dtype is in that phase's
    lines)."""
    fields = {  # kernel -> (time, bound, plain, library, error)
        "fwd_dense": ("fwd_dense_ms", "fwd_bound_ms", "plain_fwd_ms", "sdpa_fwd_ms", "max_abs_err"),
        "fwd_compact": ("fwd_compact_ms", "fwd_bound_ms", "plain_fwd_ms", "sdpa_fwd_ms", "max_abs_err"),
        "dq_dense": ("dq_dense_ms", "dq_bound_ms", "plain_bwd_ms", "sdpa_bwd_ms", "dq_max_abs_err"),
        "dq_compact": ("dq_compact_ms", "dq_bound_ms", "plain_bwd_ms", "sdpa_bwd_ms", "dq_max_abs_err"),
        "dkv_dense": ("dkv_dense_ms", "dkv_bound_ms", "plain_bwd_ms", "sdpa_bwd_ms", "dk_max_abs_err"),
        "dkv_compact": ("dkv_compact_ms", "dkv_bound_ms", "plain_bwd_ms", "sdpa_bwd_ms", "dk_max_abs_err"),
    }[kernel]
    tiles = ("live_tiles_dkv", "causal_tiles_dkv") if kernel.startswith("dkv") else ("live_tiles", "causal_tiles")
    return [dict(pattern=r["pattern"], grid_auto=r["grid_auto"], ms=r[fields[0]], bound_ms=r[fields[1]],
                 plain_ms=r[fields[2]], library_ms=r[fields[3]], max_abs_err=r[fields[4]],
                 live_tiles=r[tiles[0]], causal_tiles=r[tiles[1]])
            for r in sparse if r["d"] == 64 and r["dtype"] == "float32"]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "dalle_pytorch_tpu_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import dalle_pytorch_tpu_torch as port
    from dalle_pytorch_tpu_torch import checkpoint, weights
    from dalle_pytorch_tpu_torch.kernels import build
    from dalle_pytorch_tpu_torch.kernels import flash_attention as fa
    from dalle_pytorch_tpu_torch.models import sampling
    from dalle_pytorch_tpu_torch.models import transformer as tr
    from dalle_pytorch_tpu_torch.ops import masks

    phase_environment(build)
    compared = phase_kernel_vs_plain(fa)
    compared_bwd = phase_backward_vs_plain(fa)
    sparse = phase_sparse_kernel_vs_plain(fa, masks)
    paths = {}
    dalle, text, paths["generate"] = phase_slice(fa, port)
    phase_forward(fa, dalle, text)
    phase_decode_profile(dalle, text, sampling)
    del dalle
    phase_parity(fa, port, sampling)
    paths["train"] = phase_train(fa, port, "slice_train", FULL, 6)
    phase_train_parity(fa, port)
    phase_train_cli(weights, checkpoint)

    dalle, text, paths["sparse_generate"] = phase_sparse_generate(fa, tr, port)
    phase_decode_profile(dalle, text, sampling, phase="sparse_decode_profile")
    del dalle
    torch.cuda.empty_cache()
    parity = phase_parity(fa, port, sampling, "sparse_parity", SMALL_SPARSE, SMALL_SPARSE_VAE, prime_len=128)
    check(parity["flash_fwd_compact"] > 0, f"the small pattern model's primed prefill ran no compacted forward: {parity}")
    parity = phase_train_parity(fa, port, "sparse_train_parity", SMALL_SPARSE, SMALL_SPARSE_VAE)
    check(min(parity.values()) > 0, f"the small pattern model's train steps left a kernel unlaunched: {parity}")
    paths["sparse_train"] = phase_train(fa, port, "sparse_train", SLICE, 4)
    check(min(paths["sparse_train"].values()) > 0, f"a kernel was not launched in sparse_train: {paths['sparse_train']}")

    # each kernel at the training shape of the path it runs on; `launches`
    # is its count on this slice's main path, the pattern model's training
    main_shape = next(r for r in compared if r["case"] == "train" and r["dtype"] == "float32")
    prefill = next(r for r in compared if r["case"] == "prefill" and r["dtype"] == "float32")
    bwd = next(r for r in compared_bwd if r["case"] == "train" and r["dtype"] == "float32")
    shape = {k: bwd[k] for k in ("dtype", "bh", "n", "d", "causal")}
    row = next(r for r in sparse if r["pattern"] == "axial_row" and r["d"] == 64 and r["dtype"] == "float32")
    compact_shape = {k: row[k] for k in ("pattern", "dtype", "bh", "n", "d", "live_tiles", "causal_tiles")}
    source_bwd = "dalle_pytorch_tpu_torch/kernels/csrc/flash_bwd.cu"
    source_compact = "dalle_pytorch_tpu_torch/kernels/csrc/flash_compact.cu"
    replaces = "dalle_pytorch_tpu/kernels/flash_attention.py:"

    def launched(name):
        return {"launches": paths["sparse_train"][name],
                "launches_by_path": {path: counts[name] for path, counts in paths.items()}}

    def worst(key, dtype):
        return max(r[key] for r in sparse if r["dtype"] == dtype)

    kernels = [{
        "name": "flash_fwd", "route": "cuda", "source": "dalle_pytorch_tpu_torch/kernels/csrc/flash_fwd.cu",
        "replaces": replaces + "126", **launched("flash_fwd"),
        "masked_launches_by_path": {path: counts["flash_fwd_masked"] for path, counts in paths.items()},
        "max_abs_err": main_shape["max_abs_err"],
        "max_abs_err_all_cases": {r["dtype"]: max(x["max_abs_err"] for x in compared if x["dtype"] == r["dtype"])
                                  for r in compared},
        "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"], "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"], "library_ms": main_shape["library_ms"],
        "shape": {k: main_shape[k] for k in ("dtype", "bh", "n", "d", "causal")},
        "prefill": {k: prefill[k] for k in ("bh", "n", "ms", "plain_ms", "bound_ms", "library_ms")},
        "masked": pattern_readings(sparse, "fwd_dense"),
    }, {
        "name": "flash_dq", "route": "cuda", "source": source_bwd, "replaces": replaces + "276",
        **launched("flash_dq"), "max_abs_err": bwd["dq_max_abs_err"], "ms": bwd["dq_ms"],
        "plain_ms": bwd["plain_ms"], "bound_ms": bwd["dq_bound_ms"], "bound_by": bwd["dq_bound_by"],
        "library_ms": bwd["library_bwd_ms"],
        "note": "plain_ms and library_ms are whole backwards (dq, dk and dv together)", "shape": shape,
        "masked": pattern_readings(sparse, "dq_dense"),
    }, {
        "name": "flash_dkv", "route": "cuda", "source": source_bwd, "replaces": replaces + "312",
        **launched("flash_dkv"), "max_abs_err": max(bwd["dk_max_abs_err"], bwd["dv_max_abs_err"]),
        "ms": bwd["dkv_ms"], "plain_ms": bwd["plain_ms"], "bound_ms": bwd["dkv_bound_ms"],
        "bound_by": bwd["dkv_bound_by"], "library_ms": bwd["library_bwd_ms"],
        "note": "plain_ms and library_ms are whole backwards (dq, dk and dv together)", "shape": shape,
        "masked": pattern_readings(sparse, "dkv_dense"),
    }, {
        "name": "flash_fwd_compact", "route": "cuda", "source": source_compact, "replaces": replaces + "524",
        **launched("flash_fwd_compact"), "max_abs_err": row["max_abs_err"],
        "max_abs_err_all_cases": {dt: worst("max_abs_err", dt) for dt in ("float32", "bfloat16")},
        "ms": row["fwd_compact_ms"], "plain_ms": row["plain_fwd_ms"], "bound_ms": row["fwd_bound_ms"],
        "bound_by": row["fwd_bound_by"], "library_ms": row["sdpa_fwd_ms"], "shape": compact_shape,
        "bit_equal_to_dense_all_cases": all(r["bit_equal"] for r in sparse),
        "by_pattern": pattern_readings(sparse, "fwd_compact"),
    }, {
        "name": "flash_dq_compact", "route": "cuda", "source": source_compact, "replaces": replaces + "723",
        **launched("flash_dq_compact"), "max_abs_err": row["dq_max_abs_err"],
        "err_over_ref_max_all_cases": {dt: worst("dq_err_over_ref_max", dt) for dt in ("float32", "bfloat16")},
        "ms": row["dq_compact_ms"], "plain_ms": row["plain_bwd_ms"], "bound_ms": row["dq_bound_ms"],
        "bound_by": row["dq_bound_by"], "library_ms": row["sdpa_bwd_ms"], "shape": compact_shape,
        "note": "plain_ms and library_ms are whole backwards (dq, dk and dv together)",
        "bit_equal_to_dense_all_cases": all(r["bit_equal"] for r in sparse),
        "by_pattern": pattern_readings(sparse, "dq_compact"),
    }, {
        "name": "flash_dkv_compact", "route": "cuda", "source": source_compact, "replaces": replaces + "758",
        **launched("flash_dkv_compact"), "max_abs_err": max(row["dk_max_abs_err"], row["dv_max_abs_err"]),
        "err_over_ref_max_all_cases": {dt: max(worst("dk_err_over_ref_max", dt), worst("dv_err_over_ref_max", dt))
                                       for dt in ("float32", "bfloat16")},
        "ms": row["dkv_compact_ms"], "plain_ms": row["plain_bwd_ms"], "bound_ms": row["dkv_bound_ms"],
        "bound_by": row["dkv_bound_by"], "library_ms": row["sdpa_bwd_ms"],
        "shape": dict(compact_shape, live_tiles=row["live_tiles_dkv"], causal_tiles=row["causal_tiles_dkv"]),
        "note": "plain_ms and library_ms are whole backwards (dq, dk and dv together)",
        "bit_equal_to_dense_all_cases": all(r["bit_equal"] for r in sparse),
        "by_pattern": pattern_readings(sparse, "dkv_compact"),
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
