#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, counts the
tensor-core instructions (HGMMA) the libraries and each bf16 dq
instantiation hold, holds each kernel against its plain PyTorch version on
the card (the flash forward, and the backward's dq and dk/dv kernels and the
delta the dq kernels write, on the dense grid and, for static attention
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
parity of a small pattern model, and training.  Then the flagship 1.3B
DALL-E (dim 1152, depth 64, 8 heads x 128, the same cycle, tied input and
output embeddings, the VFA forward on the compacted grid): one primed
generation, a decode profile, card-vs-CPU parity of a small model with its
features, and training (bf16 compute sequential and rematerialised, f32
compute rematerialised).  Each path runs with every launch counter set to 0
just before it and read just after.

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
import re
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
VFA_KERNELS = ("flash_max_compact", "flash_fwd_compact_vfa")
# the README quick-start model: pattern attention, depth 16 (each type 4 times)
SLICE = dict(FULL, depth=16, attn_types=("full", "axial_row", "axial_col", "conv_like"))
PATTERNS = ("axial_row", "axial_col", "conv_like", "sparse", "sparse_per_head")

# the flagship 1.3B model (BASELINE.json configs[3], tools/flagship_sweep.py)
FLAGSHIP = dict(dim=1152, depth=64, heads=8, dim_head=128, num_text_tokens=10000, text_seq_len=256,
                attn_types=SLICE["attn_types"], rotary_emb=True, shift_tokens=True,
                share_input_output_emb=True, attn_vfa=True)

# kernels-line name -> (wrapper in kernels/flash_attention.py, its counter);
# flash_fwd_masked counts the flash_fwd launches that took a pattern
COUNTERS = {
    "flash_fwd": ("flash_fwd", "launches"),
    "flash_fwd_masked": ("flash_fwd", "masked_launches"),
    "flash_dq": ("flash_bwd", "dq_launches"),
    "flash_dkv": ("flash_bwd", "dkv_launches"),
    "flash_fwd_compact": ("flash_fwd_compact", "launches"),
    "flash_max_compact": ("flash_fwd_compact", "max_launches"),
    "flash_fwd_compact_vfa": ("flash_fwd_compact", "vfa_launches"),
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


def backward_bound_ms(bh, n, d, dtype, causal, padded, b, products):
    """The least time for one backward kernel: six (bh, n, d) tensors (dq:
    q, k, v, do and out read, dq written; dk/dv: q, k, v and do read, dk and
    dv written), lse and delta (read, or delta written by dq) and the key
    mask each moved once over the memory rate, against its `products` n x n x
    d matrix products (2 flops a multiply-add) over the dtype's peak; the
    larger of the two."""
    esize = torch.tensor([], dtype=dtype).element_size()
    nbytes = 6 * bh * n * d * esize + 2 * bh * n * 4 + (b * n * 4 if padded else 0)
    pairs = n * (n + 1) // 2 if causal else n * n
    flops = products * 2 * bh * pairs * d
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def pattern_bound_ms(bh, n, d, dtype, live_tiles, heads, tile, products, tensors, floats):
    """The least time for one pattern kernel: its `tensors` (bh, n, d)
    inputs and outputs and its `floats` (bh, n) f32 ones each moved once, and
    the pattern's bytes of its `live_tiles` (tile[0] x tile[1]) tiles, over
    `heads` table heads, read once, over the memory rate; against its
    `products` matrix products over the live tiles' elements (2 flops a
    multiply-add) over the dtype's peak; the larger of the two."""
    esize = torch.tensor([], dtype=dtype).element_size()
    tq, tk = tile
    nbytes = tensors * bh * n * d * esize + floats * bh * n * 4 + live_tiles * tq * tk
    flops = products * 2 * bh * live_tiles / heads * tq * tk * d
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def reset_launches(fa) -> None:
    for wrapper, counter in COUNTERS.values():
        setattr(getattr(fa, wrapper), counter, 0)


def read_launches(fa) -> dict:
    return {name: getattr(getattr(fa, wrapper), counter) for name, (wrapper, counter) in COUNTERS.items()}


def forward_launches(model, n):
    """The flash launches of one full-sequence pass of `model` at length n
    and of its backward, from the layer cycle and the grid each pattern
    takes at the model's head dim (`Transformer.attention_inputs`, the
    tables the layers run with): a dense layer launches flash_fwd (counted
    in flash_fwd_masked too when it takes a pattern), then flash_dq and
    flash_dkv; a compacted one flash_fwd_compact or, with attn_vfa,
    flash_max_compact and flash_fwd_compact_vfa, then flash_dq_compact and
    flash_dkv_compact.  Returns (forward launches, backward launches)."""
    from dalle_pytorch_tpu_torch.models.transformer import _pattern_key

    tr, vfa = model.transformer, model.cfg.attn_vfa
    fwd, bwd = dict.fromkeys(COUNTERS, 0), dict.fromkeys(COUNTERS, 0)
    for spec in tr.specs:
        mask, tables = tr.attention_inputs(_pattern_key(spec), n, True, torch.device("cuda"))
        if tables is not None and tables.compact:
            for name in (("flash_max_compact", "flash_fwd_compact_vfa") if vfa else ("flash_fwd_compact",)):
                fwd[name] += 1
            bwd["flash_dq_compact"] += 1
            bwd["flash_dkv_compact"] += 1
        else:
            fwd["flash_fwd"] += 1
            fwd["flash_fwd_masked"] += int(mask is not None)
            bwd["flash_dq"] += 1
            bwd["flash_dkv"] += 1
    return fwd, bwd


def launches_per_step(model, n):
    """The flash launches one training step of `model` at length n makes;
    remat runs each forward twice."""
    fwd, bwd = forward_launches(model, n)
    times = 2 if model.cfg.execution == "remat" else 1
    return {name: times * fwd[name] + bwd[name] for name in COUNTERS}


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


def device_times(calls: dict, reps: int = 10) -> dict:
    """Device ms per call of each of `calls` ({label: fn}), run `reps` times
    each in turn under one profiler window: a label's time sums the port's
    kernels named `<label><...>(flash::Args)`; the label None takes every
    other kernel (a library call).  Unlike `time_ms` it leaves out the host
    time between launches, which bounds a wrapper's calls at small shapes."""
    rows = device_profile(lambda: [fn() for fn in calls.values() for _ in range(reps)])

    def ours(label, name):
        return f"{label}<" in name and "flash::Args" in name

    named = [label for label in calls if label is not None]
    out = {label: sum(ms for name, ms, _ in rows if ours(label, name)) / reps for label in named}
    if None in calls:
        out[None] = sum(ms for name, ms, _ in rows if not any(ours(label, name) for label in named)) / reps
    return out


def sdpa_backend(fn) -> str:
    """Which scaled_dot_product_attention backend fn ran, from its kernels."""
    names = " ".join(name.lower() for name, _, _ in device_profile(fn))
    for pattern, backend in (("cudnn", "cudnn"), ("flash", "flash"), ("fmha", "efficient"),
                             ("mem_eff", "efficient")):
        if pattern in names:
            return backend
    return "math"


def cuobjdump(build, name, *flags) -> str:
    """`cuobjdump` of the built library of `csrc/<name>.cu`."""
    tool = Path(build._nvcc()).with_name("cuobjdump")
    proc = subprocess.run([str(tool), *flags, str(build.library_path(name))], capture_output=True, text=True,
                          timeout=120)
    check(proc.returncode == 0, f"cuobjdump {' '.join(flags)} {name} failed: {proc.stderr}")
    return proc.stdout


# the entries whose bf16 instantiation runs a tensor-core body
TC_ENTRIES = ("flash_fwd_kernel", "flash_fwd_compact_kernel", "flash_bwd_dq_kernel", "flash_dq_compact_kernel",
              "flash_bwd_dkv_kernel", "flash_dkv_compact_kernel")


def instance_key(mangled: str):
    """'<entry> <dtype> d<D>' of an instantiation of an entry in TC_ENTRIES
    from its mangled name, or None for another function."""
    entry = re.search(rf"({'|'.join(TC_ENTRIES)})I(f|13__nv_bfloat16)Li(\d+)E", mangled)
    if entry is None:
        return None
    return f"{entry.group(1)} {'float32' if entry.group(2) == 'f' else 'bfloat16'} d{entry.group(3)}"


def kernel_resources(text: str) -> dict:
    """Registers, stack and local bytes (spills land there) of each
    instantiation of the entries in TC_ENTRIES, from `cuobjdump -res-usage`,
    by `instance_key`."""
    out = {}
    for mangled, reg, stack, local in re.findall(
            r"Function (\S+):\s*REG:(\d+) STACK:(\d+) SHARED:\d+ LOCAL:(\d+)", text):
        key = instance_key(mangled)
        if key:
            out[key] = dict(registers=int(reg), stack_bytes=int(stack), local_bytes=int(local))
    return out


def hgmma_by_instance(sass: str) -> dict:
    """The HGMMA instructions in each instantiation's own SASS (`cuobjdump
    -sass`, one `Function : <mangled>` section each), by `instance_key`."""
    out = {}
    for mangled, body in re.findall(r"Function : (\S+)(.*?)(?=Function : |\Z)", sass, re.S):
        key = instance_key(mangled)
        if key:
            out[key] = sum(" HGMMA." in line for line in body.splitlines())
    return out


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
    build_s = time.perf_counter() - t0
    # the tensor cores are reached only if the libraries hold wgmma (HGMMA
    # in SASS): the bf16 forward, dq and dk/dv bodies
    sass = {name: cuobjdump(build, name, "-sass") for name in compile_s}
    mma = {name: {op: sum(f" {op}." in line for line in text.splitlines()) for op in ("HGMMA", "HMMA")}
           for name, text in sass.items()}
    for name in ("flash_fwd", "flash_bwd", "flash_compact"):
        check(mma[name]["HGMMA"] > 0, f"lib{name} holds no HGMMA instruction: {mma[name]}")
    hgmma = {}
    for name in ("flash_fwd", "flash_bwd", "flash_compact"):
        hgmma.update(hgmma_by_instance(sass[name]))
    resources = {}
    for name in ("flash_fwd", "flash_bwd", "flash_compact"):
        resources.update(kernel_resources(cuobjdump(build, name, "-res-usage")))
    # every bf16 dq and dk/dv instantiation keeps its accumulators in
    # registers, and every bf16 dq instantiation runs wgmma in its own SASS
    for part, label in (("_dq_", "dq"), ("dkv", "dk/dv")):
        bf16 = {key: r for key, r in resources.items() if part in key and "bfloat16" in key}
        check(len(bf16) == 6 and all(r["local_bytes"] == 0 for r in bf16.values()),
              f"the bf16 {label} instantiations spill or are missing: {bf16}")
    dq_hgmma = {key: count for key, count in hgmma.items() if "_dq_" in key and "bfloat16" in key}
    check(len(dq_hgmma) == 6 and min(dq_hgmma.values()) > 0,
          f"a bf16 dq instantiation holds no HGMMA instruction: {dq_hgmma}")
    emit("environment", device=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda, python=sys.version.split()[0],
         kernel_compile_s=compile_s, build_s=build_s, tensor_core_instructions=mma,
         hgmma_by_instance=hgmma, kernel_resources=resources,
         tf32="off (cudnn.allow_tf32=False, matmul precision highest)")


def phase_kernel_vs_plain(fa):
    """flash_fwd against flash_attention_reference at the slices' shapes
    (f32 runs the FMA body, bf16 the tensor-core body), with SDPA's time
    and the backend it took."""
    dev = torch.device("cuda")
    cases = [  # (name, b, h, n, d, causal, padded)
        ("prefill", 4, 16, 257, 64, True, False),  # 2 prompts x CFG, bos + 256 text
        ("forward", 2, 16, 1280, 64, True, False),  # scoring forward, batch 2
        ("padded_noncausal", 2, 16, 300, 64, False, True),
        ("train", 4, 16, 1280, 64, True, False),  # the training step, batch 4
        ("flagship", 4, 8, 1280, 128, True, False),  # the flagship's full layers, batch 4
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

            def kernel():
                return fa.flash_fwd(q, k, v, h=h, causal=causal, key_mask=kmask)

            kernel_ms = time_ms(kernel, reps)
            plain_ms = time_ms(
                lambda: fa.flash_attention_reference(q, k, v, h, causal, d ** -0.5, None, kmask), reps)

            def sdpa():
                return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=sdpa_mask,
                                                      is_causal=causal and sdpa_mask is None)

            library_ms = time_ms(sdpa, reps)
            dtimes = device_times({"flash_fwd_kernel": kernel, None: sdpa})
            bound_ms, bound_by = flash_bound_ms(b * h, n, d, dtype, causal, padded, b)
            row = dict(case=name, dtype=str(dtype).replace("torch.", ""), bh=b * h, n=n, d=d,
                       causal=causal, key_padding=padded, max_abs_err=err, lse_err=lse_err,
                       tolerance=TOLERANCE[dtype], ms=kernel_ms, plain_ms=plain_ms,
                       library_ms=library_ms, device_ms=dtimes["flash_fwd_kernel"], library_device_ms=dtimes[None],
                       sdpa_backend=sdpa_backend(sdpa), bound_ms=bound_ms, bound_by=bound_by)
            emit("kernel_vs_plain", kernel="flash_fwd", **row)
            results.append(row)
    return results


def phase_backward_vs_plain(fa):
    """flash_bwd's two kernels against flash_attention_backward_reference at
    the training shape, the flagship's (d 128), the ragged prefill length and
    a padded non-causal case whose second batch masks every key (rows that
    see no key).  The error is max abs error over the reference's max abs
    value.  The library time is SDPA forward + backward minus SDPA forward,
    same inputs; device times are the kernels' own (`device_times`)."""
    dev = torch.device("cuda")
    cases = [  # (name, b, h, n, d, causal, padded)
        ("train", 4, 16, 1280, 64, True, False),
        ("flagship", 4, 8, 1280, 128, True, False),  # the flagship's full layers, batch 4
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

            dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
            delta = torch.empty_like(lse)
            reps = 20 if n >= 1000 else 50

            def dq_kernel():
                fa._call("flash_bwd_dq", q, (q, k, v, do, out, lse, kmask, None, None, dq, delta), h, causal,
                         scale)

            dq_kernel()
            torch.cuda.synchronize()
            delta_err = delta_error(fa, delta, out, lse, do, v)
            check(delta_err <= 1.0, f"flash_bwd_dq {name} {dtype}: delta at {delta_err} of its limit")

            def dkv_kernel():
                fa._call("flash_bwd_dkv", q, (q, k, v, do, lse, delta, kmask, None, None, dk, dv), h, causal,
                         scale)

            dq_ms, dkv_ms = time_ms(dq_kernel, reps), time_ms(dkv_kernel, reps)
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
            dtimes = device_times({"flash_bwd_dq_kernel": dq_kernel, "flash_bwd_dkv_kernel": dkv_kernel,
                                   None: sdpa_fwd_bwd})
            library_device_ms = dtimes[None] - device_times({None: sdpa_fwd})[None]
            dq_bound, dq_by = backward_bound_ms(b * h, n, d, dtype, causal, padded, b, 3)
            dkv_bound, dkv_by = backward_bound_ms(b * h, n, d, dtype, causal, padded, b, 4)
            row = dict(case=name, dtype=str(dtype).replace("torch.", ""), bh=b * h, n=n, d=d, causal=causal,
                       key_padding=padded, tolerance=TOLERANCE[dtype], delta_err_over_limit=delta_err,
                       **{f"{gname}_max_abs_err": e[0] for gname, e in err.items()},
                       **{f"{gname}_err_over_ref_max": e[1] for gname, e in err.items()},
                       dq_ms=dq_ms, dkv_ms=dkv_ms, dq_device_ms=dtimes["flash_bwd_dq_kernel"],
                       dkv_device_ms=dtimes["flash_bwd_dkv_kernel"], flash_bwd_ms=bwd_ms, plain_ms=plain_ms,
                       library_bwd_ms=library_ms, library_bwd_device_ms=library_device_ms,
                       sdpa_backend=sdpa_backend(sdpa_fwd_bwd),
                       dq_bound_ms=dq_bound, dq_bound_by=dq_by, dkv_bound_ms=dkv_bound, dkv_bound_by=dkv_by)
            emit("kernel_vs_plain", kernel="flash_dq+flash_dkv", **row)
            results.append(row)
    return results


def delta_error(fa, delta, out, lse, do, v) -> float:
    """The largest distance of the dq kernel's delta from `_delta` (the
    plain version) over its limit, `_delta_limit` (another order of f32
    sums): at most 1 where every row is within its limit."""
    diff = (delta.double() - fa._delta(out, lse, do, v).double()).abs()
    return (diff / fa._delta_limit(out, lse, do, v).clamp_min(1e-300)).max().item()


def pattern_mask(masks, kind, n, h):
    """The slice's (n, n) pattern, or (h, n, n) for per-head 'sparse', at
    seq 1280 on the 32 x 32 map."""
    if kind == "sparse":
        return masks.build_block_sparse_mask(n, 32)
    if kind == "sparse_per_head":
        return masks.build_block_sparse_mask(n, 32, heads=h)
    return masks.build_pattern_mask(kind, n, 32)


def vfa_vs_plain(fa, q, k, v, do, mask, h, t, online):
    """The VFA pair on the compacted grid of tables `t`: the max pass's gmax
    against `vfa_max_reference` (1e-4 relative), the fixed-max pass against
    `vfa_fwd_reference` on that gmax and against the online compacted
    kernel's (out, lse) `online` (out at the dtype's tolerance, lse 1e-4),
    the compacted backward run from the VFA lse against the plain backward
    (over the reference's max); then each pass's time against its bound over
    the live tiles and its plain version's."""
    bh, n, d = q.shape
    dtype, scale = q.dtype, d ** -0.5
    out, lse = fa.flash_fwd_compact(q, k, v, t, h, mask=mask, vfa=True)
    m, mh = fa._device_mask(q, mask, h)
    gmax, o, l_ = torch.empty_like(lse), torch.empty_like(q), torch.empty_like(lse)
    tab = (h, True, scale, mh, t.heads, t.col.shape[1], t.row_tile)

    def max_pass():
        fa._call("flash_max_compact", q, (q, k, None, m, t.row_ptr, t.col, gmax), *tab)

    def fixed_max_pass():
        fa._call("flash_fwd_compact_vfa", q, (q, k, v, None, m, t.row_ptr, t.col, gmax, o, l_), *tab)

    max_pass()
    torch.cuda.synchronize()
    name = f"VFA {tuple(q.shape)} {dtype}"
    ref_gmax = fa.vfa_max_reference(q, k, h, True, scale, mask)
    gmax_abs_err = (gmax - ref_gmax).abs()
    gmax_err = (gmax_abs_err / ref_gmax.abs().clamp_min(1.0)).max().item()
    check(gmax_err <= 1e-4, f"{name}: gmax relative error {gmax_err}")
    ref_out, ref_lse = fa.vfa_fwd_reference(q, k, v, gmax, h, True, scale, mask)
    err = (out.float() - ref_out.float()).abs().max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    online_err = (out.float() - online[0].float()).abs().max().item()
    online_lse_err = (lse - online[1]).abs().max().item()
    check(max(err, online_err) <= TOLERANCE[dtype] and max(lse_err, online_lse_err) <= LSE_TOLERANCE,
          f"{name}: out err {err} (online {online_err}), lse err {lse_err} (online {online_lse_err})")
    grads = fa.flash_bwd_compact(q, k, v, out, lse, do, t, h, mask=mask)
    ref = fa.flash_attention_backward_reference(q, k, v, out, lse, do, h, True, scale, mask)
    bwd_err = {g: (a.float() - r.float()).abs().max().item() / r.float().abs().max().item()
               for g, a, r in zip(("dq", "dk", "dv"), grads, ref)}
    check(max(bwd_err.values()) <= TOLERANCE[dtype], f"{name}: backward from the VFA lse {bwd_err}")
    # max pass: q, k in, gmax out; fixed-max pass: q, k, v, gmax in, out, lse out
    max_bound = pattern_bound_ms(bh, n, d, dtype, t.live_tiles, t.heads, t.row_tile, 1, 2, 1)
    fwd_bound = pattern_bound_ms(bh, n, d, dtype, t.live_tiles, t.heads, t.row_tile, 2, 4, 2)
    return dict(vfa_gmax_rel_err=gmax_err, vfa_gmax_max_abs_err=gmax_abs_err.max().item(),
                vfa_max_abs_err=err, vfa_lse_err=lse_err,
                vfa_vs_online_max_abs_err=online_err, vfa_vs_online_lse_err=online_lse_err,
                vfa_bwd_err_over_ref_max=bwd_err,
                vfa_max_ms=time_ms(max_pass, 10), vfa_fwd_ms=time_ms(fixed_max_pass, 10),
                vfa_plain_max_ms=time_ms(lambda: fa.vfa_max_reference(q, k, h, True, scale, mask), 10),
                vfa_plain_fwd_ms=time_ms(lambda: fa.vfa_fwd_reference(q, k, v, gmax, h, True, scale, mask), 10),
                vfa_max_bound_ms=max_bound[0], vfa_max_bound_by=max_bound[1],
                vfa_fwd_bound_ms=fwd_bound[0], vfa_fwd_bound_by=fwd_bound[1])


def phase_sparse_kernel_vs_plain(fa, masks):
    """For each pattern at bh 64, n 1280, d 64 and bh 32, n 1280, d 128, in
    f32 and bf16: forward, dq and dk/dv on the dense grid with the mask and
    on the compacted grid (torch.equal, bit for bit), both against the plain
    versions (forward: max abs error; backward: over the reference's max),
    and their times against the bound over the live tiles, the plain
    versions and SDPA with the boolean mask pattern & causal (forward, and
    forward + backward - forward for the backward).  Where the grid rule
    compacts the pattern, also the VFA pair (`vfa_vs_plain`)."""
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
                o, l_ = torch.empty_like(q), torch.empty_like(lse)
                gq, gk, gv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
                gq2, delta, delta2 = torch.empty_like(q), torch.empty_like(lse), torch.empty_like(lse)
                calls = {
                    "fwd_dense": ("flash_fwd", (q, k, v, None, m, td.live_rows, o, l_), 0, td.row_tile),
                    "fwd_compact": ("flash_fwd_compact", (q, k, v, None, m, tc.row_ptr, tc.col, o, l_),
                                    tc.col.shape[1], tc.row_tile),
                    "dq_dense": ("flash_bwd_dq", (q, k, v, do, out, lse, None, m, td.live_rows, gq, delta), 0,
                                 td.row_tile),
                    "dq_compact": ("flash_dq_compact",
                                   (q, k, v, do, out, lse, None, m, tc.row_ptr, tc.col, gq2, delta2),
                                   tc.col.shape[1], tc.row_tile),
                    "dkv_dense": ("flash_bwd_dkv", (q, k, v, do, lse, delta, None, m, td.live_cols, gk, gv), 0,
                                  td.col_tile),
                    "dkv_compact": ("flash_dkv_compact",
                                    (q, k, v, do, lse, delta, None, m, tc.col_ptr, tc.row, gk, gv),
                                    tc.row.shape[1], tc.col_tile),
                }
                launch = {key: functools.partial(fa._call, entry, q, ptrs, h, True, scale, mh,
                                                 (td if key.endswith("dense") else tc).heads, tab_len, tile)
                          for key, (entry, ptrs, tab_len, tile) in calls.items()}
                # the dq kernels' delta, which dk/dv read: the same bits on both grids, near the plain one
                launch["dq_dense"]()
                launch["dq_compact"]()
                torch.cuda.synchronize()
                check(torch.equal(gq, gq2) and torch.equal(delta, delta2),
                      f"{kind} d {d} {dtype}: the compacted dq kernel's dq or delta differs from the dense one's")
                delta_err = delta_error(fa, delta, out, lse, do, v)
                check(delta_err <= 1.0, f"{kind} d {d} {dtype}: delta at {delta_err} of its limit")
                ms = {key: time_ms(fn, 10) for key, fn in launch.items()}
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
                dtimes = device_times({"flash_fwd_kernel": launch["fwd_dense"],
                                       "flash_fwd_compact_kernel": launch["fwd_compact"],
                                       "flash_bwd_dq_kernel": launch["dq_dense"],
                                       "flash_dq_compact_kernel": launch["dq_compact"],
                                       "flash_bwd_dkv_kernel": launch["dkv_dense"],
                                       "flash_dkv_compact_kernel": launch["dkv_compact"], None: sdpa_fwd})
                sdpa_bwd_device_ms = device_times({None: sdpa_fwd_bwd})[None] - dtimes[None]
                compact_auto = fa.pattern_tables(mask, n, d, device=dev).compact
                vfa = vfa_vs_plain(fa, q, k, v, do, mask, h, tc, res["compact"][:2]) if compact_auto else {}
                # live tiles per (batch, head), at each kernel's tile
                live_fwd, live_dkv = tc.live_tiles / tc.heads, tc.live_tiles_dkv / tc.heads
                bound = {  # fwd: q, k, v, out, lse; dq: q, k, v, do, out, dq, lse, delta; dk/dv: q, k, v, do,
                    # dk, dv, lse, delta
                    "fwd": pattern_bound_ms(bh, n, d, dtype, tc.live_tiles, tc.heads, tc.row_tile, 2, 4, 1),
                    "dq": pattern_bound_ms(bh, n, d, dtype, tc.live_tiles, tc.heads, tc.row_tile, 3, 6, 2),
                    "dkv": pattern_bound_ms(bh, n, d, dtype, tc.live_tiles_dkv, tc.heads, tc.col_tile[::-1], 4, 6, 2),
                }
                row = dict(pattern=kind, dtype=str(dtype).replace("torch.", ""), bh=bh, h=h, n=n, d=d,
                           grid_auto="compact" if compact_auto else "dense",
                           live_tiles=live_fwd, causal_tiles=tc.causal_tiles / tc.heads,
                           live_tiles_dkv=live_dkv, causal_tiles_dkv=tc.causal_tiles_dkv / tc.heads,
                           row_tile=tc.row_tile, col_tile=tc.col_tile, bit_equal=bit_equal,
                           delta_err_over_limit=delta_err,
                           max_abs_err=err, lse_err=lse_err, tolerance=TOLERANCE[dtype],
                           **{f"{gname}_max_abs_err": e[0] for gname, e in bwd_err.items()},
                           **{f"{gname}_err_over_ref_max": e[1] for gname, e in bwd_err.items()},
                           **{f"{key}_ms": value for key, value in ms.items()},
                           plain_fwd_ms=plain_fwd_ms, plain_bwd_ms=plain_bwd_ms, sdpa_fwd_ms=sdpa_ms,
                           sdpa_bwd_ms=sdpa_bwd_ms, fwd_dense_device_ms=dtimes["flash_fwd_kernel"],
                           fwd_compact_device_ms=dtimes["flash_fwd_compact_kernel"], sdpa_fwd_device_ms=dtimes[None],
                           dq_dense_device_ms=dtimes["flash_bwd_dq_kernel"],
                           dq_compact_device_ms=dtimes["flash_dq_compact_kernel"],
                           dkv_dense_device_ms=dtimes["flash_bwd_dkv_kernel"],
                           dkv_compact_device_ms=dtimes["flash_dkv_compact_kernel"],
                           sdpa_bwd_device_ms=sdpa_bwd_device_ms,
                           **{f"{key}_bound_ms": value[0] for key, value in bound.items()},
                           **{f"{key}_bound_by": value[1] for key, value in bound.items()}, **vfa)
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
    prime_len = 0 if img is None else int(DEFAULT_PRIME_FRACTION * cfg.image_seq_len)
    want, _ = forward_launches(dalle.module, cfg.text_seq_len + 1 + prime_len)
    check(launches == want, f"one prefill launched {launches}; its layer cycle gives {want}")
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


def phase_flagship_generate(fa, tr, port):
    """The flagship serves: one `generate_images` call at full width, two
    prompts (one padded) with CFG 3.0, primed with an image at the default
    prime fraction (448 codes, prefill n = 705: axial_row and conv_like
    compact at d 128 and run the VFA pair), then 576 cached decode steps
    and the VAE decode."""
    vae = port.DiscreteVAE(seed=0, **FULL_VAE)
    dalle = port.DALLE(vae=vae, seed=1, **FLAGSHIP)
    cfg = dalle.cfg
    n_params = sum(p.numel() for p in dalle.module.parameters())
    text = torch.randint(1, cfg.num_text_tokens, (2, cfg.text_seq_len),
                         generator=torch.Generator().manual_seed(22)).cuda()
    text[1, 180:] = 0  # a padded prompt
    pixels = torch.rand(2, vae.image_size, vae.image_size, 3, generator=torch.Generator().manual_seed(23)).cuda()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tr.decode_step.gathers = 0
    run, launches = generate(fa, dalle, text, 3.0, pixels)
    check(launches["flash_max_compact"] > 0 and launches["flash_fwd_compact"] == 0,
          f"the flagship's primed prefill did not run the VFA pair: {launches}")
    emit("flagship_generate", params=n_params, seq_len=cfg.total_seq_len, vocab=cfg.total_tokens, depth=cfg.depth,
         heads=cfg.heads, dim_head=cfg.dim_head, attn_types=cfg.attn_types, tied_embeddings=True, attn_vfa=True,
         run=run, gather_decode_layer_steps=tr.decode_step.gathers,
         peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    return dalle, text, launches


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
# a small model with the flagship's features (tied embeddings, d_head 128,
# the four-type cycle, VFA) at n = 319; primed with 128 codes, its prefill
# (n = 192) compacts axial_row at the 64 x 32 tile and runs the VFA pair
SMALL_FLAGSHIP = dict(SMALL_SPARSE, heads=2, dim_head=128, share_input_output_emb=True, attn_vfa=True)


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


def phase_train(fa, port, phase, model_kwargs, runs):
    """The training path at full width: pixels through the frozen VAE, the
    DALL-E loss, backward through the flash kernels, clipping, the guard and
    Adam, on one repeated batch of 4.  `runs`: (execution, compute dtype,
    steps, profile) for each run, each on a fresh model and a fresh Adam;
    the loss must fall over its steps.  With `profile`, one more step runs
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

    def run(model, dtype, steps, profile):
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
        check(losses[-1] < losses[0], f"{name}: the loss did not fall: {losses}")
        per_step = {key: value / steps for key, value in launches.items()}
        want = launches_per_step(model, cfg.total_seq_len)
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
                                "flash_max_compact", "flash_fwd_compact_vfa", "flash_dq_compact",
                                "flash_dkv_compact")}
            out["profile"] = dict(device_ms=total, flash_ms=ours, flash_share=sum(ours.values()) / total,
                                  top=[dict(name=kname[:90], device_ms=ms, count=c) for kname, ms, c in rows[:8]])
        return name, out, launches

    results, total, n_params = {}, dict.fromkeys(COUNTERS, 0), None
    for execution, dtype, steps, profile in runs:
        model = init_dalle(dataclasses.replace(cfg, execution=execution),
                           torch.Generator(device=dev).manual_seed(1), dev).train().requires_grad_(True)
        n_params = sum(p.numel() for p in model.parameters())
        name, results[name], launches = run(model, dtype, steps, profile)
        total = {key: total[key] + launches[key] for key in COUNTERS}
        del model
        torch.cuda.empty_cache()
    emit(phase, params=n_params, seq_len=cfg.total_seq_len, vocab=cfg.total_tokens, batch=4,
         depth=cfg.depth, attn_types=cfg.attn_types, **results,
         peak_memory_gib={name: r["peak_memory_gib"] for name, r in results.items()})
    return total


def standard_runs(steps):
    """f32 then bf16 compute for `steps` steps each (the first profiled),
    then 2 rematerialised f32 steps."""
    return [(None, torch.float32, steps, True), (None, torch.bfloat16, steps, True), ("remat", torch.float32, 2, False)]


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


def pattern_readings(sparse, kernel, d=64):
    """A kernel's readings at n 1280, f32, head dim d (bh 64 at d 64, 32 at
    d 128), one per pattern that runs it, from `sparse_kernel_vs_plain`
    (every shape and dtype is in that phase's lines)."""
    fields = {  # kernel -> (time, bound, plain, library, error)
        "fwd_dense": ("fwd_dense_ms", "fwd_bound_ms", "plain_fwd_ms", "sdpa_fwd_ms", "max_abs_err"),
        "fwd_compact": ("fwd_compact_ms", "fwd_bound_ms", "plain_fwd_ms", "sdpa_fwd_ms", "max_abs_err"),
        "dq_dense": ("dq_dense_ms", "dq_bound_ms", "plain_bwd_ms", "sdpa_bwd_ms", "dq_max_abs_err"),
        "dq_compact": ("dq_compact_ms", "dq_bound_ms", "plain_bwd_ms", "sdpa_bwd_ms", "dq_max_abs_err"),
        "dkv_dense": ("dkv_dense_ms", "dkv_bound_ms", "plain_bwd_ms", "sdpa_bwd_ms", "dk_max_abs_err"),
        "dkv_compact": ("dkv_compact_ms", "dkv_bound_ms", "plain_bwd_ms", "sdpa_bwd_ms", "dk_max_abs_err"),
        "vfa_max": ("vfa_max_ms", "vfa_max_bound_ms", "vfa_plain_max_ms", "sdpa_fwd_ms", "vfa_gmax_rel_err"),
        "vfa_fwd": ("vfa_fwd_ms", "vfa_fwd_bound_ms", "vfa_plain_fwd_ms", "sdpa_fwd_ms", "vfa_max_abs_err"),
    }[kernel]
    tiles = ("live_tiles_dkv", "causal_tiles_dkv") if kernel.startswith("dkv") else ("live_tiles", "causal_tiles")
    return [dict(pattern=r["pattern"], grid_auto=r["grid_auto"], ms=r[fields[0]], bound_ms=r[fields[1]],
                 plain_ms=r[fields[2]], library_ms=r[fields[3]], max_abs_err=r[fields[4]],
                 live_tiles=r[tiles[0]], causal_tiles=r[tiles[1]])
            for r in sparse if r["d"] == d and r["dtype"] == "float32" and fields[0] in r]


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
    paths["train"] = phase_train(fa, port, "slice_train", FULL, standard_runs(6))
    phase_train_parity(fa, port)
    phase_train_cli(weights, checkpoint)

    dalle, text, paths["sparse_generate"] = phase_sparse_generate(fa, tr, port)
    phase_decode_profile(dalle, text, sampling, phase="sparse_decode_profile")
    del dalle
    torch.cuda.empty_cache()
    parity = phase_parity(fa, port, sampling, "sparse_parity", SMALL_SPARSE, SMALL_SPARSE_VAE, prime_len=128)
    check(parity["flash_fwd_compact"] > 0, f"the small pattern model's primed prefill ran no compacted forward: {parity}")
    online = [name for name in COUNTERS if name not in VFA_KERNELS]
    parity = phase_train_parity(fa, port, "sparse_train_parity", SMALL_SPARSE, SMALL_SPARSE_VAE)
    check(min(parity[k] for k in online) > 0,
          f"the small pattern model's train steps left a kernel unlaunched: {parity}")
    paths["sparse_train"] = phase_train(fa, port, "sparse_train", SLICE, standard_runs(4))
    check(min(paths["sparse_train"][k] for k in online) > 0,
          f"a kernel was not launched in sparse_train: {paths['sparse_train']}")

    dalle, text, paths["flagship_generate"] = phase_flagship_generate(fa, tr, port)
    phase_decode_profile(dalle, text, sampling, phase="flagship_decode_profile", steps=16)
    del dalle
    torch.cuda.empty_cache()
    parity = phase_parity(fa, port, sampling, "flagship_parity", SMALL_FLAGSHIP, SMALL_SPARSE_VAE, prime_len=128)
    check(min(parity[k] for k in VFA_KERNELS) > 0, f"the small flagship's primed prefill ran no VFA pair: {parity}")
    parity = phase_train_parity(fa, port, "flagship_train_parity", SMALL_FLAGSHIP, SMALL_SPARSE_VAE)
    check(min(parity[k] for k in VFA_KERNELS) > 0, f"the small flagship's train steps ran no VFA pair: {parity}")
    paths["flagship_train"] = phase_train(fa, port, "flagship_train", FLAGSHIP, [
        (None, torch.bfloat16, 4, True), ("remat", torch.bfloat16, 3, False), ("remat", torch.float32, 3, False)])

    # each kernel at the training shape of the path it runs on; `launches`
    # is its count on this slice's main path, the flagship's training (the
    # online compacted forward, which VFA replaces there: the pattern
    # model's training)
    main_shape = next(r for r in compared if r["case"] == "train" and r["dtype"] == "float32")
    fwd_keys = ("bh", "n", "d", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "library_device_ms", "sdpa_backend", "max_abs_err", "lse_err")
    fwd_bf16 = {case: {k: r[k] for k in fwd_keys} for case in ("train", "flagship")
                for r in compared if r["case"] == case and r["dtype"] == "bfloat16"}
    prefill = next(r for r in compared if r["case"] == "prefill" and r["dtype"] == "float32")
    bwd = next(r for r in compared_bwd if r["case"] == "train" and r["dtype"] == "float32")
    dkv_keys = ("bh", "n", "d", "dkv_ms", "dkv_device_ms", "plain_ms", "dkv_bound_ms", "dkv_bound_by",
                "library_bwd_ms", "library_bwd_device_ms", "sdpa_backend", "dk_err_over_ref_max", "dv_err_over_ref_max")
    dkv_bf16 = {case: {k: r[k] for k in dkv_keys} for case in ("train", "flagship")
                for r in compared_bwd if r["case"] == case and r["dtype"] == "bfloat16"}
    dq_keys = ("bh", "n", "d", "dq_ms", "dq_device_ms", "plain_ms", "dq_bound_ms", "dq_bound_by",
               "library_bwd_ms", "library_bwd_device_ms", "sdpa_backend", "dq_err_over_ref_max",
               "delta_err_over_limit")
    dq_bf16 = {case: {k: r[k] for k in dq_keys} for case in ("train", "flagship")
               for r in compared_bwd if r["case"] == case and r["dtype"] == "bfloat16"}
    shape = {k: bwd[k] for k in ("dtype", "bh", "n", "d", "causal")}
    row = next(r for r in sparse if r["pattern"] == "axial_row" and r["d"] == 64 and r["dtype"] == "float32")
    compact_bf16 = {d: {"ms": r["fwd_compact_ms"], "device_ms": r["fwd_compact_device_ms"],
                        "dense_grid_ms": r["fwd_dense_ms"], "dense_grid_device_ms": r["fwd_dense_device_ms"],
                        "plain_ms": r["plain_fwd_ms"], "bound_ms": r["fwd_bound_ms"], "bound_by": r["fwd_bound_by"],
                        "library_ms": r["sdpa_fwd_ms"], "library_device_ms": r["sdpa_fwd_device_ms"],
                        "max_abs_err": r["max_abs_err"], "lse_err": r["lse_err"], "bh": r["bh"]}
                    for r in sparse if r["pattern"] == "axial_row" and r["dtype"] == "bfloat16" for d in [r["d"]]}
    dq_compact_bf16 = {d: {"ms": r["dq_compact_ms"], "device_ms": r["dq_compact_device_ms"],
                           "dense_grid_ms": r["dq_dense_ms"], "dense_grid_device_ms": r["dq_dense_device_ms"],
                           "plain_ms": r["plain_bwd_ms"], "bound_ms": r["dq_bound_ms"], "bound_by": r["dq_bound_by"],
                           "library_ms": r["sdpa_bwd_ms"], "library_device_ms": r["sdpa_bwd_device_ms"],
                           "dq_err_over_ref_max": r["dq_err_over_ref_max"], "bh": r["bh"]}
                       for r in sparse if r["pattern"] == "axial_row" and r["dtype"] == "bfloat16" for d in [r["d"]]}
    dkv_compact_bf16 = {d: {"ms": r["dkv_compact_ms"], "device_ms": r["dkv_compact_device_ms"],
                            "dense_grid_ms": r["dkv_dense_ms"], "dense_grid_device_ms": r["dkv_dense_device_ms"],
                            "plain_ms": r["plain_bwd_ms"], "bound_ms": r["dkv_bound_ms"], "bound_by": r["dkv_bound_by"],
                            "library_ms": r["sdpa_bwd_ms"], "library_device_ms": r["sdpa_bwd_device_ms"],
                            "dk_err_over_ref_max": r["dk_err_over_ref_max"],
                            "dv_err_over_ref_max": r["dv_err_over_ref_max"], "bh": r["bh"]}
                        for r in sparse if r["pattern"] == "axial_row" and r["dtype"] == "bfloat16" for d in [r["d"]]}
    compact_shape = {k: row[k] for k in ("pattern", "dtype", "bh", "n", "d", "live_tiles", "causal_tiles")}
    source_bwd = "dalle_pytorch_tpu_torch/kernels/csrc/flash_bwd.cu"
    source_compact = "dalle_pytorch_tpu_torch/kernels/csrc/flash_compact.cu"
    replaces = "dalle_pytorch_tpu/kernels/flash_attention.py:"

    def launched(name, path="flagship_train"):
        return {"launches": paths[path][name], "launches_path": path,
                "launches_by_path": {p: counts[name] for p, counts in paths.items()}}

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
        "sdpa_backend": main_shape["sdpa_backend"],
        "shape": {k: main_shape[k] for k in ("dtype", "bh", "n", "d", "causal")},
        "bf16_tensor_cores": fwd_bf16,
        "prefill": {k: prefill[k] for k in ("bh", "n", "ms", "plain_ms", "bound_ms", "library_ms")},
        "masked": pattern_readings(sparse, "fwd_dense"),
    }, {
        "name": "flash_dq", "route": "cuda", "source": source_bwd, "replaces": replaces + "276",
        **launched("flash_dq"), "max_abs_err": bwd["dq_max_abs_err"], "ms": bwd["dq_ms"],
        "plain_ms": bwd["plain_ms"], "bound_ms": bwd["dq_bound_ms"], "bound_by": bwd["dq_bound_by"],
        "library_ms": bwd["library_bwd_ms"],
        "note": "plain_ms and library_ms are whole backwards (dq, dk and dv together)", "shape": shape,
        "delta_err_over_limit_all_cases": max(r["delta_err_over_limit"] for r in compared_bwd + sparse),
        "bf16_tensor_cores": dq_bf16, "masked": pattern_readings(sparse, "dq_dense"),
    }, {
        "name": "flash_dkv", "route": "cuda", "source": source_bwd, "replaces": replaces + "312",
        **launched("flash_dkv"), "max_abs_err": max(bwd["dk_max_abs_err"], bwd["dv_max_abs_err"]),
        "ms": bwd["dkv_ms"], "plain_ms": bwd["plain_ms"], "bound_ms": bwd["dkv_bound_ms"],
        "bound_by": bwd["dkv_bound_by"], "library_ms": bwd["library_bwd_ms"],
        "note": "plain_ms and library_ms are whole backwards (dq, dk and dv together)", "shape": shape,
        "bf16_tensor_cores": dkv_bf16, "masked": pattern_readings(sparse, "dkv_dense"),
    }, {
        "name": "flash_fwd_compact", "route": "cuda", "source": source_compact, "replaces": replaces + "524",
        **launched("flash_fwd_compact", "sparse_train"), "max_abs_err": row["max_abs_err"],
        "max_abs_err_all_cases": {dt: worst("max_abs_err", dt) for dt in ("float32", "bfloat16")},
        "ms": row["fwd_compact_ms"], "plain_ms": row["plain_fwd_ms"], "bound_ms": row["fwd_bound_ms"],
        "bound_by": row["fwd_bound_by"], "library_ms": row["sdpa_fwd_ms"], "shape": compact_shape,
        "bit_equal_to_dense_all_cases": all(r["bit_equal"] for r in sparse),
        "bf16_tensor_cores_axial_row": compact_bf16,
        "by_pattern": pattern_readings(sparse, "fwd_compact"),
    }, {
        "name": "flash_dq_compact", "route": "cuda", "source": source_compact, "replaces": replaces + "723",
        **launched("flash_dq_compact"), "max_abs_err": row["dq_max_abs_err"],
        "err_over_ref_max_all_cases": {dt: worst("dq_err_over_ref_max", dt) for dt in ("float32", "bfloat16")},
        "ms": row["dq_compact_ms"], "plain_ms": row["plain_bwd_ms"], "bound_ms": row["dq_bound_ms"],
        "bound_by": row["dq_bound_by"], "library_ms": row["sdpa_bwd_ms"], "shape": compact_shape,
        "note": "plain_ms and library_ms are whole backwards (dq, dk and dv together)",
        "bit_equal_to_dense_all_cases": all(r["bit_equal"] for r in sparse),
        "bf16_tensor_cores_axial_row": dq_compact_bf16, "by_pattern": pattern_readings(sparse, "dq_compact"),
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
        "bf16_tensor_cores_axial_row": dkv_compact_bf16, "by_pattern": pattern_readings(sparse, "dkv_compact"),
    }]
    vfa = next(r for r in sparse if r["pattern"] == "axial_row" and r["d"] == 128 and r["dtype"] == "float32")
    vfa_shape = {k: vfa[k] for k in ("pattern", "dtype", "bh", "n", "d", "live_tiles", "causal_tiles")}

    def worst_vfa(key, dtype):
        return max(r[key] for r in sparse if r["dtype"] == dtype and key in r)

    kernels += [{
        "name": "flash_max_compact", "route": "cuda", "source": source_compact, "replaces": replaces + "564",
        **launched("flash_max_compact"), "max_abs_err": vfa["vfa_gmax_max_abs_err"],
        "rel_err_all_cases": {dt: worst_vfa("vfa_gmax_rel_err", dt) for dt in ("float32", "bfloat16")},
        "ms": vfa["vfa_max_ms"], "plain_ms": vfa["vfa_plain_max_ms"], "bound_ms": vfa["vfa_max_bound_ms"],
        "bound_by": vfa["vfa_max_bound_by"], "library_ms": vfa["sdpa_fwd_ms"], "shape": vfa_shape,
        "note": "library_ms is a whole forward (SDPA with the mask pattern & causal)",
        "by_pattern": pattern_readings(sparse, "vfa_max", 128),
    }, {
        "name": "flash_fwd_compact_vfa", "route": "cuda", "source": source_compact, "replaces": replaces + "595",
        **launched("flash_fwd_compact_vfa"), "max_abs_err": vfa["vfa_max_abs_err"],
        "max_abs_err_all_cases": {dt: worst_vfa("vfa_max_abs_err", dt) for dt in ("float32", "bfloat16")},
        "vs_online_max_abs_err_all_cases": {dt: worst_vfa("vfa_vs_online_max_abs_err", dt)
                                            for dt in ("float32", "bfloat16")},
        "ms": vfa["vfa_fwd_ms"], "plain_ms": vfa["vfa_plain_fwd_ms"], "bound_ms": vfa["vfa_fwd_bound_ms"],
        "bound_by": vfa["vfa_fwd_bound_by"], "library_ms": vfa["sdpa_fwd_ms"], "shape": vfa_shape,
        "online_compact_ms": vfa["fwd_compact_ms"], "by_pattern": pattern_readings(sparse, "vfa_fwd", 128),
    }]
    unlaunched = [k["name"] for k in kernels if k["launches"] <= 0]
    check(not unlaunched, f"kernels never launched on their path: {unlaunched}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
