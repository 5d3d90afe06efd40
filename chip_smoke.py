#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds each
against its plain PyTorch version on the card (the flash forward, and the
backward's dq and dk/dv kernels), drives the serving path at the full width
of the 12-layer DALL-E (dim 1024, 16 heads, seq 1280, OpenAI-dVAE geometry,
seeded random weights) through `DALLE.generate_images`, runs the scoring
forward at n = 1280, checks a small model's sampling on the card against the
same model on the CPU, trains the full-width model (f32 and bf16 compute,
then rematerialised), holds a small model's train steps on the card against
the CPU, and runs the training CLI's dummy run.

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


def reset_launches(fa) -> None:
    fa.flash_fwd.launches = 0
    fa.flash_bwd.dq_launches = 0
    fa.flash_bwd.dkv_launches = 0


def read_launches(fa) -> dict:
    return {"flash_fwd": fa.flash_fwd.launches, "flash_dq": fa.flash_bwd.dq_launches,
            "flash_dkv": fa.flash_bwd.dkv_launches}


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
            dq_ms = time_ms(lambda: fa._call("flash_bwd_dq", q, (q, k, v, do, lse, delta, kmask, dq),
                                             h, causal, scale), reps)
            dkv_ms = time_ms(lambda: fa._call("flash_bwd_dkv", q, (q, k, v, do, lse, delta, kmask, dk, dv),
                                              h, causal, scale), reps)
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


def phase_slice(fa, port):
    """The serving path at full width: generate_images with and without CFG."""
    vae = port.DiscreteVAE(seed=0, **FULL_VAE)
    dalle = port.DALLE(vae=vae, seed=1, **FULL)
    cfg = dalle.cfg
    n_params = sum(p.numel() for p in dalle.module.parameters())
    text = torch.randint(1, cfg.num_text_tokens, (2, cfg.text_seq_len),
                         generator=torch.Generator().manual_seed(2)).cuda()
    text[1, 200:] = 0  # a padded prompt
    runs = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.flash_fwd.launches = 0
    for cond_scale in (3.0, 1.0):
        before = fa.flash_fwd.launches
        timings = {}
        t0 = time.perf_counter()
        images = dalle.generate_images(text, 3, cond_scale=cond_scale, timings=timings)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        launches = fa.flash_fwd.launches - before
        check(tuple(images.shape) == (2, 256, 256, 3), f"images of shape {tuple(images.shape)}")
        check(bool(torch.isfinite(images).all()), "non-finite pixels")
        check(launches == cfg.depth, f"{launches} flash_fwd launches for one prefill of depth {cfg.depth}")
        runs.append(dict(cond_scale=cond_scale, prefill_s=timings["prefill_s"], decode_s=timings["decode_s"],
                         vae_s=timings["vae_s"], total_s=total_s, images_per_s=2 / total_s,
                         decode_tokens_per_s=2 * cfg.image_seq_len / timings["decode_s"],
                         flash_fwd_launches=launches))
    main_path_launches = fa.flash_fwd.launches
    emit("slice_generate", params=n_params, seq_len=cfg.total_seq_len, vocab=cfg.total_tokens,
         prefill_len=cfg.text_seq_len + 1, runs=runs,
         peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    return dalle, text, main_path_launches


def phase_decode_profile(dalle, text, sampling, steps=32):
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
    emit("decode_profile", steps=steps, window_s=wall_s, step_ms=wall_s / steps * 1e3,
         device_kernel_s=device_s or None,
         device_busy_share=(device_s / wall_s) if device_s else None,
         device_kernel_launches=sum(e.count for e in kernels),
         top_kernels=[dict(name=e.key[:80], device_ms=e.self_device_time_total / 1e3, count=e.count)
                      for e in top],
         note="profiled window: the tracer's host overhead slows the steps")


def phase_forward(fa, dalle, text):
    """The scoring forward at n = 1280, batch 2: logits and the loss."""
    cfg = dalle.cfg
    codes = torch.randint(0, cfg.num_image_tokens, (2, cfg.image_seq_len),
                          generator=torch.Generator().manual_seed(4)).cuda()
    fa.flash_fwd.launches = 0
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


def phase_parity(port, sampling):
    """A small model samples on the card (kernel) and on the CPU (plain
    version) under the same gumbel noise."""
    small = dict(dim=256, depth=2, heads=4, dim_head=64, num_text_tokens=100, text_seq_len=63,
                 attn_types=("full",), rotary_emb=True, shift_tokens=True)
    vae_cpu = port.DiscreteVAE(seed=0, device="cpu", image_size=64, num_tokens=128, num_layers=3)
    cpu = port.DALLE(vae=vae_cpu, seed=5, device="cpu", **small)
    gpu = port.DALLE(vae=vae_cpu, seed=5, device="cpu", **small)
    gpu.module.cuda()
    cfg = cpu.cfg
    rng = np.random.default_rng(6)
    text = torch.from_numpy(rng.integers(1, cfg.num_text_tokens, (2, cfg.text_seq_len)))
    noise = torch.from_numpy(rng.gumbel(size=(cfg.image_seq_len, 2, cfg.total_tokens)).astype(np.float32))

    _, logits_cpu = sampling._prefill_phase(cpu.module, text, None, 0, 3.0)
    _, logits_gpu = sampling._prefill_phase(gpu.module, text.cuda(), None, 0, 3.0)
    logit_err = (logits_gpu.cpu() - logits_cpu).abs().max().item()
    check(logit_err <= 1e-4, f"prefill logits differ by {logit_err}")

    codes_cpu = sampling.sample_image_codes(cpu.module, text, cond_scale=3.0, noise_override=noise)
    codes_gpu = sampling.sample_image_codes(gpu.module, text.cuda(), cond_scale=3.0,
                                            noise_override=noise.cuda()).cpu()
    agree = (codes_cpu == codes_gpu).float().mean().item()
    check(agree >= 0.99, f"only {agree:.4f} of the codes agree between card and CPU")
    emit("slice_parity", prefill_logits_max_abs_err=logit_err, tolerance=1e-4,
         codes_agree=agree, codes=int(codes_cpu.numel()))


def phase_slice_train(fa, port):
    """The training path at full width: pixels through the frozen VAE, the
    DALL-E loss, backward through the flash kernels, clipping, the guard and
    Adam, on one repeated batch of 4: 6 steps in f32 compute, 6 in bf16
    compute (the same model, a fresh Adam), then 2 rematerialised steps of a
    fresh remat model.  One more step of each compute dtype runs under the
    profiler for the device-time breakdown."""
    import dataclasses

    from dalle_pytorch_tpu_torch.cli.train_dalle import dalle_loss_fn
    from dalle_pytorch_tpu_torch.models.dalle import DALLEConfig, init_dalle
    from dalle_pytorch_tpu_torch.parallel.train_step import StepSettings, make_train_step

    dev = torch.device("cuda")
    vae = port.DiscreteVAE(seed=0, **FULL_VAE)
    cfg = DALLEConfig.from_vae(vae.cfg, **FULL)
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
        fwd_per_layer = 2 if model.cfg.execution == "remat" else 1
        check(per_step == {"flash_fwd": fwd_per_layer * cfg.depth, "flash_dq": cfg.depth, "flash_dkv": cfg.depth},
              f"{name}: launches per step {per_step}")
        step_s = statistics.median(secs[1:]) if steps > 2 else secs[-1]
        out = dict(losses=losses, grad_norms=norms, step_s=step_s, first_step_s=secs[0], steps_s=secs,
                   tokens_per_s=4 * cfg.total_seq_len / step_s,
                   peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30, launches=launches)
        if profile:
            rows = device_profile(lambda: step_fn(state, batch))
            total = sum(ms for _, ms, _ in rows)
            ours = {key: sum(ms for kname, ms, _ in rows if f"{key}_kernel" in kname)
                    for key in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
            out["profile"] = dict(device_ms=total, flash_ms=ours, flash_share=sum(ours.values()) / total,
                                  top=[dict(name=kname[:90], device_ms=ms, count=c) for kname, ms, c in rows[:8]])
        return out, launches

    model = new_model()
    f32, f32_launches = run(model, torch.float32, 6)
    check(f32["losses"][-1] < f32["losses"][0], f"f32 loss did not fall: {f32['losses']}")
    bf16, bf16_launches = run(model, torch.bfloat16, 6)
    check(bf16["losses"][-1] < bf16["losses"][0], f"bf16 loss did not fall: {bf16['losses']}")
    n_params = sum(p.numel() for p in model.parameters())
    del model
    torch.cuda.empty_cache()
    remat, _ = run(new_model("remat"), torch.float32, 2, profile=False)
    torch.cuda.empty_cache()
    emit("slice_train", params=n_params, seq_len=cfg.total_seq_len, vocab=cfg.total_tokens, batch=4,
         depth=cfg.depth, float32=f32, bfloat16=bf16, remat_float32=remat,
         peak_memory_gib={"sequential_float32": f32["peak_memory_gib"], "remat_float32": remat["peak_memory_gib"]})
    return {key: f32_launches[key] + bf16_launches[key] for key in f32_launches}


def phase_train_parity(port):
    """A small model (dim 256, depth 2, text 63 + an 8 x 8 map) takes the
    same 3 train steps (Adam 3e-4, clip 0.5) on the card, through the
    kernels, and on the CPU, through the plain versions.  Loss and grad
    norm agree to 1e-4 relative each step."""
    import copy

    from torch.func import functional_call

    from dalle_pytorch_tpu_torch.models.dalle import DALLEConfig, init_dalle
    from dalle_pytorch_tpu_torch.parallel.train_step import StepSettings, make_train_step

    small = dict(dim=256, depth=2, heads=4, dim_head=64, num_text_tokens=100, text_seq_len=63,
                 attn_types=("full",), rotary_emb=True, shift_tokens=True)
    vae_cpu = port.DiscreteVAE(seed=0, device="cpu", image_size=64, num_tokens=128, num_layers=3)
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

    ref, got = run(cpu, "cpu"), run(gpu, "cuda")
    agree = sum(all(abs(g - r) <= 1e-4 * abs(r) for g, r in zip(gs, rs)) for gs, rs in zip(got, ref))
    param_diff = max((a.detach().cpu() - b.detach()).abs().max().item()
                     for a, b in zip(gpu.parameters(), cpu.parameters()))
    print(f"train_parity: {agree} of {len(batches)} steps agree (loss and grad norm to 1e-4 relative)",
          flush=True)
    emit("train_parity", steps=len(batches), steps_agree=agree, tolerance=1e-4, cpu=ref, card=got,
         max_param_diff_after=param_diff)
    check(agree == len(batches), f"only {agree} of {len(batches)} train steps agree between card and CPU")


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

    phase_environment(build)
    compared = phase_kernel_vs_plain(fa)
    compared_bwd = phase_backward_vs_plain(fa)
    dalle, text, launches = phase_slice(fa, port)
    phase_forward(fa, dalle, text)
    phase_decode_profile(dalle, text, sampling)
    del dalle
    phase_parity(port, sampling)
    train_launches = phase_slice_train(fa, port)
    phase_train_parity(port)
    phase_train_cli(weights, checkpoint)

    # the kernels line reads each kernel at the training shape, the main path
    # of this slice; flash_fwd also keeps its serving (prefill) reading
    main_shape = next(r for r in compared if r["case"] == "train" and r["dtype"] == "float32")
    prefill = next(r for r in compared if r["case"] == "prefill" and r["dtype"] == "float32")
    bwd = next(r for r in compared_bwd if r["case"] == "train" and r["dtype"] == "float32")
    shape = {k: bwd[k] for k in ("dtype", "bh", "n", "d", "causal")}
    source_bwd = "dalle_pytorch_tpu_torch/kernels/csrc/flash_bwd.cu"
    kernels = [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "dalle_pytorch_tpu_torch/kernels/csrc/flash_fwd.cu",
        "replaces": "dalle_pytorch_tpu/kernels/flash_attention.py:126",
        "launches": train_launches["flash_fwd"],
        "launches_by_path": {"generate": launches, "train": train_launches["flash_fwd"]},
        "max_abs_err": main_shape["max_abs_err"],
        "max_abs_err_all_cases": {r["dtype"]: max(x["max_abs_err"] for x in compared if x["dtype"] == r["dtype"])
                                  for r in compared},
        "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": main_shape["library_ms"],
        "shape": {k: main_shape[k] for k in ("dtype", "bh", "n", "d", "causal")},
        "prefill": {k: prefill[k] for k in ("bh", "n", "ms", "plain_ms", "bound_ms", "library_ms")},
    }, {
        "name": "flash_dq",
        "route": "cuda",
        "source": source_bwd,
        "replaces": "dalle_pytorch_tpu/kernels/flash_attention.py:276",
        "launches": train_launches["flash_dq"],
        "max_abs_err": bwd["dq_max_abs_err"],
        "ms": bwd["dq_ms"],
        "plain_ms": bwd["plain_ms"],
        "bound_ms": bwd["dq_bound_ms"],
        "bound_by": bwd["dq_bound_by"],
        "library_ms": bwd["library_bwd_ms"],
        "note": "plain_ms and library_ms are whole backwards (dq, dk and dv together)",
        "shape": shape,
    }, {
        "name": "flash_dkv",
        "route": "cuda",
        "source": source_bwd,
        "replaces": "dalle_pytorch_tpu/kernels/flash_attention.py:312",
        "launches": train_launches["flash_dkv"],
        "max_abs_err": max(bwd["dk_max_abs_err"], bwd["dv_max_abs_err"]),
        "ms": bwd["dkv_ms"],
        "plain_ms": bwd["plain_ms"],
        "bound_ms": bwd["dkv_bound_ms"],
        "bound_by": bwd["dkv_bound_by"],
        "library_ms": bwd["library_bwd_ms"],
        "note": "plain_ms and library_ms are whole backwards (dq, dk and dv together)",
        "shape": shape,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
