#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, counts the
tensor-core instructions (HGMMA) the libraries and each f32 forward, VFA, dq
and dk/dv and bf16 dq and VFA instantiation hold, holds each kernel against its plain PyTorch
version on the card (the flash forward, and the backward's dq and dk/dv kernels and the
delta the dq kernels write, on the dense grid and, for static attention
patterns, on the compacted grid, which must equal the dense grid with the
same mask bit for bit), drives the serving path at the full width of the
12-layer DALL-E (dim 1024, 16 heads, seq 1280, OpenAI-dVAE geometry, seeded
random weights) through `DALLE.generate_images`, runs the scoring forward at
n = 1280, checks a small model's sampling on the card against the same model
on the CPU, trains the full-width model (f32 and bf16 compute, then
rematerialised), holds a small model's train steps on the card against the
CPU, and runs the training CLI's dummy run with `--remat_policy flash_qkv
--param_dtype bfloat16`.  Then what the JAX CLI trains, on real data
(`train_real_data`): the 12-layer model at full width with learned
positions and the BPE tokenizer's vocabulary, trained by `cli.train_dalle`
from a folder of PNGs the script writes (through the port's PNG reader and
loader), resumed from a step checkpoint to
the uninterrupted run's losses, then served from its checkpoint through
`cli.generate`, replayed decode graphs and the engine.  Then the same for
the README's
pattern-attention model (depth 16 cycling full, axial_row, axial_col and
conv_like): generation plain and primed, a decode profile, card-vs-CPU
parity of a small pattern model, and training.  Then the flagship 1.3B
DALL-E (dim 1152, depth 64, 8 heads x 128, the same cycle, tied input and
output embeddings, the VFA forward on the compacted grid): one primed
generation, replayed decode graphs, card-vs-CPU parity of a small model with its
features, and training (bf16 compute sequential and rematerialised, f32
compute rematerialised, on f32 masters with Adam; then the JAX package's
flagship recipe: `flash_qkv` remat at batch 8 and "full" at batch 4, bf16
parameter storage with stochastic rounding, bf16 gradients, Adafactor),
the same recipe on a small model held card against CPU under one set of
rounding bits (`lowp_train_parity`), and the recipe's numerics smoke
(`tools/numerics_smoke.py` at its defaults).  The pattern model also
takes one gradient under each remat policy (`remat_policies`: equal to the
sequential one, the forward launched once under the selective policies,
peak memory in the policies' order).  Then text in, PNG out: the generate CLI
(`cli.generate.main`, in process) on the pattern model at full width with
the BPE tokenizer's vocabulary, from a v3 checkpoint the port writes, with
--gentxt (and once more on a one-cycle cut of it that forces the compacted
grid), and CLIP at its default config scoring those images with and without
the text mask, its kernel path held against its plain path.  Each path runs
with every launch counter set to 0 just before it and read just after.

The transformer settings: the flagship's weights under `reversible=True`
(the same tensors, `twin_module`) serve (`reversible_flagship_serve`: the
engine's codes against batch-1 loops) and train (`reversible_flagship_train`: reversible against
remat "full" steps, bf16 on f32 masters, at depths 64 and 16, with step
times, peaks and activation peaks; gradients against plain autograd
through the twin stream at depth 8; the rebuilt input of layer 0 at depth
64); the 12-layer model with `stable`, `sandwich_norm` and shared ids
trains, decodes replayed against eager, and goes through the train CLI
and `cli.generate` (`stable_shared`); a small model with every setting
runs on the card against the CPU (`settings_parity`,
`settings_train_parity`).

The tokenizer's and the reranker's training: `vae_train_parity` holds the
DiscreteVAE's training loss and gradients on the card against the CPU for
every option (plain, straight-through, ReinMax, smooth-L1, KL, resnet, four
channels) under one uniform draw; `train_vae_cli` runs `cli.train_vae` in
process at BASELINE.json configs[1]'s width (256 px, 8,192 tokens) on PNGs
it writes, and reads its checkpoint back on the card and the CPU;
`clip_train_parity` holds a small CLIP's key-masked loss, gradients and two
clipped Adam steps on the card against the CPU; `train_clip_cli` runs
`cli.train_clip` at its defaults, f32 and bf16, whose steps run the flash
forward, dq and dk/dv non-causal, the text encoder's under the caption key
mask, and holds its f32 losses against the plain attention path's.

BASELINE.json configs[4], the reversible flagship on the taming VQGAN-16k
reranked by CLIP (`configs4_generate`): the VQGAN's published geometry
with seeded weights, seq 512 and 26,640 logits; a primed CFG generation
reranked by CLIP, the replayed decode against the eager one at n 512, the
model written as a v3 checkpoint with `vae_class_name` VQGanVAE and served
through `cli.generate` and `cli.generate --engine` (its PNG the batch-1
image under one seed); `configs4_kernel_vs_plain` holds the pattern masks,
tile tables and VFA pair at that shape (fmap 16) against their plain
versions.  The pretrained families and other formats:
`vae_families_parity` (the VQGAN-16k and OpenAI's dVAE, card against CPU:
codes, pixels, times), `train_openai_taming` (the 12-layer model trained
by `cli.train_dalle` on OpenAI's dVAE from a converted cache and with
--taming, then served), `legacy_formats` (a torch-reference dalle.pt and
a v2 checkpoint through `cli.generate`).

Distributed training (`parallel/`): `dist_parity` runs the sharded train
step of the flagship's widths at depth 4 on two ranks that share the card
over gloo with CUDA tensors (dp2, fsdp2 at ZeRO-1 and ZeRO-3, tp2; a mesh
whose collective gloo refuses there is named and left to the CPU tests),
each against the one-process card step on the same global batches, and
`dist_train_cli` runs `cli.train_dalle` under torchrun over NCCL at ZeRO-3
against the one-process CLI on `train_real_data`'s data, then resumes its
checkpoint in the one-process CLI.

Serving replays the decode step from CUDA graphs (`models/sampling.py`
`DecodeGraphs`).  The `decode_graphs` lines hold the replayed loop against
the same step run eagerly, at full width, over the last 128 steps of a
primed loop (the step is static, so any window times it): the 12-layer
model with CFG (and its logit stats), the pattern model with CFG and
without (its pattern layers gathering their keys), the flagship with CFG,
the 12-layer model with learned positions, and the --gentxt text loop at
the CLI's vocabulary, whole: codes (ids) equal under one noise_override,
two calls with one generator seed equal, step times replayed and eager,
and the `*_decode_profile` windows' device time, busy share, kernels and
host launches per step (replayed; the 12-layer and pattern models).  Freeing the
flagship must return its graphs' memory.

The continuous-batching serving engine (`serving/engine.py`, its paged
decode step captured in one CUDA graph per engine): `engine_parity` on the
pattern model at full width, f32, six requests on four lanes
(two guided, one at temperature 0.7) with staggered submits, holds each
request's codes equal to its batch-1 `sample_image_codes` under its
generator seed, replayed, the first codes of two requests run eagerly
under their noise, and one seeded request alone in
lane 0 equal to its run beside the others;
`engine_flagship` serves the flagship on eight lanes (two requests held to
their batch-1 codes under noise, the paged step's times replayed and
eager, a profiled window);
`serve_cli` runs `cli.serve --synthetic
--loadgen 8`, the same with the fleet's flags, and `cli.generate --engine`
against `cli.generate` under one
seed.  Each admission's prefill must launch its layer cycle's kernels.

The serving fleet (`serving/fleet.py`): `fleet_durability` serves the
12-layer model through two replicas: a child process journals six
requests and SIGKILLs itself, a fresh fleet replays the journal to every
request's batch-1 codes under its seed (the replicas' seeded replayed
engines, two guided requests, one at temperature 0.7) with no duplicate
acknowledgement, an unmeetable TTFT target fires one SLO alarm, a stalled
replica's breaker opens and recovers while its deadline request is hedged
once, and a flood climbs the degrade ladder to cap_candidates, where the
capped requests give the batch-1 codes of `degraded_filter_thres` and no
speculative round runs; `fleet_flagship` serves the flagship through two
replicas with prefill handed off by the prefill worker (one admission's
launches, the handoff's bytes against its comms row, each replica's
step), and a Poisson load of six requests through `tools/loadgen.py` with
one replica lost mid-decode: every request completes, its first 34 codes
equal to its batch-1 loop's under its noise.

The serving levers: `quant_spec_parity` (a small flagship-like model
quantized, card against CPU: the serving path's logits under int8 and fp8
weights over the int8 pool, codes under injected noise, speculative ==
sequential), `generate_spec` (`sample_image_codes` / `generate_images` with
spec_k 4 on the 12-layer model: codes equal the sequential call's under one
seed), `engine_quant_flagship` (the flagship with int8 weights and the int8
pool on eight lanes: at-rest bytes, codes against batch-1 loops under
noise, the replayed and eager step beside the f32 engine's, the quantize
and dequantize ops of a step) and `engine_spec_flagship` (the same with
speculative rounds, k 4, d 32: codes equal the sequential engine's, the
round's ms and acceptance, the poison drill, reversible refused).

The telemetry hub and the HBM ledger (`observability/`): the measured
training runs of `slice_train` (12-layer f32) and `flagship_train` (bf16,
f32 remat, the `flash_qkv` recipe) and each run of
`reversible_flagship_train` print the ledger's rows and total beside the
run's step peak (verdict `fits`, measured over ledger in (1/3, 3), a
repeated `MemoryCrosscheck` quiet, the in-place audit of the last step);
the measured runs count their step's FLOPs on the meta device (nothing
taken on the card), each flash launch's tallied work equal to what the
bound functions count for it (`kernels/work.py`) and the launches a step's
counters', measured over analytic FLOPs in (1/3, 3), and the MFU at
`training/profiling.chip_peak_flops`; a step taken after the count peaks
where a plain step does, within 1 %, there and under each remat policy of
`remat_policies`.  `train_real_data`'s CLI run has
its telemetry (spans, step records, one ledger, the crosschecks);
`telemetry_cli` takes a `--profile_steps` Chrome trace naming the flash
kernels, one `hbm_headroom` alarm with its one capture, and a real
allocator OOM under a per-process cap that exits 77 with its report and
leaves the allocated bytes as it found them.

Every phase prints one JSON line; any failure raises and exits non-zero.  The
last two lines are the kernel table and `{"ok": true, "device": {...}}`.  It
exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.

Comparisons run with TF32 off: `torch.backends.cudnn.allow_tf32 = False`
and matmul precision "highest", so float32 means float32 on both sides.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import io
import json
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
# bf16: the tensor cores.  f32: the least time for f32-accurate products on
# this card is 3xTF32 (three TF32 tensor-core products for one, f32's 1e-4
# kept; one TF32 product misses it), a third of the 494.7 TFLOP/s TF32 rate,
# which beats the 67 TFLOP/s of the FMA units
PEAK_FLOPS = {torch.float32: 494.7e12 / 3, torch.bfloat16: 989e12}
TOLERANCE = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
LSE_TOLERANCE = 1e-4

FULL = dict(dim=1024, depth=12, heads=16, dim_head=64, num_text_tokens=10000, text_seq_len=256,
            attn_types=("full",), rotary_emb=True, shift_tokens=True)
FULL_VAE = dict(image_size=256, num_tokens=8192, num_layers=3)
VFA_KERNELS = ("flash_max_compact", "flash_fwd_compact_vfa")
# the README quick-start model: pattern attention, depth 16 (each type 4 times)
SLICE = dict(FULL, depth=16, attn_types=("full", "axial_row", "axial_col", "conv_like"))
PATTERNS = ("axial_row", "axial_col", "conv_like", "sparse", "sparse_per_head")

# the default prime fraction's codes (0.4375 of 1,024)
PRIME_LEN = 448
# the primed replayed-against-eager decode checks (pattern model, flagship)
# run the last 128 steps, the flagship's the last 64: their eager loops take
# 32 and 110 ms a step
GRAPHS_PRIME_LEN = 896
FLAGSHIP_GRAPHS_PRIME_LEN = 960

# the flagship 1.3B model (BASELINE.json configs[3], tools/flagship_sweep.py)
FLAGSHIP = dict(dim=1152, depth=64, heads=8, dim_head=128, num_text_tokens=10000, text_seq_len=256,
                attn_types=SLICE["attn_types"], rotary_emb=True, shift_tokens=True,
                share_input_output_emb=True, attn_vfa=True)

# BASELINE.json configs[4]: the flagship under reversible execution on the
# taming VQGAN-16k (vqgan_imagenet_f16_16384's ddconfig: 256 px, a 16 x 16
# map of 16,384 codes; seq 256 + 256), reranked by CLIP
VQGAN16K = dict(ch=128, ch_mult=(1, 1, 2, 2, 4), num_res_blocks=2, attn_resolutions=(16,), resolution=256,
                z_channels=256, n_embed=16384, embed_dim=256)
CONFIGS4 = dict(FLAGSHIP, reversible=True)

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


_START = time.monotonic()


def emit(phase: str, **fields) -> None:
    """One phase's JSON line, with the seconds since the run started."""
    print(json.dumps({"phase": phase, **fields, "elapsed_s": round(time.monotonic() - _START, 1)}), flush=True)


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


def attention_work(kmask, b, h, n, causal):
    """`kernels/work.attention_work`: the scored pairs, live keys and the
    query rows that see a key, over the b*h batch-heads."""
    from dalle_pytorch_tpu_torch.kernels import work

    return work.attention_work(kmask, b, h, n, causal)


def bound(nbytes, flops, dtype):
    """The larger of `nbytes` over the memory rate and `flops` over the
    dtype's peak, in ms, and which of the two it is."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def flash_bound_ms(b, h, n, d, dtype, causal, kmask):
    """The least time for the attention forward under key mask `kmask` (or
    None): Q read for the rows that see a key, K and V for the live keys,
    the output and lse written for every row, the mask read once, over the
    memory rate; against the two matrix products over the scored pairs over
    the dtype's peak; the larger of the two (`kernels/work.dense_work`, the
    arithmetic the FLOPs tally of a step shares)."""
    from dalle_pytorch_tpu_torch.kernels import work

    return bound(*work.dense_work("fwd", b, h, n, d, dtype, causal, kmask), dtype)


def backward_bound_ms(b, h, n, d, dtype, causal, kmask, kind):
    """The least time for one backward kernel (`kind` "dq" or "dkv") under
    key mask `kmask` (or None): its query-side inputs read for the rows that
    see a key, K and V for the live keys, its outputs written for every row,
    and the mask, over the memory rate (dq: q, do and out, lse; dq and
    delta.  dk/dv: q and do, lse and delta; dk and dv); against its matrix
    products (dq 3, dk/dv 4) over the scored pairs over the dtype's peak;
    the larger of the two (`kernels/work.dense_work`)."""
    from dalle_pytorch_tpu_torch.kernels import work

    return bound(*work.dense_work(kind, b, h, n, d, dtype, causal, kmask), dtype)


def pattern_bound_ms(bh, n, d, dtype, live_tiles, heads, tile, kind):
    """The least time for one pattern kernel (`kind` "fwd", "dq", "dkv",
    "vfa_max" or "vfa_fwd"): its tensors moved once and the pattern's bytes
    of its `live_tiles` tiles read once, over the memory rate; against its
    matrix products over the live tiles' elements over the dtype's peak; the
    larger of the two (`kernels/work.pattern_work`)."""
    from dalle_pytorch_tpu_torch.kernels import work

    return bound(*work.pattern_work(kind, bh, n, d, dtype, live_tiles, heads, tile), dtype)


def reset_launches(fa) -> None:
    for wrapper, counter in COUNTERS.values():
        setattr(getattr(fa, wrapper), counter, 0)


def read_launches(fa) -> dict:
    return {name: getattr(getattr(fa, wrapper), counter) for name, (wrapper, counter) in COUNTERS.items()}


def forward_launches(model, n, layers=None):
    """The flash launches of one full-sequence pass of `model` at length n
    and of its backward, from the layer cycle and the grid each pattern
    takes at the model's head dim (`Transformer.attention_inputs`, the
    tables the layers run with): a dense layer launches flash_fwd (counted
    in flash_fwd_masked too when it takes a pattern), then flash_dq and
    flash_dkv; a compacted one flash_fwd_compact or, with attn_vfa,
    flash_max_compact and flash_fwd_compact_vfa, then flash_dq_compact and
    flash_dkv_compact.  `layers`: those layers' alone.  Returns (forward
    launches, backward launches)."""
    from dalle_pytorch_tpu_torch.models.transformer import _pattern_key

    tr, vfa = model.transformer, model.cfg.attn_vfa
    fwd, bwd = dict.fromkeys(COUNTERS, 0), dict.fromkeys(COUNTERS, 0)
    for spec in tr.specs if layers is None else [tr.specs[i] for i in layers]:
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
    """The flash launches one training step of `model` at length n makes:
    remat under the "full" policy runs each forward twice, and so does
    reversible execution (its backward recomputes every branch on the
    rebuilt inputs); the selective policies keep the forward's outputs, so
    it runs once.  Read from the transformer's own config, which a phase
    may switch between steps."""
    fwd, bwd = forward_launches(model, n)
    cfg = model.transformer.cfg
    full = cfg.execution == "remat" and cfg.remat_policy == "full"
    times = 2 if full or cfg.execution == "reversible" else 1
    return {name: times * fwd[name] + bwd[name] for name in COUNTERS}


# The profiler can drop the kernels that run in the first moments of its
# window: on an H100 it read none of the first twenty launches (about a
# millisecond of work) in three windows running, late in a long process.  So
# the measured work starts PROFILER_GAP_S after the window opens (and the
# window closes a third of that after the work has finished); `device_times`
# checks each label's kernel count and times with CUDA events what the
# profiler still did not read whole.
PROFILER_GAP_S = 0.03
PROFILER_LOG = {"calls": 0, "windows": 0, "retaken": [], "event_timed": []}


def device_profile(fn) -> list:
    """(kernel name, device ms, count) of one call of fn, by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILER_GAP_S)
        fn()
        torch.cuda.synchronize()
        time.sleep(PROFILER_GAP_S / 3)
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    return sorted(rows, key=lambda r: -r[1])


def device_times(calls: dict, reps: int = 10, windows: int = 3) -> dict:
    """Device ms per call of each of `calls` ({label: fn}), run `reps` times
    each in turn under one profiler window: a label's time sums the port's
    kernels named `<label><...>(flash::Args)`; the label None takes every
    other kernel (a library call).  Unlike `time_ms` it leaves out the host
    time between launches, which bounds a wrapper's calls at small shapes.
    Each call of a label's fn launches its kernel, so a window in which a
    label's kernel count is 0 or no multiple of `reps`, or the library reads
    0 ms, dropped some of them: it is taken again, up to `windows` windows,
    and a label still short is timed with CUDA events (`time_ms`), which
    `PROFILER_LOG` lists and the `profiler` phase line reports."""

    def ours(label, name):
        return f"{label}<" in name and "flash::Args" in name

    named = [label for label in calls if label is not None]
    PROFILER_LOG["calls"] += 1
    for _ in range(windows):
        PROFILER_LOG["windows"] += 1
        rows = device_profile(lambda: [fn() for fn in calls.values() for _ in range(reps)])
        out = {label: sum(ms for name, ms, _ in rows if ours(label, name)) / reps for label in named}
        counts = {label: sum(c for name, _, c in rows if ours(label, name)) for label in named}
        short = [label for label in named if not (counts[label] > 0 and counts[label] % reps == 0
                                                  and out[label] > 0)]
        if None in calls:
            out[None] = sum(ms for name, ms, _ in rows if not any(ours(label, name) for label in named)) / reps
            short += [None] * (not out[None] > 0)
        if not short:
            return out
        PROFILER_LOG["retaken"].append({str(label): counts.get(label) for label in short})
    for label in short:
        out[label] = time_ms(calls[label], reps)
        PROFILER_LOG["event_timed"].append(str(label))
    return out


def device_difference(whole, part, windows: int = 3) -> float:
    """Device ms of one call of `whole` less one of `part` (a library call
    and the share of it to leave out, e.g. SDPA forward + backward less its
    forward), each from its own `device_times` window; taken again, up to
    `windows` times, where the difference comes out at 0 or below, and the
    phase fails if it still does."""
    for _ in range(windows):
        diff = device_times({None: whole})[None] - device_times({None: part})[None]
        if diff > 0:
            return diff
    raise RuntimeError(f"device_difference: {diff} ms in {windows} tries")


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
              "flash_bwd_dkv_kernel", "flash_dkv_compact_kernel", "flash_max_compact_kernel",
              "flash_fwd_compact_vfa_kernel")


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
    # in SASS): every body, f32 (3xTF32) and bf16
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
    # every f32 forward, VFA, dq and dk/dv and bf16 dq, dk/dv and VFA
    # instantiation (two entries at d 32, 64 and 128 each) keeps its
    # accumulators in registers, and every f32 forward, VFA, dq and dk/dv
    # (3xTF32) and bf16 dq and VFA instantiation runs wgmma in its own SASS
    entries = {("float32", "forward"): ("flash_fwd_kernel", "flash_fwd_compact_kernel"),
               ("float32", "VFA"): ("flash_max_compact_kernel", "flash_fwd_compact_vfa_kernel"),
               ("float32", "dq"): ("flash_bwd_dq_kernel", "flash_dq_compact_kernel"),
               ("float32", "dk/dv"): ("flash_bwd_dkv_kernel", "flash_dkv_compact_kernel"),
               ("bfloat16", "dq"): ("flash_bwd_dq_kernel", "flash_dq_compact_kernel"),
               ("bfloat16", "dk/dv"): ("flash_bwd_dkv_kernel", "flash_dkv_compact_kernel"),
               ("bfloat16", "VFA"): ("flash_max_compact_kernel", "flash_fwd_compact_vfa_kernel")}

    def instances(table, label):
        return {key: value for key, value in table.items()
                if key.split()[1] == label[0] and key.split()[0] in entries[label]}

    for label in entries:
        spills = instances(resources, label)
        check(len(spills) == 6 and all(r["local_bytes"] == 0 for r in spills.values()),
              f"the {' '.join(label)} instantiations spill or are missing: {spills}")
    # the f32 dq and dk/dv bodies call no function, so a stack frame there
    # is spilled registers (the forward bodies' frame is store_dead_rows'
    # call)
    for label in (("float32", "dq"), ("float32", "dk/dv")):
        frames = instances(resources, label)
        check(all(r["stack_bytes"] == 0 for r in frames.values()),
              f"the {' '.join(label)} instantiations spill registers: {frames}")
    for label in (("float32", "forward"), ("float32", "VFA"), ("float32", "dq"), ("float32", "dk/dv"),
                  ("bfloat16", "dq"), ("bfloat16", "VFA")):
        counts = instances(hgmma, label)
        check(len(counts) == 6 and min(counts.values()) > 0,
              f"a {' '.join(label)} instantiation holds no HGMMA instruction: {counts}")
    emit("environment", device=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda, python=sys.version.split()[0],
         kernel_compile_s=compile_s, build_s=build_s, tensor_core_instructions=mma,
         hgmma_by_instance=hgmma, kernel_resources=resources,
         tf32="off (cudnn.allow_tf32=False, matmul precision highest)")


def random_keys_first_dead(b, n, g, dev):
    """A key mask keeping each key with probability 0.8, the first 16 keys
    of the first batch masked."""
    kmask = (torch.rand(b, n, generator=g, device=dev) > 0.2).to(torch.int32)
    kmask[0, :16] = 0
    return kmask


def random_keys_last_batch_dead(b, n, g, dev):
    """A key mask keeping each key with probability 0.8, every key of the
    last batch masked (rows that see no key)."""
    kmask = (torch.rand(b, n, generator=g, device=dev) > 0.2).to(torch.int32)
    kmask[-1] = 0
    return kmask


def caption_keys(b, n, g, dev):
    """CLIP's text mask (text != 0) for captions of n, 200, 31 and 7
    tokens (in turn over the batch), padded at the end."""
    lengths = torch.tensor(([n, 200, 31, 7] * b)[:b], device=dev)
    return (torch.arange(n, device=dev)[None] < lengths[:, None]).to(torch.int32)


def phase_kernel_vs_plain(fa):
    """flash_fwd against flash_attention_reference at the slices' shapes
    (both dtypes on the tensor cores: f32 in 3xTF32, bf16), with SDPA's time
    and the backend it took; among them the serving entry points' own: CLIP's
    non-causal text (key-padded) and image encoders and a --gentxt prompt's
    causal prefill under one tile."""
    dev = torch.device("cuda")
    cases = [  # (name, b, h, n, d, causal, key mask builder or None)
        ("prefill", 4, 16, 257, 64, True, None),  # 2 prompts x CFG, bos + 256 text
        ("forward", 2, 16, 1280, 64, True, None),  # scoring forward, batch 2
        ("padded_noncausal", 2, 16, 300, 64, False, random_keys_first_dead),
        ("train", 4, 16, 1280, 64, True, None),  # the training step, batch 4
        ("flagship", 4, 8, 1280, 128, True, None),  # the flagship's full layers, batch 4
        ("configs4", 4, 8, 512, 128, True, None),  # the flagship on the VQGAN-16k's map, 2 prompts x CFG
        ("clip_text", 4, 8, 256, 64, False, caption_keys),  # CLIP's text encoder
        ("clip_image", 4, 8, 64, 64, False, None),  # CLIP's image encoder, 64 patches
        ("text_prompt", 2, 16, 7, 64, True, None),  # a --gentxt prompt's prefill
    ]
    results = []
    for dtype in (torch.float32, torch.bfloat16):
        for name, b, h, n, d, causal, key_mask in cases:
            g = torch.Generator(device=dev).manual_seed(n)
            q, k, v = (torch.randn(b * h, n, d, generator=g, device=dev).to(dtype) for _ in range(3))
            kmask = None if key_mask is None else key_mask(b, n, g, dev)
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
            bound_ms, bound_by = flash_bound_ms(b, h, n, d, dtype, causal, kmask)
            row = dict(case=name, dtype=str(dtype).replace("torch.", ""), bh=b * h, n=n, d=d,
                       causal=causal, key_padding=kmask is not None, live_keys=attention_work(kmask, b, h, n,
                                                                                              causal)[1] // h,
                       max_abs_err=err, lse_err=lse_err,
                       tolerance=TOLERANCE[dtype], ms=kernel_ms, plain_ms=plain_ms,
                       library_ms=library_ms, device_ms=dtimes["flash_fwd_kernel"], library_device_ms=dtimes[None],
                       sdpa_backend=sdpa_backend(sdpa), bound_ms=bound_ms, bound_by=bound_by)
            emit("kernel_vs_plain", kernel="flash_fwd", **row)
            results.append(row)
    return results


def phase_backward_vs_plain(fa):
    """flash_bwd's two kernels against flash_attention_backward_reference at
    the training shape, the flagship's (d 128), the ragged prefill length, a
    padded non-causal case whose second batch masks every key (rows that
    see no key), and CLIP's training shapes at the CLIP CLI's batch of 16:
    the text encoder non-causal under the caption key mask, the image
    encoder's 64 patches non-causal.  The error is max abs error over the reference's max abs
    value.  The library time is SDPA forward + backward minus SDPA forward,
    same inputs; device times are the kernels' own (`device_times`)."""
    dev = torch.device("cuda")
    cases = [  # (name, b, h, n, d, causal, key mask builder or None)
        ("train", 4, 16, 1280, 64, True, None),
        ("flagship", 4, 8, 1280, 128, True, None),  # the flagship's full layers, batch 4
        ("configs4", 4, 8, 512, 128, True, None),  # the flagship on the VQGAN-16k's map, 2 prompts x CFG
        ("prefill", 4, 16, 257, 64, True, None),
        ("padded_noncausal", 2, 16, 300, 64, False, random_keys_last_batch_dead),
        ("clip_text", 16, 8, 256, 64, False, caption_keys),  # CLIP training's text encoder
        ("clip_image", 16, 8, 64, 64, False, None),  # and its image encoder
    ]
    results = []
    for dtype in (torch.float32, torch.bfloat16):
        for name, b, h, n, d, causal, key_mask in cases:
            g = torch.Generator(device=dev).manual_seed(n + 1)
            q, k, v, do = (torch.randn(b * h, n, d, generator=g, device=dev).to(dtype) for _ in range(4))
            kmask = None if key_mask is None else key_mask(b, n, g, dev)
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
            dtimes = device_times({"flash_bwd_dq_kernel": dq_kernel, "flash_bwd_dkv_kernel": dkv_kernel})
            library_device_ms = device_difference(sdpa_fwd_bwd, sdpa_fwd)
            dq_bound, dq_by = backward_bound_ms(b, h, n, d, dtype, causal, kmask, "dq")
            dkv_bound, dkv_by = backward_bound_ms(b, h, n, d, dtype, causal, kmask, "dkv")
            row = dict(case=name, dtype=str(dtype).replace("torch.", ""), bh=b * h, n=n, d=d, causal=causal,
                       key_padding=kmask is not None, live_keys=attention_work(kmask, b, h, n, causal)[1] // h,
                       tolerance=TOLERANCE[dtype], delta_err_over_limit=delta_err,
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


def pattern_mask(masks, kind, n, h, fmap=32):
    """The slice's (n, n) pattern, or (h, n, n) for per-head 'sparse', at
    seq n on the fmap x fmap map."""
    if kind == "sparse":
        return masks.build_block_sparse_mask(n, fmap)
    if kind == "sparse_per_head":
        return masks.build_block_sparse_mask(n, fmap, heads=h)
    return masks.build_pattern_mask(kind, n, fmap)


def vfa_vs_plain(fa, q, k, v, do, mask, h, t, online):
    """The VFA pair on the compacted grid of tables `t`: the max pass's gmax
    against `vfa_max_reference` (1e-4 relative), the fixed-max pass against
    `vfa_fwd_reference` on that gmax and against the online compacted
    kernel's (out, lse) `online` (out at the dtype's tolerance, lse 1e-4),
    the compacted backward run from the VFA lse against the plain backward
    (over the reference's max); then each pass's time (events, and its own
    device time from the profiler) against its bound over the live tiles and
    its plain version's."""
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
    max_bound = pattern_bound_ms(bh, n, d, dtype, t.live_tiles, t.heads, t.row_tile, "vfa_max")
    fwd_bound = pattern_bound_ms(bh, n, d, dtype, t.live_tiles, t.heads, t.row_tile, "vfa_fwd")
    dtimes = device_times({"flash_max_compact_kernel": max_pass, "flash_fwd_compact_vfa_kernel": fixed_max_pass})
    return dict(vfa_gmax_rel_err=gmax_err, vfa_gmax_max_abs_err=gmax_abs_err.max().item(),
                vfa_max_abs_err=err, vfa_lse_err=lse_err,
                vfa_vs_online_max_abs_err=online_err, vfa_vs_online_lse_err=online_lse_err,
                vfa_bwd_err_over_ref_max=bwd_err,
                vfa_max_ms=time_ms(max_pass, 10), vfa_fwd_ms=time_ms(fixed_max_pass, 10),
                vfa_max_device_ms=dtimes["flash_max_compact_kernel"],
                vfa_fwd_device_ms=dtimes["flash_fwd_compact_vfa_kernel"],
                vfa_plain_max_ms=time_ms(lambda: fa.vfa_max_reference(q, k, h, True, scale, mask), 10),
                vfa_plain_fwd_ms=time_ms(lambda: fa.vfa_fwd_reference(q, k, v, gmax, h, True, scale, mask), 10),
                vfa_max_bound_ms=max_bound[0], vfa_max_bound_by=max_bound[1],
                vfa_fwd_bound_ms=fwd_bound[0], vfa_fwd_bound_by=fwd_bound[1])


def sparse_case(fa, masks, b, h, d, n, fmap, dtype, kind, always_vfa=False):
    """One pattern at one shape and dtype (`phase_sparse_kernel_vs_plain`);
    `always_vfa` runs the VFA pair on the compacted tables where the grid
    rule would take the dense grid too."""
    dev = torch.device("cuda")
    bh, scale = b * h, d ** -0.5
    mask = pattern_mask(masks, kind, n, h, fmap).to(dev)
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
    sdpa_bwd_device_ms = device_difference(sdpa_fwd_bwd, sdpa_fwd)
    compact_auto = fa.pattern_tables(mask, n, d, device=dev).compact
    vfa = vfa_vs_plain(fa, q, k, v, do, mask, h, tc, res["compact"][:2]) if compact_auto or always_vfa else {}
    # live tiles per (batch, head), at each kernel's tile
    live_fwd, live_dkv = tc.live_tiles / tc.heads, tc.live_tiles_dkv / tc.heads
    bound = {  # fwd: q, k, v, out, lse; dq: q, k, v, do, out, dq, lse, delta; dk/dv: q, k, v, do,
        # dk, dv, lse, delta
        "fwd": pattern_bound_ms(bh, n, d, dtype, tc.live_tiles, tc.heads, tc.row_tile, "fwd"),
        "dq": pattern_bound_ms(bh, n, d, dtype, tc.live_tiles, tc.heads, tc.row_tile, "dq"),
        "dkv": pattern_bound_ms(bh, n, d, dtype, tc.live_tiles_dkv, tc.heads, tc.col_tile[::-1], "dkv"),
    }
    row = dict(pattern=kind, dtype=str(dtype).replace("torch.", ""), bh=bh, h=h, n=n, d=d, fmap=fmap,
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
               sdpa_bwd_ms=sdpa_bwd_ms, sdpa_backend=sdpa_backend(sdpa_fwd),
               fwd_dense_device_ms=dtimes["flash_fwd_kernel"],
               fwd_compact_device_ms=dtimes["flash_fwd_compact_kernel"], sdpa_fwd_device_ms=dtimes[None],
               dq_dense_device_ms=dtimes["flash_bwd_dq_kernel"],
               dq_compact_device_ms=dtimes["flash_dq_compact_kernel"],
               dkv_dense_device_ms=dtimes["flash_bwd_dkv_kernel"],
               dkv_compact_device_ms=dtimes["flash_dkv_compact_kernel"],
               sdpa_bwd_device_ms=sdpa_bwd_device_ms,
               **{f"{key}_bound_ms": value[0] for key, value in bound.items()},
               **{f"{key}_bound_by": value[1] for key, value in bound.items()}, **vfa)
    return row


def phase_sparse_kernel_vs_plain(fa, masks):
    """For each pattern at bh 64, n 1280, d 64 and bh 32, n 1280, d 128, in
    f32 and bf16: forward, dq and dk/dv on the dense grid with the mask and
    on the compacted grid (torch.equal, bit for bit), both against the plain
    versions (forward: max abs error; backward: over the reference's max),
    and their times against the bound over the live tiles, the plain
    versions and SDPA with the boolean mask pattern & causal (forward, and
    forward + backward - forward for the backward).  Where the grid rule
    compacts the pattern, also the VFA pair (`vfa_vs_plain`)."""
    results = []
    for b, h, d in ((4, 16, 64), (4, 8, 128)):
        for dtype in (torch.float32, torch.bfloat16):
            for kind in PATTERNS:
                row = sparse_case(fa, masks, b, h, d, 1280, 32, dtype, kind)
                emit("sparse_kernel_vs_plain", **row)
                results.append(row)
    return results


def phase_configs4_kernels(fa, masks):
    """BASELINE.json configs[4]'s shape, new to the kernels: the flagship's
    pattern layers at n 512 (256 text + a 16 x 16 map, the VQGAN-16k's),
    bh 32 (2 prompts x CFG x 8 heads), d 128, f32 and bf16: the pattern
    masks and tile tables at fmap 16 through the dense and compacted grids
    (bit for bit), and the VFA pair against its plain versions, each time
    against its bound (`sparse_case`, the VFA pair run on every pattern's
    compacted tables)."""
    results = []
    for dtype in (torch.float32, torch.bfloat16):
        for kind in ("axial_row", "axial_col", "conv_like"):
            row = sparse_case(fa, masks, 4, 8, 128, 512, 16, dtype, kind, always_vfa=True)
            emit("configs4_kernel_vs_plain", **row)
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
    return dict(cond_scale=cond_scale, primed=img is not None, capture_s=timings["capture_s"],
                prefill_s=timings["prefill_s"], decode_s=timings["decode_s"], vae_s=timings["vae_s"], total_s=total_s,
                images_per_s=2 / total_s,
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


# host calls that launch device work, as the profiler names them
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch",
                "cudaMemcpyAsync", "cudaMemsetAsync")


def profile_window(fn, steps):
    """One call of fn (a decode loop of `steps` steps) under torch.profiler:
    wall time, the device's summed kernel time and busy share (null where
    the profiler records no device time), kernels and host launch calls
    per step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    device_s = sum(e.self_device_time_total for e in kernels) / 1e6
    calls = {e.key: e.count for e in events if e.key in LAUNCH_CALLS}
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    return dict(steps=steps, window_s=wall_s, step_ms=wall_s / steps * 1e3,
                device_ms_per_step=device_s / steps * 1e3 if device_s else None,
                device_busy_share=device_s / wall_s if device_s else None,
                kernels_per_step=sum(e.count for e in kernels) / steps,
                host_launches_per_step=sum(calls.values()) / steps if calls else None, host_launch_calls=calls,
                top_kernels=[dict(name=e.key[:80], device_ms=e.self_device_time_total / 1e3, count=e.count)
                             for e in top])


def decode_window(sampling, dalle, text, steps, graphs, cond_scale=3.0):
    """The last `steps` steps of an image loop (primed with random codes so
    that only they remain), replayed (graphs=True) or eager, profiled after
    an unprofiled call of the same loop (the replayed one's capture)."""
    cfg, model = dalle.cfg, dalle.module
    prime_len = cfg.image_seq_len - steps
    primer = torch.randint(0, cfg.num_image_tokens, (text.shape[0], prime_len),
                           generator=torch.Generator().manual_seed(5)).cuda()
    mode = sampling.Mode(noise=False, stats=False)

    def window():
        loop, run = sampling.image_loop(model, text.shape[0], cond_scale, prime_len, 0.5, mode, graphs)
        _, logits = sampling._prefill_phase(model, text, primer, prime_len, cond_scale, loop.cache)
        gen = torch.Generator(device=text.device).manual_seed(6)
        return lambda: run(model, logits, steps, gen, 1.0, None, mode)

    window()()
    return profile_window(window(), steps)


def phase_decode_profile(dalle, text, sampling, phase="decode_profile", steps=32, eager=True):
    """Where a decode step's time goes: the last `steps` steps of a CFG
    generation, replayed from CUDA graphs and, with `eager`, beside it
    eager."""
    replayed = decode_window(sampling, dalle, text, steps, True)
    eager = decode_window(sampling, dalle, text, steps, False) if eager else None
    emit(phase, replayed=replayed, eager=eager, note="profiled windows: the tracer's host overhead slows the steps")
    return replayed, eager


def phase_decode_graphs(fa, tr, sampling, dalle, text, model, cond_scale, prime_len=0, stats=False,
                        eager_stream=False, profile=None):
    """The image loop replayed from CUDA graphs against the same static step
    run eagerly, at full width: codes array_equal under one noise_override
    over the whole n_gen (replayed first: the call that captures, its
    decode_s the replays alone), with `stats` the logit stats equal too; two
    calls with one generator seed equal, with codes that vary; with
    `eager_stream`, whether the replayed generator stream equals the eager
    loop's (one eager run more, so on one model only).  Each call's flash launches
    are its prefill's layer cycle (decode launches none), and its
    gather-branch layer-steps the pattern layers times the decode steps.
    `profile`: its decode_profile readings (replayed, eager)."""
    from dalle_pytorch_tpu_torch.ops.sampling import gumbel_noise

    cfg, m = dalle.cfg, dalle.module
    graphs = dalle.decode_graphs
    b, n_gen = text.shape[0], cfg.image_seq_len - prime_len
    primer = (torch.randint(0, cfg.num_image_tokens, (b, prime_len), generator=torch.Generator().manual_seed(8)).cuda()
              if prime_len else None)
    noise = gumbel_noise((n_gen, b, cfg.total_tokens), torch.Generator(device="cuda").manual_seed(9), device="cuda")
    want, _ = forward_launches(m, cfg.text_seq_len + 1 + prime_len)
    pattern_layers = sum(s.attn_type != "full" for s in m.transformer.specs) if cfg.sparse_decode else 0

    def call(replayed, **kw):
        timings = {}
        reset_launches(fa)
        tr.decode_step.gathers = 0
        reserved = torch.cuda.memory_reserved()
        out = sampling.sample_image_codes(m, text, cond_scale=cond_scale, primer_codes=primer, prime_len=prime_len,
                                          graphs=replayed, timings=timings, **kw)
        torch.cuda.synchronize()
        launches, gathers = read_launches(fa), tr.decode_step.gathers
        check(launches == want, f"{model}: a sampling call launched {launches}; its prefill's layer cycle gives {want}")
        check(gathers == pattern_layers * (n_gen - 1),
              f"{model}: {gathers} gather-branch layer-steps for {pattern_layers} pattern layers x {n_gen - 1} steps")
        timings["reserved_delta_gib"] = (torch.cuda.memory_reserved() - reserved) / 2 ** 30
        return out, timings

    first = (graphs.hits, graphs.misses)
    kw = dict(noise_override=noise, return_logit_stats=stats)
    replayed, t_replayed = call(True, **kw)
    eager, t_eager = call(False, **kw)
    codes = [out[0] if stats else out for out in (replayed, eager)]
    check(torch.equal(*codes), f"{model}: replayed and eager codes differ under one noise")
    check(tuple(codes[0].shape) == (b, cfg.image_seq_len), f"{model}: codes of shape {tuple(codes[0].shape)}")
    logit_stats = None
    if stats:
        logit_stats = {k: [out[1][k].item() for out in (replayed, eager)] for k in replayed[1]}
        check(all(len(set(v)) == 1 and np.isfinite(v[0]) for v in logit_stats.values()),
              f"{model}: replayed and eager logit stats differ: {logit_stats}")

    def seeded(replayed):
        return call(replayed, generator=torch.Generator(device="cuda").manual_seed(7))

    (g1, t_g1), (g2, _) = seeded(True), seeded(True)
    check(torch.equal(g1, g2), f"{model}: two replayed calls with one seed differ")
    check(all(len(torch.unique(row[prime_len:])) > 1 for row in g1), f"{model}: replayed codes do not vary over steps")
    stream_equal = torch.equal(g1, seeded(False)[0]) if eager_stream else None
    entry = next(e for k, e in graphs.entries().items()
                 if k[:6] == ("image", b, float(cond_scale), prime_len, 0.5, None))
    row = dict(model=model, loop="image", batch=b, cond_scale=cond_scale, prime_len=prime_len, n_gen=n_gen,
               codes_equal_under_noise=True, seeded_calls_equal=True, generator_stream_equals_eager=stream_equal,
               logit_stats=logit_stats,
               step_ms_replayed=t_replayed["decode_s"] / n_gen * 1e3, step_ms_eager=t_eager["decode_s"] / n_gen * 1e3,
               decode_s_replayed=t_replayed["decode_s"], decode_s_eager=t_eager["decode_s"],
               prefill_s_replayed=t_replayed["prefill_s"], capture_s=t_replayed["capture_s"],
               capture_s_generator=t_g1["capture_s"],
               entry_buffers_gib=entry.loop.nbytes() / 2 ** 30, captured_graphs=len(entry.graphs),
               reserved_delta_gib_first_call=t_replayed["reserved_delta_gib"],
               hits=graphs.hits - first[0], misses=graphs.misses - first[1],
               gather_layer_steps_per_call=pattern_layers * (n_gen - 1))
    if profile is not None:
        replayed_p, eager_p = profile
        row.update({f"{k}_{path}": v[k] for path, v in (("replayed", replayed_p), ("eager", eager_p)) if v is not None
                    for k in ("device_ms_per_step", "device_busy_share", "kernels_per_step", "host_launches_per_step")})
    emit("decode_graphs", **row)
    return row


def phase_decode_graphs_text(sampling, dalle, prompt, model, steps=32):
    """The --gentxt text loop replayed from CUDA graphs against the same
    static step run eagerly: ids array_equal under one noise_override over
    the whole completion, two calls with one generator seed equal, and
    whether the replayed generator stream equals the eager loop's; then a
    profiled window of `steps` steps (a prompt of text_seq_len - steps
    random ids), replayed and eager."""
    from dalle_pytorch_tpu_torch.models import dalle as dalle_mod
    from dalle_pytorch_tpu_torch.models.transformer import prefill
    from dalle_pytorch_tpu_torch.ops.sampling import gumbel_noise

    cfg, m = dalle.cfg, dalle.module
    graphs = dalle.decode_graphs
    b, n0 = prompt.shape
    n_gen = cfg.text_seq_len - n0
    noise = gumbel_noise((n_gen, b, cfg.total_tokens), torch.Generator(device="cuda").manual_seed(9), device="cuda")
    first = (graphs.hits, graphs.misses)

    def call(replayed, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids = sampling.generate_texts(m, prompt, graphs=replayed, **kw)
        torch.cuda.synchronize()
        return ids, time.perf_counter() - t0

    def seeded(replayed):
        return call(replayed, generator=torch.Generator(device="cuda").manual_seed(7))[0]

    (captured, capture_call_s), (eager, eager_s), (replayed, replayed_s) = (
        call(True, noise_override=noise), call(False, noise_override=noise), call(True, noise_override=noise))
    check(torch.equal(captured, eager) and torch.equal(replayed, eager),
          f"{model}: replayed and eager text ids differ under one noise")
    check(tuple(eager.shape) == (b, cfg.text_seq_len) and bool((eager < cfg.num_text_tokens_padded).all()),
          f"{model}: text ids {tuple(eager.shape)} out of the text vocabulary")
    g1, g2 = seeded(True), seeded(True)
    check(torch.equal(g1, g2), f"{model}: two replayed text calls with one seed differ")
    check(len(torch.unique(g1[0, n0:])) > 1, f"{model}: replayed text ids do not vary over steps")
    stream_equal = torch.equal(g1, seeded(False))
    entry = next(e for k, e in graphs.entries().items() if k[:3] == ("text", b, 0.5))

    long_prompt = torch.randint(1, cfg.num_text_tokens, (b, cfg.text_seq_len - steps),
                                generator=torch.Generator().manual_seed(10)).cuda()
    mode = sampling.Mode(noise=False, stats=False)

    def window(replayed):
        loop, run = sampling.text_loop(m, b, 0.5, mode, replayed)
        out, _ = prefill(m.transformer, dalle_mod.embed_text_ids(m, long_prompt), loop.cache)
        logits = sampling._logits_at(m, out[:, -1:], image=False)
        gen = torch.Generator(device="cuda").manual_seed(6)
        return lambda: run(m, logits, steps, gen, 1.0, None, mode)

    profiles = {}
    for path, replayed_flag in (("replayed", True), ("eager", False)):
        window(replayed_flag)()
        profiles[path] = profile_window(window(replayed_flag), steps)
    row = dict(model=model, loop="text", batch=b, prompt_len=n0, n_gen=n_gen, vocab=cfg.total_tokens,
               ids_equal_under_noise=True, seeded_calls_equal=True, generator_stream_equals_eager=stream_equal,
               step_ms_replayed=replayed_s / n_gen * 1e3, step_ms_eager=eager_s / n_gen * 1e3,
               call_s_replayed=replayed_s, call_s_eager=eager_s, first_call_s=capture_call_s,
               entry_buffers_gib=entry.loop.nbytes() / 2 ** 30, captured_graphs=len(entry.graphs),
               hits=graphs.hits - first[0], misses=graphs.misses - first[1], profile=profiles)
    row.update({f"{k}_{path}": v[k] for path, v in profiles.items()
                for k in ("device_ms_per_step", "device_busy_share", "kernels_per_step", "host_launches_per_step")})
    emit("decode_graphs", **row)
    return row


def phase_graph_memory(reserved_before, reserved_with_model, entry_bytes):
    """Freeing a model frees its graph cache: once the caller has dropped
    the last reference to the model, `empty_cache` must return the entries'
    buffers and the graphs' pool, leaving the card's reserved memory within
    1 GiB of what it was before the model was made."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    after = torch.cuda.memory_reserved()
    check(after <= reserved_before + 2 ** 30,
          f"freeing the model left {after / 2 ** 30:.2f} GiB reserved, {reserved_before / 2 ** 30:.2f} before it")
    emit("decode_graphs_memory", entry_buffers_gib=entry_bytes / 2 ** 30,
         reserved_with_model_gib=reserved_with_model / 2 ** 30, reserved_before_model_gib=reserved_before / 2 ** 30,
         reserved_after_free_gib=after / 2 ** 30)


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


class Run(NamedTuple):
    """One training run of `phase_train`: remat execution or None, compute
    dtype, steps, whether one more step runs under the profiler, the remat
    policy, the batch, and whether it trains with the JAX package's
    flagship recipe (bf16 storage and gradients, Adafactor 1e-3, no
    clipping; `bench.py`, `tools/flagship_sweep.py`) instead of f32 masters
    and Adam 3e-4 with clipping at 0.5; with `measure`, one more step under
    the FLOPs count and the allocator's peak (`measured_step`)."""

    execution: Optional[str]
    dtype: torch.dtype
    steps: int
    profile: bool
    policy: str = "full"
    batch: int = 4
    recipe: bool = False
    measure: bool = False


CUBLAS_KERNEL = re.compile(r"gemm|cutlass|nvjet|xmma|cublas", re.IGNORECASE)


def host_and_device(fn):
    """(host ms to issue fn's work, its kernels' device ms from the
    profiler, the kernel count) of one call of fn."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    rows = device_profile(fn)
    return host, sum(ms for _, ms, _ in rows), sum(c for _, _, c in rows)


def optimizer_profile(state, step_fn):
    """The grouped optimizer's update alone (on zero gradients of the
    parameters' dtype, the same kernels as a step's) and the stochastic
    rounding alone (on each group's stacked f32 shape), host and device
    time each."""
    from dalle_pytorch_tpu_torch.parallel.train_step import stochastic_round

    grads = [torch.zeros_like(p) for p in state.params.values()]
    host, device, kernels = host_and_device(lambda: step_fn.apply_update(state, grads))
    groups = state.opt_state.groups
    out = dict(host_ms=host, device_ms=device, kernels=kernels, groups=len(groups))
    if state.round_generator is not None:
        sizes = [(len(g.names), *g.shape) for g in groups]
        buf = torch.zeros(max(int(np.prod(size)) for size in sizes), device="cuda")

        def rounding():
            for size in sizes:
                stochastic_round(buf[: int(np.prod(size))].view(size), generator=state.round_generator)

        out["rounding_host_ms"], out["rounding_device_ms"], out["rounding_kernels"] = host_and_device(rounding)
    return out


# the kernels-line name of each tallied kernel -> its kind in `kernels/work.py`
WORK_KIND = {"flash_fwd": "fwd", "flash_dq": "dq", "flash_dkv": "dkv", "flash_fwd_compact": "fwd",
             "flash_max_compact": "vfa_max", "flash_fwd_compact_vfa": "vfa_fwd", "flash_dq_compact": "dq",
             "flash_dkv_compact": "dkv"}
LEDGER_BAND = (1 / 3, 3)  # measured over analytic, the JAX package's band (tests/test_memory.py)
# a step taken after the FLOPs count against a plain step's peak, relative:
# the count runs on the meta device and leaves the step as it was
COUNT_PEAK_SLACK = 0.01


def meta_count(step):
    """The measured FLOPs count of `step`, a step on the meta device
    (`observability/cuda.step_cost_analysis`), which must take nothing on
    the card: the bytes allocated, and the allocator's peak across the
    count, stay where they were."""
    from dalle_pytorch_tpu_torch.observability import cuda as obs_cuda

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _, ca = obs_cuda.step_cost_analysis(step)
    torch.cuda.synchronize()
    peak, after = torch.cuda.max_memory_allocated(), torch.cuda.memory_allocated()
    check(peak == before == after, f"the count on meta moved the card's memory: {before} before, peak {peak}, "
          f"{after} after")
    return ca


def step_under_counter(step, meta_ca, name):
    """The same step on the card under the measured count
    (`step_cost_analysis` around a real step, as the CLI first counted
    its first step): its flash tally must be the meta count's record for
    record (the meta route takes the card's grid); returns (the step's
    result, its peak, its aten FLOPs over the meta count's), a reading of
    what the counter's dispatch mode does to a step on the card."""
    from dalle_pytorch_tpu_torch.observability import cuda as obs_cuda

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out, ca = obs_cuda.step_cost_analysis(step)
    torch.cuda.synchronize()
    check([(r.name, r.flops) for r in ca["flash_records"]] == [(r.name, r.flops) for r in meta_ca["flash_records"]],
          f"{name}: the card's tally differs from the meta count's")
    return out, torch.cuda.max_memory_allocated(), ca["aten_flops"] / meta_ca["aten_flops"]


def counted_step_peak(step, plain_peak, name):
    """A step taken right after the FLOPs count, as the CLI takes its first
    step: its peak (`max_memory_allocated` after a reset) must equal the
    plain step's `plain_peak` within `COUNT_PEAK_SLACK`.  Returns (the
    step's result, its peak)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = step()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    check(abs(peak - plain_peak) <= COUNT_PEAK_SLACK * plain_peak,
          f"{name}: the step after the FLOPs count peaked at {peak}, a plain step at {plain_peak}")
    return out, peak


def ledger_reading(memory, ledger, peak, name):
    """A ledger's rows and total beside a measured step peak: the verdict
    must be `fits`, measured over ledger inside `LEDGER_BAND`, and a
    `MemoryCrosscheck` fed the same reading twice must not alarm."""
    total = ledger["total_bytes"]
    ratio = peak / total
    check(ledger["fits"] is True, f"{name}: the ledger's verdict is {ledger['fits']} ({total / 1e9:.3f} GB of "
          f"{ledger['capacity_bytes']})")
    check(LEDGER_BAND[0] < ratio < LEDGER_BAND[1], f"{name}: measured peak over ledger {ratio:.3f}")
    chk = memory.MemoryCrosscheck(total, rtol=0.5)
    chk.check(peak)
    chk.check(peak)
    check(not chk.alarmed, f"{name}: a repeated memory crosscheck alarmed")
    return dict(rows={r["name"]: r["bytes"] for r in ledger["rows"]}, total_bytes=total, verdict="fits",
                dominant=ledger["dominant"], capacity_bytes=ledger["capacity_bytes"], measured_peak_bytes=peak,
                measured_over_ledger=ratio)


def tally_against_bounds(fa, tr, records, cfg, rows, name):
    """Each tallied flash launch against what the bound functions count
    for it: its shape the model's (rows x heads, the sequence, the head
    dim), a pattern call's live tiles those of one of the model's patterns
    at the kernels' tiles, and its FLOPs `dense_work` / `pattern_work` of
    that geometry, exactly.  Returns the FLOPs by kernel."""
    from dalle_pytorch_tpu_torch.kernels import work

    tcfg = cfg.transformer_config()
    n, d, h = cfg.total_seq_len, cfg.dim_head, cfg.heads
    live = {"row": set(), "col": set()}
    for key in dict.fromkeys(tr._pattern_key(sp) for sp in tr.derive_layer_specs(tcfg)):
        pm = tr._pattern_for(tcfg, *key)
        if pm is not None:
            t = fa.pattern_tables(pm, n, d)
            live["row"].add(t.live_tiles)
            live["col"].add(t.live_tiles_dkv)
    by_kernel = {}
    for r in records:
        kind = WORK_KIND[r.name]
        check((r.bh, r.n, r.d, r.causal, r.key_masked) == (rows * h, n, d, True, False),
              f"{name}: a tallied {r.name} launch at {(r.bh, r.n, r.d, r.causal, r.key_masked)}")
        if r.live_tiles is None:
            flops = work.dense_work(kind, rows, h, n, d, r.dtype, True, None)[1]
        else:
            check(r.live_tiles in live["col" if kind == "dkv" else "row"],
                  f"{name}: {r.name}'s {r.live_tiles} live tiles are no pattern's of the model")
            flops = work.pattern_work(kind, r.bh, n, d, r.dtype, r.live_tiles, r.heads, r.tile)[1]
        check(flops == r.flops, f"{name}: {r.name} tallied {r.flops} FLOPs, the bound counts {flops}")
        by_kernel[r.name] = by_kernel.get(r.name, 0.0) + flops
    return by_kernel


def measured_step(fa, tr, cfg, vae, state, step_fn, batch, settings, dtype, step_s, name, peak, last_step,
                  per_step, plain_peak):
    """A training run's readings: the ledger beside the run's step peak
    (`peak`: `max_memory_allocated` over its steps less what was allocated
    before its model was made — the frozen VAE, what other phases keep;
    `ledger_reading`), the in-place audit of its last step (`last_step`:
    the bytes allocated before and after it), then the measured FLOPs count
    of its step on the meta device (`train_dalle.dalle_meta_step`,
    `meta_count`: nothing taken on the card): its launches the run's
    `per_step` launches, each flash launch's tallied work against the
    bounds (`tally_against_bounds`), the measured FLOPs over the analytic
    ones (tile granularity) inside (1/3, 3), and the MFU of the run's step
    time at the card's peak for the compute dtype; then one more step on
    the card, whose peak must be the run's last plain step's `plain_peak`
    (`counted_step_peak`), and one under the counter on the card
    (`step_under_counter`: its tally the meta count's, its peak read).
    Returns (the state after the steps, the readings)."""
    from dalle_pytorch_tpu_torch.cli.train_dalle import dalle_meta_step
    from dalle_pytorch_tpu_torch.observability import memory
    from dalle_pytorch_tpu_torch.training import profiling

    dev = torch.device("cuda")
    rows = int(batch["text"].shape[0])
    ledger = memory.dalle_step_memory(None, state.params, state.opt_state, cfg, rows, settings=settings, device=dev)
    held = memory.state_bytes(state)
    audit = memory.audit_donation({"output_bytes": last_step[1] - last_step[0]}, held)
    check(audit["ok"], f"{name}: the last step left {audit['grown_bytes']} bytes more allocated (slack "
          f"{audit['slack_bytes']}): a second copy of the state")
    ca = meta_count(dalle_meta_step(cfg, vae, batch, dtype))
    launched = {k: per_step[k] for k in WORK_KIND}
    tallied = {k: ca["flash_launches"].get(k, 0) for k in WORK_KIND}
    check(tallied == launched, f"{name}: the tally counted {tallied} launches, a step's counters {launched}")
    flash = tally_against_bounds(fa, tr, ca["flash_records"], cfg, rows, name)
    out, counted_peak = counted_step_peak(lambda: step_fn(state, batch), plain_peak, name)
    out, under_counter, aten_ratio = step_under_counter(lambda: step_fn(out[0], batch), ca, name)
    n_matmul = profiling.matmul_param_count(state.params)
    analytic = profiling.dalle_step_flops(cfg, rows, n_matmul, granularity="tile")
    ratio = ca["flops"] / analytic
    check(LEDGER_BAND[0] < ratio < LEDGER_BAND[1], f"{name}: measured over analytic FLOPs {ratio:.3f}")
    peak_flops = profiling.chip_peak_flops(dtype)
    check(peak_flops is not None, f"no peak for {torch.cuda.get_device_name(0)} in {dtype}")
    readings = dict(
        memory=dict(ledger_reading(memory, ledger, peak, name), in_place_audit=audit),
        flops=dict(measured=ca["flops"], aten=ca["aten_flops"], flash=ca["flash_flops"], flash_by_kernel=flash,
                   analytic_tile=analytic,
                   analytic_element=profiling.dalle_step_flops(cfg, rows, n_matmul, granularity="element"),
                   measured_over_analytic=ratio, tallied_launches=tallied, peak_flops=peak_flops,
                   mfu=profiling.mfu(analytic, step_s, dtype=dtype), mfu_measured=ca["flops"] / step_s / peak_flops),
        counted_step=dict(peak_bytes=counted_peak, plain_step_peak_bytes=plain_peak,
                          over_plain=counted_peak / plain_peak, slack=COUNT_PEAK_SLACK,
                          under_counter_peak_bytes=under_counter, under_counter_over_plain=under_counter / plain_peak,
                          under_counter_aten_over_meta=aten_ratio))
    return out[0], readings


def phase_train(fa, port, phase, model_kwargs, runs):
    """The training path at full width: pixels through the frozen VAE, the
    DALL-E loss, backward through the flash kernels, the guard and the
    optimizer, on one repeated batch (`Run`: f32 masters, Adam and clipping,
    or the JAX recipe's bf16 storage and gradients with Adafactor), each run
    on a fresh model and a fresh optimizer; the loss must fall over its
    steps.  With `profile`, one more step runs under the profiler for the
    device-time breakdown (flash kernels, cuBLAS) and, for a grouped
    optimizer, the update and the rounding are profiled alone.  Each run's
    launches per step must match the layer cycle and the remat policy
    (`launches_per_step`)."""
    import dataclasses

    from dalle_pytorch_tpu_torch.cli.train_dalle import dalle_loss_fn
    from dalle_pytorch_tpu_torch.models import transformer as tr
    from dalle_pytorch_tpu_torch.models.dalle import DALLEConfig, init_dalle
    from dalle_pytorch_tpu_torch.optim.adafactor import Adafactor
    from dalle_pytorch_tpu_torch.parallel.train_step import StepSettings, make_train_step

    dev = torch.device("cuda")
    vae = port.DiscreteVAE(seed=0, **FULL_VAE)
    cfg = DALLEConfig.from_vae(vae.cfg, **model_kwargs)
    rng = np.random.default_rng(8)
    text = torch.from_numpy(rng.integers(1, cfg.num_text_tokens, (4, cfg.text_seq_len))).to(dev)
    text[3, 200:] = 0  # a padded caption
    pixels = torch.from_numpy(rng.random((4, vae.image_size, vae.image_size, 3), dtype=np.float32)).to(dev)
    extra = max(r.batch for r in runs) - 4
    if extra > 0:  # rows past the first 4, drawn after them
        text = torch.cat([text, torch.from_numpy(rng.integers(1, cfg.num_text_tokens, (extra, cfg.text_seq_len))).to(dev)])
        pixels = torch.cat([pixels, torch.from_numpy(
            rng.random((extra, vae.image_size, vae.image_size, 3), dtype=np.float32)).to(dev)])
    adam = functools.partial(torch.optim.Adam, lr=3e-4, betas=(0.9, 0.999), eps=1e-8)

    def run(model, r: Run, resident):
        batch = {"text": text[: r.batch], "image": pixels[: r.batch]}
        if r.recipe:
            settings = StepSettings(compute_dtype=r.dtype, grad_dtype=torch.bfloat16, param_dtype=torch.bfloat16)
            optimizer = Adafactor(1e-3)
        else:
            settings, optimizer = StepSettings(compute_dtype=r.dtype, clip_grad_norm=0.5), adam
        init_fn, step_fn = make_train_step(dalle_loss_fn(model, vae.module, r.dtype), optimizer, settings)
        state = init_fn(dict(model.named_parameters()))
        torch.cuda.synchronize()
        reset_launches(fa)
        losses, norms, secs, step_peaks = [], [], [], []
        for _ in range(r.steps):
            before_step = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            step_peaks.append(torch.cuda.max_memory_allocated())
        last_step = (before_step, torch.cuda.memory_allocated())
        launches = read_launches(fa)
        name = str(r.dtype).replace("torch.", "") + ("_remat" if r.execution == "remat" else "")
        if r.policy != "full":
            name += f"_{r.policy}"
        if r.batch != 4:
            name += f"_b{r.batch}"
        if r.recipe:
            name += "_bf16_params_adafactor"
        check(all(np.isfinite(losses)), f"{name}: non-finite loss {losses}")
        check(losses[-1] < losses[0], f"{name}: the loss did not fall: {losses}")
        per_step = {key: value / r.steps for key, value in launches.items()}
        want = launches_per_step(model, cfg.total_seq_len)
        check(per_step == want, f"{name}: launches per step {per_step}, the layer cycle gives {want}")
        step_s = statistics.median(secs[1:]) if r.steps > 2 else secs[-1]
        peak = max(step_peaks)
        measured = None
        if r.measure:
            state, measured = measured_step(fa, tr, model.cfg, vae.module, state, step_fn, batch, settings, r.dtype,
                                            step_s, f"{phase} {name}", peak - resident, last_step, per_step,
                                            step_peaks[-1])
        out = dict(losses=losses, grad_norms=norms, step_s=step_s, first_step_s=secs[0], steps_s=secs,
                   tokens_per_s=r.batch * cfg.total_seq_len / step_s, batch=r.batch, remat_policy=r.policy,
                   peak_memory_gib=peak / 2 ** 30, peak_memory_gb=peak / 1e9, launches_per_step=per_step,
                   param_dtype=str(next(model.parameters()).dtype).replace("torch.", ""),
                   optimizer="adafactor" if r.recipe else "adam")
        if measured is not None:
            out.update(measured)
        if r.profile:
            rows = device_profile(lambda: step_fn(state, batch))
            total = sum(ms for _, ms, _ in rows)
            ours = {key: sum(ms for kname, ms, _ in rows if f"{key}_kernel" in kname)
                    for key in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "flash_fwd_compact",
                                "flash_max_compact", "flash_fwd_compact_vfa", "flash_dq_compact",
                                "flash_dkv_compact")}
            cublas = sum(ms for kname, ms, _ in rows if CUBLAS_KERNEL.search(kname))
            out["profile"] = dict(device_ms=total, flash_ms=ours, flash_share=sum(ours.values()) / total,
                                  cublas_ms=cublas, cublas_share=cublas / total,
                                  kernels=sum(c for _, _, c in rows),
                                  top=[dict(name=kname[:90], device_ms=ms, count=c) for kname, ms, c in rows[:8]])
            if hasattr(step_fn, "apply_update"):
                opt = optimizer_profile(state, step_fn)
                opt.update(device_share=opt["device_ms"] / total, host_share=opt["host_ms"] / 1e3 / step_s)
                if "rounding_device_ms" in opt:
                    opt.update(rounding_device_share=opt["rounding_device_ms"] / total,
                               rounding_host_share=opt["rounding_host_ms"] / 1e3 / step_s)
                out["profile"]["optimizer"] = opt
        return name, out, launches

    results, total, n_params = {}, dict.fromkeys(COUNTERS, 0), None
    for r in runs:
        resident = torch.cuda.memory_allocated()
        model = init_dalle(dataclasses.replace(cfg, execution=r.execution, remat_policy=r.policy),
                           torch.Generator(device=dev).manual_seed(1), dev).train().requires_grad_(True)
        n_params = sum(p.numel() for p in model.parameters())
        name, results[name], launches = run(model, r, resident)
        total = {key: total[key] + launches[key] for key in COUNTERS}
        del model
        torch.cuda.empty_cache()
    emit(phase, params=n_params, seq_len=cfg.total_seq_len, vocab=cfg.total_tokens,
         depth=cfg.depth, attn_types=cfg.attn_types, **results,
         peak_memory_gib={name: r["peak_memory_gib"] for name, r in results.items()})
    return total


def standard_runs(steps, measure=False):
    """f32 then bf16 compute for `steps` steps each (the first profiled; with
    `measure`, the f32 run measured), then 2 rematerialised f32 steps."""
    return [Run(None, torch.float32, steps, True, measure=measure), Run(None, torch.bfloat16, steps, True),
            Run("remat", torch.float32, 2, False)]


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


def bf16_step_distance(a: torch.Tensor, b: torch.Tensor, before: torch.Tensor) -> torch.Tensor:
    """|a - b| in bf16 steps at the largest of |before|, |a| and |b| (all
    bf16-exact), so that an update that nearly cancels the parameter is
    measured at the scale it was computed at."""
    m = torch.maximum(torch.maximum(before.float().abs(), a.float().abs()), b.float().abs())
    step = (m.view(torch.int32) + (1 << 16)).view(torch.float32) - m
    return (a.float() - b.float()).abs() / step


def phase_lowp_train_parity(fa, port, phase="lowp_train_parity", small=SMALL_FLAGSHIP, vae_kwargs=SMALL_SPARSE_VAE):
    """The JAX flagship recipe on a small model with the flagship's features
    (remat `flash_qkv`, f32 compute, bf16 storage and gradients, Adafactor
    1e-3): 3 steps on the card (kernels), each repeated on the CPU (plain
    versions) from the card's parameters and Adafactor statistics before
    it, the stochastic rounding's bits drawn once on the CPU and handed to
    both.  Loss and grad norm agree to 1e-4 relative each step; after each
    step the bf16 parameters are equal on all but 1e-4 of the elements, and
    each of the rest is one bf16 step away (at the largest of the parameter
    before the step and the two results) where the two sides' bf16
    gradients are equal.  Where the gradients differ (the kernels and the
    plain versions sum in other orders, and a bf16 gradient can land on the
    other side of a rounding boundary) the update moves with the gradient,
    by up to one step of the update, and the rounding adds one: two steps
    are allowed there and only there.  The elements more than one step
    apart are printed with both sides' gradients and updates."""
    import copy
    import dataclasses

    from torch.func import functional_call

    from dalle_pytorch_tpu_torch.models.dalle import DALLEConfig, init_dalle
    from dalle_pytorch_tpu_torch.optim.adafactor import Adafactor
    from dalle_pytorch_tpu_torch.parallel.train_step import StepSettings, make_train_step

    vae_cpu = port.DiscreteVAE(seed=0, device="cpu", **vae_kwargs)
    cfg = dataclasses.replace(DALLEConfig.from_vae(vae_cpu.cfg, **small), execution="remat", remat_policy="flash_qkv")
    cpu = init_dalle(cfg, torch.Generator().manual_seed(5), "cpu").train()
    gpu = copy.deepcopy(cpu).cuda()
    rng = np.random.default_rng(9)
    batches = [{"text": torch.from_numpy(rng.integers(0, cfg.num_text_tokens, (2, cfg.text_seq_len))),
                "codes": torch.from_numpy(rng.integers(0, cfg.num_image_tokens, (2, cfg.image_seq_len)))}
               for _ in range(3)]
    gen = torch.Generator().manual_seed(10)
    bits = [{name: torch.randint(0, 65536, p.shape, generator=gen, dtype=torch.int32)
             for name, p in cpu.named_parameters()} for _ in batches]
    settings = StepSettings(grad_dtype=torch.bfloat16, param_dtype=torch.bfloat16)

    class Recorded(Adafactor):
        """Adafactor that keeps the last step's f32 gradients and updates by
        leaf name, on the CPU."""

        def __init__(self, lr):
            super().__init__(lr)
            self.seen = {}

        def update(self, grads, group, params, count):
            u, group = super().update(grads, group, params, count)
            self.seen.update({n: (g.cpu(), x.cpu()) for n, g, x in zip(group.names, grads, u)})
            return u, group

    def trainer(model):
        def loss_fn(params, batch, generator):
            return functional_call(model, params, (batch["text"], batch["codes"]), {"return_loss": True})

        opt = Recorded(1e-3)
        init_fn, step_fn = make_train_step(loss_fn, opt, settings)
        return init_fn(dict(model.named_parameters())), step_fn, opt

    (gpu_state, gpu_step, gpu_opt), (cpu_state, cpu_step, cpu_opt) = trainer(gpu), trainer(cpu)
    reset_launches(fa)
    rows, differ, grads_differ, over_one, over_one_same_grad, worst, apart = [], [], [], [], [], 0.0, []
    total = sum(p.numel() for p in cpu.parameters())
    for step, (batch, round_bits) in enumerate(zip(batches, bits)):
        with torch.no_grad():  # the CPU takes this step from the card's state
            for c, g in zip(cpu.parameters(), gpu.parameters()):
                c.copy_(g.cpu())
            for cg, gg in zip(cpu_state.opt_state.groups, gpu_state.opt_state.groups):
                cg.stats = {key: v.cpu() for key, v in gg.stats.items()}
        before = {n: p.detach().clone() for n, p in cpu.named_parameters()}
        gpu_state, got = gpu_step(gpu_state, {k: x.cuda() for k, x in batch.items()}, round_bits=round_bits)
        cpu_state, ref = cpu_step(cpu_state, batch, round_bits=round_bits)
        rows.append({"card": [float(got["loss"]), float(got["grad_norm"])],
                     "cpu": [float(ref["loss"]), float(ref["grad_norm"])]})
        n_differ = n_grads = n_over = n_over_same = 0
        for (name, g), c in zip(gpu.named_parameters(), cpu.parameters()):
            g, c, b = g.detach().cpu(), c.detach(), before[name]
            check(g.dtype == c.dtype == torch.bfloat16, f"{g.dtype} / {c.dtype} storage")
            (g_card, u_card), (g_cpu, u_cpu) = gpu_opt.seen[name], cpu_opt.seen[name]
            grad_differs = g_card != g_cpu
            n_differ += int((g != c).sum())
            n_grads += int(grad_differs.sum())
            steps = bf16_step_distance(g, c, b)
            n_over += int((steps > 1).sum())
            n_over_same += int(((steps > 1) & ~grad_differs).sum())
            worst = max(worst, float(steps.max()))
            for i in (steps > 1).nonzero().tolist()[:4]:
                i = tuple(i)
                apart.append(dict(step=step + 1, leaf=name, index=list(i), bf16_steps=float(steps[i]),
                                  before=float(b[i]), card=float(g[i]), cpu=float(c[i]),
                                  grad_card=float(g_card[i]), grad_cpu=float(g_cpu[i]),
                                  grad_bf16_steps=float(bf16_step_distance(g_card[i].bfloat16(),
                                                                           g_cpu[i].bfloat16(), g_cpu[i])),
                                  update_card=float(u_card[i]), update_cpu=float(u_cpu[i]),
                                  bits=int(round_bits[name][i])))
        differ.append(n_differ)
        grads_differ.append(n_grads)
        over_one.append(n_over)
        over_one_same_grad.append(n_over_same)
    launches = read_launches(fa)
    agree = sum(all(abs(g - r) <= 1e-4 * abs(r) for g, r in zip(row["card"], row["cpu"])) for row in rows)
    want = launches_per_step(gpu, cfg.total_seq_len)
    emit(phase, steps=len(batches), steps_agree=agree, tolerance=1e-4, steps_read=rows,
         params_differ=differ, grads_differ=grads_differ, params_differ_over_one_step=over_one,
         over_one_step_with_equal_grads=over_one_same_grad, params=total, worst_bf16_steps=worst,
         over_one_step=apart[:12], n=cfg.total_seq_len, launches=launches, launches_per_step_expected=want)
    check(agree == len(batches), f"only {agree} of {len(batches)} low-precision steps agree between card and CPU")
    check(max(differ) <= 1e-4 * total and worst <= 2.0 and max(over_one_same_grad) == 0,
          f"bf16 parameters: {differ} of {total} differ, {over_one_same_grad} by more than one bf16 step "
          f"where the two gradients are equal, the worst by {worst} bf16 steps")
    check(launches == {k: len(batches) * v for k, v in want.items()},
          f"launches {launches}, the cycle under flash_qkv gives {want} a step")
    check(min(launches[k] for k in VFA_KERNELS + ("flash_dq_compact", "flash_dkv_compact")) > 0,
          f"the recipe's steps left the VFA pair or a compacted backward kernel unlaunched: {launches}")
    return launches


def phase_remat_policies(fa, port, model_kwargs=SLICE):
    """The README pattern model at full width, batch 4, bf16 compute on a
    working copy of f32 masters: one loss and gradient under each remat
    policy and sequentially, on the same weights and batch.  Loss and grad
    norm equal the sequential step's to 1e-5 relative; the launches follow
    the policy (the forward twice under "full", once under the others);
    peak memory in the order full <= flash <= flash_qkv <= flash_qkv_ff <=
    sequential.  Under each, the step's FLOPs counted on the meta device
    (`meta_count`) tally the launches the policy gives, the same step
    taken again after the count peaks where the plain one did
    (`counted_step_peak`), and once more under the counter on the card
    its tally is the meta count's and its peak is read
    (`step_under_counter`)."""
    import dataclasses

    from torch.func import functional_call

    from dalle_pytorch_tpu_torch.models.dalle import DALLE, DALLEConfig, init_dalle

    dev = torch.device("cuda")
    vae = port.DiscreteVAE(seed=0, **FULL_VAE)
    cfg = DALLEConfig.from_vae(vae.cfg, **model_kwargs)
    model = init_dalle(cfg, torch.Generator(device=dev).manual_seed(1), dev).train().requires_grad_(True)
    rng = np.random.default_rng(11)
    text = torch.from_numpy(rng.integers(1, cfg.num_text_tokens, (4, cfg.text_seq_len))).to(dev)
    codes = torch.from_numpy(rng.integers(0, cfg.num_image_tokens, (4, cfg.image_seq_len))).to(dev)
    masters = dict(model.named_parameters())
    base = model.transformer.cfg
    results = {}
    for execution, policy in (("sequential", "full"), ("remat", "full"), ("remat", "flash"),
                              ("remat", "flash_qkv"), ("remat", "flash_qkv_ff")):
        model.transformer.cfg = dataclasses.replace(base, execution=execution, remat_policy=policy)
        name = "sequential" if execution == "sequential" else policy

        def step():
            work = {n: p.to(torch.bfloat16) for n, p in masters.items()}
            loss = functional_call(model, work, (text, codes), {"return_loss": True})
            grads = torch.autograd.grad(loss, list(masters.values()))
            gnorm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
            return float(loss.detach()), float(gnorm)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches(fa)
        t0 = time.perf_counter()
        loss, gnorm = step()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = read_launches(fa)
        want = launches_per_step(model, cfg.total_seq_len)
        check(launches == want, f"{name}: launches {launches}, the policy gives {want}")
        with torch.device("meta"):
            shapes = DALLE(dataclasses.replace(cfg, execution=execution, remat_policy=policy))
        meta_params = {n: p.detach().to(torch.bfloat16).requires_grad_() for n, p in shapes.train().named_parameters()}
        ca = meta_count(lambda: functional_call(shapes, meta_params, (text.to("meta"), codes.to("meta")),
                                                {"return_loss": True}).backward())
        tallied = {k: ca["flash_launches"].get(k, 0) for k in WORK_KIND}
        check(tallied == {k: want[k] for k in WORK_KIND}, f"{name}: the count tallied {tallied}, the policy gives {want}")
        counted, counted_peak = counted_step_peak(step, peak, f"remat_policies {name}")
        _, under_counter, aten_ratio = step_under_counter(step, ca, f"remat_policies {name}")
        check(all(abs(c - p) <= 1e-5 * abs(p) for c, p in zip(counted, (loss, gnorm))),
              f"{name}: the step after the count gave {counted}, the plain one {(loss, gnorm)}")
        results[name] = dict(loss=loss, grad_norm=gnorm, step_s=seconds, peak_memory_gib=peak / 2 ** 30,
                             counted_step_peak_gib=counted_peak / 2 ** 30, flops_counted=ca["flops"],
                             under_counter_peak_gib=under_counter / 2 ** 30, under_counter_aten_over_meta=aten_ratio,
                             flash_fwd=launches["flash_fwd"], vfa_pair=launches["flash_max_compact"])
    model.transformer.cfg = base
    seq = results["sequential"]
    for name, r in results.items():
        for key in ("loss", "grad_norm"):
            check(abs(r[key] - seq[key]) <= 1e-5 * abs(seq[key]), f"{name}: {key} {r[key]} against {seq[key]}")
    order = ["full", "flash", "flash_qkv", "flash_qkv_ff", "sequential"]
    peaks = [results[name]["peak_memory_gib"] for name in order]
    emit("remat_policies", batch=4, n=cfg.total_seq_len, depth=cfg.depth, **results,
         bit_equal={name: r["loss"] == seq["loss"] and r["grad_norm"] == seq["grad_norm"] for name, r in results.items()},
         peak_order=order)
    check(peaks == sorted(peaks), f"peak memory {dict(zip(order, peaks))} is not in the policies' order")
    del model
    torch.cuda.empty_cache()


def phase_numerics_smoke():
    """`tools/numerics_smoke.py --steps 60` (flagship width, depth 8, batch
    8, the JAX recipe; the tool's default is 200 steps, and the loss falls
    past its 5 % bar inside 60: 9.2498 -> 8.6509, the mean of its last four
    losses, on an H100 80GB HBM3 at 700 W) in process (a subprocess's
    start costs tens of seconds on the card's machine): its loss must
    fall."""
    import io

    from dalle_pytorch_tpu_torch.tools import numerics_smoke

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        try:
            rc = numerics_smoke.main(["--steps", "60"])
        except SystemExit as e:  # the tool exits 1 on an error, 2 when the loss did not fall
            rc = e.code
    seconds = time.perf_counter() - t0
    lines = [line for line in out.getvalue().splitlines() if line.startswith("{")]
    check(bool(lines), f"numerics_smoke printed no result (rc {rc})")
    result = json.loads(lines[-1])
    emit("numerics_smoke", rc=rc, seconds=seconds, **result)
    check(rc == 0 and result.get("decreased") is True, f"numerics_smoke: rc {rc}, decreased {result.get('decreased')}")


def phase_train_cli(fa, weights, checkpoint):
    """`cli.train_dalle --dummy_run 4 --execution remat --remat_policy
    flash_qkv --param_dtype bfloat16` in process (the dummy model at head
    dim 32, which the kernels take; the `python -m` entry runs under
    torchrun in `dist_train_cli`): its checkpoint loads back through the
    port's reader with bf16 leaves and gives finite logits.  The dummy
    run's default f32 path is the real-data phase's (`train_real_data`).
    Returns the launches."""
    from dalle_pytorch_tpu_torch.cli import train_dalle

    flags = ["--execution", "remat", "--remat_policy", "flash_qkv", "--param_dtype", "bfloat16", "--dim_head", "32"]
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "dalle"
        lines, launches, _, seconds = run_main(fa, train_dalle.main, ["--dummy_run", "4", "--dalle_output_file_name",
                                                                     str(out), *flags])
        steps = [r for r in lines if "loss" in r]
        losses = [s["loss"] for s in steps]
        check(len(steps) == 4 and all(np.isfinite(losses)), f"train_dalle {flags} steps {steps}")
        trees, meta = checkpoint.load_checkpoint(f"{out}.pt")
        model, vae = weights.load_dalle_checkpoint(f"{out}.pt")
        dtypes = sorted({str(p.dtype).replace("torch.", "") for p in model.parameters()})
        check(dtypes == ["bfloat16"], f"train_dalle {flags}: checkpoint loads with {dtypes} leaves, not bfloat16")
        text = torch.randint(0, model.cfg.num_text_tokens, (1, model.cfg.text_seq_len), device="cuda")
        with torch.no_grad():
            check(bool(torch.isfinite(model(text)).all()), "the trained checkpoint gives non-finite logits")
    emit("train_cli", remat_flash_qkv_bf16=dict(flags=flags, losses=losses, seconds=seconds,
                                               batches=[s["batch"] for s in steps], trees=sorted(trees),
                                               global_step=meta["global_step"], leaf_dtypes=dtypes,
                                               remat_policy=meta["hparams"].get("remat_policy"),
                                               rotary_emb=meta["hparams"].get("rotary_emb"), launches=launches))
    return launches


def spans_of(directory: Path) -> list:
    """The records of a telemetry directory's spans JSONL."""
    files = sorted(Path(directory).glob("*.spans.jsonl"))
    check(len(files) == 1, f"{directory}: spans files {files}")
    return [json.loads(line) for line in files[0].read_text().splitlines() if line.strip()]


LOOP_SPANS = {"data_wait", "dispatch", "block", "log", "checkpoint", "flops_crosscheck"}
OOM_MARGIN = 256 * 2 ** 20  # what the capped allocator may take beyond what it holds


def phase_telemetry_cli(fa):
    """`cli.train_dalle`'s telemetry and out-of-memory exit on the card, in
    process (the dummy model at head dim 32): `--dummy_run 4
    --profile_steps 2:3` writes one Chrome trace of step 2 that names the
    flash kernels; `--hbm_headroom_frac 1e-6 --profile_on_alarm 1` fires
    exactly one `hbm_headroom` alarm and takes exactly one capture; then,
    under a cap of the caching allocator
    (`torch.cuda.set_per_process_memory_fraction`: what it holds now plus
    `OOM_MARGIN`), the 12-layer model's widths run out of memory in the
    allocator itself: SystemExit(77), an `oom_report_*.txt` with the
    ledger's rows and the allocator's stats, and, with the cap lifted, the
    bytes allocated back at their value before the call within 1 MiB."""
    import gc

    from dalle_pytorch_tpu_torch.cli import train_dalle
    from dalle_pytorch_tpu_torch.training import resilience

    small = ["--dummy_run", "4", "--dim_head", "32", "--log_every_n_steps", "1"]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        _, launches, _, seconds = run_main(fa, train_dalle.main, [
            *small, "--profile_steps", "2:3", "--profile_on_alarm", "0", "--dalle_output_file_name",
            str(tmp / "manual")])
        traces = sorted((tmp / "manual.telemetry" / "traces").glob("*.json"))
        check([t.name for t in traces] == ["trace_step2_manual.json"], f"--profile_steps 2:3 wrote {traces}")
        text = traces[0].read_text()
        named = {k: f"{k}_kernel" in text for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
        check(all(named.values()), f"the captured trace names the flash kernels: {named}")
        records = spans_of(tmp / "manual.telemetry")
        check(LOOP_SPANS <= {r["name"] for r in records if r["kind"] == "span"},
              f"spans {sorted({r['name'] for r in records if r['kind'] == 'span'})}")
        out["manual_capture"] = dict(trace_bytes=len(text), names_flash_kernels=named, seconds=seconds,
                                     launches=launches)

        run_main(fa, train_dalle.main, [*small, "--hbm_headroom_frac", "1e-6", "--profile_on_alarm", "1",
                                        "--dalle_output_file_name", str(tmp / "alarm")])
        records = spans_of(tmp / "alarm.telemetry")
        alarms = [r for r in records if r["kind"] == "alarm"]
        starts = [r for r in records if r["kind"] == "trace_capture" and r["action"] == "start"]
        check([a["type"] for a in alarms] == ["hbm_headroom"], f"alarms {alarms}")
        check(len(starts) == 1 and len(list((tmp / "alarm.telemetry" / "traces").glob("*.json"))) == 1,
              f"captures {starts}")
        out["headroom_alarm"] = dict(alarm=alarms[0], capture=starts[0])

        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        total = torch.cuda.get_device_properties(0).total_memory
        cap = (torch.cuda.memory_reserved() + OOM_MARGIN) / total
        argv = ["--dummy_run", "2", "--dim", "1024", "--depth", "12", "--heads", "16", "--dim_head", "64",
                "--text_seq_len", "256", "--dalle_output_file_name", str(tmp / "oom")]
        torch.cuda.set_per_process_memory_fraction(cap)
        code = None
        try:
            with contextlib.redirect_stdout(io.StringIO()) as printed:
                train_dalle.main(argv)
        except SystemExit as e:
            code = e.code
        finally:
            torch.cuda.set_per_process_memory_fraction(1.0)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        after = torch.cuda.memory_allocated()
        check(code == resilience.EXIT_OOM, f"the capped run exited {code}, not {resilience.EXIT_OOM}")
        reports = sorted((tmp / "oom.telemetry").glob("oom_report_*.txt"))
        check(len(reports) == 1, f"OOM reports {reports}")
        report = reports[0].read_text()
        for want in ("CUDA out of memory", "<-- dominant", "params", "activations", "bytes_in_use", "num_ooms",
                     "memory_summary", "suggestions (ranked"):
            check(want in report, f"the OOM report lacks {want!r}")
        check(abs(after - before) <= 2 ** 20, f"allocated {before} before the capped run, {after} after")
        out["oom"] = dict(exit_code=code, cap_fraction=cap, report=reports[0].name, report_lines=len(report.splitlines()),
                          allocated_before=before, allocated_after=after,
                          printed=[ln for ln in printed.getvalue().splitlines() if "[memory]" in ln])
    emit("telemetry_cli", **out)


# the real-data phase: the 12-layer full-attention model at full width with
# learned positions (the JAX train CLI's default, no --rotary_emb), the BPE
# tokenizer's 49,408 text tokens (the CLI takes them from the tokenizer),
# the OpenAI dVAE's geometry; 16 PNGs of 320 x 288 with one to three
# caption lines, as a folder and as a tar shard
REAL_DATA_FLAGS = ("--dim", "1024", "--depth", "12", "--heads", "16", "--dim_head", "64", "--text_seq_len", "256",
                   "--shift_tokens", "--truncate_captions", "--batch_size", "4", "--lr_decay", "--num_workers", "4")
REAL_DATA_IMAGES, REAL_DATA_HW = 16, (288, 320)
REAL_DATA_WORDS = ("a", "red", "blue", "green", "small", "large", "cat", "dog", "house", "on", "under", "the",
                   "table", "tree", "sky", "painting", "of", "river", "at", "night")


def write_real_data(root: Path, seed: int) -> None:
    """`pairs/imgNN.png` + `imgNN.txt` from `seed` (smooth gradients and
    noise, through the port's PNG writer) and `pairs.tar` of the same."""
    import tarfile

    from dalle_pytorch_tpu_torch.cli.png import write_png

    rng = np.random.default_rng(seed)
    pairs = root / "pairs"
    pairs.mkdir()
    h, w = REAL_DATA_HW
    yy, xx = np.mgrid[0:h, 0:w]
    for i in range(REAL_DATA_IMAGES):
        planes = [(xx * rng.integers(1, 4) + yy * rng.integers(1, 4) + rng.integers(0, 48, (h, w))) % 256
                  for _ in range(3)]
        write_png(pairs / f"img{i:02d}.png", np.stack(planes, -1).astype(np.uint8))
        lines = [" ".join(rng.choice(REAL_DATA_WORDS, int(rng.integers(3, 9)))) for _ in range(rng.integers(1, 4))]
        (pairs / f"img{i:02d}.txt").write_text("\n".join(lines))
    with tarfile.open(root / "pairs.tar", "w") as tf:
        for f in sorted(pairs.iterdir()):
            tf.add(f, arcname=f.name)


# the CLIP phase's pairs: one image per colour and pattern, its caption
# naming both, so that training tells the 16 pairs apart where no training
# leaves the loss at log 16
CLIP_COLOURS = {"red": (210, 40, 40), "green": (40, 190, 60), "blue": (40, 70, 220), "yellow": (230, 210, 40)}
CLIP_PATTERNS = ("plain", "stripes", "columns", "checks")
CLIP_LOSS_DROP = 0.1  # nats, over the run's 8 steps


def write_caption_pairs(root: Path, seed: int, hw=REAL_DATA_HW, band: int = 32) -> None:
    """`pairs/imgNN.png` + `imgNN.txt`, 16 of them: colour c in pattern p
    (bands and squares of `band` px, on black) with seeded noise, captioned
    "a c p picture" and "p in c" (the loader picks a line)."""
    from dalle_pytorch_tpu_torch.cli.png import write_png

    rng = np.random.default_rng(seed)
    pairs = root / "pairs"
    pairs.mkdir(parents=True)
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w] // band
    lit = {"plain": np.ones((h, w), bool), "stripes": yy % 2 == 0, "columns": xx % 2 == 0,
           "checks": (yy + xx) % 2 == 0}
    i = 0
    for colour, rgb in CLIP_COLOURS.items():
        for pattern in CLIP_PATTERNS:
            pixels = lit[pattern][..., None] * np.array(rgb) + rng.integers(0, 32, (h, w, 3))
            write_png(pairs / f"img{i:02d}.png", np.clip(pixels, 0, 255).astype(np.uint8))
            (pairs / f"img{i:02d}.txt").write_text(f"a {colour} {pattern} picture\n{pattern} in {colour}")
            i += 1


def run_train_cli(fa, argv):
    """`cli.train_dalle.main(argv)` in process (`run_main`); returns (the
    step records, the header line with the config and the parameter count,
    launches, wall seconds)."""
    from dalle_pytorch_tpu_torch.cli import train_dalle

    lines, launches, _, wall_s = run_main(fa, train_dalle.main, argv)
    header = next(r for r in lines if "config" in r)
    return [r for r in lines if "loss" in r], header, launches, wall_s


def plateau_and_step(path) -> dict:
    """A checkpoint's global_step and its reduce-on-plateau leaves, read
    from the npz without loading the weights."""
    with np.load(str(path), allow_pickle=False) as data:
        meta = json.loads(bytes(data["__meta"]).decode())
        paths = json.loads(bytes(data["__paths_opt_state"]).decode())
        leaves = {p[-1][1]: data[f"opt_state:{i}"].item() for i, p in enumerate(paths)
                  if p[0] == ["i", 1] and p[-1][0] == "a"}
    return {"global_step": meta["global_step"], **leaves}


def phase_train_real_data(fa, tr, sampling, weights, rotary_step_ms):
    """Train what the JAX CLI trains, on real data, then serve it, at the
    full width of the 12-layer model with learned positions:
    (1) `train_dalle --image_text_folder --vae_path --epochs 2
    --save_every_n_steps 4 --keep_n_checkpoints 1 --lr_decay` (8 steps of
    batch 4); (2) `--resume` of a step file is `dist_train_cli`'s (the
    torchrun run's file, with --lr_decay), and `--wds` over the tar shard
    is `train_openai_taming`'s --taming run; (3)
    `cli.generate` from the final
    checkpoint, two prompts with CFG, replayed, PNGs of 256 x 256 x 3, and
    the replayed loop's codes equal to the eager loop's under one noise
    (`decode_graphs`, the last 128 steps, and the replayed step's ms over a
    whole image beside the rotary model's); (4) the engine: two requests
    (one guided) give their batch-1 codes under their noise, and `generate
    --engine` writes the PNGs `generate` writes under one seed.  Also the
    host's PNG decode rate and the loader's batches/s.  Returns the
    launches of (1)."""
    import types

    from dalle_pytorch_tpu_torch.cli import train_dalle
    from dalle_pytorch_tpu_torch.cli.png import read_png
    from dalle_pytorch_tpu_torch.data import loader
    from dalle_pytorch_tpu_torch.data import tokenizer as tokenizer_mod
    from dalle_pytorch_tpu_torch.models import vae as vae_mod
    from dalle_pytorch_tpu_torch.serving.engine import EngineConfig, GenerationEngine

    readings = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        write_real_data(tmp, seed=71)
        vae = vae_mod.init_discrete_vae(vae_mod.DiscreteVAEConfig(**FULL_VAE),
                                        torch.Generator(device="cuda").manual_seed(0), "cuda")
        train_dalle.write_vae_checkpoint(str(tmp / "vae.npz"), vae)
        del vae

        files = sorted((tmp / "pairs").glob("*.png"))
        t0 = time.perf_counter()
        for f in files:
            loader.decode_image(f.read_bytes(), str(f), "RGB")
        decode_s = time.perf_counter() - t0
        dataset = loader.TextImageDataset(str(tmp / "pairs"), text_len=256, image_size=FULL_VAE["image_size"],
                                          truncate_captions=True, tokenizer=tokenizer_mod.tokenizer, shuffle=True)
        loader_rate = {}
        for workers in (0, 4):
            t0 = time.perf_counter()
            n = len(list(loader.iterate_batches(dataset, 4, seed=1, num_workers=workers)))
            loader_rate[workers] = n / (time.perf_counter() - t0)
        readings["host"] = dict(png_decode_images_per_s=len(files) / decode_s, png_hw=list(REAL_DATA_HW),
                                loader_batches_per_s={f"workers_{k}": v for k, v in loader_rate.items()},
                                loader_images_per_s={f"workers_{k}": 4 * v for k, v in loader_rate.items()})

        folder = ["--image_text_folder", str(tmp / "pairs"), "--epochs", "2", *REAL_DATA_FLAGS]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        full, header, full_launches, full_s = run_train_cli(fa, [
            *folder, "--vae_path", str(tmp / "vae.npz"), "--save_every_n_steps", "4", "--keep_n_checkpoints", "1",
            "--dalle_output_file_name", str(tmp / "full")])
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        # the run's telemetry, on by default: the loop's spans, a record a step, the ledger, the crosschecks
        records = spans_of(tmp / "full.telemetry")
        span_names = {r["name"] for r in records if r["kind"] == "span"}
        kinds = [r["kind"] for r in records]
        check(LOOP_SPANS <= span_names, f"the real-data run's spans {sorted(span_names)}")
        check(kinds.count("step") == len(full) and kinds.count("mem_ledger") == 1,
              f"the real-data run's records: {kinds.count('step')} steps, {kinds.count('mem_ledger')} ledgers")
        crosschecks = {k: next(r for r in records if r["kind"] == k) for k in ("flops_crosscheck", "memory_crosscheck")}
        check(crosschecks["memory_crosscheck"]["donation"]["ok"]
              and not [r for r in records if r["kind"] == "alarm"], "the real-data run's in-place audit or alarms")
        readings["telemetry"] = dict(
            span_names=sorted(span_names), step_records=kinds.count("step"),
            ledger={r["name"]: r["bytes"] for r in next(r for r in records if r["kind"] == "mem_ledger")["rows"]},
            flops_ratio=crosschecks["flops_crosscheck"]["ratio"],
            flash_launches=crosschecks["flops_crosscheck"]["flash_launches"],
            memory_ratio=crosschecks["memory_crosscheck"]["ratio"],
            measured_peak_bytes=crosschecks["memory_crosscheck"]["total_bytes"])
        losses = [r["loss"] for r in full]
        check(len(full) == 8 and all(np.isfinite(losses)), f"the real-data run's steps: {full}")
        steps_on_disk = sorted(p.name for p in tmp.glob("full_step*"))
        check(steps_on_disk == ["full_step4.npz"], f"step files kept: {steps_on_disk}")
        for name in ("flash_fwd", "flash_dq", "flash_dkv"):
            check(full_launches[name] == 12 * len(full), f"{name}: {full_launches[name]} launches in "
                  f"{len(full)} steps of 12 layers")
        steady = [r["step_s"] for r in full[1:]]
        n_tokens = 4 * (256 + 1024)
        readings["train"] = dict(
            params=header["params"], steps=len(full), batch=4, step_s=statistics.median(steady), step_s_all=[r["step_s"] for r in full],
            data_s=[r["data_s"] for r in full], tokens_per_s=n_tokens / statistics.median(steady),
            peak_memory_gib=peak_gib, losses=losses, lr_scale=[r["lr_scale"] for r in full], wall_s=full_s,
            launches=full_launches)

        prompts = ("a red cat on the table", "a painting of a river at night")
        common = ["--dalle_path", str(tmp / "full.pt"), "--text", "|".join(prompts), "--num_images", "1",
                  "--batch_size", "1", "--seed", "3", "--cond_scale", "3.0"]
        plain_paths, plain_t, _, _, plain_s = run_cli(fa, [*common, "--outputs_dir", str(tmp / "plain")])
        # the engine seeds each prompt's image j with --seed + j, the plain
        # loop one generator over both prompts: the first prompt's image is
        # the one both draw alike
        engine_paths, _, _, _, engine_s = run_cli(fa, [*common[:3], prompts[0], *common[4:], "--outputs_dir",
                                                       str(tmp / "engine"), "--engine", "--engine_slots", "4"])
        pngs = [read_png(p) for p in plain_paths]
        check(len(pngs) == 2 and all(px.shape == (256, 256, 3) for px in pngs), f"generate wrote {plain_paths}")
        check(len(engine_paths) == 1 and np.array_equal(read_png(engine_paths[0]), pngs[0]),
              "generate --engine wrote another image than generate under one seed")

        model, _ = weights.load_dalle_checkpoint(tmp / "full.pt")
    cfg = model.cfg
    check(not cfg.rotary_emb and cfg.num_text_tokens == 49408, f"the trained checkpoint's config {cfg}")
    text = torch.tensor(tokenizer_mod.tokenizer.tokenize(list(prompts), 256, truncate_text=True), device="cuda")
    dalle = types.SimpleNamespace(cfg=cfg, module=model, decode_graphs=sampling.decode_graphs(model))
    graphs_row = phase_decode_graphs(fa, tr, sampling, dalle, text, "12-layer learned positions", 3.0,
                                     prime_len=GRAPHS_PRIME_LEN)

    from dalle_pytorch_tpu_torch.ops.sampling import gumbel_noise

    noise = gumbel_noise((2, cfg.image_seq_len, cfg.total_tokens), torch.Generator(device="cuda").manual_seed(72),
                         device="cuda")
    want, _ = forward_launches(model, cfg.text_seq_len + 1)
    engine = GenerationEngine(model, engine_cfg=EngineConfig(num_slots=4, block_size=ENGINE_BLOCK,
                                                             filter_thres=ENGINE_THRES, noise_override=True))
    reqs, engine_wall_s, engine_steps, _ = engine_run(fa, engine, text, want, stagger=16, noise=list(noise))
    for i, req in enumerate(reqs):
        check(np.array_equal(req.codes, batch1_codes(sampling, model, text[i], i, noise_override=noise[i][:, None])),
              f"the learned-position engine's request {i} differs from its batch-1 codes under its noise")
    del engine, model, dalle
    torch.cuda.empty_cache()
    engine_step_ms = (engine_wall_s - sum(r.phases["prefill"] for r in reqs)) / engine_steps * 1e3
    readings["serve"] = dict(generate_s=plain_s, generate_seconds=plain_t, generate_engine_s=engine_s,
                             engine_step_ms_replayed=engine_step_ms,
                             engine_png_equal_to_generate=True, engine_codes_equal_batch1_under_noise=True,
                             engine_decode_steps=engine_steps, engine_wall_s=engine_wall_s,
                             decode_graphs_codes_equal=graphs_row["codes_equal_under_noise"],
                             replayed_step_ms=graphs_row["step_ms_replayed"], rotary_replayed_step_ms=rotary_step_ms)
    emit("train_real_data", model=dict(dim=1024, depth=12, heads=16, dim_head=64, text_seq_len=256,
                                       num_text_tokens=cfg.num_text_tokens, rotary_emb=False, shift_tokens=True,
                                       vae=FULL_VAE), **readings)
    return full_launches


# the tokenizer's and the reranker's training (VAE and CLIP).  The options
# vae_train_parity holds card against CPU, as the CPU tests hold the port
# against JAX (tests/test_torch_vae_train.py), on a small VAE
VAE_OPTIONS = {
    "plain": {}, "straight_through": dict(straight_through=True),
    "reinmax": dict(straight_through=True, reinmax=True), "smooth_l1": dict(smooth_l1_loss=True),
    "kl": dict(kl_div_loss_weight=1.0), "resnet": dict(num_resnet_blocks=2), "channels4": dict(channels=4),
}
SMALL_TRAIN_VAE = dict(image_size=64, num_tokens=512, codebook_dim=64, num_layers=3, hidden_dim=32)
# BASELINE.json configs[1] ("DiscreteVAE num_tokens=8192 training at 256x256 (train_vae.py)") with the JAX
# CLI's other defaults: 3 layers, 2 resnet blocks, emb 512, hidden 256, batch 8
VAE_CLI_FLAGS = ("--image_size", "256", "--num_tokens", "8192", "--num_layers", "3", "--num_resnet_blocks", "2",
                 "--emb_dim", "512", "--hidden_dim", "256", "--batch_size", "8", "--num_workers", "4")
SMALL_TRAIN_CLIP = dict(dim_text=128, dim_image=128, dim_latent=64, num_text_tokens=1000, text_enc_depth=2,
                        text_seq_len=128, text_heads=2, visual_enc_depth=2, visual_heads=2, visual_image_size=64,
                        visual_patch_size=16)
KEY_MASKED = {"flash_fwd": ("flash_fwd", "key_masked_launches"),
              "flash_dq": ("flash_bwd", "key_masked_dq_launches"),
              "flash_dkv": ("flash_bwd", "key_masked_dkv_launches")}


def reset_key_masked(fa) -> None:
    for wrapper, counter in KEY_MASKED.values():
        setattr(getattr(fa, wrapper), counter, 0)


def read_key_masked(fa) -> dict:
    return {name: getattr(getattr(fa, wrapper), counter) for name, (wrapper, counter) in KEY_MASKED.items()}


def run_main(fa, main, argv):
    """A CLI's `main(argv)` in process, with every launch counter (and the
    key-masked ones) set to 0 just before it; returns (its JSON lines, its
    launches, its key-masked launches, wall seconds)."""
    import io

    out = io.StringIO()
    reset_launches(fa)
    reset_key_masked(fa)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    check(rc == 0, f"{main.__module__} {argv} returned {rc}")
    lines = [json.loads(line) for line in out.getvalue().splitlines() if line.startswith("{")]
    return lines, read_launches(fa), read_key_masked(fa), wall_s


def grad_errors(card: dict, cpu: dict) -> float:
    """The largest gradient difference over the leaves, each over its CPU
    leaf's largest magnitude."""
    return max(((card[n].cpu() - g).abs().max() / g.abs().max().clamp_min(1e-30)).item() for n, g in cpu.items())


def phase_vae_train_parity():
    """The VAE's training forward, loss and gradients on the card against the
    same VAE on the CPU (the port's plain path there), on the same weights,
    images, temperature (a device scalar) and uniform draw, for every
    option the CLI sets: plain, straight-through, ReinMax, smooth-L1, KL
    weight 1, two resnet blocks, four channels.  Loss within 1e-4 relative,
    each gradient leaf within 1e-4 of its largest value, the
    reconstruction within 1e-4; TF32 off."""
    import copy

    from dalle_pytorch_tpu_torch.models import vae as vae_mod

    rows = {}
    for name, option in VAE_OPTIONS.items():
        cfg = vae_mod.DiscreteVAEConfig(**SMALL_TRAIN_VAE, **option)
        card = vae_mod.init_discrete_vae(cfg, torch.Generator(device="cuda").manual_seed(5), "cuda")
        cpu = copy.deepcopy(card).cpu()
        g = torch.Generator().manual_seed(6)
        images = torch.rand(4, cfg.image_size, cfg.image_size, cfg.channels, generator=g)
        uniform = vae_mod.gumbel_uniform((4, cfg.fmap_size, cfg.fmap_size, cfg.num_tokens), g)
        results = []
        for model, dev in ((card, "cuda"), (cpu, "cpu")):
            model.train().requires_grad_(True)
            loss, out = vae_mod.forward(model, images.to(dev), uniform=uniform.to(dev), return_loss=True,
                                        return_recons=True, temp=torch.tensor(0.8, device=dev))
            loss.backward()
            results.append((loss.item(), out.detach().cpu(), {n: p.grad for n, p in model.named_parameters()}))
        (loss_card, out_card, grads_card), (loss_cpu, out_cpu, grads_cpu) = results
        rel = abs(loss_card - loss_cpu) / abs(loss_cpu)
        out_err = (out_card - out_cpu).abs().max().item()
        grad_err = grad_errors(grads_card, grads_cpu)
        check(np.isfinite(loss_card) and rel <= 1e-4 and out_err <= 1e-4 and grad_err <= 1e-4,
              f"vae_train_parity {name}: loss {loss_card} vs {loss_cpu} ({rel} relative), reconstruction {out_err}, "
              f"gradients {grad_err} of their largest")
        rows[name] = dict(loss=loss_card, loss_cpu=loss_cpu, loss_rel_err=rel, recons_max_abs_err=out_err,
                          grad_err_over_leaf_max=grad_err, leaves=len(grads_cpu))
    emit("vae_train_parity", vae=SMALL_TRAIN_VAE, batch=4, tolerance=1e-4,
         tf32=dict(cudnn=torch.backends.cudnn.allow_tf32, matmul=torch.backends.cuda.matmul.allow_tf32), options=rows)


def phase_train_vae_cli(fa):
    """`cli.train_vae.main` in process at BASELINE.json configs[1]'s width
    (256 px, 8,192 tokens, 3 layers, 2 resnet blocks, emb 512, hidden 256,
    batch 8) on 16 PNGs that `write_real_data` writes, for 3 epochs of 2
    steps: finite losses, the step-0 grids and codebook histogram, step_s
    (median after the first step, each synchronised by its loss read),
    images/s, peak memory and codebook_used; then its checkpoint through
    `load_vae_checkpoint` on the card and on the CPU, whose codes of the
    first 4 crops agree (at least 0.99 of them, as the parity phases hold
    codes; the count that differs is reported).  TF32 as set above (off).
    The VAE launches no flash kernel."""
    from dalle_pytorch_tpu_torch.cli import train_dalle, train_vae
    from dalle_pytorch_tpu_torch.data import loader
    from dalle_pytorch_tpu_torch.models import vae as vae_mod

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        write_real_data(tmp, seed=73)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        lines, launches, _, wall_s = run_main(fa, train_vae.main, [
            "--image_folder", str(tmp / "pairs"), *VAE_CLI_FLAGS, "--epochs", "3",
            "--vae_output_file_name", str(tmp / "vae")])
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        steps = [r for r in lines if "loss" in r]
        check(len(steps) == 6 and all(np.isfinite(r["loss"]) for r in steps), f"train_vae's steps: {steps}")
        check(sum(launches.values()) == 0, f"the VAE launched flash kernels: {launches}")
        records = [json.loads(line) for line in open(tmp / "vae.metrics.jsonl")]
        logged = next(r for r in records if "codebook_used" in r)
        grids = sorted(p.name for p in (tmp / "vae.images").iterdir())
        check(grids == ["step0_hard_reconstructions.png", "step0_original_images.png", "step0_reconstructions.png"]
              and any("codebook_indices_hist" in r for r in records), f"train_vae logged {grids}")
        crops = torch.from_numpy(np.stack([loader.ImageDataset(str(tmp / "pairs"), 256)[i] for i in range(4)]))
        codes = [vae_mod.get_codebook_indices(train_dalle.load_vae_checkpoint(str(tmp / "vae.pt"), dev),
                                              crops.to(dev)).cpu() for dev in ("cuda", "cpu")]
        agree = (codes[0] == codes[1]).float().mean().item()
        check(agree >= 0.99, f"the trained VAE's codes on the card agree with the CPU's at {agree}")
    step_s = statistics.median(r["step_s"] for r in steps[1:])
    emit("train_vae_cli", flags=list(VAE_CLI_FLAGS), params=lines[0]["params"], steps=len(steps), epochs=3,
         step_s=step_s, step_s_all=[r["step_s"] for r in steps], images_per_s=8 / step_s,
         data_s=[r["data_s"] for r in steps], peak_memory_gib=peak_gib, losses=[r["loss"] for r in steps],
         codebook_used=logged["codebook_used"], num_tokens=8192, codes_agree_card_cpu=agree,
         codes_differ=int((codes[0] != codes[1]).sum()), codes_compared=codes[0].numel(), wall_s=wall_s,
         tf32=dict(cudnn=torch.backends.cudnn.allow_tf32, matmul=torch.backends.cuda.matmul.allow_tf32))


def phase_clip_train_parity(fa):
    """A small CLIP (dim 128, 2 + 2 layers of 2 heads x 64, text 128, 16
    patches) trained on the card against the same CLIP on the CPU: the
    contrastive loss and every gradient under the caption key mask (captions
    of 128, 40, 9 and 3 tokens), through the flash forward and backward
    non-causal and key-masked on the card (4 launches of each, 2 of them
    key-masked), within 1e-4 relative and 1e-4 of each leaf's largest value;
    then two steps of `make_train_step` with the CLI's loss, Adam 1e-3 and
    clipping at 0.5, each step's loss and grad norm within 1e-4 relative."""
    import copy

    from dalle_pytorch_tpu_torch.cli import train_clip
    from dalle_pytorch_tpu_torch.models import clip as clip_mod
    from dalle_pytorch_tpu_torch.optim.grouped import Adam
    from dalle_pytorch_tpu_torch.parallel.train_step import StepSettings, make_train_step

    cfg = clip_mod.CLIPConfig(**SMALL_TRAIN_CLIP)
    card = clip_mod.init_clip(cfg, torch.Generator(device="cuda").manual_seed(7), "cuda")
    models = {"cuda": card, "cpu": copy.deepcopy(card).cpu()}
    g = torch.Generator().manual_seed(8)
    text = torch.randint(1, cfg.num_text_tokens, (4, cfg.text_seq_len), generator=g)
    for i, n in enumerate((128, 40, 9, 3)):
        text[i, n:] = 0
    images = torch.rand(4, cfg.visual_image_size, cfg.visual_image_size, 3, generator=g)
    steps_from = {dev: copy.deepcopy(m).train().requires_grad_(True) for dev, m in models.items()}
    results = {}
    for dev, model in models.items():
        model.train().requires_grad_(True)
        reset_launches(fa)
        reset_key_masked(fa)
        loss = clip_mod.forward(model, text.to(dev), images.to(dev), text_mask=(text != 0).to(dev), return_loss=True)
        loss.backward()
        results[dev] = (loss.item(), {n: p.grad for n, p in model.named_parameters()}, read_launches(fa),
                        read_key_masked(fa))
    launches, key_masked = results["cuda"][2], results["cuda"][3]
    depth = cfg.text_enc_depth + cfg.visual_enc_depth
    check(all(launches[k] == depth for k in ("flash_fwd", "flash_dq", "flash_dkv"))
          and all(v == cfg.text_enc_depth for v in key_masked.values()),
          f"CLIP's gradient launched {launches}, key-masked {key_masked}")
    rel = abs(results["cuda"][0] - results["cpu"][0]) / abs(results["cpu"][0])
    grad_err = grad_errors(results["cuda"][1], results["cpu"][1])
    check(rel <= 1e-4 and grad_err <= 1e-4, f"clip_train_parity: loss {rel} relative, gradients {grad_err}")

    metrics = {}
    for dev, model in steps_from.items():
        init_fn, step_fn = make_train_step(train_clip.clip_loss_fn(model), Adam(1e-3), StepSettings(clip_grad_norm=0.5))
        state = init_fn(dict(model.named_parameters()))
        metrics[dev] = []
        for i in range(2):
            batch = {"text": text.roll(i, 0).to(dev), "image": images.roll(i, 0).to(dev)}
            state, m = step_fn(state, batch)
            metrics[dev].append((float(m["loss"]), float(m["grad_norm"])))
    step_rel = max(abs(a - b) / abs(b) for c, p in zip(metrics["cuda"], metrics["cpu"]) for a, b in zip(c, p))
    check(step_rel <= 1e-4, f"clip_train_parity: train steps {metrics}")
    emit("clip_train_parity", clip=SMALL_TRAIN_CLIP, batch=4, caption_tokens=[128, 40, 9, 3], tolerance=1e-4,
         loss=results["cuda"][0], loss_cpu=results["cpu"][0], loss_rel_err=rel, grad_err_over_leaf_max=grad_err,
         launches=launches, key_masked_launches=key_masked, steps=metrics, step_rel_err=step_rel)


def phase_train_clip_cli(fa):
    """`cli.train_clip.main` in process at the CLI's defaults (dim 512, 6 + 6
    layers of 8 heads x 64, text 256 of the BPE tokenizer's 49,408 tokens,
    256 px in 64 patches of 32, batch 16, Adam 1e-3, clipping at 0.5), f32
    and `--bf16`, on the 16 pairs of `write_caption_pairs` (captions of 3 to
    5 tokens: the text encoder's keys are mostly padding), 8 epochs of one
    step: finite losses, the last at least `CLIP_LOSS_DROP` below the first
    (each epoch is the same 16 pairs, so a run that does not update its
    weights repeats its first loss to rounding); each step launches
    flash_fwd, flash_dq and flash_dkv 12 times, 6 of each under the key
    mask; step_s (median after the first step), tokens/s (text and
    patches) and peak memory.  Then the f32 run once more with the
    encoders' attention through its plain version (no kernel launched): the
    same batches and weights give the same losses, within 1e-4 relative."""
    from unittest import mock

    from dalle_pytorch_tpu_torch.cli import train_clip
    from dalle_pytorch_tpu_torch.models import transformer as tr

    runs, total, epochs = {}, dict.fromkeys(COUNTERS, 0), 8
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        write_caption_pairs(tmp, seed=74)
        for name, extra in (("f32", ()), ("bf16", ("--bf16",)), ("f32_plain_attention", ())):
            plain = mock.patch.object(tr, "flash_attention", plain_flash_attention(fa))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with plain if name.endswith("plain_attention") else contextlib.nullcontext():
                lines, launches, key_masked, wall_s = run_main(fa, train_clip.main, [
                    "--image_text_folder", str(tmp / "pairs"), "--truncate_captions",
                    "--epochs", str(epochs), *extra, "--clip_output_file_name", str(tmp / f"clip_{name}")])
            peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
            steps = [r for r in lines if "loss" in r]
            step_s = statistics.median(r["step_s"] for r in steps[1:])
            runs[name] = dict(step_s=step_s, step_s_all=[r["step_s"] for r in steps],
                              tokens_per_s=16 * (256 + 64) / step_s, data_s=[r["data_s"] for r in steps],
                              peak_memory_gib=peak_gib, losses=[r["loss"] for r in steps],
                              grad_norms=[r["grad_norm"] for r in steps],
                              launches_per_step={k: v / len(steps) for k, v in launches.items() if v},
                              key_masked_launches_per_step={k: v / len(steps) for k, v in key_masked.items()},
                              params=lines[0]["params"], wall_s=wall_s)
            if name != "f32_plain_attention":
                total = {k: total[k] + launches[k] for k in COUNTERS}
    kernel, plain = runs["f32"]["losses"], runs["f32_plain_attention"]["losses"]
    plain_rel = max(abs(a - b) / abs(b) for a, b in zip(kernel, plain))
    emit("train_clip_cli", batch=16, text_seq_len=256, num_patches=64, heads=8, dim_head=64, runs=runs,
         f32_losses_vs_plain_attention_rel=plain_rel, loss_drop_required=CLIP_LOSS_DROP)
    check(not runs["f32_plain_attention"]["launches_per_step"] and len(plain) == epochs and plain_rel <= 1e-4,
          f"train_clip: the kernels' losses {kernel} against the plain attention's {plain}")
    for name in ("f32", "bf16"):
        run = runs[name]
        losses = run["losses"]
        check(len(losses) == epochs and all(np.isfinite(losses)) and losses[-1] <= losses[0] - CLIP_LOSS_DROP,
              f"train_clip {name}: losses {losses} (the last must be {CLIP_LOSS_DROP} below the first)")
        check(all(run["launches_per_step"].get(k) == 12 for k in ("flash_fwd", "flash_dq", "flash_dkv"))
              and all(v == 6 for v in run["key_masked_launches_per_step"].values()),
              f"train_clip {name}: launches a step {run['launches_per_step']}, key-masked "
              f"{run['key_masked_launches_per_step']}")
    return total


# the generate CLI's model: the README pattern model with the BPE tokenizer's
# 49,408 text tokens; two prompts, each completed by --gentxt first
CLI_MODEL = dict(SLICE, num_text_tokens=49408)
CLI_PROMPTS = ("a red apple on a wooden table", "an astronaut riding a horse")


def save_dalle_checkpoint(checkpoint, weights, path, dalle, vae, **hparams):
    """The facade models' weights as the v3 checkpoint the CLIs read;
    `hparams` override the DALL-E's config (a cut `depth` keeps the first
    layers)."""
    import dataclasses

    from dalle_pytorch_tpu_torch.models import vae_registry
    from dalle_pytorch_tpu_torch.version import __version__

    cfg = dataclasses.replace(dalle.cfg, **hparams)
    trees = {"weights": weights.dalle_tree(dalle.module.state_dict(), cfg),
             "vae_weights": weights.vae_tree(vae.module.state_dict(), vae.cfg)}
    vae_class_name, vae_params = vae_registry.config_to_meta(vae.cfg)
    meta = {"hparams": cfg.to_dict(), "vae_params": vae_params, "vae_class_name": vae_class_name,
            "version": __version__}
    checkpoint.save_checkpoint(str(path), trees, meta)


def run_cli(fa, argv):
    """`cli.generate.main(argv)` in process, with every launch counter set to
    0 just before it; returns (PNG paths, phase seconds, launches, what it
    printed, wall seconds)."""
    import contextlib
    import io

    from dalle_pytorch_tpu_torch.cli import generate as cli

    timings, out = {}, io.StringIO()
    reset_launches(fa)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        paths = cli.main(argv, timings=timings)
    torch.cuda.synchronize()
    return paths, timings, read_launches(fa), out.getvalue(), time.perf_counter() - t0


def phase_generate_cli(fa, port, weights, checkpoint, sampling):
    """Text in, PNG out: `python -m dalle_pytorch_tpu_torch.cli.generate`'s
    `main`, in process, on the README pattern model at full width with the
    BPE vocabulary, its seeded weights written as a v3 checkpoint by the
    port's writer: two prompts, --gentxt, --num_images 2 --batch_size 2.  No
    prefill of this run kills a pattern tile (each prompt's causal text
    prefill, n = its token count, and each image prefill, n = 257, lie in
    the text region), so every layer launches flash_fwd, the pattern layers
    with their masks: the counts must be the layer cycle's.  Then the same
    weights cut to one cycle of the four layer types, with attn_grid
    "compact" in the checkpoint's hparams: one prompt, whose image prefill
    launches flash_fwd_compact in every layer.  Every PNG must decode to
    256 x 256 x 3.  Returns (launches of both runs, [(prompt, pixels)] of
    the first run's images)."""
    from dalle_pytorch_tpu_torch.cli.png import read_png
    from dalle_pytorch_tpu_torch.data import tokenizer as tokenizer_mod

    vae = port.DiscreteVAE(seed=0, **FULL_VAE)
    dalle = port.DALLE(vae=vae, seed=31, **CLI_MODEL)
    cfg = dalle.cfg
    n_params = sum(p.numel() for p in dalle.module.parameters())
    cycle = len(cfg.attn_types)
    want = dict.fromkeys(COUNTERS, 0)
    for n in [len(tokenizer_mod.tokenizer.encode(p)) for p in CLI_PROMPTS] + [cfg.text_seq_len + 1] * len(CLI_PROMPTS):
        want = {k: want[k] + v for k, v in forward_launches(dalle.module, n)[0].items()}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        save_dalle_checkpoint(checkpoint, weights, tmp / "dalle.pt", dalle, vae)
        save_dalle_checkpoint(checkpoint, weights, tmp / "compact.pt", dalle, vae, depth=cycle, attn_grid="compact")
        write_s = time.perf_counter() - t0
        prompt = torch.tensor([tokenizer_mod.tokenizer.encode(CLI_PROMPTS[0])], device="cuda")
        phase_decode_graphs_text(sampling, dalle, prompt, "cli_pattern_49408_text_tokens")
        del dalle, vae
        torch.cuda.empty_cache()
        common = ["--num_images", "2", "--batch_size", "2", "--seed", "0"]
        paths, timings, launches, printed, wall_s = run_cli(fa, [
            "--dalle_path", str(tmp / "dalle.pt"), "--text", "|".join(CLI_PROMPTS), "--gentxt",
            "--outputs_dir", str(tmp / "out"), *common])
        check(launches == want, f"the CLI launched {launches}; the layer cycle gives {want}")
        # a completion may hold any character, a newline too
        completed = re.findall(r"completed text: (.*?)\ncreated 2 images at ", printed, re.S)
        check(len(completed) == len(CLI_PROMPTS) and len(paths) == 2 * len(CLI_PROMPTS),
              f"{len(paths)} PNGs for {len(completed)} completed prompts: {printed!r}")
        pixels = [read_png(p) for p in paths]
        check(all(px.shape == (256, 256, 3) and px.dtype == np.uint8 for px in pixels),
              f"PNG shapes {[px.shape for px in pixels]}")
        for text, path in zip([t for t in completed for _ in range(2)], paths):
            check(path.parent == tmp / "out" / text.replace(" ", "_")[:100], f"{path} for the prompt {text!r}")
        cut_paths, cut_timings, cut_launches, _, cut_wall_s = run_cli(fa, [
            "--dalle_path", str(tmp / "compact.pt"), "--text", CLI_PROMPTS[0], "--outputs_dir",
            str(tmp / "out_compact"), *common])
        check(cut_launches["flash_fwd_compact"] == cycle and cut_launches["flash_fwd"] == 0,
              f"the compacted checkpoint's prefill launched {cut_launches}")
        check(len(cut_paths) == 2 and all(read_png(p).shape == (256, 256, 3) for p in cut_paths),
              f"the compacted checkpoint wrote {cut_paths}")
    images = len(paths)
    emit("generate_cli", params=n_params, vocab=cfg.total_tokens, depth=cfg.depth, attn_types=cfg.attn_types,
         prompts=list(CLI_PROMPTS), completed=completed, pngs=images, png_shape=list(pixels[0].shape),
         checkpoint_write_s=write_s, wall_s=wall_s, images_per_s=images / wall_s,
         seconds=timings, seconds_per_image={k: v / images for k, v in timings.items()}, launches=launches,
         compact_checkpoint=dict(depth=cycle, attn_grid="compact", pngs=len(cut_paths), wall_s=cut_wall_s,
                                 seconds=cut_timings, launches=cut_launches))
    total = {k: launches[k] + cut_launches[k] for k in COUNTERS}
    return total, list(zip([prompt for prompt in CLI_PROMPTS for _ in range(2)], pixels))


# the serving engine's requests: two guided (two lanes each), one at
# temperature 0.7, the rest plain; six on four lanes, so later admissions
# wait for evictions and take freed blocks
ENGINE_COND = (1.0, 3.0, 1.0, 3.0, 1.0, 1.0)
ENGINE_TEMP = (1.0, 1.0, 0.7, 1.0, 1.0, 1.0)
ENGINE_THRES = 0.5
ENGINE_BLOCK = 64


def engine_texts(cfg, n, seed):
    text = torch.randint(1, cfg.num_text_tokens, (n, cfg.text_seq_len), generator=torch.Generator().manual_seed(seed))
    text[n - 2, 150:] = 0  # a padded prompt
    return text.cuda()


def engine_run(fa, engine, texts, want, stagger=64, **per_request):
    """The requests of `texts` through `engine`, submitted two at a time
    with `stagger` polls between, with every launch counter set to 0 just
    before: each admission's prefill launches its layer cycle (`want`), the
    decode steps none.  Returns (requests, wall seconds, decode steps,
    launches)."""
    reset_launches(fa)
    steps = engine.decode_steps
    t0 = time.perf_counter()
    reqs = []
    for i in range(texts.shape[0]):
        reqs.append(engine.submit(texts[i].cpu().numpy(), temperature=ENGINE_TEMP[i], cond_scale=ENGINE_COND[i],
                                  **{k: v[i] for k, v in per_request.items()}))
        if i % 2:
            for _ in range(stagger):
                engine.poll()
    engine.run_until_idle()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_launches(fa)
    check(launches == {k: v * len(reqs) for k, v in want.items()},
          f"{len(reqs)} admissions launched {launches}; one prefill's layer cycle gives {want}")
    check(all(r.outcome == "completed" for r in reqs), f"outcomes {[r.outcome for r in reqs]}")
    return reqs, wall_s, engine.decode_steps - steps, launches


def batch1_codes(sampling, model, text_row, i, **kw):
    """A batch-1 `sample_image_codes` call (replayed from the model's graphs)
    with request i's settings."""
    return sampling.sample_image_codes(model, text_row[None], filter_thres=ENGINE_THRES, temperature=ENGINE_TEMP[i],
                                       cond_scale=ENGINE_COND[i], **kw)[0].cpu().numpy()


def engine_prefix_parity(fa, sampling, engine, texts, conds, noise, polls=32):
    """Requests of `texts` at `conds` under their `noise` through `engine`,
    admitted together in one poll (their prefills launching the layer
    cycle each), `polls` more polls timed with their lanes decoding, then
    drained: each request's codes so far must equal a batch-1 image loop
    of as many codes under its noise (replayed from the model's graphs;
    over an int8 pool, run eagerly over the prefilled dense cache quantized
    per token, `quantization.quantize_cache_layers`, as the pool quantizes
    it).  Returns (admission launches, the replayed step's ms, codes
    compared per request)."""
    from dalle_pytorch_tpu_torch.quantization import quantize_cache_layers

    m, cfg = engine.model, engine.model.cfg
    quantized = engine.ecfg.quantize_kv not in (None, "none")
    want, _ = forward_launches(m, cfg.text_seq_len + 1)
    reset_launches(fa)
    reqs = [engine.submit(texts[i].cpu().numpy(), cond_scale=conds[i], noise=noise[i]) for i in range(len(conds))]
    engine.poll()
    admitted = read_launches(fa)
    check(admitted == {k: len(conds) * v for k, v in want.items()}, f"{len(conds)} admissions launched {admitted}")
    check(all(r.codes_done == 2 for r in reqs), f"not every request was admitted: {[r.codes_done for r in reqs]}")
    step_ms = engine_window(engine, polls)
    exported = {e["origin_id"]: e["codes"] for e in engine.drain()}
    mode = sampling.Mode(noise=True, stats=False)
    made = []
    for i, req in enumerate(reqs):
        codes = exported[req.id]
        loop, run = sampling.image_loop(m, 1, conds[i], 0, ENGINE_THRES, mode, graphs=False if quantized else None)
        _, logits = sampling._prefill_phase(m, texts[i:i + 1], None, 0, conds[i], loop.cache)
        if quantized:
            loop.cache["layers"] = quantize_cache_layers(loop.cache["layers"])
        ref, _ = run(m, logits, len(codes), None, 1.0, noise[i][:, None], mode)
        check(np.array_equal(codes, ref[0].cpu().numpy()),
              f"request {i}'s {len(codes)} codes (lanes {req.lanes}) differ from its batch-1 loop's")
        made.append(len(codes))
    return admitted, step_ms, made


def phase_engine_parity(fa, sampling, dalle, name, seed, noised=True, eagerly=True):
    """The continuous-batching engine at full width (`serving/engine.py`,
    f32): six requests on four lanes with staggered submits.  (a) Under each
    request's injected noise, its codes equal its batch-1 `sample_image_codes`
    under that noise; (b) seeded, they equal its batch-1 call with a
    generator of that seed, with the step replayed from the engine's CUDA
    graph (the lanes' registered generators reseeded between replays); run
    eagerly (`graphs=False`), the first two requests (one guided) give the
    first codes of their batch-1 loops under their noise
    (`engine_prefix_parity`, 64 polls); one seeded request, run again alone in a fresh
    engine's lane 0, gives the codes it gave beside the others in another
    lane.  Each admission's prefill launches the layer cycle.  `noised` and
    `eagerly` False leave out (a) and the eager engine (the pattern model,
    whose paged step the seeded runs hold to batch-1 all the same; the
    12-layer model leaves out (a), which `train_real_data` holds on its
    learned-position engine)."""
    from dalle_pytorch_tpu_torch.ops.sampling import gumbel_noise
    from dalle_pytorch_tpu_torch.serving.engine import EngineConfig, GenerationEngine

    m, cfg = dalle.module, dalle.cfg
    texts = engine_texts(cfg, len(ENGINE_COND), seed)
    noise = gumbel_noise((len(ENGINE_COND), cfg.image_seq_len, cfg.total_tokens),
                         torch.Generator(device="cuda").manual_seed(seed), device="cuda")
    seeds = [seed * 1000 + i for i in range(len(ENGINE_COND))]
    want, _ = forward_launches(m, cfg.text_seq_len + 1)
    ecfg = EngineConfig(num_slots=4, block_size=ENGINE_BLOCK, filter_thres=ENGINE_THRES, noise_override=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine = GenerationEngine(m, engine_cfg=ecfg)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    check(engine.graph is not None, f"{name}: the engine captured no graph on the card")

    nothing = dict.fromkeys(COUNTERS, 0)
    noised, noised_s, noised_steps, noised_launches = (engine_run(fa, engine, texts, want, noise=list(noise))
                                                       if noised else ([], None, 0, nothing))
    seeded, seeded_s, seeded_steps, seeded_launches = engine_run(fa, engine, texts, want, seed=seeds)
    t0 = time.perf_counter()
    refs_noise = [batch1_codes(sampling, m, texts[i], i, noise_override=noise[i][:, None]) for i in range(len(noised))]
    refs_seed = [batch1_codes(sampling, m, texts[i], i, generator=torch.Generator(device="cuda").manual_seed(s))
                 for i, s in enumerate(seeds)]
    refs_s = time.perf_counter() - t0
    for i in range(len(noised)):
        check(np.array_equal(noised[i].codes, refs_noise[i]), f"{name}: request {i}'s codes differ from its "
              f"batch-1 call under its noise (lanes {noised[i].lanes})")
    for i in range(len(seeds)):
        check(np.array_equal(seeded[i].codes, refs_seed[i]), f"{name}: request {i}'s replayed codes differ from its "
              f"batch-1 call under its seed (lanes {seeded[i].lanes})")
    check(len({tuple(r.codes) for r in seeded}) == len(seeds), f"{name}: seeded requests share codes")

    moved = next(i for i, r in enumerate(seeded) if not r.guided and r.lanes[0] != 0)
    alone_engine = GenerationEngine(m, engine_cfg=EngineConfig(num_slots=4, block_size=ENGINE_BLOCK,
                                                               filter_thres=ENGINE_THRES))
    reset_launches(fa)
    alone = alone_engine.submit(texts[moved].cpu().numpy(), seed=seeds[moved], temperature=ENGINE_TEMP[moved],
                                cond_scale=ENGINE_COND[moved])
    alone_engine.run_until_idle()
    alone_launches = read_launches(fa)
    check(alone_launches == want, f"{name}: the alone request's admission launched {alone_launches}; want {want}")
    check(alone.lanes == [0] and np.array_equal(alone.codes, seeded[moved].codes),
          f"{name}: request {moved} alone in lane 0 differs from its run in lanes {seeded[moved].lanes}")
    del alone_engine

    # eagerly, two requests (one guided) over their first codes: an eager
    # step takes ten times a replayed one
    eager_launches, eager_step_ms, eager_codes = nothing, None, []
    if eagerly:
        eager_engine = GenerationEngine(m, engine_cfg=ecfg, graphs=False)
        eager_launches, eager_step_ms, eager_codes = engine_prefix_parity(fa, sampling, eager_engine, texts[:2],
                                                                          ENGINE_COND[:2], noise[:2], polls=64)
        del eager_engine

    def step_ms(reqs, wall_s, steps):
        return (wall_s - sum(r.phases["prefill"] for r in reqs)) / steps * 1e3

    emit("engine_parity", model=name, requests=len(seeds), lanes=4, cond_scale=list(ENGINE_COND),
         temperature=list(ENGINE_TEMP), filter_thres=ENGINE_THRES, block_size=ENGINE_BLOCK,
         pool_blocks=engine.pool.num_blocks, pool_gib=engine.pool.bytes() / 2 ** 30,
         noise_buffer_gib=engine.lanes.noise.numel() * 4 / 2 ** 30, build_and_capture_s=build_s,
         noise_codes_equal_batch1=dict(requests=len(noised)), seed_codes_equal_batch1_replayed=True,
         eager_codes_equal_batch1_under_noise=dict(codes_compared=eager_codes),
         alone_equals_beside=dict(request=moved, lanes_beside=seeded[moved].lanes, lanes_alone=alone.lanes),
         lanes_taken=[r.lanes for r in seeded], high_water_blocks=engine.pool.high_water,
         decode_steps=dict(noise=noised_steps, seed=seeded_steps),
         wall_s=dict(noise=noised_s, seed=seeded_s, batch1_references=refs_s),
         step_ms_replayed=step_ms(seeded, seeded_s, seeded_steps), step_ms_eager=eager_step_ms,
         ttft_s=[r.ttft_s for r in seeded], latency_s=[r.latency_s for r in seeded],
         launches=dict(noise=noised_launches, seed=seeded_launches, eager=eager_launches, alone=alone_launches))
    runs = (noised_launches, seeded_launches, eager_launches, alone_launches)
    return {k: sum(run[k] for run in runs) for k in COUNTERS}


def engine_window(engine, steps):
    """`steps` polls of a full engine (every lane decoding), timed on the host
    clock with a synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        engine.poll()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps * 1e3


def phase_engine_flagship(fa, sampling, dalle):
    """The flagship served by the engine at full width, f32, eight lanes:
    two requests, one guided, hold property (a) over their first codes
    (`engine_prefix_parity`: drained after 32 polls, against batch-1
    loops of as many codes under their noise); then the paged step's time,
    replayed and eager, with all
    eight lanes decoding, and a profiled window of replays (device ms, busy
    share).  The flagship's Poisson load runs through the fleet
    (`fleet_flagship`)."""
    from dalle_pytorch_tpu_torch.ops.sampling import gumbel_noise
    from dalle_pytorch_tpu_torch.serving.engine import EngineConfig, GenerationEngine

    m, cfg = dalle.module, dalle.cfg
    lanes = 8
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine = GenerationEngine(m, None, EngineConfig(num_slots=lanes, block_size=ENGINE_BLOCK, filter_thres=ENGINE_THRES,
                                                   noise_override=True))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    texts = engine_texts(cfg, 8, 41)
    noise = gumbel_noise((2, cfg.image_seq_len, cfg.total_tokens), torch.Generator(device="cuda").manual_seed(42),
                         device="cuda")
    want, _ = forward_launches(m, cfg.text_seq_len + 1)
    launches, _, parity_codes = engine_prefix_parity(fa, sampling, engine, texts, ENGINE_COND[:2], noise)

    def fill(eng):
        """Every lane admitted (one poll), with the admissions' launches."""
        reset_launches(fa)
        for i in range(lanes):
            eng.submit(texts[i].cpu().numpy(), seed=i)
        eng.poll()
        got = read_launches(fa)
        check(got == {k: lanes * v for k, v in want.items()}, f"{lanes} admissions launched {got}; {want} each")
        return got

    fill_launches = fill(engine)
    replayed_ms = engine_window(engine, 32)
    window = profile_window(lambda: [engine.poll() for _ in range(16)], 16)
    engine.drain()
    # the eager step over the same window, through a `graphs=False` engine's poll()
    eager_engine = GenerationEngine(m, None, EngineConfig(num_slots=lanes, block_size=ENGINE_BLOCK,
                                                          filter_thres=ENGINE_THRES), graphs=False)
    eager_fill_launches = fill(eager_engine)
    eager_ms = engine_window(eager_engine, 8)
    eager_engine.drain()
    del eager_engine

    emit("engine_flagship", lanes=lanes, block_size=ENGINE_BLOCK, filter_thres=ENGINE_THRES,
         pool_blocks=engine.pool.num_blocks, blocks_per_seq=engine.pool.blocks_per_seq,
         pool_gib=engine.pool.bytes() / 2 ** 30, pool_block_mib=engine.pool.bytes() / (engine.pool.num_blocks + 1) / 2 ** 20,
         noise_buffer_gib=engine.lanes.noise.numel() * 4 / 2 ** 30, build_and_capture_s=build_s,
         noise_codes_equal_batch1=dict(codes_compared=parity_codes), step_ms_replayed=replayed_ms,
         step_ms_eager=eager_ms,
         profile=window, capacity_images_per_s=lanes / (cfg.image_seq_len * replayed_ms / 1e3),
         window_fill_launches=dict(
             replayed=fill_launches, eager=eager_fill_launches),
         peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    READINGS["engine_flagship"] = dict(step_ms_replayed=replayed_ms, step_ms_eager=eager_ms,
                                       kernels_per_step=window["kernels_per_step"],
                                       pool_bytes=engine.pool.bytes(), pool_blocks=engine.pool.num_blocks)
    runs = (launches, fill_launches, eager_fill_launches)
    return {k: sum(run[k] for run in runs) for k in COUNTERS}


# readings a later phase sets beside its own: the f32 engine's step, for the quantized engines'
READINGS = {}
SPEC_K = 4
# the poison drill's model: the flagship's widths and its first layers
DRILL_DEPTH = 4
QUANT_STEPS = 16  # quant_spec_parity's paged steps


def quant_ops_per_step(step):
    """The aten ops of one eager decode step that quantize (an int8 result)
    or dequantize (an int8 or fp8 input cast to a float), and all of them,
    recorded by a TorchDispatchMode: the quantize and dequantize kernels a
    step launches."""
    from torch.utils._python_dispatch import TorchDispatchMode

    low = (torch.int8, torch.float8_e4m3fn)
    counts = dict(quantize=0, dequantize=0, total=0)

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            counts["total"] += 1
            ins = [a for a in args if isinstance(a, torch.Tensor)]
            if isinstance(out, torch.Tensor):
                if out.dtype == torch.int8 and not any(a.dtype == torch.int8 for a in ins):
                    counts["quantize"] += 1
                elif out.is_floating_point() and out.dtype not in low and any(a.dtype in low for a in ins):
                    counts["dequantize"] += 1
            return out

    with Count():
        step()
    torch.cuda.synchronize()
    return counts


def stepwise_logits(sampling, models, text, kv, steps, block_size=64):
    """The serving path (prefill, `write_prefill_to_pool`, paged steps) of
    one prompt on the CPU and on the card, the card fed the CPU's greedy
    codes: the largest logit difference over `steps` positions.  Over an
    int8 pool (`kv`) the card's pool and rings take the CPU's before each
    step, so that both read the same int8 values: a value whose card and
    CPU floats straddle a rounding boundary quantizes one step apart.
    Returns (largest difference, int8 values of the prefilled pools that
    differ between card and CPU)."""
    from dalle_pytorch_tpu_torch.models import dalle as dalle_mod
    from dalle_pytorch_tpu_torch.models.paged import (init_paged_pool, init_slot_rings, paged_blocks_per_seq,
                                                      paged_decode_step, write_prefill_to_pool)

    cfg = models["cpu"].cfg
    tcfg = cfg.transformer_config()
    n_pre, bps = cfg.text_seq_len + 1, paged_blocks_per_seq(tcfg, block_size)
    state, logits = {}, {}
    for dev, m in models.items():
        cache, logits[dev] = sampling._prefill_phase(m, text.to(dev)[None], None, 0, 1.0)
        pool = init_paged_pool(tcfg, bps + 1, block_size, m.dtype, dev, quantize=kv)
        tables = torch.arange(1, bps + 1, device=dev)[None]
        write_prefill_to_pool(tcfg, pool, tables, cache["layers"], n_pre, block_size)
        rings = init_slot_rings(tcfg, 1, m.dtype, dev)
        for ring, layer in zip(rings["layers"], cache["layers"]):
            for name in ring:
                ring[name].copy_(layer[name])
        state[dev] = pool, tables, rings
    flips = sum(int((a[k].cpu() != b[k]).sum()) for a, b in zip(state["cuda"][0]["layers"], state["cpu"][0]["layers"])
                for k in ("k", "v")) if kv else 0
    err = (logits["cuda"].cpu() - logits["cpu"]).abs().max().item()
    code = (logits["cpu"].argmax(-1) - cfg.num_text_tokens_padded).clamp(0, cfg.num_image_tokens - 1)
    for t in range(steps):
        if kv:
            for dst, src in ((state["cuda"][0], state["cpu"][0]), (state["cuda"][2], state["cpu"][2])):
                for a, b in zip(dst["layers"], src["layers"]):
                    for k in a:
                        a[k].copy_(b[k])
        for dev, m in models.items():
            pool, tables, rings = state[dev]
            x = dalle_mod.embed_image_codes(m, code.to(dev)[:, None], torch.tensor([t], device=dev))
            out = paged_decode_step(m.transformer, x, pool, tables, torch.tensor([n_pre + t], device=dev), rings,
                                    block_size)
            logits[dev] = sampling._logits_at(m, out, image=True)
        err = max(err, (logits["cuda"].cpu() - logits["cpu"]).abs().max().item())
        code = (logits["cpu"].argmax(-1) - cfg.num_text_tokens_padded).clamp(0, cfg.num_image_tokens - 1)
    return err, flips


def phase_quant_spec_parity(fa, port, sampling):
    """A small model with the flagship's features (`SMALL_FLAGSHIP`: tied
    embeddings, d_head 128, the layer cycle, VFA) quantized on the CPU and
    copied to the card: the serving path's logits (`stepwise_logits`:
    prefill, the pool's scatter, 16 paged steps fed the CPU's greedy codes)
    card against CPU over the int8 pool under f32, int8 and fp8 weights,
    within 1e-4 (f32, TF32 off); then codes under injected noise, int8
    weights, speculative (k 4) against sequential: card == CPU on at least
    0.99 of them, and card spec == card sequential."""
    import copy

    from dalle_pytorch_tpu_torch import quantization as quant

    rng = np.random.default_rng(71)
    small = SMALL_FLAGSHIP
    cpu = port.DALLE(vae=port.DiscreteVAE(seed=0, device="cpu", **SMALL_SPARSE_VAE), seed=7, device="cpu", **small)
    cfg = cpu.cfg
    text = torch.from_numpy(rng.integers(1, cfg.num_text_tokens, (2, cfg.text_seq_len)))
    noise = torch.from_numpy(rng.gumbel(size=(cfg.image_seq_len, 2, cfg.total_tokens)).astype(np.float32))
    logits, codes = {}, {}
    reset_launches(fa)
    for kind, kv in ((None, "int8"), ("int8", "int8"), ("fp8", "int8")):
        m_cpu = cpu.module if kind is None else quant.quantize_tree(copy.deepcopy(cpu.module), kind)
        models = {"cpu": m_cpu, "cuda": copy.deepcopy(m_cpu).cuda()}
        err, flips = stepwise_logits(sampling, models, text[0], kv, QUANT_STEPS)
        name = f"weights_{kind or 'float32'}_pool_{kv or 'float32'}"
        check(err <= 1e-4, f"{name}: logits card vs CPU differ by {err}")
        logits[name] = dict(max_abs_err=err, prefill_int8_values_differing=flips)
        if (kind, kv) == ("int8", "int8"):
            m_gpu = models["cuda"]
            timings = {}
            spec_cpu = sampling.sample_image_codes(m_cpu, text, cond_scale=3.0, noise_override=noise, spec_k=SPEC_K)
            spec_gpu = sampling.sample_image_codes(m_gpu, text.cuda(), cond_scale=3.0, noise_override=noise.cuda(),
                                                   spec_k=SPEC_K, timings=timings)
            seq_gpu = sampling.sample_image_codes(m_gpu, text.cuda(), cond_scale=3.0, noise_override=noise.cuda())
            agree = (spec_gpu.cpu() == spec_cpu).float().mean().item()
            check(agree >= 0.99, f"only {agree:.4f} of the int8 spec codes agree between card and CPU")
            check(torch.equal(spec_gpu, seq_gpu), "the card's speculative codes differ from its sequential codes")
            codes = dict(agree_card_cpu=agree, codes=int(spec_cpu.numel()), spec_equals_sequential_on_card=True,
                         spec_rounds=timings["spec_rounds"])
    launches = read_launches(fa)
    emit("quant_spec_parity", model=small, tolerance=1e-4, steps=QUANT_STEPS, logits=logits, spec_codes_under_noise=codes,
         spec_k=SPEC_K, launches=launches)
    return launches


def engine_prefix_codes(engine, texts, conds, seeds, codes):
    """Requests of `texts` at `conds` under `seeds` through `engine`, all
    admitted in one poll, polled until each has `codes` codes, then
    drained: their first `codes` codes, and the polls taken."""
    reqs = [engine.submit(texts[i].cpu().numpy(), seed=seeds[i], cond_scale=conds[i]) for i in range(len(conds))]
    polls = 0
    while min(r.codes_done for r in reqs) < codes:
        engine.poll()
        polls += 1
    exported = {e["origin_id"]: e["codes"] for e in engine.drain()}
    return [torch.as_tensor(exported[r.id][:codes]) for r in reqs], polls


def phase_engine_quant_flagship(fa, sampling, dalle):
    """The flagship with int8 weights (`quantization.quantize_tree` on a
    twin holding the same tensors) and the int8 pool, served on 8 lanes:
    at-rest weight and pool bytes against the f32 engine's (and the JAX
    package's `weight_reduction`, against bf16 storage); two requests, one
    guided, whose first 32 codes equal batch-1 loops of the quantized
    model over a per-token int8 dense cache under their noise
    (`engine_prefix_parity`; each admission launching the layer cycle:
    64 flash_fwd, 48 masked); the replayed and eager step beside the f32
    engine's replayed step of this run; and the quantize and dequantize
    ops of one eager step.  Returns (the quantized module, the launches)."""
    import dataclasses

    from dalle_pytorch_tpu_torch import quantization as quant
    from dalle_pytorch_tpu_torch.ops.sampling import gumbel_noise
    from dalle_pytorch_tpu_torch.serving.engine import EngineConfig, GenerationEngine

    plain, cfg = dalle.module, dalle.cfg
    t0 = time.perf_counter()
    qmodel = quant.quantize_tree(twin_module(plain, dataclasses.replace(cfg)).eval().requires_grad_(False), "int8")
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    f32_bytes, q_bytes = quant.tree_weight_bytes(plain), quant.tree_weight_bytes(qmodel)
    check(f32_bytes / q_bytes >= 3.8, f"int8 weights only {f32_bytes / q_bytes:.3f}x smaller than f32")
    lanes = 8
    ecfg = EngineConfig(num_slots=lanes, block_size=ENGINE_BLOCK, filter_thres=ENGINE_THRES, noise_override=True,
                        quantize_kv="int8")
    engine = GenerationEngine(qmodel, engine_cfg=ecfg)
    check(engine.graph is not None, "the quantized engine captured no graph")
    f32 = READINGS["engine_flagship"]
    per_elem = engine.pool.bytes() / (f32["pool_bytes"] / 4)
    check(abs(per_elem - (1 + 2 / cfg.dim_head)) < 1e-9, f"the int8 pool costs {per_elem} bytes an element")
    texts = engine_texts(cfg, 8, 91)
    noise = gumbel_noise((2, cfg.image_seq_len, cfg.total_tokens), torch.Generator(device="cuda").manual_seed(92),
                         device="cuda")
    admitted, _, made = engine_prefix_parity(fa, sampling, engine, texts, ENGINE_COND[:2], noise)

    reset_launches(fa)
    for i in range(lanes):
        engine.submit(texts[i].cpu().numpy(), seed=i)
    engine.poll()
    fill_launches = read_launches(fa)
    replayed_ms = engine_window(engine, 32)
    window = profile_window(lambda: [engine.poll() for _ in range(8)], 8)
    engine.drain()
    eager = GenerationEngine(qmodel, engine_cfg=dataclasses.replace(ecfg, noise_override=False), graphs=False)
    reset_launches(fa)
    for i in range(lanes):
        eager.submit(texts[i].cpu().numpy(), seed=i)
    eager.poll()
    eager_launches = read_launches(fa)
    eager_ms = engine_window(eager, 8)
    ops = quant_ops_per_step(eager._step)
    eager.drain()
    del eager
    state = engine.quantization_state()
    emit("engine_quant_flagship", lanes=lanes, weights="int8", kv="int8", quantize_s=quantize_s,
         weight_bytes=dict(f32=f32_bytes, int8=q_bytes, reduction_vs_f32=f32_bytes / q_bytes,
                           weight_reduction_vs_bf16=quant.weight_reduction(plain, qmodel)),
         pool=dict(blocks=engine.pool.num_blocks, int8_gib=engine.pool.bytes() / 2 ** 30,
                   f32_gib=f32["pool_bytes"] / 2 ** 30, bytes_per_elem=per_elem,
                   kv_pool_reduction_vs_f32=f32["pool_bytes"] / engine.pool.bytes()),
         noise_codes_equal_batch1=dict(codes_compared=made), admission_launches=admitted,
         step_ms_replayed=replayed_ms, step_ms_eager=eager_ms, f32_step_ms_replayed=f32["step_ms_replayed"],
         f32_kernels_per_step=f32["kernels_per_step"], profile=window, quant_ops_per_eager_step=ops,
         dequant_frac_of_step=state["dequant_frac_of_step"], peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    READINGS["engine_quant_flagship"] = engine
    READINGS["engine_quant_step_ms"] = replayed_ms
    runs = (admitted, fill_launches, eager_launches)
    return qmodel, {k: sum(run[k] for run in runs) for k in COUNTERS}


def phase_engine_spec_flagship(fa, sampling, dalle, qmodel):
    """The int8 flagship (int8 weights, int8 pool) served by speculative
    rounds (k 4, d 32 of 64), the draft and the verification captured:
    two requests, one guided, whose first 64 codes equal the same
    engine's with speculation off (`torch.equal`) under their seeds; the
    replayed round's ms with 8 lanes decoding, the codes a round gives and
    the draft's share of the round (every draft of d 32 is accepted on
    these seeded weights, so the rejection path runs on the first
    `DRILL_DEPTH` layers of the flagship, int8, d 2 of 4: two requests,
    one guided, whose whole images' codes equal the sequential engine's,
    with drafts rejected); a poison-request drill on those layers
    (speculative, one retry): the victim ends "poisoned" and its
    neighbour's codes equal its codes in the clean speculative engine; and
    the reversible flagship refused with `validate_spec`'s message."""
    import dataclasses

    from dalle_pytorch_tpu_torch import quantization as quant
    from dalle_pytorch_tpu_torch.models import speculative as spec_mod
    from dalle_pytorch_tpu_torch.serving.engine import EngineConfig, GenerationEngine
    from dalle_pytorch_tpu_torch.training import resilience

    cfg, lanes = dalle.cfg, 8
    seq_engine = READINGS.pop("engine_quant_flagship")
    ecfg = EngineConfig(num_slots=lanes, block_size=ENGINE_BLOCK, filter_thres=ENGINE_THRES, quantize_kv="int8",
                        spec_k=SPEC_K)
    t0 = time.perf_counter()
    engine = GenerationEngine(qmodel, engine_cfg=ecfg)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    check(engine.spec_graphs is not None, "the speculative engine captured no graphs")
    texts = engine_texts(cfg, 8, 101)
    conds, seeds = ENGINE_COND[:2], (1010, 1011)
    want, _ = forward_launches(qmodel, cfg.text_seq_len + 1)
    reset_launches(fa)
    spec_codes, rounds = engine_prefix_codes(engine, texts, conds, seeds, 64)
    admitted = read_launches(fa)
    check(admitted == {k: 2 * v for k, v in want.items()}, f"2 speculative admissions launched {admitted}")
    seq_codes, polls = engine_prefix_codes(seq_engine, texts, conds, seeds, 64)
    del seq_engine
    for i in range(2):
        check(torch.equal(spec_codes[i], seq_codes[i]),
              f"request {i}'s first 64 speculative codes differ from the sequential engine's")

    reset_launches(fa)
    for i in range(lanes):
        engine.submit(texts[i].cpu().numpy(), seed=i)
    engine.poll()
    fill_launches = read_launches(fa)
    before = dict(engine.counts), engine.spec_draft_s, engine.spec_round_s
    round_ms = engine_window(engine, 16)
    accepted = (engine.counts["spec_accepted_tokens"] - before[0]["spec_accepted_tokens"]) / (
        engine.counts["spec_request_rounds"] - before[0]["spec_request_rounds"])
    draft_frac = (engine.spec_draft_s - before[1]) / (engine.spec_round_s - before[2])
    engine.drain()
    state = engine.spec_state()
    del engine

    # the flagship's first layers, int8: speculative rounds that reject (the
    # lanes' rollback) against the sequential engine, then the poison drill
    small = twin_module(dalle.module, dataclasses.replace(cfg, depth=DRILL_DEPTH)).eval().requires_grad_(False)
    quant.quantize_tree(small, "int8")
    drill_reqs = ((texts[0], 7, 3.0), (texts[1], 8, 1.0))
    shallow = {}
    for name, k in (("spec", SPEC_K), ("sequential", 0)):
        eng = GenerationEngine(small, engine_cfg=dataclasses.replace(ecfg, spec_k=k))
        reqs = [eng.submit(t.cpu().numpy(), seed=seed, cond_scale=c) for t, seed, c in drill_reqs]
        eng.run_until_idle()
        check(all(r.outcome == "completed" for r in reqs), f"shallow {name}: outcomes {[r.outcome for r in reqs]}")
        shallow[name] = dict(codes=[torch.as_tensor(r.codes) for r in reqs], counts=dict(eng.counts),
                             state=eng.spec_state() if k else None)
        del eng
    rejected = shallow["spec"]["counts"]["spec_rejected_tokens"]
    check(rejected > 0, f"the {DRILL_DEPTH}-layer drafter had no draft rejected: the rollback did not run")
    for i in range(len(drill_reqs)):
        check(torch.equal(shallow["spec"]["codes"][i], shallow["sequential"]["codes"][i]),
              f"the {DRILL_DEPTH}-layer model's request {i}: speculative codes differ from the sequential engine's")
    drill = GenerationEngine(small, engine_cfg=dataclasses.replace(ecfg, poison_max_retries=1))
    inj = resilience.FaultInjector(resilience.parse_fault("poison-request@2")).install()
    try:
        t0 = time.perf_counter()
        victim, neighbour = (drill.submit(t.cpu().numpy(), seed=seed, cond_scale=c) for t, seed, c in drill_reqs)
        drill.run_until_idle()
        torch.cuda.synchronize()
        drill_s = time.perf_counter() - t0
    finally:
        inj.uninstall()
    check(victim.outcome == "poisoned" and victim.poison_retries == 1,
          f"the victim ended {victim.outcome} after {victim.poison_retries} retries")
    # the neighbour's codes: those of the clean engines of the same settings
    # (the int8 pool's codes, not the f32 cache's)
    check(neighbour.outcome == "completed"
          and torch.equal(torch.as_tensor(neighbour.codes), shallow["spec"]["codes"][1]),
          "the poisoned request's neighbour lost the codes it gets in a clean engine")
    drill_state = drill.spec_state()
    del drill, small

    rev_cfg = dataclasses.replace(cfg, reversible=True)
    try:
        spec_mod.validate_spec(rev_cfg.transformer_config(), SPEC_K, None)
        refused = None
    except ValueError as e:
        refused = str(e)
    check(refused is not None and "requires sequential execution" in refused, f"reversible spec: {refused}")
    emit("engine_spec_flagship", lanes=lanes, spec_k=SPEC_K, draft_layers=ecfg.spec_draft_layers or cfg.depth // 2,
         weights="int8", kv="int8", build_and_capture_s=build_s,
         codes_equal_sequential=dict(requests=2, cond_scale=list(conds), codes_compared=64, spec_rounds=rounds,
                                     sequential_polls=polls),
         admission_launches=admitted, round_ms_replayed=round_ms, accepted_tokens_per_round=accepted,
         draft_time_frac=draft_frac, ms_per_code=round_ms / accepted,
         int8_step_ms_replayed=READINGS.get("engine_quant_step_ms"), totals=state,
         rejecting_drafter=dict(depth=DRILL_DEPTH, requests=len(drill_reqs), codes_equal_sequential=True,
                                codes_compared=[len(c) for c in shallow["spec"]["codes"]], rejected_tokens=rejected,
                                spec=shallow["spec"]["state"]),
         poison_drill=dict(depth=DRILL_DEPTH, victim_outcome=victim.outcome, retries=victim.poison_retries,
                           neighbour_codes_equal_clean=True, wall_s=drill_s, spec=drill_state),
         reversible_refused=refused)
    runs = (admitted, fill_launches)
    return {k: sum(run[k] for run in runs) for k in COUNTERS}


def phase_generate_spec(fa, sampling, dalle):
    """Speculative sampling on the 12-layer model (configs[2]; k 4, d 6 of
    12), two prompts with CFG 3.0, against the sequential call under one
    seed: `sample_image_codes(spec_k=4)`'s codes equal (`torch.equal`),
    the call capturing the rounds; then `generate_images(spec_k=4)`,
    replaying them, its images within 1e-4 of the VAE's decode of the
    sequential codes (the convolutions need not repeat bit for bit).
    The rounds' ms, the codes a round gives and the draft's share, beside
    the sequential step."""
    from dalle_pytorch_tpu_torch.models import vae_registry

    m, vae = dalle.module, dalle.vae.module
    cfg = dalle.cfg
    text = torch.randint(1, cfg.num_text_tokens, (2, cfg.text_seq_len),
                         generator=torch.Generator().manual_seed(111)).cuda()
    runs = {}
    reset_launches(fa)
    for name, k in (("sequential", 0), ("spec", SPEC_K)):
        timings = {}
        codes = sampling.sample_image_codes(m, text, torch.Generator(device="cuda").manual_seed(112),
                                            filter_thres=ENGINE_THRES, cond_scale=3.0, spec_k=k, timings=timings)
        runs[name] = dict(codes=codes, timings=timings)
    timings = {}  # the second spec call replays the rounds the first captured
    images = sampling.generate_images(m, vae, text, torch.Generator(device="cuda").manual_seed(112),
                                      filter_thres=ENGINE_THRES, cond_scale=3.0, spec_k=SPEC_K, timings=timings)
    launches = read_launches(fa)
    seq, t = runs["sequential"], timings
    check(torch.equal(runs["spec"]["codes"], seq["codes"]),
          "speculative codes differ from the sequential call's under one seed")
    image_err = (vae_registry.decode_indices(vae, seq["codes"]) - images).abs().max().item()
    check(image_err <= 1e-4 and bool(torch.isfinite(images).all()),
          f"generate_images(spec_k={SPEC_K})'s images differ from the sequential codes' by {image_err}")
    n_gen = cfg.image_seq_len
    emit("generate_spec", model="12-layer", spec_k=SPEC_K, draft_layers=cfg.depth // 2, cond_scale=3.0,
         codes_equal_sequential=True, images_max_abs_err=image_err, spec_rounds=t["spec_rounds"],
         accepted_tokens_per_round=(n_gen - 1) / t["spec_rounds"],
         round_ms=(t["draft_s"] + t["verify_s"]) / t["spec_rounds"] * 1e3,
         draft_time_frac=t["draft_s"] / (t["draft_s"] + t["verify_s"]), spec_decode_s=t["decode_s"],
         sequential_decode_s=seq["timings"]["decode_s"],
         sequential_step_ms=seq["timings"]["decode_s"] / (n_gen - 1) * 1e3,
         capture_s=dict(sequential=seq["timings"]["capture_s"], spec=runs["spec"]["timings"]["capture_s"],
                        generate_images=t["capture_s"]),
         launches=launches)
    return launches


# ---------------------------------------------------------------------------
# the serving fleet: replicas behind the router, disaggregated prefill, the
# journal, the breaker and the hedge, the degrade ladder, the SLO monitor
# ---------------------------------------------------------------------------

FLEET_LANES = 4  # lanes a replica
FLEET_KILL_AT = 36  # fleet_flagship's loss: the fleet iteration, 34-code prefixes made before it
FLEET_PREFIX = 34
CRASH_AT = 24  # fleet_durability's kill-fleet: the child's fleet iteration

# the child of fleet_durability's crash drill: the 12-layer model served by a
# journaled fleet that SIGKILLs itself at fleet iteration CRASH_AT
CRASH_CHILD = r"""
import sys
root, journal_dir, texts = sys.argv[1], sys.argv[2], sys.argv[3]
sys.path.insert(0, root)
import numpy as np
import chip_smoke as cs
import dalle_pytorch_tpu_torch as port
from dalle_pytorch_tpu_torch.serving.engine import EngineConfig
from dalle_pytorch_tpu_torch.serving.fleet import FleetConfig, ServingFleet
from dalle_pytorch_tpu_torch.serving.journal import RequestJournal
from dalle_pytorch_tpu_torch.training import resilience

dalle = port.DALLE(vae=port.DiscreteVAE(seed=0, **cs.FULL_VAE), seed=1, **cs.FULL)
fleet = ServingFleet(dalle.module, fleet_cfg=FleetConfig(replicas=2, engine=EngineConfig(
    num_slots=cs.FLEET_LANES, block_size=cs.ENGINE_BLOCK, filter_thres=cs.ENGINE_THRES)))
fleet.attach_journal(RequestJournal(journal_dir))
resilience.FaultInjector(resilience.parse_fault(f"kill-fleet@{cs.CRASH_AT}")).install()
texts = np.load(texts)
for i in range(len(cs.ENGINE_COND)):
    fleet.submit(texts[i], seed=cs.FLEET_SEEDS[i], temperature=cs.ENGINE_TEMP[i], cond_scale=cs.ENGINE_COND[i])
print("journaled", len(texts), flush=True)
while fleet.busy:
    fleet.poll()
print("the fleet outlived its kill-fleet fault", flush=True)
"""
FLEET_SEEDS = tuple(7100 + i for i in range(6))


class CompletionTap:
    """A fleet as the loadgen drives it, keeping every completion."""

    def __init__(self, fleet):
        self.fleet, self.done = fleet, []

    @property
    def busy(self):
        return self.fleet.busy

    def submit(self, **kw):
        return self.fleet.submit(**kw)

    def poll(self):
        out = self.fleet.poll()
        self.done.extend(out)
        return out


def noise_prefix_refs(sampling, model, texts, noise, n):
    """Batch-1 image loops of `n` codes under each request's noise, with the
    ENGINE_COND / ENGINE_TEMP settings (replayed from the model's graphs)."""
    mode = sampling.Mode(noise=True, stats=False)
    refs = []
    for i in range(noise.shape[0]):
        loop, run = sampling.image_loop(model, 1, ENGINE_COND[i], 0, ENGINE_THRES, mode)
        _, logits = sampling._prefill_phase(model, texts[i:i + 1], None, 0, ENGINE_COND[i], loop.cache)
        ref, _ = run(model, logits, n, None, ENGINE_TEMP[i], noise[i][:, None], mode)
        refs.append(ref[0].cpu().numpy())
    return refs


def handoff_bytes(handoff):
    """(KV bytes, ring bytes) of a handoff's tensors."""
    kv = sum(layer[name].nbytes for layer in handoff["layers"] for name in ("k", "v", "k_scale", "v_scale")
             if name in layer)
    ring = sum(layer[name].nbytes for layer in handoff["layers"] for name in ("shift_attn", "shift_ff")
               if name in layer)
    return kv, ring


def phase_fleet_flagship(fa, sampling, loadgen, dalle):
    """The flagship served by a fleet (`serving/fleet.py`) of 2 replicas x 4
    lanes, f32, with disaggregated prefill: each replica's replayed step
    with its lanes full; one guided admission handed off by the prefill
    worker, its flash launches (the flagship's layer cycle: 64, 48 masked)
    and its handoff's bytes from the tensors against `prefill_handoff_row`;
    then six requests (two guided, one at temperature 0.7) under injected
    noise through `tools/loadgen.py`, with `kill-replica@N:0` at a fixed
    fleet iteration: replica 0's requests requeue on replica 1 and every
    request completes; each one's first 34 codes equal its batch-1 loop's
    under its noise; images/s and journey TTFT over the six."""
    from dalle_pytorch_tpu_torch.observability import metrics as obs_metrics
    from dalle_pytorch_tpu_torch.ops.sampling import gumbel_noise
    from dalle_pytorch_tpu_torch.serving.engine import EngineConfig
    from dalle_pytorch_tpu_torch.serving.fleet import FleetConfig, ServingFleet
    from dalle_pytorch_tpu_torch.training import resilience

    m, cfg = dalle.module, dalle.cfg
    n = len(ENGINE_COND)
    want, _ = forward_launches(m, cfg.text_seq_len + 1)
    ecfg = EngineConfig(num_slots=FLEET_LANES, block_size=ENGINE_BLOCK, filter_thres=ENGINE_THRES,
                        noise_override=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fleet = ServingFleet(m, dalle.vae.module, fleet_cfg=FleetConfig(replicas=2, disaggregate=True, engine=ecfg))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    check(all(e.graph is not None for e in fleet.engines), "a replica captured no graph on the card")
    texts = engine_texts(cfg, 8, 71)

    # each replica's replayed step with its lanes full, polled alone
    reset_launches(fa)
    step_ms = []
    for eng in fleet.engines:
        for i in range(FLEET_LANES):
            eng.submit(texts[i].cpu().numpy(), seed=i)
        eng.poll()
        step_ms.append(engine_window(eng, 16))
        eng.drain()
    fill_launches = read_launches(fa)
    check(fill_launches == {k: 2 * FLEET_LANES * v for k, v in want.items()},
          f"{2 * FLEET_LANES} handed-off admissions launched {fill_launches}")

    # one guided admission through the prefill worker
    worker = fleet.prefill_worker
    reset_launches(fa)
    guided = fleet.submit(texts[1].cpu().numpy(), seed=9, cond_scale=3.0)
    fleet.poll()
    one_launches = read_launches(fa)
    check(guided.codes_done == 2 and one_launches == want,
          f"one handed-off admission launched {one_launches}; the layer cycle gives {want}")
    kv, ring = handoff_bytes(worker.last_handoff)
    row, lane_row = worker.last_handoff["comms_row"], worker.handoff_row(1)
    n_pre = cfg.text_seq_len + 1
    check(row == worker.handoff_row(2) and (kv, ring) == (row["payload_bytes"], row["ring_bytes"])
          and lane_row["payload_bytes"] == 2 * cfg.depth * cfg.heads * n_pre * cfg.dim_head * 4,
          f"handoff tensors {kv} + {ring} B against the row {row}")
    fleet.engines[guided.replica].drain()

    # six requests under noise through the loadgen, replica 0 lost mid-decode
    noise = gumbel_noise((n, cfg.image_seq_len, cfg.total_tokens), torch.Generator(device="cuda").manual_seed(72),
                         device="cuda")
    tap = CompletionTap(fleet)
    requeued0 = obs_metrics.counter("router/requeued").value
    admitted0 = obs_metrics.counter("serving/admitted").value
    kill_at = fleet._iter + FLEET_KILL_AT
    inj = resilience.FaultInjector(resilience.parse_fault(f"kill-replica@{kill_at}:0")).install()
    reset_launches(fa)
    try:
        report = loadgen.PoissonLoadGen(n, 1000.0, streams=2, seed=0).run(tap, lambda i: dict(
            text=texts[i].cpu().numpy(), noise=noise[i], temperature=ENGINE_TEMP[i], cond_scale=ENGINE_COND[i]))
    finally:
        inj.uninstall()
    load_launches = read_launches(fa)
    requeued = int(obs_metrics.counter("router/requeued").value - requeued0)
    lost = [a for a in fleet.router.alarms if a["type"] == "replica_lost"]
    check(len(lost) == 1 and lost[0]["replica"] == 0 and requeued == lost[0]["requeued"] > 0,
          f"the loss drill: alarms {fleet.router.alarms}, requeued {requeued}")
    check(fleet.engines[0].kv is None and [r.id for r in fleet.router.alive()] == [1],
          "the lost replica kept its pool or stays alive")
    admitted = int(obs_metrics.counter("serving/admitted").value - admitted0)
    check(admitted >= n and load_launches == {k: admitted * v for k, v in want.items()},
          f"{admitted} admissions ({n} requests, {requeued} requeued) launched {load_launches}")
    journeys = {}
    for r in tap.done:
        check(r.trace_uid not in journeys, f"journey {r.trace_uid} completed twice")
        journeys[r.trace_uid] = r
    check(len(journeys) == n and report["journeys_completed"] == n and report["requests_refused"] == 0,
          f"the six journeys: {report}")
    refs = noise_prefix_refs(sampling, m, texts, noise, FLEET_PREFIX)
    hops = {}
    for i in range(n):
        uid = next(u for u, r in journeys.items() if np.array_equal(r.text, texts[i].cpu().numpy())
                   and r.cond_scale == ENGINE_COND[i])
        got = journeys[uid]
        hops[i] = got.replica
        check(len(got.codes) == cfg.image_seq_len and np.array_equal(got.codes[:FLEET_PREFIX], refs[i]),
              f"request {i} (served by replica {got.replica}): its first {FLEET_PREFIX} codes differ from its "
              "batch-1 loop's under its noise")
    emit("fleet_flagship", replicas=2, lanes_per_replica=FLEET_LANES, disaggregate=True,
         build_and_capture_s=build_s, step_ms_replayed_by_replica=step_ms,
         step_ms_single_engine_8_lanes=READINGS.get("engine_flagship", {}).get("step_ms_replayed"),
         one_admission_launches=one_launches,
         handoff=dict(guided_row=row, lane_row=lane_row, tensor_bytes=kv + ring, kv_bytes=kv, ring_bytes=ring),
         kill_at_fleet_iteration=kill_at, requeued=requeued, admissions=admitted, served_by=hops,
         codes_equal_batch1=dict(requests=n, codes_compared=FLEET_PREFIX, whole_images=True),
         loadgen=report, images_per_s=report["images_per_sec_per_chip"], ttft_p50_s=report["ttft_p50_s"],
         ttft_p99_s=report["ttft_p99_s"], handoff_bytes_total=obs_metrics.counter("serving/handoff_bytes").value,
         launches=dict(fill=fill_launches, one=one_launches, load=load_launches),
         peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    runs = (fill_launches, one_launches, load_launches)
    del fleet, tap
    return {k: sum(run[k] for run in runs) for k in COUNTERS}


def seeded_prefix(sampling, model, text_row, seed, i, filter_thres=ENGINE_THRES, cond_scale=None):
    """The first FLEET_PREFIX codes of a batch-1 image loop whose generator
    has `seed`, at request i's ENGINE_TEMP and cond_scale (ENGINE_COND[i]
    unless given; replayed from the model's graphs)."""
    cond = ENGINE_COND[i] if cond_scale is None else cond_scale
    mode = sampling.Mode(noise=False, stats=False)
    loop, run = sampling.image_loop(model, 1, cond, 0, filter_thres, mode)
    _, logits = sampling._prefill_phase(model, text_row[None], None, 0, cond, loop.cache)
    codes, _ = run(model, logits, FLEET_PREFIX, torch.Generator(device="cuda").manual_seed(seed), ENGINE_TEMP[i],
                   None, mode)
    return codes[0].cpu().numpy()


def whole_with_prefix(codes, ref, n_gen) -> bool:
    """A request's codes: a whole image whose first codes are `ref`."""
    return codes is not None and len(codes) == n_gen and np.array_equal(codes[:len(ref)], ref)


def phase_fleet_durability(fa, sampling, dalle):
    """The 12-layer model (configs[2]) at full width behind a fleet of 2
    replicas x 4 lanes, f32, prefill fused.  Journal replay: a child
    process serves six journaled requests (two guided, one at temperature
    0.7) and SIGKILLs itself (`kill-fleet@N`); a fresh fleet replays the
    journal: every unacknowledged request completes, its first 34 codes
    those of its batch-1 loop under its seed, with no duplicate
    acknowledgement; an unmeetable TTFT
    target on that fleet fires one `slo_burn_rate` alarm and its status
    file parses.  Stall: `stall-replica@N:1` opens replica 1's breaker once
    and it recovers; its deadline request is hedged once on replica 0, and
    the pair's second completion is suppressed.  Degrade: speculative
    replicas (k 4) under a flood climb the ladder to cap_candidates (rung
    2): the requests admitted there give the batch-1 loops' codes at
    `degraded_filter_thres` under their seeds (34), from the replayed
    sequential graph, and no speculative round runs at that rung."""
    from dalle_pytorch_tpu_torch.observability import metrics as obs_metrics
    from dalle_pytorch_tpu_torch.observability.slo import SloMonitor, SloTargets
    from dalle_pytorch_tpu_torch.serving.degrade import DegradeConfig, DegradeLadder
    from dalle_pytorch_tpu_torch.serving.engine import EngineConfig
    from dalle_pytorch_tpu_torch.serving.fleet import FleetConfig, ServingFleet
    from dalle_pytorch_tpu_torch.serving.journal import RequestJournal
    from dalle_pytorch_tpu_torch.training import resilience

    m, cfg = dalle.module, dalle.cfg
    n = len(ENGINE_COND)
    want, _ = forward_launches(m, cfg.text_seq_len + 1)
    texts = engine_texts(cfg, n, 81)
    ecfg = EngineConfig(num_slots=FLEET_LANES, block_size=ENGINE_BLOCK, filter_thres=ENGINE_THRES, telemetry_every=8)
    counter = lambda name: obs_metrics.counter(name).value  # noqa: E731
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        np.save(tmp / "texts.npy", texts.cpu().numpy())
        t0 = time.perf_counter()
        child = subprocess.run([sys.executable, "-c", CRASH_CHILD, str(ROOT), str(tmp / "journal"),
                                str(tmp / "texts.npy")], capture_output=True, text=True, timeout=300)
        child_s = time.perf_counter() - t0
        check(child.returncode == -9 and "kill-fleet" in child.stdout,
              f"the crash child exited {child.returncode}: {child.stdout[-800:]} {child.stderr[-1500:]}")
        journal = RequestJournal(str(tmp / "journal"))
        before = journal.stats()
        check(before == {"accepted": n, "acked": 0, "unacknowledged": n}, f"the journal after the crash: {before}")

        fleet = ServingFleet(m, fleet_cfg=FleetConfig(replicas=2, engine=ecfg, stall_wedge_s=2.0, stall_after_s=0.2,
                                                      probe_after_s=0.2, hedge_frac=0.1))
        alarms = []
        fleet.attach_journal(journal)
        fleet.attach_slo(SloMonitor(SloTargets(ttft_p99_s=1e-6), on_alarm=alarms.append),
                         status_path=str(tmp / "status.json"))
        dup0 = counter("journal/duplicate_acks")
        reset_launches(fa)
        t0 = time.perf_counter()
        payloads = journal.replay()
        replayed = [fleet.submit_when_able(p["text"], seed=p["seed"], temperature=p["temperature"],
                                           cond_scale=p["cond_scale"], replayed=True) for p in payloads]
        fleet.run_until_idle()
        torch.cuda.synchronize()
        replay_s = time.perf_counter() - t0
        replay_launches = read_launches(fa)
        check(replay_launches == {k: n * v for k, v in want.items()}, f"{n} replayed admissions: {replay_launches}")
        after = journal.stats()
        dup = counter("journal/duplicate_acks") - dup0
        check(after == {"accepted": n, "acked": n, "unacknowledged": 0} and dup == 0,
              f"the journal after the replay: {after}, {dup} duplicate acks")
        refs = [seeded_prefix(sampling, m, texts[i], FLEET_SEEDS[i], i) for i in range(n)]
        for i, req in enumerate(replayed):
            check(req.outcome == "completed" and req.replayed
                  and whole_with_prefix(req.codes, refs[i], cfg.image_seq_len),
                  f"replayed request {i} (replica {req.replica}): its codes differ from its batch-1 loop's")
        fleet.close()
        check([a["type"] for a in alarms] == ["slo_burn_rate"] and alarms[0]["slo"] == "ttft_p99",
              f"the unmeetable TTFT target's alarms: {alarms}")
        status = json.loads((tmp / "status.json").read_text())
        check(status["active_alarms"] == ["ttft_p99"] and status["live"]["completed"] >= n,
              f"status.json: {status}")
        fleet.attach_slo(None)  # its status file goes with the directory
        journal.close()

    # each replica's replayed step with its lanes full (seeded), polled alone
    fleet.attach_journal(None)
    reset_launches(fa)
    step_ms = []
    for eng in fleet.engines:
        for i in range(FLEET_LANES):
            eng.submit(texts[i].cpu().numpy(), seed=900 + i)
        eng.poll()
        step_ms.append(engine_window(eng, 32))
        eng.drain()
    fill_launches = read_launches(fa)
    check(fill_launches == {k: 2 * FLEET_LANES * v for k, v in want.items()}, f"the fills launched {fill_launches}")

    # the stall drill on the same fleet, without the journal
    base = {k: counter(f"router/{k}") for k in ("breaker_open", "breaker_closed", "hedged", "hedge_duplicates")}
    inj = resilience.FaultInjector(resilience.parse_fault(f"stall-replica@{fleet._iter + 3}:1")).install()
    reset_launches(fa)
    t0 = time.perf_counter()
    try:
        stalled = [fleet.submit(texts[i].cpu().numpy(), seed=FLEET_SEEDS[i], temperature=ENGINE_TEMP[i],
                                cond_scale=ENGINE_COND[i], deadline_s=4.0) for i in (0, 2)]
        done = fleet.run_until_idle()
    finally:
        inj.uninstall()
    stall_s = time.perf_counter() - t0
    stall_launches = read_launches(fa)
    moved = {k: counter(f"router/{k}") - v for k, v in base.items()}
    check(sorted(r.replica for r in stalled) == [0, 1], f"the stall drill's placements: {[r.replica for r in stalled]}")
    check(moved["breaker_open"] == 1 and moved["breaker_closed"] >= 1 and moved["hedged"] == 1
          and moved["hedge_duplicates"] == 1, f"the stall drill: {moved}")
    check(sorted(r.trace_uid for r in done) == sorted(r.trace_uid for r in stalled),
          "the stall drill delivered a request twice or lost one")
    for r in done:
        i = 0 if r.trace_uid == stalled[0].trace_uid else 2
        check(whole_with_prefix(r.codes, refs[i], cfg.image_seq_len),
              f"stall drill: request {i}'s delivered codes differ from its batch-1 loop's")
    check(stall_launches == {k: 3 * v for k, v in want.items()}, f"2 admissions and a hedge: {stall_launches}")
    del fleet

    # the degrade ladder on speculative replicas
    # a flood of 4 x lanes fills a replica's lanes and its queue of 2 x lanes: a queue fraction of 0.5
    spec_cfg = dataclasses.replace(ecfg, max_queue=2 * FLEET_LANES, spec_k=SPEC_K)
    fleet = ServingFleet(m, fleet_cfg=FleetConfig(replicas=2, engine=spec_cfg))
    check(all(e.graph is None and e.spec_graphs is not None for e in fleet.engines),
          "a speculative replica without a ladder lacks its speculative graphs or has a sequential one")
    ladder = DegradeLadder(DegradeConfig(enter_after_s=0.05, exit_after_s=600.0, queue_frac_hi=0.5,
                                         queue_frac_lo=0.1, max_rung=2), text_seq_len=cfg.text_seq_len)
    fleet.attach_degrade(ladder)
    check(all(e.graph is not None for e in fleet.engines),
          "attaching the ladder did not capture a speculative replica's sequential step")
    admitted0 = counter("serving/admitted")
    inj = resilience.FaultInjector(resilience.parse_fault(f"flood@{fleet.engines[0]._iter + 1}:{4 * FLEET_LANES}"))
    inj.install()
    reset_launches(fa)
    try:
        polls = 0
        while ladder.rung < 2:
            fleet.poll()
            polls += 1
            check(polls < 2000, f"the flood left the ladder at rung {ladder.rung}")
    finally:
        inj.uninstall()
    rounds_at_2 = counter("serving/spec_rounds")
    check(rounds_at_2 > 0, "the speculative replicas ran no round before the ladder climbed")
    probes = [fleet.submit(texts[i].cpu().numpy(), seed=FLEET_SEEDS[i] + 50, cond_scale=ENGINE_COND[i])
              for i in (3, 4)]
    check(all(p.degrade_rung == 2 and p.cond_scale == 1.0 for p in probes), "the probes were not shaped at rung 2")
    while any(p.codes is None for p in probes):
        fleet.poll()
        check(ladder.rung == 2, f"the ladder left rung 2 ({ladder.rung}) while the probes decoded")
    torch.cuda.synchronize()
    check(counter("serving/spec_rounds") == rounds_at_2, "a speculative round ran at rung 2")
    for eng in fleet.engines:
        eng.drain()
    degrade_launches = read_launches(fa)
    admitted = int(counter("serving/admitted") - admitted0)
    check(degrade_launches == {k: admitted * v for k, v in want.items()}, f"{admitted} admissions: {degrade_launches}")
    thres = spec_cfg.degraded_filter_thres
    for p, i in zip(probes, (3, 4)):
        ref = seeded_prefix(sampling, m, texts[i], FLEET_SEEDS[i] + 50, i, filter_thres=thres, cond_scale=1.0)
        check(whole_with_prefix(p.codes, ref, cfg.image_seq_len),
              f"the capped probe {i}'s codes differ from its batch-1 loop's at {thres}")
    emit("fleet_durability", replicas=2, lanes_per_replica=FLEET_LANES, crash_child_s=child_s,
         crash_at_fleet_iteration=CRASH_AT, journal_before=before, journal_after=after, duplicate_acks=dup,
         replay=dict(requests=n, whole_images=True, codes_equal_batch1=FLEET_PREFIX, wall_s=replay_s,
                     launches=replay_launches),
         step_ms_replayed_by_replica=step_ms, fill_launches=fill_launches,
         slo=dict(alarms=len(alarms), alarm=alarms[0], status_keys=sorted(status)),
         stall=dict(moved, wall_s=stall_s, launches=stall_launches, placements=[r.replica for r in stalled]),
         degrade=dict(rung=ladder.rung, polls_to_rung_2=polls, rungs_entered=ladder.rungs_entered,
                      degraded_filter_thres=thres, probes_codes_equal_batch1=FLEET_PREFIX,
                      spec_rounds_before=rounds_at_2,
                      admitted=admitted, launches=degrade_launches))
    runs = (replay_launches, fill_launches, stall_launches, degrade_launches)
    del fleet
    return {k: sum(run[k] for run in runs) for k in COUNTERS}


def phase_serve_cli(fa, port, weights, checkpoint):
    """`python -m dalle_pytorch_tpu_torch.cli.serve --synthetic --loadgen 8`
    in process at a small width (the report holds the loadgen's keys), the
    same with the fleet's flags (`--replicas 2 --disaggregate --journal
    --degrade --slo_ttft_p99 --status_json`: every request handed off and
    acknowledged, one SLO alarm, the status file parsed), then
    `cli.generate --engine` for one prompt against a v3 checkpoint of a small
    model: its PNG equals the one `cli.generate` without `--engine` writes
    under the same seed."""
    import contextlib
    import io

    from dalle_pytorch_tpu_torch.cli import serve
    from dalle_pytorch_tpu_torch.cli.png import read_png

    out = io.StringIO()
    reset_launches(fa)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(out):
        report = serve.main(["--synthetic", "--loadgen", "8", "--rate", "4", "--streams", "2", "--dim", "256",
                             "--depth", "2", "--heads", "4", "--dim_head", "64", "--text_seq_len", "63",
                             "--image_fmap_size", "8", "--slots", "4", "--cond_scale", "2.0",
                             "--report_json", str(Path(tmp) / "report.json")])
        check(json.loads((Path(tmp) / "report.json").read_text()) == report, "serve: the report file differs")
    serve_s = time.perf_counter() - t0
    serve_launches = read_launches(fa)
    keys = {"requests_completed", "requests_refused", "ttft_p50_s", "ttft_p99_s", "latency_p50_s", "latency_p99_s",
            "images_per_sec_per_chip"}
    check(keys <= set(report) and report["requests_completed"] == 8, f"serve report {report}")
    check(serve_launches["flash_fwd"] == 8 * 2, f"serve: 8 admissions of a depth-2 model launched {serve_launches}")
    # the fleet's flags: two replicas, prefill handed off, the journal, the ladder, an SLO and its status file
    reset_launches(fa)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(out):
        fleet_report = serve.main(["--synthetic", "--loadgen", "6", "--rate", "4", "--streams", "2", "--dim", "256",
                                   "--depth", "2", "--heads", "4", "--dim_head", "64", "--text_seq_len", "63",
                                   "--image_fmap_size", "8", "--slots", "4", "--cond_scale", "2.0", "--replicas",
                                   "2", "--disaggregate", "--journal", str(Path(tmp) / "journal"), "--degrade",
                                   "--slo_ttft_p99", "1e-6", "--status_json", str(Path(tmp) / "status.json")])
        status = json.loads((Path(tmp) / "status.json").read_text())
    fleet_s = time.perf_counter() - t0
    fleet_launches = read_launches(fa)
    check(fleet_report["requests_completed"] == 6 and fleet_report["replicas"] == 2
          and fleet_report["handoff_requests"] == 6 and fleet_report["journal_acked"] == 6
          and fleet_report["journal_unacknowledged"] == 0 and fleet_report["slo_alarms"] == 1
          and "degrade_rung" in fleet_report and status["active_alarms"] == ["ttft_p99"],
          f"serve --replicas 2 --disaggregate ...: {fleet_report}")
    check(fleet_launches["flash_fwd"] == 6 * 2, f"serve: 6 handed-off admissions launched {fleet_launches}")

    vae = port.DiscreteVAE(seed=0, **SMALL_VAE)
    dalle = port.DALLE(vae=vae, seed=51, **SMALL)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        save_dalle_checkpoint(checkpoint, weights, tmp / "dalle.pt", dalle, vae)
        common = ["--dalle_path", str(tmp / "dalle.pt"), "--text", "a small red cube", "--num_images", "1",
                  "--batch_size", "1", "--seed", "5", "--cond_scale", "3.0"]
        (plain,), _, _, _, plain_s = run_cli(fa, common + ["--outputs_dir", str(tmp / "plain")])
        (engined,), _, engine_launches, _, engine_s = run_cli(fa, common + ["--outputs_dir", str(tmp / "engine"),
                                                                            "--engine", "--engine_slots", "2"])
        check(np.array_equal(read_png(plain), read_png(engined)),
              "generate --engine wrote another image than generate under the same seed")
    emit("serve_cli", serve_wall_s=serve_s, report=report, launches=serve_launches,
         fleet=dict(wall_s=fleet_s, report=fleet_report, launches=fleet_launches),
         generate_engine=dict(png_equal_to_plain=True, plain_s=plain_s, engine_s=engine_s,
                              launches=engine_launches))
    return {k: serve_launches[k] + fleet_launches[k] + engine_launches[k] for k in COUNTERS}


# ---------------------------------------------------------------------------
# the transformer settings: reversible execution, shared layers, the stable
# model and the sandwich norm
# ---------------------------------------------------------------------------

# the 12-layer model (configs[2]) with the stable model, the sandwich norm
# and four attention and feed-forward ids cycled over its 12 layers
STABLE_SHARED = dict(FULL, stable=True, sandwich_norm=True, shared_attn_ids=(0, 1, 2, 3),
                     shared_ff_ids=(0, 1, 2, 3))
# the train CLI's flags for it (the CLI has no sandwich-norm flag, as the
# JAX CLI has none): configs[2]'s widths with rotary, 16 PNGs in 2 steps
STABLE_SHARED_CLI = ("--dim", "1024", "--depth", "12", "--heads", "16", "--dim_head", "64", "--text_seq_len", "256",
                     "--shift_tokens", "--rotary_emb", "--truncate_captions", "--batch_size", "8", "--epochs", "1",
                     "--num_workers", "4", "--stable_softmax", "--shared_attn_ids", "0,1,2,3", "--shared_ff_ids",
                     "0,1,2,3")
# a small model with every setting: SMALL_FLAGSHIP's features over two
# cycles of its four layer types, the attention ids (0, 1, 2, 3) repeating
# with the types (ids (0, 1, 0, 1) would give the full layer's id to
# axial_col, which derive_layer_specs refuses), feed-forward ids (0, 1, 0, 1)
SMALL_SETTINGS = dict(SMALL_FLAGSHIP, depth=8, reversible=True, stable=True, sandwich_norm=True,
                      shared_attn_ids=(0, 1, 2, 3), shared_ff_ids=(0, 1, 0, 1))


def twin_module(module, cfg, clone=False):
    """A `DALLE` of config `cfg` holding `module`'s weights (the layers past
    cfg.depth left out) without a second initialisation: made on the meta
    device and handed the tensors by `load_state_dict(assign=True)`,
    `module`'s own or, with `clone`, copies that a trainer may update.
    Reversible execution keeps the parameter tree as it is."""
    from dalle_pytorch_tpu_torch.models.dalle import DALLE

    with torch.device("meta"):
        twin = DALLE(cfg)
    keep = set(twin.state_dict())
    twin.load_state_dict({k: v.clone() if clone else v for k, v in module.state_dict().items() if k in keep},
                         assign=True)
    return twin


def twin_facade(dalle, sampling, **changes):
    """The facade `dalle` over the same weights under its config with
    `changes`, with decode graphs of its own."""
    import copy
    import dataclasses

    twin = copy.copy(dalle)
    twin.cfg = dataclasses.replace(dalle.cfg, **changes)
    twin.module = twin_module(dalle.module, twin.cfg).eval().requires_grad_(False)
    twin.decode_graphs = sampling.decode_graphs(twin.module)
    return twin


@contextlib.contextmanager
def naive_twin_stream():
    """The DALL-E forward's transformer as plain autograd through the twin
    stream (`apply_transformer(rebuild=False)`), the reference `Reversible`
    is held to."""
    from dalle_pytorch_tpu_torch.models import dalle as dalle_mod
    from dalle_pytorch_tpu_torch.models import transformer as tr

    real = dalle_mod.apply_transformer
    dalle_mod.apply_transformer = functools.partial(tr.apply_transformer, rebuild=False)
    try:
        yield
    finally:
        dalle_mod.apply_transformer = real


def phase_reversible_serve(fa, sampling, dalle):
    """The flagship's weights under reversible=True serve through the engine
    on 4 lanes: three requests (one guided) under their noise admitted, 32
    polls timed with every lane decoding, then drained: each request's
    codes so far equal a batch-1 image loop of as many codes under its noise
    (`engine_prefix_parity`).  The twin's primed generate and its replayed
    decode against the eager one run at configs[4]'s n 512
    (`configs4_generate`).  Returns the launches."""
    from dalle_pytorch_tpu_torch.ops.sampling import gumbel_noise
    from dalle_pytorch_tpu_torch.serving.engine import EngineConfig, GenerationEngine

    rev = twin_facade(dalle, sampling, reversible=True)
    m, cfg = rev.module, rev.cfg
    check(m.transformer.cfg.execution == "reversible", f"the twin runs {m.transformer.cfg.execution}")
    conds, lanes, polls = (3.0, 1.0, 1.0), 4, 32
    texts = engine_texts(cfg, len(conds), 81)
    noise = gumbel_noise((len(conds), cfg.image_seq_len, cfg.total_tokens),
                         torch.Generator(device="cuda").manual_seed(82), device="cuda")
    engine = GenerationEngine(m, engine_cfg=EngineConfig(num_slots=lanes, block_size=ENGINE_BLOCK,
                                                         filter_thres=ENGINE_THRES, noise_override=True))
    check(engine.graph is not None, "the reversible engine captured no graph")
    admitted, step_ms, made = engine_prefix_parity(fa, sampling, engine, texts, conds, noise, polls)
    del engine
    emit("reversible_flagship_serve",
         engine=dict(lanes=lanes, requests=len(conds), cond_scale=list(conds), step_ms_replayed=step_ms,
                     polls_timed=polls, codes_compared=made, codes_equal_batch1_under_noise=True,
                     admission_launches=admitted))
    return admitted


def phase_reversible_train(fa, dalle):
    """The flagship's weights under reversible=True train, bf16 compute on
    f32 masters with Adam 3e-4 and clipping, batch 4 x 1280, each run on a
    copy of the weights and a fresh optimizer: 3 reversible steps, then 2
    remat "full" steps; the same at depth 16 (the first 16 layers), 2 steps
    each.  Per run: step_s, tokens/s, the peak (`max_memory_allocated`) and
    the activation peak (the last step's peak less the bytes allocated
    before it) and the flash launches per step, which must be the layer
    cycle's with the forward twice.  Then the stack's own activation memory
    (a bf16 gradient with respect to the transformer's input alone, weights
    frozen) at both depths; at depth 8, batch 2, `Reversible`'s gradients
    against plain autograd through the twin stream: f32 loss within 1e-5
    relative and every leaf within 1e-4 of its largest element, bf16
    gradient norm within 2e-2 relative; at depth 64 the input of layer 0 as
    the backward rebuilds it against the true one, over max |x|, f32 and
    bf16.  Returns the reversible run's launches per step."""
    import dataclasses

    from torch.func import functional_call

    from dalle_pytorch_tpu_torch.cli.train_dalle import dalle_loss_fn
    from dalle_pytorch_tpu_torch.models import dalle as dalle_mod
    from dalle_pytorch_tpu_torch.models.reversible import Reversible
    from dalle_pytorch_tpu_torch.observability import memory
    from dalle_pytorch_tpu_torch.parallel.train_step import StepSettings, make_train_step

    base = dataclasses.replace(dalle.cfg, reversible=True)
    n = base.total_seq_len
    dev = torch.device("cuda")
    rng = np.random.default_rng(8)
    text = torch.from_numpy(rng.integers(1, base.num_text_tokens, (4, base.text_seq_len))).to(dev)
    text[3, 200:] = 0  # a padded caption
    pixels = torch.from_numpy(rng.random((4, 256, 256, 3), dtype=np.float32)).to(dev)
    batch = {"text": text, "image": pixels}
    adam = functools.partial(torch.optim.Adam, lr=3e-4, betas=(0.9, 0.999), eps=1e-8)

    def config(execution, depth):
        return dataclasses.replace(base, depth=depth, execution=execution, remat_policy="full")

    def train(execution, depth, steps):
        resident = torch.cuda.memory_allocated()  # the flagship's own weights, the VAE
        model = twin_module(dalle.module, config(execution, depth), clone=True).train().requires_grad_(True)
        settings = StepSettings(compute_dtype=torch.bfloat16, clip_grad_norm=0.5)
        init_fn, step_fn = make_train_step(dalle_loss_fn(model, dalle.vae.module, torch.bfloat16), adam, settings)
        state = init_fn(dict(model.named_parameters()))
        losses, secs, before, peaks = [], [], [], []
        reset_launches(fa)
        for _ in range(steps):
            torch.cuda.synchronize()
            before.append(torch.cuda.memory_allocated())
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            losses.append(float(metrics["loss"]))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            peaks.append(torch.cuda.max_memory_allocated())
        per_step = {k: v / steps for k, v in read_launches(fa).items()}
        name = f"{execution}_depth{depth}"
        # the ledger of the run's step beside its peak (the weights, masters, moments and VAE included)
        ledger = ledger_reading(
            memory, memory.dalle_step_memory(None, state.params, state.opt_state, model.cfg, 4, settings=settings,
                                             device=dev), max(peaks) - resident, f"reversible_flagship_train {name}")
        want = launches_per_step(model, n)
        check(per_step == want, f"{name}: launches per step {per_step}, the layer cycle gives {want}")
        check(all(np.isfinite(losses)) and losses[-1] < losses[0], f"{name}: losses {losses}")
        del state, init_fn, step_fn, model
        torch.cuda.empty_cache()
        step_s = statistics.median(secs[1:])
        return name, dict(steps=steps, losses=losses, steps_s=secs, step_s=step_s, tokens_per_s=4 * n / step_s,
                          peak_memory_gib=max(peaks) / 2 ** 30, activation_peak_gib=(peaks[-1] - before[-1]) / 2 ** 30,
                          allocated_before_last_step_gib=before[-1] / 2 ** 30, launches_per_step=per_step,
                          memory=ledger)

    runs = dict(train(e, d, s) for e, d, s in (("reversible", 64, 3), ("remat", 64, 2), ("reversible", 16, 2),
                                               ("remat", 16, 2)))

    def stack_activations(execution, depth):
        model = twin_module(dalle.module, config(execution, depth)).requires_grad_(False)
        work = {k: p.to(torch.bfloat16) for k, p in model.transformer.named_parameters()}
        x = torch.randn(4, n, base.dim, generator=torch.Generator(device=dev).manual_seed(3), device=dev,
                        dtype=torch.bfloat16).requires_grad_(True)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        functional_call(model.transformer, work, (x,)).float().square().mean().backward()
        torch.cuda.synchronize()
        return (torch.cuda.max_memory_allocated() - before) / 2 ** 30

    stack = {f"{e}_depth{d}": stack_activations(e, d) for e in ("reversible", "remat") for d in (64, 16)}

    model8 = twin_module(dalle.module, config("reversible", 8))
    codes = torch.from_numpy(rng.integers(0, base.num_image_tokens, (2, base.image_seq_len))).to(dev)

    def gradient(dtype, rebuild):
        params = {k: p.detach().to(dtype).requires_grad_(True) for k, p in model8.named_parameters()}
        with contextlib.nullcontext() if rebuild else naive_twin_stream():
            loss = functional_call(model8, params, (text[:2], codes), {"return_loss": True})
        return loss.float().item(), torch.autograd.grad(loss, list(params.values()))

    versus = {}
    for dtype, name in ((torch.float32, "float32"), (torch.bfloat16, "bfloat16")):
        (loss_r, g_r), (loss_n, g_n) = gradient(dtype, True), gradient(dtype, False)
        norm_r, norm_n = (torch.linalg.vector_norm(torch.stack([g.float().norm() for g in gs])).item()
                          for gs in (g_r, g_n))
        leaf_err = max(((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30)).item()
                       for a, b in zip(g_r, g_n))
        versus[name] = dict(loss=loss_r, loss_naive=loss_n, loss_rel_err=abs(loss_r - loss_n) / abs(loss_n),
                            grad_norm=norm_r, grad_norm_naive=norm_n, grad_norm_rel_err=abs(norm_r - norm_n) / norm_n,
                            leaf_err_over_leaf_max=leaf_err)
    del model8
    f32, b16 = versus["float32"], versus["bfloat16"]
    check(f32["loss_rel_err"] <= 1e-5 and f32["leaf_err_over_leaf_max"] <= 1e-4,
          f"f32 reversible gradients against the naive twin stream: {f32}")
    check(b16["grad_norm_rel_err"] <= 2e-2, f"bf16 reversible gradient norm against the naive twin stream: {b16}")

    model64 = twin_module(dalle.module, base).requires_grad_(False)
    tokens = torch.cat([dalle_mod.embed_text_ids(model64, dalle_mod.remap_and_bos(base, text[:2])),
                        dalle_mod.embed_image_codes(model64, codes)], dim=1)[:, :n]
    rebuilt = {}
    for dtype, name in ((torch.float32, "float32"), (torch.bfloat16, "bfloat16")):
        work = {k: p.to(dtype) for k, p in model64.transformer.named_parameters()}
        x = tokens.detach().to(dtype).requires_grad_(True)
        seen = []
        Reversible.on_rebuilt = lambda a, b: seen.append((a.detach().float(), b.detach().float()))
        try:
            out = functional_call(model64.transformer, work, (x,))
            out.float().square().mean().backward()
        finally:
            Reversible.on_rebuilt = None
        x32 = x.detach().float()
        # the error is the streams' rounding at their own scale, which the
        # output's shows beside the input's
        rebuilt[name] = dict(err_over_max_x=max((s - x32).abs().max().item() for s in seen[0]) / x32.abs().max().item(),
                             max_abs_x=x32.abs().max().item(), max_abs_out=out.detach().float().abs().max().item())
    del model64, work, x, seen, out
    torch.cuda.empty_cache()

    rev, remat = runs["reversible_depth64"], runs["remat_depth64"]
    emit("reversible_flagship_train", batch=4, n=n, compute="bfloat16 on f32 masters, Adam 3e-4, clip 0.5", **runs,
         step_s_ratio_reversible_over_remat=rev["step_s"] / remat["step_s"],
         activation_peak_gib_remat_less_reversible={d: runs[f"remat_depth{d}"]["activation_peak_gib"]
                                                    - runs[f"reversible_depth{d}"]["activation_peak_gib"]
                                                    for d in (64, 16)},
         stack_activation_gib=stack, versus_naive_twin_stream_depth8_batch2=versus,
         rebuilt_input_err_over_max_x_depth64=rebuilt,
         predictions=dict(step_s="within 15 % of remat full", activation_peak="0.5-1 GiB below remat at depth 64",
                          depth="reversible within 10 % across depths 16 and 64, remat about in proportion"))
    return rev["launches_per_step"]


def phase_stable_shared(fa, port, tr, sampling):
    """The 12-layer model with `stable`, `sandwich_norm` and the shared ids
    0-3 (`STABLE_SHARED`): 3 f32 train steps (`phase_train`); a replayed
    CFG decode whose codes equal the eager loop's (`decode_graphs`, the last
    128 steps); then the train CLI with --stable_softmax --shared_attn_ids
    0,1,2,3 --shared_ff_ids 0,1,2,3 at configs[2]'s widths on the real-data
    phase's 16 PNGs (the same seed) with its VAE: 2 steps of batch 8 and
    the checkpoint, whose hparams carry the settings; and `cli.generate`
    from that checkpoint: one image, a valid PNG.  Returns the launches of
    the train steps and the CLI."""
    from dalle_pytorch_tpu_torch.cli import train_dalle
    from dalle_pytorch_tpu_torch.cli.png import read_png
    from dalle_pytorch_tpu_torch.models import vae as vae_mod

    launches = phase_train(fa, port, "stable_shared_train", STABLE_SHARED, [Run(None, torch.float32, 3, False)])
    dalle = port.DALLE(vae=port.DiscreteVAE(seed=0, **FULL_VAE), seed=1, **STABLE_SHARED)
    layers = dalle.module.transformer.layers
    check(len({id(layer.attn) for layer in layers}) == 4 and layers[0].attn is layers[4].attn,
          "the stable_shared model does not share its attention by id")
    text = torch.randint(1, dalle.cfg.num_text_tokens, (2, dalle.cfg.text_seq_len),
                         generator=torch.Generator().manual_seed(91)).cuda()
    graphs_row = phase_decode_graphs(fa, tr, sampling, dalle, text, "stable_shared", 3.0, prime_len=GRAPHS_PRIME_LEN)
    n_params = sum(p.numel() for p in dalle.module.parameters())
    del dalle, layers
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        write_real_data(tmp, seed=71)
        vae = vae_mod.init_discrete_vae(vae_mod.DiscreteVAEConfig(**FULL_VAE),
                                        torch.Generator(device="cuda").manual_seed(0), "cuda")
        train_dalle.write_vae_checkpoint(str(tmp / "vae.npz"), vae)
        del vae
        steps, header, cli_launches, cli_s = run_train_cli(fa, [
            "--image_text_folder", str(tmp / "pairs"), "--vae_path", str(tmp / "vae.npz"),
            "--dalle_output_file_name", str(tmp / "ss"), *STABLE_SHARED_CLI])
        config = header["config"]
        check(len(steps) == 2 and all(np.isfinite(r["loss"]) for r in steps), f"the CLI's steps: {steps}")
        ids = [0, 1, 2, 3]
        check(config["stable"] and config["shared_attn_ids"] == ids and config["shared_ff_ids"] == ids,
              f"the CLI's config {config}")
        for name in ("flash_fwd", "flash_dq", "flash_dkv"):
            check(cli_launches[name] == 12 * len(steps), f"{name}: {cli_launches[name]} launches in {len(steps)} steps")
        pngs, gen_t, gen_launches, _, gen_s = run_cli(fa, [
            "--dalle_path", str(tmp / "ss.pt"), "--text", "a red cat on the table", "--num_images", "1",
            "--batch_size", "1", "--seed", "3", "--cond_scale", "3.0", "--outputs_dir", str(tmp / "out")])
        shapes = [read_png(p).shape for p in pngs]
        check(shapes == [(256, 256, 3)], f"generate wrote {shapes}")
    emit("stable_shared", params=n_params, decode_graphs_codes_equal=graphs_row["codes_equal_under_noise"],
         decode_step_ms_replayed=graphs_row["step_ms_replayed"], decode_step_ms_eager=graphs_row["step_ms_eager"],
         cli=dict(params=header["params"], steps=len(steps), batch=8, losses=[r["loss"] for r in steps],
                  step_s=[r["step_s"] for r in steps], wall_s=cli_s, launches=cli_launches,
                  settings={k: config[k] for k in ("stable", "sandwich_norm", "shared_attn_ids", "shared_ff_ids",
                                                   "reversible", "execution")}),
         generate=dict(wall_s=gen_s, seconds=gen_t, launches=gen_launches, png_shapes=shapes))
    return {k: launches[k] + cli_launches[k] for k in COUNTERS}


def plain_flash_attention(fa):
    """`flash_attention` through its plain version, on any device."""

    def attention(q, k, v, mask=None, causal=True, scale=None, key_mask=None, **_):
        b, h, n, d = q.shape
        out, _ = fa.flash_attention_reference(*(t.reshape(b * h, n, d) for t in (q, k, v)), h, causal, scale,
                                              mask, key_mask)
        return out.reshape(b, h, n, d)

    return attention


def phase_clip_rerank(fa, port, tr, scored):
    """CLIP at its default config (dim 512, 6 + 6 layers, 8 heads x 64, text
    256, 256 px, patch 32) with the BPE vocabulary, seeded weights, scores
    the generate_cli images against the prompts they were made for (a few
    tokens of 256, the rest padding), without and with the text mask (text
    != 0): the text encoder runs flash_fwd non-causally at n 256 (with the
    mask as its key mask), the image encoder at n 64.  The scores are held against the same CLIP on the card with its
    attention through flash_attention_reference, to 1e-4 of the largest
    score's magnitude."""
    from unittest import mock

    from dalle_pytorch_tpu_torch.data import tokenizer as tokenizer_mod

    clip = port.CLIP(seed=41, num_text_tokens=49408)
    cfg = clip.cfg
    text = torch.from_numpy(tokenizer_mod.tokenizer.tokenize([t for t, _ in scored], cfg.text_seq_len,
                                                         truncate_text=True)).cuda()
    images = torch.from_numpy(np.stack([px for _, px in scored])).cuda().float() / 255
    mask = text != 0
    depth = cfg.text_enc_depth + cfg.visual_enc_depth
    runs, total = [], dict.fromkeys(COUNTERS, 0)
    for text_mask in (None, mask):
        reset_launches(fa)
        t0 = time.perf_counter()
        scores = clip(text, images, text_mask=text_mask)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = read_launches(fa)
        check(launches["flash_fwd"] == depth and launches["flash_fwd_compact"] == 0,
              f"CLIP scoring launched {launches}; its {depth} layers each launch flash_fwd")
        total = {k: total[k] + launches[k] for k in COUNTERS}
        with mock.patch.object(tr, "flash_attention", plain_flash_attention(fa)):
            plain = clip(text, images, text_mask=text_mask)
            plain_ms = time_ms(lambda: clip(text, images, text_mask=text_mask), 5)
        check(fa.flash_fwd.launches == launches["flash_fwd"], "the plain path launched a kernel")
        rel = ((scores - plain).abs().max() / plain.abs().max()).item()
        check(bool(torch.isfinite(scores).all()) and rel <= 1e-4,
              f"CLIP scores: kernel vs plain path {rel} of the largest score")
        runs.append(dict(masked=text_mask is not None, scores=scores.tolist(), plain_scores=plain.tolist(),
                         rel_err=rel, tolerance=1e-4, first_call_s=first_s,
                         score_ms=time_ms(lambda: clip(text, images, text_mask=text_mask), 10),
                         plain_attention_score_ms=plain_ms, launches=launches))
    emit("clip_rerank", params=sum(p.numel() for p in clip.module.parameters()), batch=len(scored),
         text_seq_len=cfg.text_seq_len, num_patches=cfg.num_patches, heads=cfg.text_heads,
         pad_fraction=1 - mask.float().mean().item(), runs=runs,
         ranking=[sorted(range(len(r["scores"])), key=lambda i: -r["scores"][i]) for r in runs])
    return total


CONFIGS4_PROMPTS = ("a red apple on a wooden table", "an astronaut riding a horse")
# the `--engine` run's images held to batch 1: each prompt's, in lanes of their own
CONFIGS4_BATCH1 = (0, 3)
CONFIGS4_PRIME = 224  # the replayed-against-eager check: the last 32 of 256 codes
# the primed call's codes: prefill n 449, where axial_row's last row tile
# sees no key of the tile before it, so its layers compact and run the VFA
# pair (at the default fraction, 112 codes and n 369, no tile dies)
CONFIGS4_PRIMED = 192


def phase_configs4_generate(fa, tr, port, weights, checkpoint, sampling):
    """BASELINE.json configs[4] served end to end: the flagship's widths
    under reversible execution on the taming VQGAN-16k (its published
    geometry, decoder attention included; seeded weights), seq 512, 26,640
    logits a position, and CLIP reranking.  (1) In memory: one
    `generate_images` of two prompts (one padded) with CFG 3.0, primed from
    an image (192 codes, prefill n 449: axial_row's layers compact and run
    the VFA pair), reranked by CLIP at its default config (the
    `clip_rerank` phase's): the launches are the layer cycle's plus CLIP's
    12 layers.  (2) The
    replayed decode loop against the eager one under one noise over the
    last 32 codes (`decode_graphs`), the step's ms at n 512.  (3) The
    model written as a v3 checkpoint with `vae_class_name` VQGanVAE, then
    `cli.generate --engine` on it, two prompts x 2 images with CFG 3.0 (one
    load of the 5.5 GB file): every admission's prefill launches the layer
    cycle, every PNG is 256 x 256 x 3, and the first and the last image
    (the two prompts, each in its own lane) equal the batch-1
    `generate_images` image under its seed (image j of the run is seeded
    with j).  Returns the launches of (1) and (3)."""
    from dalle_pytorch_tpu_torch.cli.png import read_png
    from dalle_pytorch_tpu_torch.data import tokenizer as tokenizer_mod
    from dalle_pytorch_tpu_torch.models import vae_registry
    from dalle_pytorch_tpu_torch.models.vqgan import VQGANConfig

    t0 = time.perf_counter()
    vae = port.VQGanVAE(cfg=VQGANConfig(**VQGAN16K), seed=0, decoder_attn=True)
    dalle = port.DALLE(vae=vae, seed=1, **CONFIGS4)
    clip = port.CLIP(seed=41, num_text_tokens=49408)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg = dalle.cfg
    check((cfg.total_seq_len, cfg.image_fmap_size, cfg.total_tokens, cfg.resolved_execution)
          == (512, 16, 10000 + 256 + 16384, "reversible"), f"configs[4]'s config {cfg}")
    n_params = sum(p.numel() for p in dalle.module.parameters())
    vae_params = sum(p.numel() for p in vae.module.parameters())
    text = torch.randint(1, cfg.num_text_tokens, (2, cfg.text_seq_len),
                         generator=torch.Generator().manual_seed(52)).cuda()
    text[1, 180:] = 0  # a padded prompt
    pixels = torch.rand(2, 256, 256, 3, generator=torch.Generator().manual_seed(53)).cuda()
    prime_len = CONFIGS4_PRIMED
    want, _ = forward_launches(dalle.module, cfg.text_seq_len + 1 + prime_len)
    clip_layers = clip.cfg.text_enc_depth + clip.cfg.visual_enc_depth
    want = {k: v + (clip_layers if k == "flash_fwd" else 0) for k, v in want.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timings = {}
    reset_launches(fa)
    t0 = time.perf_counter()
    images, scores = dalle.generate_images(text, 3, cond_scale=3.0, img=pixels, num_init_img_tokens=prime_len,
                                           timings=timings, clip=clip)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    primed = read_launches(fa)
    check(primed == want, f"the primed CFG call launched {primed}; the layer cycle and CLIP give {want}")
    check(primed["flash_max_compact"] > 0, f"the primed prefill at n {cfg.text_seq_len + 1 + prime_len} ran no "
          f"VFA pair: {primed}")
    shown = vae_registry.to_display(vae.cfg, images)
    check(tuple(images.shape) == (2, 256, 256, 3) and bool(torch.isfinite(images).all())
          and bool(torch.isfinite(scores).all()), f"images {tuple(images.shape)}, scores {scores.tolist()}")
    primed_run = dict(cond_scale=3.0, prime_len=prime_len, prefill_len=cfg.text_seq_len + 1 + prime_len,
                      capture_s=timings["capture_s"], prefill_s=timings["prefill_s"], decode_s=timings["decode_s"],
                      vae_s=timings["vae_s"], clip_s=timings["clip_s"], total_s=total_s, images_per_s=2 / total_s,
                      clip_scores=scores.tolist(), ranking=sorted(range(2), key=lambda i: -scores[i].item()),
                      pixel_range=[shown.min().item(), shown.max().item()], launches=primed,
                      peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    graphs_row = phase_decode_graphs(fa, tr, sampling, dalle, text, "configs4", 3.0, prime_len=CONFIGS4_PRIME)

    tok = tokenizer_mod.tokenizer
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        save_dalle_checkpoint(checkpoint, weights, tmp / "configs4.pt", dalle, vae)
        write_s = time.perf_counter() - t0
        per_prompt = forward_launches(dalle.module, cfg.text_seq_len + 1)[0]
        paths, cli_t, cli_launches, printed, cli_wall = run_cli(fa, [
            "--dalle_path", str(tmp / "configs4.pt"), "--text", "|".join(CONFIGS4_PROMPTS), "--num_images", "2",
            "--batch_size", "2", "--cond_scale", "3.0", "--seed", "0", "--engine", "--engine_slots", "4",
            "--outputs_dir", str(tmp / "out")])
        check(cli_launches == {k: 4 * v for k, v in per_prompt.items()},
              f"the CLI's four admissions launched {cli_launches}; one prefill gives {per_prompt}")
        pngs = [read_png(p) for p in paths]
        check(len(pngs) == 4 and all(px.shape == (256, 256, 3) and px.dtype == np.uint8 for px in pngs),
              f"the CLI wrote {paths}")
    for j in CONFIGS4_BATCH1:
        ids = torch.from_numpy(tok.tokenize(CONFIGS4_PROMPTS[j // 2], cfg.text_seq_len, truncate_text=True)).cuda()
        batch1 = sampling.generate_images(dalle.module, vae.module, ids, torch.Generator(device="cuda").manual_seed(j),
                                          filter_thres=0.9, cond_scale=3.0)
        want_png = (np.clip(vae_registry.to_display(vae.cfg, batch1).cpu().numpy()[0], 0, 1) * 255).astype(np.uint8)
        check(np.array_equal(pngs[j], want_png), f"generate --engine's image {j} differs from the batch-1 "
              f"generate_images image under its seed ({int((pngs[j] != want_png).sum())} values differ)")
    images_n = len(paths)
    emit("configs4_generate", params=n_params, vae_params=vae_params, vqgan=VQGAN16K, decoder_attn=True,
         seq_len=cfg.total_seq_len, vocab=cfg.total_tokens, depth=cfg.depth, execution="reversible",
         init_s=init_s, primed_with_clip=primed_run,
         decode_step_ms=dict(replayed=graphs_row["step_ms_replayed"], eager=graphs_row["step_ms_eager"]),
         replayed_codes_equal_eager=graphs_row["codes_equal_under_noise"], checkpoint_write_s=write_s,
         cli_engine=dict(prompts=list(CONFIGS4_PROMPTS), pngs=images_n, wall_s=cli_wall,
                         images_per_s=images_n / cli_wall, seconds=cli_t,
                         seconds_per_image={k: v / images_n for k, v in cli_t.items()},
                         launches_per_admission=per_prompt, launches=cli_launches, png_equal_batch1=list(CONFIGS4_BATCH1)))
    del dalle, vae, clip, batch1
    torch.cuda.empty_cache()
    return {k: primed[k] + cli_launches[k] for k in COUNTERS}


def phase_vae_families_parity(port, weights):
    """The two pretrained families at their published geometries, seeded,
    on the card against the same weights on the CPU: the VQGAN-16k (decoder
    attention included) and OpenAI's dVAE encode two 256 x 256 images
    (indices equal at >= 0.99 of the positions; the CPU's margin between
    the best and the second-best code at the positions that differ) and
    decode two code maps (pixels within 1e-4); then the card's encode and
    decode times at batch 2 and 8."""
    from dalle_pytorch_tpu_torch.models import openai_vae, vae_registry
    from dalle_pytorch_tpu_torch.models.vqgan import VQGANConfig

    rows = {}
    g = torch.Generator().manual_seed(61)
    images = torch.rand(2, 256, 256, 3, generator=g)
    for family in ("vqgan16k", "openai"):
        if family == "vqgan16k":
            card = port.VQGanVAE(cfg=VQGANConfig(**VQGAN16K), seed=3, decoder_attn=True).module
        else:
            card = port.OpenAIDiscreteVAE(seed=4).module
        cpu = weights.load_vae(weights.vae_tree(card.state_dict(), card.cfg), card.cfg, "cpu")
        t0 = time.perf_counter()
        codes_cpu = vae_registry.get_codebook_indices(cpu, images)
        codes = vae_registry.get_codebook_indices(card, images.cuda()).cpu()
        agree = (codes == codes_cpu).float().mean().item()
        check(agree >= 0.99, f"{family}: the card's codes agree with the CPU's at {agree} of the positions")
        differ = (codes != codes_cpu).nonzero().tolist()
        if family == "vqgan16k":  # the distance gap of the codes that differ, on the CPU
            from dalle_pytorch_tpu_torch.models import vqgan

            z = vqgan.encode(cpu, 2 * images - 1).reshape(2, -1, VQGAN16K["embed_dim"])
            emb = cpu.codebook
            d = (z ** 2).sum(-1, keepdim=True) - 2 * torch.einsum("bnd,ed->bne", z, emb) + (emb ** 2).sum(-1)
        else:
            d = -openai_vae.encoder_logits(cpu, images).reshape(2, -1, openai_vae.VOCAB)
        top2 = d.topk(2, dim=-1, largest=False).values
        gap = top2[..., 1] - top2[..., 0]
        margins = [gap[b, i].item() for b, i in differ]
        seq = torch.randint(0, card.cfg.num_tokens, (2, card.cfg.image_seq_len), generator=g)
        pixels = vae_registry.decode_indices(card, seq.cuda()).cpu()
        pixels_cpu = vae_registry.decode_indices(cpu, seq)
        err = (pixels - pixels_cpu).abs().max().item()
        check(bool(torch.isfinite(pixels).all()) and err <= 1e-4, f"{family}: decoded pixels differ by {err}")
        parity_s = time.perf_counter() - t0
        times = {}
        for b in (2, 8):
            x = torch.rand(b, 256, 256, 3, device="cuda")
            s = torch.randint(0, card.cfg.num_tokens, (b, card.cfg.image_seq_len), device="cuda")
            times[f"encode_ms_batch{b}"] = time_ms(lambda: vae_registry.get_codebook_indices(card, x), 3)
            times[f"decode_ms_batch{b}"] = time_ms(lambda: vae_registry.decode_indices(card, s), 3)
        rows[family] = dict(params=sum(p.numel() for p in card.parameters()), codes=card.cfg.image_seq_len,
                            num_tokens=card.cfg.num_tokens, codes_agree=agree, codes_differ=len(differ),
                            differing_code_margins=margins, min_margin_all=gap.min().item(), pixel_max_abs_err=err,
                            tolerance=1e-4, parity_s=parity_s, **times)
        del card, cpu
        torch.cuda.empty_cache()
    emit("vae_families_parity", **rows)


TAMING16K_YAML = """model:
  base_learning_rate: 4.5e-06
  target: taming.models.vqgan.VQModel
  params:
    embed_dim: 256
    n_embed: 16384
    monitor: val/rec_loss
    ddconfig:
      double_z: false
      z_channels: 256
      resolution: 256
      in_channels: 3
      out_ch: 3
      ch: 128
      ch_mult:
      - 1
      - 1
      - 2
      - 2
      - 4
      num_res_blocks: 2
      attn_resolutions:
      - 16
      dropout: 0.0
"""


def phase_train_openai_taming(fa, port, weights, checkpoint):
    """BASELINE.json configs[2]'s 12-layer model trains from seeded PNGs
    through `cli.train_dalle` on the two pretrained families, 3 steps of
    batch 5 each: with no --vae_path, on OpenAI's dVAE from a converted
    cache the phase writes into a temporary `DALLE_PYTORCH_TPU_CACHE` (the
    fetch replaced by one that fails: no network) from the PNG folder; and
    with --taming on a taming-format `.ckpt` (a Lightning-style dict holding
    the seeded VQGAN-16k's state dict) and its yaml, from the same pairs'
    tar shard through `--wds`.  Each checkpoint names its VAE, and the
    OpenAI one serves one image through `cli.generate` (a VQGanVAE
    checkpoint is `configs4_generate`'s).  Returns the launches."""
    import os

    from dalle_pytorch_tpu_torch.cli.png import read_png
    from dalle_pytorch_tpu_torch.models import pretrained
    from dalle_pytorch_tpu_torch.models.vqgan import VQGANConfig

    def no_network(url, dst):
        raise OSError(f"no network: {url}")

    readings, total = {}, dict.fromkeys(COUNTERS, 0)
    saved_env, saved_fetch = os.environ.get("DALLE_PYTORCH_TPU_CACHE"), pretrained._urllib_fetch
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        try:
            write_real_data(tmp, seed=91)
            openai = port.OpenAIDiscreteVAE(seed=5)
            checkpoint.save_checkpoint(str(tmp / "cache" / pretrained.OPENAI_CONVERTED),
                                       {"params": weights.openai_vae_tree(openai.module.state_dict())},
                                       {"source": "openai", "class": "OpenAIDiscreteVAE"})
            vq = port.VQGanVAE(cfg=VQGANConfig(**VQGAN16K), seed=6, decoder_attn=True)
            torch.save({"state_dict": vq.module.state_dict(), "epoch": 7, "global_step": 100},
                       str(tmp / "vqgan.ckpt"))
            (tmp / "vqgan.yaml").write_text(TAMING16K_YAML)
            del openai, vq
            torch.cuda.empty_cache()
            os.environ["DALLE_PYTORCH_TPU_CACHE"] = str(tmp / "cache")
            pretrained._urllib_fetch = no_network
            common = ["--epochs", "1", *REAL_DATA_FLAGS, "--batch_size", "5"]
            runs = {"openai": ["--image_text_folder", str(tmp / "pairs")],
                    "taming": ["--image_text_folder", str(tmp / "pairs.tar"), "--wds", "--taming",
                               "--vqgan_model_path", str(tmp / "vqgan.ckpt"),
                               "--vqgan_config_path", str(tmp / "vqgan.yaml")]}
            for name, flags in runs.items():
                records, header, launches, wall_s = run_train_cli(fa, [
                    *common, *flags, "--dalle_output_file_name", str(tmp / name)])
                check(len(records) == 3 and all(np.isfinite(r["loss"]) for r in records),
                      f"{name}: the run's steps {records}")
                for kernel in ("flash_fwd", "flash_dq", "flash_dkv"):
                    check(launches[kernel] == 12 * len(records), f"{name}: {launches[kernel]} {kernel} launches in "
                          f"{len(records)} steps of 12 layers")
                with np.load(str(tmp / f"{name}.pt"), allow_pickle=False) as data:
                    meta = json.loads(bytes(data["__meta"]).decode())
                want_class = "OpenAIDiscreteVAE" if name == "openai" else "VQGanVAE"
                check(meta["vae_class_name"] == want_class, f"{name}: the checkpoint names {meta['vae_class_name']}")
                gen = {}
                if name == "openai":  # a VQGanVAE checkpoint goes through cli.generate in configs4_generate
                    paths, gen_t, gen_launches, _, gen_s = run_cli(fa, [
                        "--dalle_path", str(tmp / f"{name}.pt"), "--text", "a red cat on the table", "--num_images",
                        "1", "--batch_size", "1", "--cond_scale", "3.0", "--outputs_dir", str(tmp / f"{name}_out")])
                    check(len(paths) == 1 and read_png(paths[0]).shape == (256, 256, 3)
                          and gen_launches["flash_fwd"] == 12, f"{name}: generate wrote {paths}, launched {gen_launches}")
                    gen = dict(generate_s=gen_s, generate_seconds=gen_t, generate_launches=gen_launches)
                    launches = {k: launches[k] + gen_launches[k] for k in COUNTERS}
                steady = [r["step_s"] for r in records[1:]]
                hp = header["config"]
                readings[name] = dict(vae_class_name=want_class, data="tar shard (--wds)" if "--wds" in flags
                                      else "folder", params=header["params"],
                                      seq_len=hp["text_seq_len"] + hp["image_fmap_size"] ** 2,
                                      steps=len(records), batch=5, losses=[r["loss"] for r in records],
                                      step_s=statistics.median(steady), step_s_all=[r["step_s"] for r in records],
                                      data_s=[r["data_s"] for r in records], wall_s=wall_s, launches=launches, **gen)
                total = {k: total[k] + launches[k] for k in COUNTERS}
                for f in tmp.glob(f"{name}*.pt"):
                    f.unlink()
        finally:
            pretrained._urllib_fetch = saved_fetch
            if saved_env is None:
                os.environ.pop("DALLE_PYTORCH_TPU_CACHE", None)
            else:
                os.environ["DALLE_PYTORCH_TPU_CACHE"] = saved_env
    emit("train_openai_taming", model=dict(dim=1024, depth=12, heads=16, dim_head=64, text_seq_len=256), **readings)
    return total


def phase_legacy_formats(fa, port, weights):
    """The checkpoints of other implementations, at the 12-layer model's full
    width (seeded): a torch-reference `dalle.pt` (the reference's state
    dict names, the DiscreteVAE under `vae.*`, written by
    `tests/torch_port_refs.py`) and the JAX package's v2 format (a pickled
    treedef, read through the restricted reader under
    --allow_legacy_pickle) each generate one image through `cli.generate`:
    both PNGs equal the in-memory model's batch-1 image under the seed.
    Returns the launches."""
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_port_refs import reference_vae_state_dict, write_legacy_checkpoint, write_reference_dalle

    from dalle_pytorch_tpu_torch.cli.png import read_png
    from dalle_pytorch_tpu_torch.data import tokenizer as tokenizer_mod
    from dalle_pytorch_tpu_torch.models import sampling, vae_registry
    from dalle_pytorch_tpu_torch.version import __version__

    vae = port.DiscreteVAE(seed=0, **FULL_VAE)
    dalle = port.DALLE(vae=vae, seed=81, **FULL)
    cfg, readings, total = dalle.cfg, {}, dict.fromkeys(COUNTERS, 0)
    tree = weights.dalle_tree(dalle.module.state_dict(), cfg)
    vae_tree = weights.vae_tree(vae.module.state_dict(), vae.cfg)
    ids = torch.from_numpy(tokenizer_mod.tokenizer.tokenize("a red cat", cfg.text_seq_len, truncate_text=True))
    want = sampling.generate_images(dalle.module, vae.module, ids.cuda(), torch.Generator(device="cuda").manual_seed(4),
                                    filter_thres=0.9)
    want = (np.clip(vae_registry.to_display(vae.cfg, want).cpu().numpy()[0], 0, 1) * 255).astype(np.uint8)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        write_reference_dalle(tmp / "reference.pt", tree, cfg, "DiscreteVAE", vae.cfg.to_dict(),
                              reference_vae_state_dict(vae_tree, vae.cfg))
        ref_write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        meta = {"hparams": cfg.to_dict(), "vae_params": vae.cfg.to_dict(), "vae_class_name": "DiscreteVAE",
                "version": __version__}
        write_legacy_checkpoint(tmp / "v2.npz", {"weights": tree, "vae_weights": vae_tree}, meta, fmt=2)
        v2_write_s = time.perf_counter() - t0
        del dalle, vae, tree, vae_tree
        torch.cuda.empty_cache()
        for name, argv, write_s in (("torch_reference", [str(tmp / "reference.pt")], ref_write_s),
                                    ("v2", [str(tmp / "v2.npz"), "--allow_legacy_pickle"], v2_write_s)):
            paths, gen_t, launches, printed, wall_s = run_cli(fa, [
                "--dalle_path", *argv, "--text", "a red cat", "--num_images", "1", "--batch_size", "1", "--seed", "4",
                "--outputs_dir", str(tmp / name)])
            check(len(paths) == 1 and np.array_equal(read_png(paths[0]), want),
                  f"{name}: the PNG differs from the in-memory model's under one seed")
            check(launches["flash_fwd"] == cfg.depth, f"{name}: the prefill launched {launches}")
            readings[name] = dict(write_s=write_s, bytes=sum(f.stat().st_size for f in tmp.glob(
                "reference.pt" if name == "torch_reference" else "v2.npz")), wall_s=wall_s, seconds=gen_t,
                png_equal_in_memory=True, launches=launches)
            total = {k: total[k] + launches[k] for k in COUNTERS}
    emit("legacy_formats", model=dict(dim=1024, depth=12, heads=16, dim_head=64), **readings)
    return total


# distributed training (the sharded step over torch.distributed): the
# flagship's widths, its attention cycle with VFA and its tied embeddings,
# with depth cut to 4; two ranks share the one card over gloo
DIST_MODEL = dict(FLAGSHIP, depth=4, num_image_tokens=FULL_VAE["num_tokens"], image_fmap_size=32)
# name -> (mesh axes, ZeRO stage, the model's mesh knobs): sp2 shards the
# sequence through ring attention, pp2 pipelines the layers in 2
# micro-batches, pp2_v2 interleaves 2 chunks a stage
DIST_MESHES = {"dp2": ({"dp": 2}, 0, {}), "fsdp2_zero1": ({"fsdp": 2}, 1, {}), "fsdp2_zero3": ({"fsdp": 2}, 3, {}),
               "tp2": ({"tp": 2}, 0, {}),
               "sp2": ({"sp": 2}, 0, {"seq_shard_axis": "sp", "attn_kernel": "ring"}),
               "pp2": ({"pp": 2}, 0, {"pipeline_axis": "pp", "pp_num_micro": 2}),
               "pp2_v2": ({"pp": 2}, 0, {"pipeline_axis": "pp", "pp_num_micro": 2, "pp_interleave": 2})}
# the collectives each mesh's step calls (`parallel/sharding.MeshPlan`,
# `parallel/tensor_parallel.py`); gloo's support of each on CUDA tensors is
# probed first.  The sp and pp hops go through `parallel/p2p.exchange`,
# which under gloo moves CUDA tensors through host buffers (its route is
# chosen by the backend's name: gloo's own send of a CUDA tensor aborts)
DIST_OPS = {"dp2": ("all_reduce",), "fsdp2_zero1": ("all_reduce", "all_gather_into_tensor"),
            "fsdp2_zero3": ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor"),
            "tp2": ("all_reduce", "all_reduce_max"), "sp2": ("all_reduce",), "pp2": ("all_reduce",),
            "pp2_v2": ("all_reduce",)}
DIST_STEPS, DIST_BATCH, DIST_SEED = 2, 2, 81


def dist_steps(fa, mesh, zero_stage, knobs=None):
    """DIST_STEPS Adam steps of the DIST_MODEL DALL-E (seeded weights and
    batches, f32; `knobs` the model's mesh knobs) on `mesh` (None: the
    one-process step), with every launch counter and the point-to-point
    counters set to 0 just before them; (losses, grad norms, step seconds,
    launches, resident parameter and moment bytes, the bytes allocated
    before the steps and the most the process's allocator held during them,
    the hops and bytes `parallel/p2p.exchange` sent and its route).  The
    one-process run also gives what the predictions read: each layer's
    flash launches in a forward and a backward pass at n 1280
    (`forward_launches`), and each pipeline stage's parameter bytes (its
    layers, by the JAX chunk map, and every leaf outside the stack) beside
    the JAX package's fold of pp into the data slot (`registry.shard_fraction`
    over the JAX paths)."""
    from torch.func import functional_call

    from dalle_pytorch_tpu_torch.models.dalle import DALLEConfig, init_dalle
    from dalle_pytorch_tpu_torch.optim.grouped import Adam
    from dalle_pytorch_tpu_torch.parallel import p2p, pipeline, registry
    from dalle_pytorch_tpu_torch.parallel.train_step import StepSettings, make_train_step
    from dalle_pytorch_tpu_torch.weights import dalle_param_paths

    cfg = DALLEConfig(**DIST_MODEL, **(knobs or {}))
    model = init_dalle(cfg, torch.Generator(device="cuda").manual_seed(DIST_SEED), "cuda")
    model.train().requires_grad_(True)
    extra = {}
    if mesh is None:
        n = cfg.total_seq_len
        extra["per_layer"] = [forward_launches(model, n, [i]) for i in range(cfg.depth)]
        inside = {id(p) for layer in model.transformer.layers for p in layer.parameters()}
        outside = sum(p.numel() for p in model.parameters() if id(p) not in inside)
        extra["stage_param_bytes"] = {str(v): [4 * (outside + sum(
            p.numel() for a, b in pipeline.stage_chunks(cfg.depth, 2, st, v) for i in range(a, b)
            for p in model.transformer.layers[i].parameters())) for st in range(2)] for v in (1, 2)}
        paths = dalle_param_paths(cfg)
        jax_tree = {paths[k].path: torch.empty(paths[k].shape, device="meta") for k, _ in model.named_parameters()}
        extra["jax_pp2_param_fraction"] = registry.default_registry().shard_fraction(jax_tree, {"pp": 2}, 0)

    def loss_fn(params, batch, generator):
        return functional_call(model, params, (batch["text"], batch["codes"]), {"return_loss": True})

    init_fn, step_fn = make_train_step(loss_fn, Adam(1e-4), StepSettings(zero_stage=zero_stage), mesh=mesh,
                                       paths=None if mesh is None else dalle_param_paths(cfg), module=model)
    state = init_fn(dict(model.named_parameters()))
    g = torch.Generator(device="cuda").manual_seed(DIST_SEED + 1)
    batches = [{"text": torch.randint(0, cfg.num_text_tokens, (DIST_BATCH, cfg.text_seq_len), generator=g,
                                      device="cuda"),
                "codes": torch.randint(0, cfg.num_image_tokens, (DIST_BATCH, cfg.image_seq_len), generator=g,
                                       device="cuda")} for _ in range(DIST_STEPS)]
    losses, norms, seconds = [], [], []
    if mesh is not None:
        batches = [step_fn.local_batch(batch) for batch in batches]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start_bytes = torch.cuda.memory_allocated()
    reset_launches(fa)
    p2p.exchange.calls = p2p.exchange.bytes = 0
    for batch in batches:
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    launches = read_launches(fa)
    resident = (step_fn.resident_bytes(state) if mesh is not None else
                {"params": sum(p.numel() * p.element_size() for p in state.params.values()),
                 "moments": sum(v.numel() * v.element_size() for grp in state.opt_state.groups
                                for v in grp.stats.values())})
    return dict(losses=losses, grad_norms=norms, step_s=seconds, launches=launches, resident_bytes=resident,
                start_bytes=start_bytes, peak_bytes=torch.cuda.max_memory_allocated(), p2p_calls=p2p.exchange.calls,
                p2p_bytes=p2p.exchange.bytes,
                p2p_route=p2p.route(torch.device("cuda")) if p2p.exchange.calls else None,
                **extra)


def probe_gloo_cuda(rank: int) -> dict:
    """{collective: None, or the error gloo raised} for each collective of
    DIST_OPS on CUDA tensors, through the helpers the step calls.  gloo's
    own send and receive are not probed: on a CUDA tensor its send writes
    from the device pointer and aborts the process (writev: Bad address,
    on an H100 with torch 2.11), so `parallel/p2p.exchange` sends host
    buffers under gloo."""
    import torch.distributed as dist

    from dalle_pytorch_tpu_torch.parallel import tensor_parallel as tpar

    x = torch.full((4,), float(rank + 1), device="cuda")
    calls = {
        "all_reduce": lambda: dist.all_reduce(x.clone()),
        "all_reduce_max": lambda: dist.all_reduce(x.clone(), op=dist.ReduceOp.MAX),
        "all_gather_into_tensor": lambda: tpar.all_gather_into(torch.empty(8, device="cuda"), x, None),
        "reduce_scatter_tensor": lambda: tpar.reduce_scatter_into(torch.empty(2, device="cuda"), x, None),
    }
    out = {}
    for name, call in calls.items():
        try:
            call()
            torch.cuda.synchronize()
            out[name] = None
        except (RuntimeError, ValueError, NotImplementedError) as e:
            out[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"
    return out


def dist_parity_rank(rank: int, world: int, rendezvous: str, out_dir: str) -> None:
    """One rank of `dist_parity`: the card's first device, a gloo process
    group, every mesh of DIST_MESHES whose collectives gloo runs on CUDA
    tensors; its readings to `out_dir/rank<r>.json`."""
    import datetime

    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from dalle_pytorch_tpu_torch.kernels import flash_attention as fa
    from dalle_pytorch_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    torch.cuda.set_device(0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        probe = probe_gloo_cuda(rank)
        out = {"probe": probe, "backend": dist.get_backend()}
        for name, (axes, stage, knobs) in DIST_MESHES.items():
            refused = {op: probe[op] for op in DIST_OPS[name] if probe[op] is not None}
            if refused:
                out[name] = {"refused_by_gloo_on_cuda": refused}
                continue
            # the mesh names the gloo groups; the tensors lie on the card
            out[name] = dist_steps(fa, make_mesh(MeshConfig(**axes), "cpu"), stage, knobs)
            torch.cuda.empty_cache()
        Path(out_dir, f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def dist_predictions(one) -> dict:
    """What each new mesh's ranks should read, from the one-process run and
    the schedules, written down before the ranks' readings are looked at:
    each rank's flash launches (sp: none, as in the JAX package; a pp stage:
    each of its layers' forward kernels 2·M times a step, the forward ticks
    and the boundary recompute, and its backward kernels M times), each pp
    rank's resident parameter bytes (its layers and the leaves outside the
    stack; Adam's moments twice that), and the bytes `p2p.exchange` sends
    (pp: the ledger's `pipeline_comm_bytes`; sp: the ledger's
    `ring_comm_bytes` in every layer, plus the token shift's halo, a (batch,
    fmap, dim) f32 block sent for each branch forward and backward)."""
    from dalle_pytorch_tpu_torch.parallel import pipeline
    from dalle_pytorch_tpu_torch.parallel.ring import ring_comm_bytes

    depth, n, m = DIST_MODEL["depth"], DIST_MODEL["text_seq_len"] + DIST_MODEL["image_fmap_size"] ** 2, 2
    pred = {"sp2": {"launches": [dict.fromkeys(COUNTERS, 0)] * 2,
                    "p2p_bytes": DIST_STEPS * depth * int(
                        ring_comm_bytes(DIST_BATCH, DIST_MODEL["heads"], n // 2, DIST_MODEL["dim_head"], 2)
                        + 4 * DIST_BATCH * DIST_MODEL["image_fmap_size"] * DIST_MODEL["dim"] * 4)}}
    for name, v in (("pp2", 1), ("pp2_v2", 2)):
        launches = []
        for stage in range(2):
            got = dict.fromkeys(COUNTERS, 0)
            for a, b in pipeline.stage_chunks(depth, 2, stage, v):
                for i in range(a, b):
                    fwd, bwd = one["per_layer"][i]
                    for k in COUNTERS:
                        got[k] += DIST_STEPS * (2 * m * fwd[k] + m * bwd[k])
            launches.append(got)
        params = one["stage_param_bytes"][str(v)]
        pred[name] = {"launches": launches, "params": params, "moments": [2 * b for b in params],
                      "param_ratio": [b / one["resident_bytes"]["params"] for b in params],
                      "p2p_bytes": DIST_STEPS * int(pipeline.pipeline_comm_bytes(
                          DIST_BATCH, n, DIST_MODEL["dim"], 2, num_micro=m, interleave=v))}
    return pred


def phase_dist_parity(fa):
    """The sharded train step (`parallel/train_step.py` on a mesh), two
    ranks on the one card over gloo with CUDA tensors (NCCL puts one rank on
    a card): dp2, fsdp2 at ZeRO-1 and ZeRO-3, tp2, sp2 (ring attention), pp2
    (M 2) and pp2_v2 (M 2, interleave 2), DIST_STEPS steps each, against
    the one-process card step on the same global batches: loss and gradient
    norm within 1e-4 relative; each rank's flash launches as in the
    one-process step (dp, fsdp, tp) or as predicted (`dist_predictions`: sp
    none, a pp stage its layers'); under ZeRO-3 each rank's resident
    parameter and moment bytes at most 0.55 of dp2's and the most its
    allocator held during the steps at most 0.8 of dp2's (ZeRO-3 gathers
    one layer's parameters at a time); each pp rank's resident bytes the
    predicted ones, below the one-process step's; each sp rank's step peak
    (the most allocated during the steps less what was allocated before
    them) below the one-process step's; the point-to-point bytes the
    predicted ones.  A mesh whose collective gloo refuses on CUDA tensors
    is named with the refused op and left to the CPU tests
    (`tests/test_torch_parallel_steps.py`, `test_torch_seq_parallel.py`,
    `test_torch_pipeline.py`); any other error fails the phase.  The step
    times go over gloo's host transport: not a speed."""
    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        # the ranks start while the one-process reference runs
        ctx = mp.spawn(dist_parity_rank, args=(2, str(Path(tmp) / "rendezvous"), tmp), nprocs=2, join=False)
        try:
            one = dist_steps(fa, None, 0)
            torch.cuda.empty_cache()
            pred = dist_predictions(one)
        finally:
            while not ctx.join():
                pass
        ranks = [json.loads(Path(tmp, f"rank{r}.json").read_text()) for r in range(2)]
    spawn_s = time.perf_counter() - t0
    meshes, refused = {}, {}
    for name in DIST_MESHES:
        if "refused_by_gloo_on_cuda" in ranks[0][name]:
            refused[name] = ranks[0][name]["refused_by_gloo_on_cuda"]
            print(f"dist_parity: gloo refuses {sorted(refused[name])} on CUDA tensors: {name}'s two-rank parity "
                  "rests on the CPU tests", flush=True)
            continue
        rel = max(max(abs(a - b) / abs(b) for a, b in zip(r[name][key], one[key]))
                  for r in ranks for key in ("losses", "grad_norms"))
        check(rel <= 1e-4, f"dist_parity {name}: loss or grad norm {rel} relative from the one-process step")
        for r, reading in enumerate(ranks):
            want = pred[name]["launches"][r] if name in pred else one["launches"]
            check(reading[name]["launches"] == want and (name == "sp2" or sum(want.values()) > 0),
                  f"dist_parity {name}: rank {r} launched {reading[name]['launches']}, predicted {want}")
            if name in pred:
                check(reading[name]["p2p_bytes"] == pred[name]["p2p_bytes"],
                      f"dist_parity {name}: rank {r} sent {reading[name]['p2p_bytes']} bytes point to point, "
                      f"predicted {pred[name]['p2p_bytes']}")
        meshes[name] = dict(max_rel_diff=rel, losses=ranks[0][name]["losses"], grad_norms=ranks[0][name]["grad_norms"],
                            step_s_gloo_host_transport=[r[name]["step_s"] for r in ranks],
                            launches_by_rank=[r[name]["launches"] for r in ranks],
                            resident_bytes_by_rank=[r[name]["resident_bytes"] for r in ranks],
                            start_bytes_by_rank=[r[name]["start_bytes"] for r in ranks],
                            peak_bytes_by_rank=[r[name]["peak_bytes"] for r in ranks],
                            p2p_calls_by_rank=[r[name]["p2p_calls"] for r in ranks],
                            p2p_bytes_by_rank=[r[name]["p2p_bytes"] for r in ranks],
                            p2p_route=ranks[0][name]["p2p_route"])
        if name in pred:
            print(f"dist_parity {name}: point-to-point route {ranks[0][name]['p2p_route']}, "
                  f"{ranks[0][name]['p2p_calls']} hops, {ranks[0][name]['p2p_bytes']} bytes a rank", flush=True)
    if "fsdp2_zero3" in meshes and "dp2" in meshes:
        for r in range(2):
            z3, dp = (sum(meshes[m]["resident_bytes_by_rank"][r].values()) for m in ("fsdp2_zero3", "dp2"))
            check(z3 <= 0.55 * dp, f"dist_parity: rank {r} holds {z3} bytes under ZeRO-3 against dp2's {dp}")
            z3, dp = (meshes[m]["peak_bytes_by_rank"][r] for m in ("fsdp2_zero3", "dp2"))
            check(z3 <= 0.8 * dp, f"dist_parity: rank {r}'s step peak {z3} bytes under ZeRO-3 against dp2's {dp}")
    for name in ("pp2", "pp2_v2"):
        for r, got in enumerate(meshes.get(name, {}).get("resident_bytes_by_rank", [])):
            want = {"params": pred[name]["params"][r], "moments": pred[name]["moments"][r]}
            check(got == want and got["params"] < one["resident_bytes"]["params"],
                  f"dist_parity {name}: rank {r} holds {got}, predicted {want} (one process "
                  f"{one['resident_bytes']})")
    if "sp2" in meshes:
        own = one["peak_bytes"] - one["start_bytes"]
        for r in range(2):
            peak = meshes["sp2"]["peak_bytes_by_rank"][r] - meshes["sp2"]["start_bytes_by_rank"][r]
            check(peak < own, f"dist_parity sp2: rank {r}'s step peak {peak} bytes against the one-process {own}")
    check(len(meshes) + len(refused) == len(DIST_MESHES) and meshes, f"dist_parity ran {sorted(meshes)}")
    one = {k: v for k, v in one.items() if k != "per_layer"}
    emit("dist_parity", model={k: v for k, v in DIST_MODEL.items() if k != "attn_types"},
         attn_types=list(DIST_MODEL["attn_types"]), cut="depth 64 -> 4", batch=DIST_BATCH, steps=DIST_STEPS,
         tolerance=1e-4, backend=ranks[0]["backend"], gloo_cuda_probe=ranks[0]["probe"], one_process=one,
         predicted=pred, meshes=meshes, refused=refused, spawn_s=spawn_s,
         note="step_s over gloo's host transport on one card: not a speed")
    return {name: m["launches_by_rank"] for name, m in meshes.items()}


DIST_CLI_FLAGS = ("--dim", "1152", "--depth", "4", "--heads", "8", "--dim_head", "128", "--num_text_tokens", "10000",
                  "--text_seq_len", "256", "--attn_types", "full,axial_row,axial_col,conv_like",
                  "--share_input_output_emb", "--rotary_emb", "--shift_tokens", "--truncate_captions",
                  "--batch_size", "4", "--epochs", "1", "--save_every_n_steps", "2", "--lr_decay",
                  "--num_workers", "4")


def phase_dist_train_cli(fa, checkpoint):
    """`python -m torch.distributed.run --standalone --nproc_per_node 1 -m
    dalle_pytorch_tpu_torch.cli.train_dalle --distributed_backend torch
    --zero_stage 3` over NCCL on `train_real_data`'s data (its PNGs and
    VAE, written again from its seed) at the flagship's widths (depth 4):
    its losses equal the one-process CLI's on the same seed to 1e-4
    relative, its checkpoint carries the run's `topology`, and the
    one-process CLI resumed from its step file gives its last step's loss
    within 1e-6 and ends in the same global_step and reduce-on-plateau
    state (the resume check of the real-data CLI path).
    The in-process runs take a fresh process's precision settings (cuDNN's
    TF32 on, which this script turns off), as the torchrun process has
    them: the VAE's codes then agree."""
    from dalle_pytorch_tpu_torch.cli import train_dalle
    from dalle_pytorch_tpu_torch.models import vae as vae_mod

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        write_real_data(tmp, seed=71)
        vae = vae_mod.init_discrete_vae(vae_mod.DiscreteVAEConfig(**FULL_VAE),
                                        torch.Generator(device="cuda").manual_seed(0), "cuda")
        train_dalle.write_vae_checkpoint(str(tmp / "vae.npz"), vae)
        del vae
        flags = ["--image_text_folder", str(tmp / "pairs"), "--vae_path", str(tmp / "vae.npz"), *DIST_CLI_FLAGS]
        # the torchrun process starts while the one-process run trains beside it (its start dominates)
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1", "-m",
             "dalle_pytorch_tpu_torch.cli.train_dalle", "--distributed_backend", "torch", "--zero_stage", "3",
             *flags, "--dalle_output_file_name", str(tmp / "dist")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT)
        torch.backends.cudnn.allow_tf32 = True  # a fresh process's default
        try:
            one, _, one_launches, one_s = run_train_cli(fa, [*flags, "--dalle_output_file_name", str(tmp / "one")])
            stdout, stderr = proc.communicate(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        dist_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        check(proc.returncode == 0, f"torchrun train_dalle exited {proc.returncode}:\n{stderr[-4000:]}")
        lines = [json.loads(x) for x in stdout.splitlines() if x.startswith("{")]
        header = next(x for x in lines if "config" in x)
        dist = [x for x in lines if "loss" in x]
        check(header["distributed"] == {"backend": "nccl", "world_size": 1} and header["device"] == "cuda:0",
              f"the torchrun run's backend and device: {header.get('distributed')}, {header['device']}")
        check(len(dist) == len(one) == 4, f"steps: torchrun {len(dist)}, one process {len(one)}")
        rel = max(abs(a["loss"] - b["loss"]) / abs(b["loss"]) for a, b in zip(dist, one))
        check(rel <= 1e-4, f"the torchrun losses differ from the one-process CLI's by {rel} relative")
        _, meta = checkpoint.load_checkpoint(str(tmp / "dist.pt"))
        check(meta.get("topology", {}).get("mesh") == {"dp": 1, "fsdp": 1, "tp": 1, "sp": 1, "pp": 1}
              and meta["topology"]["device_count"] == 1, f"the checkpoint's topology: {meta.get('topology')}")
        rest, _, rest_launches, rest_s = run_train_cli(fa, [*flags, "--resume", str(tmp / "dist_step2.npz"),
                                                            "--dalle_output_file_name", str(tmp / "rest")])
        torch.backends.cudnn.allow_tf32 = False
        check([r["step"] for r in rest] == [4], f"the resumed run took steps {[r['step'] for r in rest]}")
        rest_rel = abs(rest[0]["loss"] - dist[-1]["loss"]) / abs(dist[-1]["loss"])
        check(rest_rel <= 1e-6, f"the resumed step's loss is {rest_rel} relative from the torchrun run's")
        ends = [plateau_and_step(tmp / f"{name}.pt") for name in ("dist", "rest")]
        # the counts and the scale exactly; the averaged losses as the losses
        check(all(ends[0][k] == ends[1][k] for k in ("global_step", "scale", "plateau_count", "cooldown_count",
                                                     "count"))
              and all(abs(ends[0][k] - ends[1][k]) <= 1e-6 * abs(ends[0][k]) for k in ("best_value", "avg_value")),
              f"the final checkpoints differ: {ends}")
    emit("dist_train_cli", flags=list(DIST_CLI_FLAGS), cut="depth 64 -> 4", zero_stage=3,
         distributed=header["distributed"], topology=meta["topology"], losses=[r["loss"] for r in dist],
         one_process_losses=[r["loss"] for r in one], max_rel_diff=rel, resumed_loss=rest[0]["loss"],
         resumed_rel_diff=rest_rel, final_state=ends[1], step_s=[r["step_s"] for r in dist], one_process_step_s=[r["step_s"] for r in one],
         torchrun_wall_s=dist_s, one_process_wall_s=one_s, resume_wall_s=rest_s, launches=one_launches,
         resume_launches=rest_launches)
    return one_launches


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
    from dalle_pytorch_tpu_torch.tools import loadgen

    phase_environment(build)
    compared = phase_kernel_vs_plain(fa)
    compared_bwd = phase_backward_vs_plain(fa)
    sparse = phase_sparse_kernel_vs_plain(fa, masks)
    configs4_rows = phase_configs4_kernels(fa, masks)
    paths = {}
    dalle, text, paths["generate"] = phase_slice(fa, port)
    phase_forward(fa, dalle, text)
    profile = phase_decode_profile(dalle, text, sampling, eager=False)
    rotary_graphs = phase_decode_graphs(fa, tr, sampling, dalle, text, "12-layer", 3.0, prime_len=GRAPHS_PRIME_LEN,
                                        stats=True, profile=profile)
    # the fleet's durability on the 12-layer model: journal replay (its replicas' seeded codes against
    # batch-1), the breaker and the hedge, the degrade ladder; two requests under injected noise run on
    # the learned-position 12-layer engine in train_real_data
    paths["fleet_durability"] = phase_fleet_durability(fa, sampling, dalle)
    paths["generate_spec"] = phase_generate_spec(fa, sampling, dalle)
    del dalle
    paths["quant_spec_parity"] = phase_quant_spec_parity(fa, port, sampling)
    phase_parity(fa, port, sampling)
    paths["train"] = phase_train(fa, port, "slice_train", FULL, standard_runs(6, measure=True))
    phase_train_parity(fa, port)
    paths["train_cli"] = phase_train_cli(fa, weights, checkpoint)
    phase_telemetry_cli(fa)
    paths["train_real_data"] = phase_train_real_data(fa, tr, sampling, weights,
                                                     rotary_graphs["step_ms_replayed"])
    torch.cuda.empty_cache()
    phase_vae_train_parity()
    phase_train_vae_cli(fa)
    phase_clip_train_parity(fa)
    paths["train_clip_cli"] = phase_train_clip_cli(fa)
    torch.cuda.empty_cache()
    # the pretrained VAE families and the checkpoint formats of other implementations
    phase_vae_families_parity(port, weights)
    paths["train_openai_taming"] = phase_train_openai_taming(fa, port, weights, checkpoint)
    paths["legacy_formats"] = phase_legacy_formats(fa, port, weights)
    torch.cuda.empty_cache()

    dalle, text, paths["sparse_generate"] = phase_sparse_generate(fa, tr, port)
    profile = phase_decode_profile(dalle, text, sampling, phase="sparse_decode_profile", eager=False)
    phase_decode_graphs(fa, tr, sampling, dalle, text, "pattern", 3.0, prime_len=GRAPHS_PRIME_LEN, profile=profile)
    phase_decode_graphs(fa, tr, sampling, dalle, text, "pattern", 1.0, prime_len=GRAPHS_PRIME_LEN, eager_stream=True)
    paths["sparse_engine_parity"] = phase_engine_parity(fa, sampling, dalle, "pattern", 62, noised=False)
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
    phase_remat_policies(fa, port)

    paths["generate_cli"], scored = phase_generate_cli(fa, port, weights, checkpoint, sampling)
    paths["clip_rerank"] = phase_clip_rerank(fa, port, tr, scored)
    paths["serve_cli"] = phase_serve_cli(fa, port, weights, checkpoint)
    torch.cuda.empty_cache()

    reserved = torch.cuda.memory_reserved()
    dalle, text, paths["flagship_generate"] = phase_flagship_generate(fa, tr, port)
    # no profiled window here: `engine_flagship` profiles the flagship's replayed engine step
    phase_decode_graphs(fa, tr, sampling, dalle, text, "flagship", 3.0, prime_len=FLAGSHIP_GRAPHS_PRIME_LEN)
    paths["engine_flagship"] = phase_engine_flagship(fa, sampling, dalle)
    # two replicas of the flagship behind the router, prefill handed off, one lost mid-decode
    paths["fleet_flagship"] = phase_fleet_flagship(fa, sampling, loadgen, dalle)
    # the flagship's weights under reversible execution: serving, then training
    paths["reversible_serve"] = phase_reversible_serve(fa, sampling, dalle)
    reversible_step = phase_reversible_train(fa, dalle)
    # the serving levers on the flagship: int8 weights and pool, then speculative rounds
    qmodel, paths["engine_quant_flagship"] = phase_engine_quant_flagship(fa, sampling, dalle)
    paths["engine_spec_flagship"] = phase_engine_spec_flagship(fa, sampling, dalle, qmodel)
    del qmodel
    entry_bytes = sum(e.loop.nbytes() for e in dalle.decode_graphs.entries().values())
    with_model = torch.cuda.memory_reserved()
    del dalle
    phase_graph_memory(reserved, with_model, entry_bytes)
    # BASELINE.json configs[4]: the reversible flagship on the VQGAN-16k, reranked by CLIP
    paths["configs4_generate"] = phase_configs4_generate(fa, tr, port, weights, checkpoint, sampling)
    parity = phase_parity(fa, port, sampling, "flagship_parity", SMALL_FLAGSHIP, SMALL_SPARSE_VAE, prime_len=128)
    check(min(parity[k] for k in VFA_KERNELS) > 0, f"the small flagship's primed prefill ran no VFA pair: {parity}")
    parity = phase_train_parity(fa, port, "flagship_train_parity", SMALL_FLAGSHIP, SMALL_SPARSE_VAE)
    check(min(parity[k] for k in VFA_KERNELS) > 0, f"the small flagship's train steps ran no VFA pair: {parity}")
    phase_lowp_train_parity(fa, port)
    # the port's f32-master runs (bf16 sequential; f32 under "full" remat,
    # the flagship's only full-width f32 training), then the JAX package's
    # flagship training recipe (`bench.py`: flash_qkv at batch 8, and "full"
    # at batch 4 beside it: one optimizer, two policies; `remat_policies`
    # holds flash_qkv_ff on the pattern model)
    paths["flagship_train"] = phase_train(fa, port, "flagship_train", FLAGSHIP, [
        Run(None, torch.bfloat16, 4, True, measure=True), Run("remat", torch.float32, 2, False, measure=True),
        Run("remat", torch.bfloat16, 3, True, "flash_qkv", 8, True, measure=True),
        Run("remat", torch.bfloat16, 3, False, "full", 4, True)])
    phase_numerics_smoke()
    torch.cuda.empty_cache()
    # distributed training: the sharded step's meshes on two ranks over gloo,
    # then the training CLI under torchrun over NCCL
    dist_rank_launches = phase_dist_parity(fa)
    paths["dist_train_cli"] = phase_dist_train_cli(fa, checkpoint)
    torch.cuda.empty_cache()

    # shared layers, the stable model and the sandwich norm at configs[2]'s
    # widths; every setting at once on a small model, card against CPU
    paths["stable_shared"] = phase_stable_shared(fa, port, tr, sampling)
    parity = phase_parity(fa, port, sampling, "settings_parity", SMALL_SETTINGS, SMALL_SPARSE_VAE, prime_len=128)
    check(min(parity[k] for k in VFA_KERNELS) > 0, f"the small settings model's prefill ran no VFA pair: {parity}")
    parity = phase_train_parity(fa, port, "settings_train_parity", SMALL_SETTINGS, SMALL_SPARSE_VAE)
    check(min(parity[k] for k in VFA_KERNELS) > 0, f"the small settings model's steps ran no VFA pair: {parity}")

    # each kernel at the training shape of the path it runs on; `launches`
    # is its count on this slice's main path, the flagship's training, the
    # JAX recipe's runs included (the online compacted forward, which VFA
    # replaces there: the pattern model's training)
    main_shape = next(r for r in compared if r["case"] == "train" and r["dtype"] == "float32")
    fwd_keys = ("bh", "n", "d", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "library_device_ms", "sdpa_backend", "max_abs_err", "lse_err")
    fwd_by_dtype = {dt: {case: {k: r[k] for k in fwd_keys} for case in ("train", "flagship")
                         for r in compared if r["case"] == case and r["dtype"] == dt}
                    for dt in ("float32", "bfloat16")}
    prefill = next(r for r in compared if r["case"] == "prefill" and r["dtype"] == "float32")
    bwd = next(r for r in compared_bwd if r["case"] == "train" and r["dtype"] == "float32")
    dkv_keys = ("bh", "n", "d", "dkv_ms", "dkv_device_ms", "plain_ms", "dkv_bound_ms", "dkv_bound_by",
                "library_bwd_ms", "library_bwd_device_ms", "sdpa_backend", "dk_err_over_ref_max", "dv_err_over_ref_max")
    dkv_by_dtype = {dt: {case: {k: r[k] for k in dkv_keys} for case in ("train", "flagship")
                         for r in compared_bwd if r["case"] == case and r["dtype"] == dt}
                    for dt in ("float32", "bfloat16")}
    dq_keys = ("bh", "n", "d", "dq_ms", "dq_device_ms", "plain_ms", "dq_bound_ms", "dq_bound_by",
               "library_bwd_ms", "library_bwd_device_ms", "sdpa_backend", "dq_err_over_ref_max",
               "delta_err_over_limit")
    dq_by_dtype = {dt: {case: {k: r[k] for k in dq_keys} for case in ("train", "flagship")
                        for r in compared_bwd if r["case"] == case and r["dtype"] == dt}
                   for dt in ("float32", "bfloat16")}
    shape = {k: bwd[k] for k in ("dtype", "bh", "n", "d", "causal")}
    row = next(r for r in sparse if r["pattern"] == "axial_row" and r["d"] == 64 and r["dtype"] == "float32")
    compact_by_dtype = {dt: {r["d"]: {
        "ms": r["fwd_compact_ms"], "device_ms": r["fwd_compact_device_ms"], "dense_grid_ms": r["fwd_dense_ms"],
        "dense_grid_device_ms": r["fwd_dense_device_ms"], "plain_ms": r["plain_fwd_ms"], "bound_ms": r["fwd_bound_ms"],
        "bound_by": r["fwd_bound_by"], "library_ms": r["sdpa_fwd_ms"], "library_device_ms": r["sdpa_fwd_device_ms"],
        "sdpa_backend": r["sdpa_backend"], "max_abs_err": r["max_abs_err"], "lse_err": r["lse_err"], "bh": r["bh"]}
        for r in sparse if r["pattern"] == "axial_row" and r["dtype"] == dt} for dt in ("float32", "bfloat16")}
    dq_compact_by_dtype = {dt: {r["d"]: {
        "ms": r["dq_compact_ms"], "device_ms": r["dq_compact_device_ms"], "dense_grid_ms": r["dq_dense_ms"],
        "dense_grid_device_ms": r["dq_dense_device_ms"], "plain_ms": r["plain_bwd_ms"], "bound_ms": r["dq_bound_ms"],
        "bound_by": r["dq_bound_by"], "library_ms": r["sdpa_bwd_ms"], "library_device_ms": r["sdpa_bwd_device_ms"],
        "dq_err_over_ref_max": r["dq_err_over_ref_max"], "bh": r["bh"]}
        for r in sparse if r["pattern"] == "axial_row" and r["dtype"] == dt} for dt in ("float32", "bfloat16")}
    dkv_compact_by_dtype = {dt: {r["d"]: {
        "ms": r["dkv_compact_ms"], "device_ms": r["dkv_compact_device_ms"], "dense_grid_ms": r["dkv_dense_ms"],
        "dense_grid_device_ms": r["dkv_dense_device_ms"], "plain_ms": r["plain_bwd_ms"], "bound_ms": r["dkv_bound_ms"],
        "bound_by": r["dkv_bound_by"], "library_ms": r["sdpa_bwd_ms"], "library_device_ms": r["sdpa_bwd_device_ms"],
        "dk_err_over_ref_max": r["dk_err_over_ref_max"], "dv_err_over_ref_max": r["dv_err_over_ref_max"],
        "bh": r["bh"]}
        for r in sparse if r["pattern"] == "axial_row" and r["dtype"] == dt} for dt in ("float32", "bfloat16")}
    compact_shape = {k: row[k] for k in ("pattern", "dtype", "bh", "n", "d", "live_tiles", "causal_tiles")}
    source_bwd = "dalle_pytorch_tpu_torch/kernels/csrc/flash_bwd.cu"
    source_compact = "dalle_pytorch_tpu_torch/kernels/csrc/flash_compact.cu"
    replaces = "dalle_pytorch_tpu/kernels/flash_attention.py:"

    def launched(name, path="flagship_train", also=()):
        return {"launches": paths[path][name] + sum(paths[p][name] for p in also),
                "launches_path": "+".join((path,) + also),
                "launches_by_path": {p: counts[name] for p, counts in paths.items()}}

    real = ("train_real_data", "train_clip_cli")  # the real-data and CLIP training add to rows 1-3
    # the fleet's admissions add to row 1 (at n 257 the flagship's pattern layers take the dense grid: no VFA)
    fleet = ("fleet_flagship", "fleet_durability")
    clip_bwd_keys = ("bh", "n", "d", "live_keys", "dq_ms", "dq_device_ms", "dkv_ms", "dkv_device_ms", "plain_ms",
                     "dq_bound_ms", "dq_bound_by", "dkv_bound_ms", "dkv_bound_by", "library_bwd_ms",
                     "library_bwd_device_ms", "sdpa_backend", "dq_err_over_ref_max", "dk_err_over_ref_max",
                     "dv_err_over_ref_max")
    # CLIP training's shapes (non-causal; the text under the caption key mask)
    clip_training = {case: {r["dtype"]: {k: r[k] for k in clip_bwd_keys} for r in compared_bwd if r["case"] == case}
                     for case in ("clip_text", "clip_image")}

    def worst(key, dtype):
        return max(r[key] for r in sparse if r["dtype"] == dtype)

    kernels = [{
        "name": "flash_fwd", "route": "cuda", "source": "dalle_pytorch_tpu_torch/kernels/csrc/flash_fwd.cu",
        "replaces": replaces + "126", **launched("flash_fwd", also=real + fleet),
        "masked_launches_by_path": {path: counts["flash_fwd_masked"] for path, counts in paths.items()},
        "max_abs_err": main_shape["max_abs_err"],
        "max_abs_err_all_cases": {r["dtype"]: max(x["max_abs_err"] for x in compared if x["dtype"] == r["dtype"])
                                  for r in compared},
        "ms": main_shape["ms"], "device_ms": main_shape["device_ms"], "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"], "bound_by": main_shape["bound_by"],
        "library_ms": main_shape["library_ms"], "library_device_ms": main_shape["library_device_ms"],
        "sdpa_backend": main_shape["sdpa_backend"],
        "shape": {k: main_shape[k] for k in ("dtype", "bh", "n", "d", "causal")},
        "f32_tensor_cores": fwd_by_dtype["float32"], "bf16_tensor_cores": fwd_by_dtype["bfloat16"],
        "prefill": {k: prefill[k] for k in ("bh", "n", "ms", "plain_ms", "bound_ms", "library_ms")},
        # the serving entry points' shapes: CLIP's text (non-causal,
        # key-padded) and image encoders, a --gentxt prompt's prefill
        "entry_points": {case: {r["dtype"]: {k: r[k] for k in fwd_keys + ("causal", "key_padding", "live_keys")}
                                for r in compared if r["case"] == case}
                         for case in ("clip_text", "clip_image", "text_prompt")},
        "masked": pattern_readings(sparse, "fwd_dense"),
        # BASELINE.json configs[4]'s full layers: bh 32, n 512, d 128
        "configs4": {r["dtype"]: {k: r[k] for k in fwd_keys} for r in compared if r["case"] == "configs4"},
    }, {
        "name": "flash_dq", "route": "cuda", "source": source_bwd, "replaces": replaces + "276",
        **launched("flash_dq", also=real), "max_abs_err": bwd["dq_max_abs_err"], "ms": bwd["dq_ms"],
        "plain_ms": bwd["plain_ms"], "bound_ms": bwd["dq_bound_ms"], "bound_by": bwd["dq_bound_by"],
        "library_ms": bwd["library_bwd_ms"],
        "note": "plain_ms and library_ms are whole backwards (dq, dk and dv together)", "shape": shape,
        "delta_err_over_limit_all_cases": max(r["delta_err_over_limit"] for r in compared_bwd + sparse),
        "f32_tensor_cores": dq_by_dtype["float32"], "bf16_tensor_cores": dq_by_dtype["bfloat16"],
        "clip_training": clip_training, "masked": pattern_readings(sparse, "dq_dense"),
    }, {
        "name": "flash_dkv", "route": "cuda", "source": source_bwd, "replaces": replaces + "312",
        **launched("flash_dkv", also=real), "max_abs_err": max(bwd["dk_max_abs_err"], bwd["dv_max_abs_err"]),
        "ms": bwd["dkv_ms"], "plain_ms": bwd["plain_ms"], "bound_ms": bwd["dkv_bound_ms"],
        "bound_by": bwd["dkv_bound_by"], "library_ms": bwd["library_bwd_ms"],
        "note": "plain_ms and library_ms are whole backwards (dq, dk and dv together)", "shape": shape,
        "f32_tensor_cores": dkv_by_dtype["float32"], "bf16_tensor_cores": dkv_by_dtype["bfloat16"],
        "clip_training": clip_training, "masked": pattern_readings(sparse, "dkv_dense"),
    }, {
        "name": "flash_fwd_compact", "route": "cuda", "source": source_compact, "replaces": replaces + "524",
        **launched("flash_fwd_compact", "sparse_train"), "max_abs_err": row["max_abs_err"],
        "max_abs_err_all_cases": {dt: worst("max_abs_err", dt) for dt in ("float32", "bfloat16")},
        "ms": row["fwd_compact_ms"], "device_ms": row["fwd_compact_device_ms"], "plain_ms": row["plain_fwd_ms"],
        "bound_ms": row["fwd_bound_ms"], "bound_by": row["fwd_bound_by"], "library_ms": row["sdpa_fwd_ms"],
        "library_device_ms": row["sdpa_fwd_device_ms"], "shape": compact_shape,
        "bit_equal_to_dense_all_cases": all(r["bit_equal"] for r in sparse),
        "f32_tensor_cores_axial_row": compact_by_dtype["float32"],
        "bf16_tensor_cores_axial_row": compact_by_dtype["bfloat16"],
        "by_pattern": pattern_readings(sparse, "fwd_compact"),
    }, {
        "name": "flash_dq_compact", "route": "cuda", "source": source_compact, "replaces": replaces + "723",
        **launched("flash_dq_compact"), "max_abs_err": row["dq_max_abs_err"],
        "err_over_ref_max_all_cases": {dt: worst("dq_err_over_ref_max", dt) for dt in ("float32", "bfloat16")},
        "ms": row["dq_compact_ms"], "plain_ms": row["plain_bwd_ms"], "bound_ms": row["dq_bound_ms"],
        "bound_by": row["dq_bound_by"], "library_ms": row["sdpa_bwd_ms"], "shape": compact_shape,
        "note": "plain_ms and library_ms are whole backwards (dq, dk and dv together)",
        "bit_equal_to_dense_all_cases": all(r["bit_equal"] for r in sparse),
        "f32_tensor_cores_axial_row": dq_compact_by_dtype["float32"],
        "bf16_tensor_cores_axial_row": dq_compact_by_dtype["bfloat16"],
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
        "f32_tensor_cores_axial_row": dkv_compact_by_dtype["float32"],
        "bf16_tensor_cores_axial_row": dkv_compact_by_dtype["bfloat16"],
        "by_pattern": pattern_readings(sparse, "dkv_compact"),
    }]
    vfa = next(r for r in sparse if r["pattern"] == "axial_row" and r["d"] == 128 and r["dtype"] == "float32")
    vfa_shape = {k: vfa[k] for k in ("pattern", "dtype", "bh", "n", "d", "live_tiles", "causal_tiles")}

    def worst_vfa(key, dtype):
        return max(r[key] for r in sparse if r["dtype"] == dtype and key in r)

    def vfa_by_d(kind, dtype, *extra):
        """a VFA pass's axial_row readings in one dtype by head dim (the
        tensor-core bodies), beside SDPA's whole forward with the mask"""
        pre = f"vfa_{kind}"
        return {r["d"]: {"ms": r[f"{pre}_ms"], "device_ms": r[f"{pre}_device_ms"],
                         "plain_ms": r[f"vfa_plain_{kind}_ms"], "bound_ms": r[f"{pre}_bound_ms"],
                         "bound_by": r[f"{pre}_bound_by"], "library_ms": r["sdpa_fwd_ms"],
                         "library_device_ms": r["sdpa_fwd_device_ms"], "bh": r["bh"], **{k: r[k] for k in extra}}
                for r in sparse if r["pattern"] == "axial_row" and r["dtype"] == dtype and f"{pre}_ms" in r}

    kernels += [{
        "name": "flash_max_compact", "route": "cuda", "source": source_compact, "replaces": replaces + "564",
        **launched("flash_max_compact"), "max_abs_err": vfa["vfa_gmax_max_abs_err"],
        "rel_err_all_cases": {dt: worst_vfa("vfa_gmax_rel_err", dt) for dt in ("float32", "bfloat16")},
        "ms": vfa["vfa_max_ms"], "device_ms": vfa["vfa_max_device_ms"], "plain_ms": vfa["vfa_plain_max_ms"],
        "bound_ms": vfa["vfa_max_bound_ms"], "bound_by": vfa["vfa_max_bound_by"], "library_ms": vfa["sdpa_fwd_ms"],
        "library_device_ms": vfa["sdpa_fwd_device_ms"], "shape": vfa_shape,
        "note": "library_ms is a whole forward (SDPA with the mask pattern & causal)",
        "f32_tensor_cores_axial_row": vfa_by_d("max", "float32", "vfa_gmax_rel_err"),
        "bf16_tensor_cores_axial_row": vfa_by_d("max", "bfloat16", "vfa_gmax_rel_err"),
        "by_pattern": pattern_readings(sparse, "vfa_max", 128),
    }, {
        "name": "flash_fwd_compact_vfa", "route": "cuda", "source": source_compact, "replaces": replaces + "595",
        **launched("flash_fwd_compact_vfa"), "max_abs_err": vfa["vfa_max_abs_err"],
        "max_abs_err_all_cases": {dt: worst_vfa("vfa_max_abs_err", dt) for dt in ("float32", "bfloat16")},
        "vs_online_max_abs_err_all_cases": {dt: worst_vfa("vfa_vs_online_max_abs_err", dt)
                                            for dt in ("float32", "bfloat16")},
        "ms": vfa["vfa_fwd_ms"], "device_ms": vfa["vfa_fwd_device_ms"], "plain_ms": vfa["vfa_plain_fwd_ms"],
        "bound_ms": vfa["vfa_fwd_bound_ms"], "bound_by": vfa["vfa_fwd_bound_by"], "library_ms": vfa["sdpa_fwd_ms"],
        "library_device_ms": vfa["sdpa_fwd_device_ms"], "shape": vfa_shape,
        "online_compact_ms": vfa["fwd_compact_ms"], "online_compact_device_ms": vfa["fwd_compact_device_ms"],
        **{f"{name}_tensor_cores_axial_row": vfa_by_d("fwd", dtype, "vfa_max_abs_err", "vfa_lse_err",
                                                      "vfa_vs_online_max_abs_err", "fwd_compact_device_ms")
           for name, dtype in (("f32", "float32"), ("bf16", "bfloat16"))},
        "by_pattern": pattern_readings(sparse, "vfa_fwd", 128),
    }]
    def configs4_vfa(kind):
        """a VFA pass at configs[4]'s pattern layers (n 512, fmap 16, bh 32,
        d 128) by pattern and dtype (`configs4_kernel_vs_plain`)"""
        err = "vfa_gmax_rel_err" if kind == "max" else "vfa_max_abs_err"
        return {f"{r['pattern']}_{r['dtype']}": {
            "ms": r[f"vfa_{kind}_ms"], "device_ms": r[f"vfa_{kind}_device_ms"], "plain_ms": r[f"vfa_plain_{kind}_ms"],
            "bound_ms": r[f"vfa_{kind}_bound_ms"], "bound_by": r[f"vfa_{kind}_bound_by"],
            "library_ms": r["sdpa_fwd_ms"], "live_tiles": r["live_tiles"], "causal_tiles": r["causal_tiles"],
            "grid_auto": r["grid_auto"], err: r[err]} for r in configs4_rows}

    kernels[-2]["configs4"] = configs4_vfa("max")
    kernels[-1]["configs4"] = configs4_vfa("fwd")
    for k in kernels:  # a reversible training step of the flagship (`reversible_flagship_train`)
        k["reversible_step_launches"] = reversible_step[k["name"]]
        # each rank's launches in the sharded steps of `dist_parity` (DIST_STEPS steps a mesh)
        k["dist_parity_launches_by_rank"] = {mesh: [r[k["name"]] for r in by_rank]
                                             for mesh, by_rank in dist_rank_launches.items()}
    unlaunched = [k["name"] for k in kernels if k["launches"] <= 0]
    check(not unlaunched, f"kernels never launched on their path: {unlaunched}")
    emit("profiler", gap_s=PROFILER_GAP_S, **PROFILER_LOG)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
