"""Profiling and MFU accounting (counterpart of
`dalle_pytorch_tpu/training/profiling.py`).

* analytic FLOPs of one DALL-E training step (`dalle_step_flops`), the
  attention priced at each layer's live density: element by element, or
  whole live tiles at the port's kernels' own tiles (`flash_attention.tile_shapes`:
  64 query rows; 64 keys at d <= 64, 32 at d 128), as the kernels walk them;
* the MFU of a step time against the card's peak for the compute dtype
  (`chip_peak_flops`: H100 SXM bf16 989e12, f32 as 3xTF32 494.7e12 / 3;
  None on any other device, the CPU included);
* `torch.profiler` trace capture around a block (`trace`);
* `StepTimer`, which synchronises the card at each observation and drops the
  first interval (it overlaps the first step's builds).
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, Iterator, Mapping, Optional

import numpy as np
import torch

# the card's peak rate for each compute dtype: bf16 on the tensor cores;
# f32-accurate products as 3xTF32 (three TF32 tensor-core products for one),
# a third of the 494.7 TFLOP/s TF32 rate — the figures behind the kernels'
# bounds (`chip_smoke.py`)
PEAK_FLOPS = {
    "H100 SXM": {torch.bfloat16: 989e12, torch.float32: 494.7e12 / 3},
}


def _card_key(name: str) -> Optional[str]:
    """The table's key of a card's name (`torch.cuda.get_device_name`):
    an H100 with HBM3 is the SXM part ("NVIDIA H100 80GB HBM3")."""
    if "H100" in name and ("HBM3" in name or "SXM" in name):
        return "H100 SXM"
    return None


def chip_peak_flops(dtype: torch.dtype = torch.bfloat16, device=None) -> Optional[float]:
    """The card's peak FLOP/s for `dtype` (bf16 or f32), keyed by its name;
    None on the CPU, on an unknown card or for another dtype."""
    if device is not None and torch.device(device).type != "cuda":
        return None
    if not torch.cuda.is_available():
        return None
    key = _card_key(torch.cuda.get_device_name(device))
    return PEAK_FLOPS.get(key, {}).get(dtype) if key is not None else None


_LOOKUP_TABLES = ("text_emb", "image_emb", "text_pos", "image_pos", "codebook", "visual_pos")


def matmul_param_count(params: Mapping[str, Any]) -> int:
    """Parameters that take part in matrix products, over a {name: tensor}
    map (`model.named_parameters()`): the 2-D leaves, less the embedding
    lookup tables (counting them would inflate the FLOPs and the MFU)."""
    total = 0
    for name, x in dict(params).items():
        if getattr(x, "ndim", 0) != 2 or any(t in name for t in _LOOKUP_TABLES):
            continue
        total += x.numel()
    return int(total)


def _layer_densities(cfg, density_of) -> float:
    from dalle_pytorch_tpu_torch.models.transformer import _pattern_for, _pattern_key, derive_layer_specs

    tcfg = cfg.transformer_config() if hasattr(cfg, "transformer_config") else cfg
    cache: dict = {}
    dens = []
    for spec in derive_layer_specs(tcfg):
        key = _pattern_key(spec)
        if key not in cache:
            cache[key] = density_of(tcfg.seq_len, _pattern_for(tcfg, key[0], key[1]))
        dens.append(cache[key])
    return sum(dens) / len(dens)


def _element_density(n: int, pm: Optional[np.ndarray]) -> float:
    if pm is None:
        return (n + 1) / (2.0 * n)  # the causal triangle
    return float((np.asarray(pm) & np.tril(np.ones((n, n), dtype=bool))).mean())


def _attn_live_density(cfg) -> float:
    """Mean live fraction of the (s, s) score matrix across layers, counting
    only positions the attention may attend to (pattern and causal)."""
    return _layer_densities(cfg, _element_density)


def _attn_tile_density(cfg) -> float:
    """Live fraction of the (s, s) score matrix at the flash kernels' tiles:
    a (tq, tk) tile with one live element is computed whole, so the
    executed work prices whole live tiles inside the causal triangle — the
    count of `flash_attention.pattern_tables` (its `live_tiles` per table
    head) times the tile's area, over s x s."""
    from dalle_pytorch_tpu_torch.kernels.flash_attention import tile_shapes
    from dalle_pytorch_tpu_torch.kernels.sparse_index import block_causal_live_np
    from dalle_pytorch_tpu_torch.ops.masks import block_live_np

    tq, tk = tile_shapes(cfg.dim_head)[0]

    def density(n, pm):
        nq, nk = -(-n // tq), -(-n // tk)
        cl = block_causal_live_np(nq, nk, tq, tk)
        if pm is None:
            live = float(cl.sum())
        else:
            m = np.asarray(pm) != 0
            bl = block_live_np(m if m.ndim == 3 else m[None], tq, tk)
            live = float((bl & cl).sum()) / bl.shape[0]
        return live * tq * tk / (n * n)

    return _layer_densities(cfg, density)


def dalle_step_flops(cfg, batch: int, n_matmul_params: int, with_backward: bool = True,
                     granularity: str = "element") -> float:
    """Analytic FLOPs of one (micro)step: 2·P·T for the products of the
    parameters, plus the attention's scores and values at each layer's live
    density; the backward about twice the forward.  'element' prices what
    the math needs; 'tile' prices whole live tiles, what the flash kernels
    execute, the side the measured count is held against."""
    s = cfg.total_seq_len
    proj = 2.0 * n_matmul_params * batch * s
    density = _attn_tile_density(cfg) if granularity == "tile" else _attn_live_density(cfg)
    attn = 2.0 * 2.0 * batch * cfg.heads * s * s * cfg.dim_head * density * cfg.depth
    return (3.0 if with_backward else 1.0) * (proj + attn)


def mfu(step_flops: float, step_time_s: float, n_chips: int = 1, dtype: torch.dtype = torch.bfloat16,
        device=None) -> Optional[float]:
    """Model FLOPs utilisation: `step_flops` per `step_time_s` over the
    card's peak for `dtype`; None where the peak is unknown."""
    peak = chip_peak_flops(dtype, device)
    if peak is None:
        return None
    return step_flops / step_time_s / (peak * n_chips)


@contextlib.contextmanager
def trace(path: str = "./profile_trace.json") -> Iterator[None]:
    """Capture a `torch.profiler` trace of the enclosed block (CPU, and CUDA
    where a card is in use) as a Chrome trace at `path`."""
    from dalle_pytorch_tpu_torch.observability.capture import start_trace, stop_trace

    start_trace(path)
    try:
        yield
    finally:
        stop_trace()


class StepTimer:
    """Times steps the card runs asynchronously: call observe() after each
    step; it synchronises the card (CUDA events would time the device
    alone, this times what the caller waits), and per-step time is the
    interval between observations after the first."""

    def __init__(self, device=None):
        self._times = []
        self._t0 = None
        self.device = device

    def start(self):
        self._t0 = time.perf_counter()

    def observe(self, *_):
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        if self._t0 is not None:
            self._times.append(now - self._t0)
        self._t0 = now

    @property
    def times(self):
        return list(self._times)

    def best(self) -> Optional[float]:
        return min(self._times) if self._times else None

    def summary(self) -> Dict[str, float]:
        ts = sorted(self._times)
        if not ts:
            return {}
        return {"best_s": ts[0], "median_s": ts[len(ts) // 2], "mean_s": sum(ts) / len(ts),
                "steps": float(len(ts))}
