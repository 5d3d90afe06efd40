"""Metric logging for the training command lines (counterpart of
`dalle_pytorch_tpu/training/logging.py`).

Every record goes to stdout and to `<run>.metrics.jsonl`; images become PNG
grids under `<run>.images/` (written by `cli/png.py`, so no PIL is needed)
with a JSONL record of where; histograms are JSONL bin counts.  The same
files and records as the JAX `MetricLogger`, which the JAX package's tests
read.  `use_wandb` logs to Weights & Biases as well where `wandb` imports;
where it does not, a note is printed and the JSONL file carries on, as the
JAX logger does.  On a distributed run only the root writes
(`is_root=False`: every call is a no-op and no file is opened).
"""
from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

from dalle_pytorch_tpu_torch.cli.png import write_png


def _numpy(x) -> np.ndarray:
    """A host array of a numpy array, a scalar or a tensor on any device."""
    if hasattr(x, "detach"):
        x = x.detach().float().cpu().numpy() if x.is_floating_point() else x.detach().cpu().numpy()
    return np.asarray(x)


def make_grid(images: np.ndarray, nrow: int = 4, pad: int = 2, pad_value: float = 0.0) -> np.ndarray:
    """(N, H, W, C) floats in [0, 1] -> one (gh, gw, C) grid image, rows of
    `nrow`: torchvision's `make_grid` in NHWC, padding and empty trailing
    cells at `pad_value` (0, black)."""
    images = np.asarray(images)
    n, h, w, c = images.shape
    ncol = min(nrow, n)
    nr = (n + ncol - 1) // ncol
    grid = np.full((nr * (h + pad) + pad, ncol * (w + pad) + pad, c), pad_value, images.dtype)
    for i in range(n):
        r, col = divmod(i, ncol)
        y, x = pad + r * (h + pad), pad + col * (w + pad)
        grid[y: y + h, x: x + w] = images[i]
    return grid


class MetricLogger:
    def __init__(self, run_name: str = "run", log_dir: str = ".", use_wandb: bool = False,
                 wandb_kwargs: Optional[dict] = None, config: Optional[dict] = None, is_root: bool = True):
        self.is_root = is_root
        self._wandb = None
        self._file = None
        self._image_dir = Path(log_dir) / f"{run_name}.images"
        if not is_root:
            return
        if use_wandb:
            try:
                import wandb

                wandb.init(config=config or {}, **(wandb_kwargs or {}))
                self._wandb = wandb
            except Exception as e:  # noqa: BLE001 — any failure to start wandb falls back to JSONL, as in JAX
                print(f"[logging] wandb unavailable ({e!r}); falling back to JSONL")
        path = Path(log_dir) / f"{run_name}.metrics.jsonl"
        path.parent.mkdir(parents=True, exist_ok=True)
        self._file = open(path, "a")

    def log_images(self, images: Dict[str, Any], step: Optional[int] = None) -> None:
        """images: name -> (H, W, C) or (N, H, W, C) floats in [0, 1] (a
        batch becomes a grid), each written as `step<N>_<name>.png` (spaces
        as underscores) under `<run>.images/`, with one JSONL record of the
        paths."""
        if not self.is_root:
            return
        record: Dict[str, Any] = {}
        wandb_payload = {}
        for name, arr in images.items():
            arr = _numpy(arr).astype(np.float32)
            if arr.ndim == 4:
                arr = make_grid(arr)
            arr8 = (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)
            if arr8.shape[-1] == 1:
                arr8 = arr8[..., 0]
            fname = f"step{step}_{name.replace(' ', '_')}.png" if step is not None else f"{name}.png"
            self._image_dir.mkdir(parents=True, exist_ok=True)
            out_path = self._image_dir / fname
            write_png(out_path, arr8)
            record[name] = str(out_path)
            if self._wandb is not None:
                wandb_payload[name] = self._wandb.Image(arr8)
        if self._wandb is not None and wandb_payload:
            self._wandb.log(wandb_payload, step=step)
        self.log({"images": record}, step=step, quiet=True)

    def log_histogram(self, name: str, values, step: Optional[int] = None, bins: int = 64) -> None:
        """A distribution (the codebook's code use): `<name>_hist` with the
        bin counts, the outer edges and the number of distinct values."""
        if not self.is_root:
            return
        values = _numpy(values).reshape(-1)
        counts, edges = np.histogram(values, bins=bins)
        if self._wandb is not None:
            self._wandb.log({name: self._wandb.Histogram(np_histogram=(counts, edges))}, step=step)
        self.log({f"{name}_hist": {"counts": counts.tolist(), "edges": [float(edges[0]), float(edges[-1])],
                                   "distinct": int(len(np.unique(values)))}},
                 step=step, quiet=True)

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None, quiet: bool = False) -> None:
        """One JSONL record {ts, step, **metrics}, printed as `[step] k=v`
        unless `quiet`."""
        if not self.is_root:
            return
        record = {"ts": time.time(), **({"step": step} if step is not None else {}), **metrics}
        if self._file is not None:
            self._file.write(json.dumps({k: _jsonable(v) for k, v in record.items()}) + "\n")
            self._file.flush()
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)
        if not quiet:
            parts = " ".join(f"{k}={_fmt(v)}" for k, v in metrics.items())
            print(f"[{step}] {parts}" if step is not None else parts, flush=True)

    def finish(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None
        if self._wandb is not None:
            self._wandb.finish()


def _jsonable(v):
    try:
        json.dumps(v)
        return v
    except TypeError:
        return float(v)


def _fmt(v):
    return f"{v:.5g}" if isinstance(v, float) else v
