"""What a training run writes so that another run continues it, and reads
back (counterpart of the resume parts of `dalle_pytorch_tpu/cli/
train_dalle.py` and `training/resilience.py`).

- The optimizer state in the JAX package's layout: optax's Adam state
  `(ScaleByAdamState(count, mu, nu), EmptyState())`, chained with
  `ReduceLROnPlateauState` under `--lr_decay` and paired with the loss
  scale's `{"good_steps", "loss_scale"}` when scaling is on, stored as a
  `TreeBundle` of key paths and leaves.  The JAX CLI's `unflatten_like`
  restores the port's, and the port restores the JAX CLI's: the paths of
  a file must equal those of the state they restore into.
- The data cursor, `data_state`: {epoch, epoch_batches, seed} as the JAX
  CLI writes it, plus the states of the run's `torch.Generator`s in place
  of its `rng_key`.
- Discovery (`--resume auto`: the newest checkpoint next to the output
  file that loads) and rotation (`--keep_n_checkpoints`) over the JAX
  CLI's `<name>_step<N>.npz` files.
"""
from __future__ import annotations

import base64
import json
import re
import zipfile
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from dalle_pytorch_tpu_torch import weights
from dalle_pytorch_tpu_torch.checkpoint import TreeBundle, _flatten, _rebuild_pure, load_checkpoint
from dalle_pytorch_tpu_torch.models.dalle import DALLEConfig
from dalle_pytorch_tpu_torch.optim.grouped import GroupedState
from dalle_pytorch_tpu_torch.optim.plateau import PlateauState
from dalle_pytorch_tpu_torch.parallel.train_step import TrainState

# the `<name>_step<N>[.ext]` naming of step checkpoints (JAX
# training/checkpoint.py STEP_FILENAME_RE)
STEP_FILENAME_RE = re.compile(r"_step(\d+)(?:\.[^.]*)?$")


# ---------------------------------------------------------------------------
# the optimizer state
# ---------------------------------------------------------------------------


def _moments(opt: GroupedState) -> Dict[str, Dict[str, torch.Tensor]]:
    out: Dict[str, Dict[str, torch.Tensor]] = {"mu": {}, "nu": {}}
    for group in opt.groups:
        for stat in ("mu", "nu"):
            out[stat].update(zip(group.names, group.stats[stat].unbind(0)))
    return out


def _sections(state: TrainState, cfg: DALLEConfig) -> List[Tuple[list, str, Any]]:
    """(path prefix, what, tree or leaf) in the JAX package's flatten order."""
    adam = [["i", 0]] if state.plateau is None else [["i", 0], ["i", 0]]
    if state.loss_scale is not None:
        adam = [["i", 0]] + adam
    moments = _moments(state.opt_state)
    out = [(adam + [["a", "count"]], "count", torch.tensor(state.opt_state.count, dtype=torch.int32))]
    out += [(adam + [["a", stat]], stat, weights.dalle_tree(moments[stat], cfg)) for stat in ("mu", "nu")]
    if state.plateau is not None:
        top = [["i", 0]] if state.loss_scale is not None else []
        out += [(top + [["i", 1], ["a", name]], "plateau." + name, getattr(state.plateau, name))
                for name in PlateauState.FIELDS]
    if state.loss_scale is not None:
        out += [([["i", 1], ["k", "good_steps"]], "good_steps",
                 torch.tensor(state.loss_scale["good_steps"], dtype=torch.int32)),
                ([["i", 1], ["k", "loss_scale"]], "loss_scale",
                 torch.tensor(state.loss_scale["loss_scale"], dtype=torch.float32))]
    return out


def optimizer_bundle(state: TrainState, cfg: DALLEConfig) -> TreeBundle:
    """The optimizer state of a grouped Adam step (with its plateau and
    loss scale) as the JAX CLI's `opt_state` tree: moments in the JAX
    parameter layout, f32; counts int32."""
    paths, leaves = [], []
    for prefix, _, value in _sections(state, cfg):
        if isinstance(value, torch.Tensor):
            paths.append(prefix)
            leaves.append(value.detach().to("cpu"))
        else:
            sub_paths, sub_leaves = [], []
            _flatten(value, [], sub_paths, sub_leaves)
            paths += [prefix + p for p in sub_paths]
            leaves += sub_leaves
    return TreeBundle(paths, leaves)


def restore_optimizer(state: TrainState, saved: TreeBundle, cfg: DALLEConfig) -> None:
    """Write a saved `opt_state` bundle into `state` (a fresh state of the
    same optimizer), in place.  Raises ValueError, naming the first
    mismatch, when the file's paths are not those of `state`: a file from
    another optimizer or model never lands in the wrong leaves."""
    want = optimizer_bundle(state, cfg)
    if not isinstance(saved, TreeBundle) or saved.paths != want.paths:
        got = saved.paths if isinstance(saved, TreeBundle) else []
        first = next((f"leaf {i}: file {a} vs state {b}" for i, (a, b) in enumerate(zip(got, want.paths))
                      if a != b), f"{len(got)} leaves vs {len(want.paths)}")
        raise ValueError(f"the checkpoint's optimizer state does not match this run's: {first}")
    values = iter(saved.leaves)
    opt = state.opt_state
    for prefix, what, value in _sections(state, cfg):
        if isinstance(value, torch.Tensor):
            leaf = next(values)
            if what == "count":
                opt.count = int(leaf)
            elif what == "good_steps":
                state.loss_scale["good_steps"] = int(leaf)
            elif what == "loss_scale":
                state.loss_scale["loss_scale"] = float(leaf)
            else:
                target = getattr(state.plateau, what[len("plateau."):])
                target.copy_(leaf.to(target.dtype))
            continue
        sub_paths, sub_leaves = [], []
        struct = _flatten(value, [], sub_paths, sub_leaves)
        tree = _rebuild_pure(struct, [next(values) for _ in sub_leaves])
        by_name = weights.dalle_state_dict(tree, cfg)
        for group in opt.groups:
            stats = group.stats[what]
            stats.copy_(torch.stack([by_name[n] for n in group.names]).to(stats))


# ---------------------------------------------------------------------------
# the data cursor and the generators
# ---------------------------------------------------------------------------


def generator_state(gen: torch.Generator) -> str:
    return base64.b64encode(gen.get_state().numpy().tobytes()).decode()


def set_generator_state(gen: torch.Generator, text: str) -> None:
    state = np.frombuffer(base64.b64decode(text), np.uint8).copy()
    gen.set_state(torch.from_numpy(state))


def data_state_dict(epoch: int, epoch_batches: int, seed: int,
                    generators: Dict[str, Optional[torch.Generator]]) -> Dict[str, Any]:
    """The `data_state` meta record: the epoch, the batches of it already
    taken (the fast-forward cursor), the shuffle seed, and each generator's
    state (base64 of `get_state()`)."""
    return {"epoch": epoch, "epoch_batches": epoch_batches, "seed": seed,
            "torch_generators": {name: generator_state(g) for name, g in generators.items() if g is not None}}


# ---------------------------------------------------------------------------
# discovery and rotation
# ---------------------------------------------------------------------------


def _peek_global_step(path: Path) -> Optional[int]:
    """The meta's global_step, read from the one small zip member; None
    where it cannot be read (ranking only, never validation)."""
    try:
        with np.load(str(path), allow_pickle=False) as data:
            step = json.loads(bytes(data["__meta"]).decode()).get("global_step")
        return int(step) if step is not None else None
    except Exception:  # noqa: BLE001 — any unreadable file ranks by its name
        return None


def checkpoint_candidates(output_path: str) -> List[Path]:
    """The run's `<name>_step<N>.*` files and `<name>.pt` itself, newest
    first, ranked as the JAX package ranks them: by the meta's global_step
    (a step file's filename step + 1 when unreadable), a step file before
    the main file on a tie, then by the filename step.  `*.tmp` files never
    count, nor do directories (sharded checkpoints, ROADMAP.md Queue 1
    item 8)."""
    out = Path(output_path)
    ranked: List[Tuple[int, int, int, Path]] = []
    for p in out.parent.glob(f"{out.stem}_step*"):
        m = STEP_FILENAME_RE.search(p.name)
        if p.name.endswith(".tmp") or p.is_dir() or not m:
            continue
        step = _peek_global_step(p)
        ranked.append((step if step is not None else int(m.group(1)) + 1, 1, int(m.group(1)), p))
    if out.is_file():
        step = _peek_global_step(out)
        ranked.append((step if step is not None else -1, 0, -1, out))
    ranked.sort(key=lambda t: t[:3], reverse=True)
    return [p for *_, p in ranked]


def find_latest_valid_checkpoint(output_path: str, log=print) -> Optional[str]:
    """`--resume auto`: the newest candidate that loads (its trees and meta
    read whole); the ones that do not are reported and passed over.  None
    when there is none."""
    for p in checkpoint_candidates(output_path):
        try:
            load_checkpoint(str(p))
            return str(p)
        except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile) as e:
            if log is not None:
                log(f"[resume] skipping unusable checkpoint {p}: {e!r}")
    return None


def rotation_glob(path: str) -> str:
    """The glob of a run's step files, from one of them
    (`<name>_step<N>.npz` -> `<name>_step*.npz`)."""
    p = Path(path)
    return re.sub(r"_step\d+$", "", p.stem) + "_step*" + p.suffix


def rotate_checkpoints(directory: str, pattern: str, keep_n: Optional[int]) -> None:
    """Delete the oldest files of `pattern` so that keep_n remain; oldest by
    the step in the file name (files without one, by mtime, count older),
    `*.tmp` never touched."""
    if keep_n is None or keep_n <= 0:
        return

    def key(p: Path):
        m = STEP_FILENAME_RE.search(p.name)
        return (1, int(m.group(1)), 0.0) if m else (0, 0, p.stat().st_mtime)

    files = sorted((p for p in Path(directory).glob(pattern) if not p.name.endswith(".tmp")), key=key)
    for old in files[:-keep_n]:
        old.unlink()
