"""Rank code of the sharded train step's CPU tests (`test_torch_parallel_steps.py`).

Each rank of a gloo world runs every configuration of its world size for
three steps on the same initial weights and global batches, and rank 0
writes the losses, gradient norms, full final parameters and resident
bytes of each; every rank writes its resident bytes, whether
`full_state` gave it a state, and the most bytes of gathered parameters
alive at once during its steps (`GatherPeak`).  This module imports no JAX: the spawned ranks import it
alone.  `one_process` runs the same configuration without a mesh, the
reference the test holds the ranks against.
"""
from __future__ import annotations

import dataclasses
import datetime
import functools
import os
import weakref
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch.func import functional_call

from dalle_pytorch_tpu_torch.models.dalle import DALLE, DALLEConfig
from dalle_pytorch_tpu_torch.optim.adafactor import Adafactor
from dalle_pytorch_tpu_torch.optim.grouped import Adam
from dalle_pytorch_tpu_torch.parallel import tensor_parallel
from dalle_pytorch_tpu_torch.parallel.mesh import MeshConfig, make_mesh
from dalle_pytorch_tpu_torch.parallel.registry import PartitionRegistry
from dalle_pytorch_tpu_torch.parallel.train_step import StepSettings, make_train_step
from dalle_pytorch_tpu_torch.weights import dalle_param_paths

STEPS = 3
LR = 1e-3
# a low floor so that the tiny model's leaves shard under ZeRO (the default
# rules' 2^14 would leave most of them replicated)
REGISTRY = PartitionRegistry(min_shard_size=256)


@dataclasses.dataclass(frozen=True)
class Case:
    world: int
    mesh: Dict[str, int]
    settings: Dict = dataclasses.field(default_factory=dict)
    model: Dict = dataclasses.field(default_factory=dict)
    optimizer: str = "adam"
    round_bits: bool = False
    poison_step: Optional[int] = None  # this step's loss is multiplied by inf


CASES = {
    "dp2": Case(2, {"dp": 2}),
    "fsdp2_z1": Case(2, {"fsdp": 2}, {"zero_stage": 1}),
    "fsdp2_z2": Case(2, {"fsdp": 2}, {"zero_stage": 2}),
    "fsdp2_z3": Case(2, {"fsdp": 2}, {"zero_stage": 3}),
    "fsdp2_z3_depth6": Case(2, {"fsdp": 2}, {"zero_stage": 3}, {"depth": 6}),
    "grad_accum2_z3": Case(2, {"fsdp": 2}, {"zero_stage": 3, "grad_accum": 2}),
    "remat_fsdp2_z3": Case(2, {"fsdp": 2}, {"zero_stage": 3}, {"execution": "remat", "remat_policy": "flash_qkv"}),
    "reversible_fsdp2_z3": Case(2, {"fsdp": 2}, {"zero_stage": 3}, {"reversible": True}),
    "tp2": Case(2, {"tp": 2}),
    "grad_accum2": Case(2, {"fsdp": 2}, {"zero_stage": 1, "grad_accum": 2}),
    "bf16_round_bits": Case(2, {"fsdp": 2}, {"zero_stage": 3, "param_dtype": torch.bfloat16}, round_bits=True),
    "loss_scale_overflow": Case(2, {"dp": 2}, {"loss_scale": "dynamic"}, poison_step=1),
    "clip": Case(2, {"tp": 2}, {"clip_grad_norm": 0.05}),
    "remat_tp2": Case(2, {"tp": 2}, model={"execution": "remat", "remat_policy": "flash_qkv"}),
    "reversible_tp2": Case(2, {"tp": 2}, model={"reversible": True}),
    "shared_ff_fsdp2_tp2_z3": Case(4, {"fsdp": 2, "tp": 2}, {"zero_stage": 3}, {"shared_ff_ids": (0, 0, 1)}),
    "adafactor_tp2_z3": Case(4, {"fsdp": 2, "tp": 2}, {"zero_stage": 3}, optimizer="adafactor"),
    "dp2_tp2": Case(4, {"dp": 2, "tp": 2}),
    "fsdp2_tp2_z3": Case(4, {"fsdp": 2, "tp": 2}, {"zero_stage": 3}),
    "dropout": Case(4, {"dp": 2, "tp": 2}, {"grad_accum": 2}, {"attn_dropout": 0.1, "ff_dropout": 0.1}),
}

# tied embeddings, a pattern layer and per-head sparse layouts: the places
# where tensor parallelism slices something besides a weight
MODEL = dict(dim=64, depth=3, heads=4, dim_head=16, num_text_tokens=64, text_seq_len=8, num_image_tokens=32,
             image_fmap_size=4, attn_types=("full", "axial_row", "sparse"), sparse_per_head=True,
             sparse_block_size=4, share_input_output_emb=True)
BATCH = 8


def model_config(case: Case) -> DALLEConfig:
    return DALLEConfig(**{**MODEL, **case.model})


class GatherPeak:
    """The most bytes of gathered tensors (`tensor_parallel.gather_dim`
    over more than one rank) alive at once, each counted until its tensor
    is freed."""

    def __init__(self):
        self.live = self.peak = 0
        self._gather = tensor_parallel.gather_dim

    def __enter__(self):
        def gather_dim(x, dim, group, parts):
            out = self._gather(x, dim, group, parts)
            if parts > 1:
                n = out.numel() * out.element_size()
                self.live += n
                self.peak = max(self.peak, self.live)
                weakref.finalize(out, self._free, n)
            return out

        tensor_parallel.gather_dim = gather_dim
        return self

    def _free(self, n):
        self.live -= n

    def __exit__(self, *exc):
        tensor_parallel.gather_dim = self._gather


def loss_fn_of(model: DALLE):
    def loss_fn(params, batch, generator):
        loss = functional_call(model, params, (batch["text"], batch["codes"]),
                               {"return_loss": True, "generator": generator})
        return loss * batch["poison"].mean() if "poison" in batch else loss

    return loss_fn


def run(case: Case, inputs: dict, mesh=None) -> dict:
    """Three steps of `case` from `inputs` (initial weights, global batches,
    round bits), on `mesh` or in one process; the losses, gradient norms,
    skips, the final full parameters and this rank's resident bytes."""
    cfg = model_config(case)
    model = DALLE(cfg)
    model.load_state_dict(inputs["weights"])
    model.train().requires_grad_(True)
    settings = StepSettings(**case.settings)
    opt = (Adam if case.optimizer == "adam" else Adafactor)(LR)
    init_fn, step_fn = make_train_step(loss_fn_of(model), opt, settings, mesh=mesh,
                                       paths=dalle_param_paths(cfg) if mesh is not None else None,
                                       registry=REGISTRY, module=model)
    state = init_fn(dict(model.named_parameters()), round_seed=7)
    out = {"loss": [], "grad_norm": [], "skipped": []}
    with GatherPeak() as peak:
        _steps(case, inputs, mesh, step_fn, state, out)
    out["gathered_peak"] = peak.peak
    out["param_bytes"] = sum(w.numel() * w.element_size() for w in inputs["weights"].values())
    state = out.pop("state")
    if mesh is not None:
        out["resident"] = step_fn.resident_bytes(state)
        full = step_fn.full_state(state)
        out["has_full_state"] = full is not None
        out["params"] = None if full is None else {k: v.float().clone() for k, v in full.params.items()}
    else:
        out["params"] = {k: v.detach().float().clone() for k, v in state.params.items()}
    return out


def _steps(case: Case, inputs: dict, mesh, step_fn, state, out: dict) -> None:
    for i in range(STEPS):
        batch = dict(inputs["batches"][i])
        if case.poison_step is not None:
            batch["poison"] = torch.full((BATCH,), float("inf") if i == case.poison_step else 1.0)
        if mesh is not None:
            batch = step_fn.local_batch(batch)
        gen = torch.Generator().manual_seed(1000 + i)
        bits = inputs["round_bits"][i] if case.round_bits else None
        state, m = step_fn(state, batch, gen, round_bits=bits)
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        out["skipped"].append(int(m["skipped"]))
    out["state"] = state


def make_inputs(case: Case, seed: int = 0) -> dict:
    """The initial weights, the batches and the rounding bits of `case`,
    from numpy's seeded generator."""
    import numpy as np

    cfg = model_config(case)
    rng = np.random.default_rng(seed)
    model = DALLE(cfg)
    weights = {k: torch.from_numpy(rng.uniform(-0.2, 0.2, v.shape).astype(np.float32))
               for k, v in model.state_dict().items()}
    batches = [{"text": torch.from_numpy(rng.integers(0, cfg.num_text_tokens, (BATCH, cfg.text_seq_len))),
                "codes": torch.from_numpy(rng.integers(0, cfg.num_image_tokens, (BATCH, cfg.image_seq_len)))}
               for _ in range(STEPS)]
    names = [n for n, _ in model.named_parameters()]
    bits = [{n: torch.from_numpy(rng.integers(0, 65536, weights[n].shape).astype(np.int32)) for n in names}
            for _ in range(STEPS)]
    return {"weights": weights, "batches": batches, "round_bits": bits}


def rank_main(rank: int, world: int, rendezvous: str, out_dir: str, names) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        for name in names:
            case = CASES[name]
            inputs = torch.load(os.path.join(out_dir, f"{name}.inputs.pt"))
            mesh = make_mesh(MeshConfig(**case.mesh), "cpu")
            result = run(case, inputs, mesh)
            if rank == 0:
                torch.save(result, os.path.join(out_dir, f"{name}.result.pt"))
            else:
                torch.save({k: result[k] for k in ("resident", "has_full_state", "gathered_peak")},
                           os.path.join(out_dir, f"{name}.rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


one_process = functools.partial(run, mesh=None)
