"""Rank code of the sp and pp CPU tests (`test_torch_ring.py`,
`test_torch_seq_parallel.py`, `test_torch_pipeline.py`).

`ring_main`: each rank of a gloo world runs the port's `ring_attention` on
its part of the sequence of every case of `ring.inputs.pt` (forward, then
backward with its part of the cotangent) and writes its out, dq, dk and
dv.  `step_main`: each rank runs every named `Case` of `CASES` on its mesh
for `STEPS` Adam steps whose optimizer also keeps the first step's
gradient (`RecordingAdam`): the losses, gradient norms, the full gradient
of the initial weights and the final full parameters (gathered onto rank
0), resident bytes by rank.  `one_process` runs a case without a
mesh, the reference.  This module imports no JAX: the spawned ranks import
it alone.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Dict, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.func import functional_call

from dalle_pytorch_tpu_torch.models.dalle import DALLE, DALLEConfig
from dalle_pytorch_tpu_torch.optim.grouped import Adam
from dalle_pytorch_tpu_torch.parallel.mesh import MeshConfig, make_mesh
from dalle_pytorch_tpu_torch.parallel.p2p import exchange, route
from dalle_pytorch_tpu_torch.parallel.registry import PartitionRegistry
from dalle_pytorch_tpu_torch.parallel.ring import ring_attention
from dalle_pytorch_tpu_torch.parallel.train_step import StepSettings, make_train_step
from dalle_pytorch_tpu_torch.weights import dalle_param_paths

STEPS = 3
LR = 1e-3
REGISTRY = PartitionRegistry(min_shard_size=256)

# the full/axial_row/conv_like cycle with rotary, the token shift and tied
# embeddings; n = 8 + 16 = 24 positions, so at sp 4 a rank holds 6: the
# text/image boundary (position 9) and the token shift's halo of fmap 4
# cross ranks
MODEL = dict(dim=64, depth=3, heads=4, dim_head=16, num_text_tokens=64, text_seq_len=8, num_image_tokens=32,
             image_fmap_size=4, attn_types=("full", "axial_row", "conv_like"), share_input_output_emb=True,
             rotary_emb=True, shift_tokens=True)
RING = dict(seq_shard_axis="sp", attn_kernel="ring")
DENSE = dict(seq_shard_axis="sp")


def pipe(**kw):
    return {"depth": 4, "pipeline_axis": "pp", **kw}


@dataclasses.dataclass(frozen=True)
class Case:
    world: int
    mesh: Dict[str, int]
    model: Dict = dataclasses.field(default_factory=dict)
    settings: Dict = dataclasses.field(default_factory=dict)
    batch: int = 8


CASES = {
    # sequence parallelism: the ring and the gathered plain attention
    "sp2_ring": Case(2, {"sp": 2}, RING),
    "sp2_dense": Case(2, {"sp": 2}, DENSE),
    "sp2_ring_dropout_accum": Case(2, {"sp": 2}, dict(RING, attn_dropout=0.1, ff_dropout=0.1), {"grad_accum": 2}),
    "sp4_ring": Case(4, {"sp": 4}, RING),
    "sp4_dense": Case(4, {"sp": 4}, DENSE),
    "dp2_sp2_ring": Case(4, {"dp": 2, "sp": 2}, RING),
    "tp2_sp2_ring_dropout": Case(4, {"tp": 2, "sp": 2}, dict(RING, attn_dropout=0.1, ff_dropout=0.1)),
    # the pipeline, on batches of 6 (M 2 and 3 divide them)
    "pp2_m2": Case(2, {"pp": 2}, pipe(pp_num_micro=2), batch=6),
    "pp2_m3": Case(2, {"pp": 2}, pipe(pp_num_micro=3), batch=6),
    "pp2_v2": Case(2, {"pp": 2}, pipe(pp_num_micro=2, pp_interleave=2), batch=6),
    "pp2_dropout": Case(2, {"pp": 2}, pipe(pp_num_micro=2, attn_dropout=0.1, ff_dropout=0.1), batch=6),
    "pp2_remat_bf16": Case(2, {"pp": 2}, pipe(execution="remat", remat_policy="flash_qkv"),
                           {"param_dtype": torch.bfloat16, "loss_scale": "dynamic", "grad_accum": 2}, batch=6),
    "pp4_depth8": Case(4, {"pp": 4}, pipe(depth=8), batch=6),
    "fsdp2_pp2_z3": Case(4, {"fsdp": 2, "pp": 2}, pipe(), {"zero_stage": 3}, batch=6),
    "sp2_pp2_ring": Case(4, {"sp": 2, "pp": 2}, {**pipe(), **RING}, batch=6),
    # the mesh axes without the model knobs: replicas of the step
    "sp2_replicas": Case(2, {"sp": 2}),
    "pp2_replicas": Case(2, {"pp": 2}, {"depth": 4}, batch=6),
}


def model_config(case: Case) -> DALLEConfig:
    return DALLEConfig(**{**MODEL, **case.model})


class RecordingAdam(Adam):
    """Adam that also keeps, as its statistic `g`, the gradient of its
    first update, so that the full state holds the gradient of the initial
    weights."""

    def _init_stats(self, shape, n, device):
        stats = super()._init_stats(shape, n, device)
        return {**stats, "g": torch.zeros_like(stats["mu"])}

    def update(self, grads, group, params, count):
        g = grads.clone() if count == 0 else group.stats["g"]
        moments = {k: v for k, v in group.stats.items() if k != "g"}
        updates, group = super().update(grads, dataclasses.replace(group, stats=moments), params, count)
        return updates, dataclasses.replace(group, stats={**group.stats, "g": g})


def _loss_fn(model: DALLE):
    def loss_fn(params, batch, generator):
        return functional_call(model, params, (batch["text"], batch["codes"]),
                               {"return_loss": True, "generator": generator})

    return loss_fn


def run(case: Case, inputs: dict, mesh=None) -> dict:
    """STEPS Adam steps of `case` from `inputs` (initial weights, global
    batches, rounding bits), on `mesh` or in one process: the losses,
    gradient norms, the first step's loss and gradient (of the initial
    weights), the final full parameters (None off rank 0), this rank's
    resident bytes."""
    cfg = model_config(case)
    model = DALLE(cfg)
    model.load_state_dict(inputs["weights"])
    model.train().requires_grad_(True)
    init_fn, step_fn = make_train_step(_loss_fn(model), RecordingAdam(LR), StepSettings(**case.settings), mesh=mesh,
                                       paths=dalle_param_paths(cfg) if mesh is not None else None,
                                       registry=REGISTRY, module=model)
    state = init_fn(dict(model.named_parameters()), round_seed=7)
    out = {"loss": [], "grad_norm": []}
    for i in range(STEPS):
        batch = dict(inputs["batches"][i])
        if mesh is not None:
            batch = step_fn.local_batch(batch)
        bits = inputs["round_bits"][i] if case.settings.get("param_dtype") == torch.bfloat16 else None
        state, m = step_fn(state, batch, torch.Generator().manual_seed(1000 + i), round_bits=bits)
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
    out["first_loss"] = out["loss"][0]
    if mesh is not None:
        out["resident"] = step_fn.resident_bytes(state)
        state = step_fn.full_state(state)
    out["grads"] = None if state is None else {
        n: g.stats["g"][i].clone() for g in state.opt_state.groups for i, n in enumerate(g.names)}
    out["params"] = None if state is None else {k: v.detach().float().clone() for k, v in state.params.items()}
    return out


def stage_param_bytes(cfg: DALLEConfig, stages: int, interleave: int) -> list:
    """Each pipeline stage's parameter bytes (f32): its layers (the JAX
    chunk map) and every leaf outside the stack."""
    from dalle_pytorch_tpu_torch.parallel.pipeline import stage_chunks

    model = DALLE(cfg)
    inside = {id(p) for layer in model.transformer.layers for p in layer.parameters()}
    outside = sum(p.numel() for p in model.parameters() if id(p) not in inside)
    out = []
    for s in range(stages):
        held = {id(p): p.numel() for start, stop in stage_chunks(cfg.depth, stages, s, interleave)
                for i in range(start, stop) for p in model.transformer.layers[i].parameters()}
        out.append(4 * (outside + sum(held.values())))
    return out


def make_inputs(case: Case, seed: int = 0) -> dict:
    cfg = model_config(case)
    rng = np.random.default_rng(seed)
    weights = {k: torch.from_numpy(rng.uniform(-0.2, 0.2, v.shape).astype(np.float32))
               for k, v in DALLE(cfg).state_dict().items()}
    batches = [{"text": torch.from_numpy(rng.integers(0, cfg.num_text_tokens, (case.batch, cfg.text_seq_len))),
                "codes": torch.from_numpy(rng.integers(0, cfg.num_image_tokens, (case.batch, cfg.image_seq_len)))}
               for _ in range(STEPS)]
    bits = [{n: torch.from_numpy(rng.integers(0, 65536, weights[n].shape).astype(np.int32))
             for n, _ in DALLE(cfg).named_parameters()} for _ in range(STEPS)]
    return {"weights": weights, "batches": batches, "round_bits": bits}


def _init(rank: int, world: int, rendezvous: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))


def step_main(rank: int, world: int, rendezvous: str, out_dir: str, names) -> None:
    _init(rank, world, rendezvous)
    try:
        for name in names:
            case = CASES[name]
            inputs = torch.load(os.path.join(out_dir, f"{name}.inputs.pt"))
            mesh = make_mesh(MeshConfig(**case.mesh), "cpu")
            result = run(case, inputs, mesh)
            result["mesh"] = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
            keep = result if rank == 0 else {"resident": result["resident"], "loss": result["loss"]}
            torch.save(keep, os.path.join(out_dir, f"{name}.rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def ring_main(rank: int, world: int, rendezvous: str, out_dir: str) -> None:
    """Each case of `ring.inputs.pt` on this rank's part of the sequence
    (q, k, v, the cotangent do: (b, h, n, d); `causal`; `mask` (n, n) or
    None), and a two-tensor hop round the ring whose route is recorded."""
    _init(rank, world, rendezvous)
    try:
        cases = torch.load(os.path.join(out_dir, "ring.inputs.pt"))
        got = {}
        for name, c in cases.items():
            n = c["q"].shape[2] // world
            part = slice(rank * n, (rank + 1) * n)
            q, k, v = (c[x][:, :, part].clone().requires_grad_(True) for x in ("q", "k", "v"))
            out = ring_attention(q, k, v, list(range(world)), rank, causal=c["causal"], mask=c["mask"])
            out.backward(c["do"][:, :, part])
            got[name] = {"out": out.detach(), "dq": q.grad, "dk": k.grad, "dv": v.grad}
        a, b = torch.full((3,), float(rank)), torch.full((2, 2), rank, dtype=torch.int64)
        got["hop"] = exchange([a, b], (rank + 1) % world, (rank - 1) % world)
        got["route"] = route(a.device)
        torch.save(got, os.path.join(out_dir, f"ring.rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def one_process(case: Case, inputs: dict) -> dict:
    return run(case, inputs, None)


def spawn_world(out_dir, world: int, names) -> Tuple[dict, dict]:
    """({name: the one-process result}, {name: rank 0's result, with
    `resident_by_rank` and `loss_by_rank`}) of the named cases of one world
    size, the world spawned once."""
    import torch.multiprocessing as mp

    inputs = {name: make_inputs(CASES[name]) for name in names}
    for name in names:
        torch.save(inputs[name], os.path.join(out_dir, f"{name}.inputs.pt"))
    # the ranks start while the one-process references run
    ctx = mp.spawn(step_main, args=(world, os.path.join(out_dir, "rendezvous"), str(out_dir), list(names)),
                   nprocs=world, join=False)
    try:
        refs = {name: one_process(CASES[name], inputs[name]) for name in names}
    finally:
        while not ctx.join():
            pass
    got = {}
    for name in names:
        by_rank = [torch.load(os.path.join(out_dir, f"{name}.rank{r}.pt")) for r in range(world)]
        got[name] = dict(by_rank[0], resident_by_rank=[r["resident"] for r in by_rank],
                         loss_by_rank=[r["loss"] for r in by_rank])
    return refs, got
