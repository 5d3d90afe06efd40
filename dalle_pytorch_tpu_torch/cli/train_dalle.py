"""Train the DALL-E transformer (counterpart of `dalle_pytorch_tpu/cli/train_dalle.py`).

    python -m dalle_pytorch_tpu_torch.cli.train_dalle --dummy_run [N] [--device cpu]

The path: pixels -> frozen DiscreteVAE codes -> the DALL-E weighted
cross-entropy -> backward through the flash kernels -> global-norm clipping,
the bad-step guard, Adam -> a v3 checkpoint that the JAX package's
`load_checkpoint` reads.  It runs on the card unless `--device cpu` is given.

This slice trains on synthetic data only (`--dummy_run N`: N batches of
random captions and pixels from `--seed`, a tiny random VAE, a deliberately
ragged last batch).  Explicit model flags win over the dummy run's tiny
defaults.  Positions are always rotary.  Flags whose machinery is not ported
yet (real data, resume, learning-rate decay, meshes) exit with a message.
"""
from __future__ import annotations

import argparse
import copy
import functools
import json
import sys
import time
from typing import Dict, Iterator, Optional

import numpy as np
import torch
from torch.func import functional_call

from dalle_pytorch_tpu_torch import weights
from dalle_pytorch_tpu_torch.checkpoint import save_checkpoint
from dalle_pytorch_tpu_torch.core.device import resolve_device
from dalle_pytorch_tpu_torch.models import vae as vae_mod
from dalle_pytorch_tpu_torch.models.dalle import DALLE, DALLEConfig, init_dalle
from dalle_pytorch_tpu_torch.parallel.train_step import StepSettings, TrainState, make_train_step
from dalle_pytorch_tpu_torch.version import __version__

# flag -> what it needs that the port does not have yet
_WAITING = {
    "image_text_folder": "the image-text data layer",
    "wds": "the tar-shard data layer",
    "vae_path": "loading a trained VAE (training on real data)",
    "dalle_path": "resume",
    "resume": "resume with optimizer state",
    "lr_decay": "learning-rate decay (reduce on plateau)",
    "zero_stage": "ZeRO sharding",
    "mesh_dp": "meshes", "mesh_fsdp": "meshes", "mesh_tp": "meshes",
    "mesh_sp": "meshes", "mesh_pp": "meshes",
}

# the dummy run's tiny model, as the JAX CLI's `_apply_dummy_run_defaults`
_DUMMY_MODEL = dict(dim=64, depth=2, heads=2, dim_head=32, text_seq_len=16, num_text_tokens=256)
_DUMMY_VAE = dict(image_size=32, num_tokens=128, codebook_dim=32, num_layers=2,
                  num_resnet_blocks=0, hidden_dim=16)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--dummy_run", "--dummy-run", type=int, nargs="?", const=6, default=None,
                        metavar="N", help="train N steps (default 6) of synthetic batches")
    parser.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    parser.add_argument("--dalle_output_file_name", type=str, default="dalle")
    parser.add_argument("--seed", type=int, default=42)
    for name in ("dim", "depth", "heads", "dim_head", "text_seq_len", "num_text_tokens"):
        parser.add_argument(f"--{name}", type=int, default=None)
    parser.add_argument("--shift_tokens", action="store_true", help="use token shift")
    parser.add_argument("--attn_types", type=str, default="full",
                        help="comma-separated attention types, cycled over depth: "
                             "full, axial_row, axial_col, conv_like, sparse")
    parser.add_argument("--sparse_per_head", action="store_true",
                        help="sparse layers draw one random-block layout per head")
    parser.add_argument("--attn_dropout", type=float, default=0.0)
    parser.add_argument("--ff_dropout", type=float, default=0.0)
    parser.add_argument("--execution", type=str, default=None, choices=["sequential", "remat", "reversible"])
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--ga_steps", type=int, default=1, help="gradient accumulation steps")
    parser.add_argument("--learning_rate", type=float, default=3e-4)
    parser.add_argument("--clip_grad_norm", type=float, default=0.5)
    parser.add_argument("--bf16", action="store_true", help="bf16 compute over f32 masters")
    parser.add_argument("--loss_scale", type=str, default=None, help="a static scale or 'dynamic'")
    for name in ("image_text_folder", "vae_path", "dalle_path", "resume"):
        parser.add_argument(f"--{name}", type=str, default=None)
    parser.add_argument("--wds", action="store_true")
    parser.add_argument("--lr_decay", action="store_true")
    for name in ("zero_stage", "mesh_dp", "mesh_fsdp", "mesh_tp", "mesh_sp", "mesh_pp"):
        parser.add_argument(f"--{name}", type=int, default=None)
    return parser


def _refuse_waiting_flags(args) -> None:
    for flag, machinery in _WAITING.items():
        value = getattr(args, flag)
        if value not in (None, False):
            raise SystemExit(f"--{flag}: {machinery} is not ported yet; it comes with a "
                             "later PR of the port (ROADMAP.md Queue 1)")
    if args.execution == "reversible":
        raise SystemExit("--execution reversible is not ported yet; it comes with a later "
                         "PR of the port (ROADMAP.md Queue 1)")
    if args.dummy_run is None:
        raise SystemExit("the port trains on synthetic data only so far: pass --dummy_run [N] "
                         "(the data layer comes with a later PR, ROADMAP.md Queue 1)")


def dummy_batches(seed: int, n: int, batch_size: int, cfg: DALLEConfig,
                  vae_cfg: vae_mod.DiscreteVAEConfig) -> Iterator[Dict[str, np.ndarray]]:
    """n synthetic batches of random captions and pixels, the JAX dummy
    run's draws (epoch 0); the last one is half size when n >= 2."""
    rs = np.random.RandomState(seed)
    for i in range(n):
        bs = batch_size // 2 if i == n - 1 and n >= 2 and batch_size >= 2 else batch_size
        yield {
            "text": rs.randint(0, cfg.num_text_tokens, (bs, cfg.text_seq_len)).astype(np.int32),
            "image": rs.rand(bs, vae_cfg.image_size, vae_cfg.image_size, 3).astype(np.float32),
        }


def dalle_loss_fn(model: DALLE, vae: vae_mod.DiscreteVAE, compute_dtype: torch.dtype):
    """loss_fn(params, batch, generator) for `make_train_step`: raw pixels
    (batch["image"], (B, H, W, C) in [0, 1]) through the frozen VAE to codes,
    then the DALL-E loss on batch["text"] with `params` in place of the
    model's parameters.  The VAE encodes in the compute dtype, as the JAX
    CLI runs it."""
    encoder = vae if compute_dtype == torch.float32 else copy.deepcopy(vae).to(compute_dtype)

    def loss_fn(params, batch, generator):
        with torch.no_grad():
            codes = vae_mod.get_codebook_indices(encoder, batch["image"].to(compute_dtype))
        return functional_call(model, params, (batch["text"], codes),
                               {"return_loss": True, "generator": generator})

    return loss_fn


def optimizer_tree(state: TrainState, cfg: DALLEConfig) -> Optional[dict]:
    """Adam's moments as pure trees in the JAX package's parameter layout
    ({count, mu, nu}, as optax's adam state holds them), or None before the
    first update."""
    opt = state.opt_state
    names = {id(p): name for name, p in state.params.items()}
    mu, nu, count = {}, {}, None
    for p, s in opt.state.items():
        if "exp_avg" not in s:
            continue
        mu[names[id(p)]], nu[names[id(p)]] = s["exp_avg"], s["exp_avg_sq"]
        count = s["step"]
    if len(mu) != len(state.params):
        return None
    tree = {"count": torch.as_tensor(count).to(torch.int32), "mu": weights.dalle_tree(mu, cfg),
            "nu": weights.dalle_tree(nu, cfg)}
    if state.loss_scale is not None:
        tree["loss_scale"] = {key: torch.tensor(v) for key, v in state.loss_scale.items()}
    return tree


def save_dalle(path: str, model: DALLE, vae: vae_mod.DiscreteVAE, state: TrainState, epoch: int) -> None:
    """The checkpoint the JAX CLI writes (`build_model_payload`), in v3:
    weights, vae_weights and opt_state trees; hparams, vae_params, epoch."""
    cfg = model.cfg
    trees = {
        "weights": weights.dalle_tree(model.state_dict(), cfg),
        "vae_weights": weights.vae_tree(vae.state_dict(), vae.cfg),
        "opt_state": optimizer_tree(state, cfg),
    }
    meta = {"hparams": cfg.to_dict(), "vae_params": vae.cfg.to_dict(), "vae_class_name": "DiscreteVAE",
            "epoch": epoch, "global_step": state.step, "version": __version__}
    save_checkpoint(path, trees, meta)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    _refuse_waiting_flags(args)
    for name, value in _DUMMY_MODEL.items():
        if getattr(args, name) is None:
            setattr(args, name, value)
    batch_size = args.batch_size or 4
    device = resolve_device(args.device)
    torch.manual_seed(args.seed)

    vae_cfg = vae_mod.DiscreteVAEConfig(**_DUMMY_VAE)
    vae = vae_mod.init_discrete_vae(vae_cfg, torch.Generator(device=device).manual_seed(args.seed), device)
    cfg = DALLEConfig.from_vae(
        vae_cfg, dim=args.dim, depth=args.depth, heads=args.heads, dim_head=args.dim_head,
        text_seq_len=args.text_seq_len, num_text_tokens=args.num_text_tokens,
        attn_dropout=args.attn_dropout, ff_dropout=args.ff_dropout, execution=args.execution,
        shift_tokens=args.shift_tokens, attn_types=tuple(args.attn_types.split(",")),
        sparse_per_head=args.sparse_per_head,
    )
    model = init_dalle(cfg, torch.Generator(device=device).manual_seed(args.seed + 1), device)
    model.train().requires_grad_(True)
    compute_dtype = torch.bfloat16 if args.bf16 else torch.float32
    loss_scale = args.loss_scale if args.loss_scale in (None, "dynamic") else float(args.loss_scale)
    settings = StepSettings(grad_accum=args.ga_steps, compute_dtype=compute_dtype,
                            clip_grad_norm=args.clip_grad_norm, loss_scale=loss_scale)
    init_fn, step_fn = make_train_step(
        dalle_loss_fn(model, vae, compute_dtype),
        functools.partial(torch.optim.Adam, lr=args.learning_rate, betas=(0.9, 0.999), eps=1e-8),
        settings,
    )
    state = init_fn(dict(model.named_parameters()))
    generator = torch.Generator().manual_seed(args.seed)  # dropout seeds, drawn on the host
    n_params = sum(p.numel() for p in state.params.values())
    print(json.dumps({"config": cfg.to_dict(), "params": n_params, "device": str(device),
                      "compute_dtype": str(compute_dtype).replace("torch.", ""), "batch_size": batch_size}),
          flush=True)

    for batch in dummy_batches(args.seed, args.dummy_run, batch_size, cfg, vae_cfg):
        t0 = time.perf_counter()
        batch = {"text": torch.from_numpy(batch["text"]).long().to(device),
                 "image": torch.from_numpy(batch["image"]).to(device)}
        state, metrics = step_fn(state, batch, generator)
        record = {"step": state.step, "epoch": 0, "loss": float(metrics["loss"]),
                  "grad_norm": float(metrics["grad_norm"]), "skipped": metrics["skipped"],
                  "batch": int(batch["text"].shape[0]), "step_s": time.perf_counter() - t0}
        if "loss_scale" in metrics:
            record["loss_scale"] = metrics["loss_scale"]
        print(json.dumps(record), flush=True)

    out_file = f"{args.dalle_output_file_name}.pt"
    save_dalle(out_file, model, vae, state, epoch=0)
    print(json.dumps({"checkpoint": out_file, "global_step": state.step}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
