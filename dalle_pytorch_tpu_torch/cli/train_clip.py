"""Train CLIP on text-image pairs (counterpart of `dalle_pytorch_tpu/cli/train_clip.py`).

    python -m dalle_pytorch_tpu_torch.cli.train_clip --image_text_folder DIR [--bf16] [--device cpu]

The path: a folder of images and same-stem captions (`data/loader.py`
`TextImageDataset` with the default BPE tokenizer, batches of
`iterate_batches(seed=seed + epoch)`, decoded on `LOADER_THREADS`
threads) -> `models/clip.forward(...,
return_loss=True)` with the key mask `text != 0`: both encoders run the
flash kernels non-causally, forward and backward, the text encoder with
the mask as its key mask -> global-norm clipping at `--clip_grad_norm` ->
optax's Adam (`optim/grouped.Adam`) through `parallel/train_step.py`;
`--bf16` computes in bf16 on f32 parameters.  `<name>.pt`, a v3
checkpoint that the JAX package's `load_checkpoint` reads (its weights
tree, `hparams` and `version` meta), is written at the start, every
`--save_every_n_steps` and at each epoch's end.  Every 10 steps the loss
goes to `<name>.metrics.jsonl` (`training/logging.py`); each step prints
one JSON record.  It runs on the card unless `--device cpu`.

The flags and defaults are the JAX CLI's.  Under `--distributed_backend
torch` (one process per card, launched by torchrun; gloo with --device
cpu) `--mesh_dp/fsdp/tp` and `--zero_stage` shard the step: each data rank
reads batch_size / (dp·fsdp) pairs of its share, the contrastive loss runs
over the global batch (`models/clip.forward` gathers the latents), the
printed loss is the mean over the processes, and rank 0 alone prints and
writes the checkpoint, the full weights gathered.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch
from torch.func import functional_call

from dalle_pytorch_tpu_torch import weights
from dalle_pytorch_tpu_torch.checkpoint import save_checkpoint
from dalle_pytorch_tpu_torch.cli.common import add_mesh_flags, build_mesh, start_backend
from dalle_pytorch_tpu_torch.data import loader
from dalle_pytorch_tpu_torch.data import tokenizer as tokenizer_mod
from dalle_pytorch_tpu_torch.models.clip import CLIP, CLIPConfig, init_clip
from dalle_pytorch_tpu_torch.optim.grouped import Adam
from dalle_pytorch_tpu_torch.parallel import backend as backend_mod
from dalle_pytorch_tpu_torch.parallel.mesh import active_mesh, mesh_context
from dalle_pytorch_tpu_torch.parallel.train_step import StepSettings, make_train_step
from dalle_pytorch_tpu_torch.training.logging import MetricLogger
from dalle_pytorch_tpu_torch.version import __version__

LOG_EVERY = 10  # the loss's logging cadence, in steps
LOADER_THREADS = 4  # decode/crop threads; the batches are the JAX CLI's, which loads in its loop


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--image_text_folder", type=str, required=True)
    parser.add_argument("--truncate_captions", action="store_true")
    parser.add_argument("--clip_output_file_name", type=str, default="clip")
    parser.add_argument("--dim_text", type=int, default=512)
    parser.add_argument("--dim_image", type=int, default=512)
    parser.add_argument("--dim_latent", type=int, default=512)
    parser.add_argument("--text_enc_depth", type=int, default=6)
    parser.add_argument("--text_seq_len", type=int, default=256)
    parser.add_argument("--text_heads", type=int, default=8)
    parser.add_argument("--visual_enc_depth", type=int, default=6)
    parser.add_argument("--visual_heads", type=int, default=8)
    parser.add_argument("--visual_image_size", type=int, default=256)
    parser.add_argument("--visual_patch_size", type=int, default=32)
    parser.add_argument("--epochs", type=int, default=20)
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--learning_rate", type=float, default=1e-3)
    parser.add_argument("--clip_grad_norm", type=float, default=0.5)
    parser.add_argument("--bf16", action="store_true", help="bf16 compute on f32 parameters")
    add_mesh_flags(parser)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--wandb", action="store_true", help="log to Weights & Biases where wandb imports")
    parser.add_argument("--save_every_n_steps", type=int, default=1000)
    parser.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    backend_mod.wrap_arg_parser(parser)
    return parser


def resolve_args(argv=None) -> argparse.Namespace:
    return build_parser().parse_args(argv)


def clip_config(args, tokenizer) -> CLIPConfig:
    return CLIPConfig(
        dim_text=args.dim_text, dim_image=args.dim_image, dim_latent=args.dim_latent,
        num_text_tokens=tokenizer.vocab_size, text_enc_depth=args.text_enc_depth, text_seq_len=args.text_seq_len,
        text_heads=args.text_heads, visual_enc_depth=args.visual_enc_depth, visual_heads=args.visual_heads,
        visual_image_size=args.visual_image_size, visual_patch_size=args.visual_patch_size,
    )


def clip_loss_fn(model: CLIP, compute_dtype: torch.dtype = torch.float32):
    """loss_fn(params, batch, generator) for `make_train_step`: CLIP's
    contrastive loss on batch["text"] (token ids) and batch["image"] (NHWC
    pixels, cast to the compute dtype) under the key mask text != 0, with
    `params` in place of the model's parameters."""

    def loss_fn(params, batch, generator):
        text = batch["text"]
        return functional_call(model, params, (text, batch["image"].to(compute_dtype)),
                               {"text_mask": text != 0, "return_loss": True})

    return loss_fn


def save_clip(path: str, model: CLIP, params=None) -> None:
    """The checkpoint the JAX CLI writes: the weights tree, `hparams` and
    `version`; `params` (name -> full tensor) in place of the model's own,
    for a sharded run."""
    sd = model.state_dict() if params is None else {**model.state_dict(), **params}
    save_checkpoint(path, {"weights": weights.clip_tree(sd, model.cfg)},
                    {"hparams": model.cfg.to_dict(), "version": __version__})


def main(argv=None) -> int:
    args = resolve_args(argv)
    be, device = start_backend(args)
    try:
        with mesh_context(build_mesh(args, be, device)[0]):  # the step is built on it
            return _train(args, be, device)
    finally:
        be.shutdown()


def _train(args, be, device) -> int:
    mesh = active_mesh()
    is_root = be.is_root_worker()
    torch.manual_seed(args.seed)
    tokenizer = tokenizer_mod.tokenizer
    cfg = clip_config(args, tokenizer)
    model = init_clip(cfg, torch.Generator(device=device).manual_seed(args.seed), device)
    model.train().requires_grad_(True)
    dataset = loader.TextImageDataset(args.image_text_folder, text_len=cfg.text_seq_len,
                                      image_size=cfg.visual_image_size, truncate_captions=args.truncate_captions,
                                      tokenizer=tokenizer, shuffle=True)
    if not len(dataset):
        raise SystemExit(f"{args.image_text_folder} holds no image with a same-stem caption file")

    compute_dtype = torch.bfloat16 if args.bf16 else torch.float32
    settings = StepSettings(compute_dtype=compute_dtype, clip_grad_norm=args.clip_grad_norm,
                            zero_stage=args.zero_stage)
    init_fn, step_fn = make_train_step(clip_loss_fn(model, compute_dtype), Adam(args.learning_rate), settings,
                                       module=model, paths=weights.clip_param_paths(cfg) if mesh is not None else None)
    n_params = sum(p.numel() for p in model.parameters())  # before init_fn keeps this rank's pieces
    state = init_fn(dict(model.named_parameters()))
    plan = step_fn.plan() if mesh is not None else None
    shares, share = (1, 0) if plan is None else (plan.D, plan.data_coord)
    if args.batch_size % shares:
        raise SystemExit(f"--batch_size {args.batch_size} does not split over {shares} data ranks")
    logger = MetricLogger(run_name=args.clip_output_file_name, use_wandb=args.wandb, config=cfg.to_dict(),
                          is_root=is_root)
    out_file = f"{args.clip_output_file_name}.pt"

    def save():
        full = None if plan is None else step_fn.full_state(state)  # on the root alone
        if is_root:
            save_clip(out_file, model, None if full is None else full.params)
        be.local_barrier()

    save()
    if is_root:
        print(json.dumps({"config": cfg.to_dict(), "params": n_params,
                          "device": str(device), "compute_dtype": str(compute_dtype).replace("torch.", ""),
                          "batch_size": args.batch_size, "pairs": len(dataset)}), flush=True)

    step = 0
    for epoch in range(args.epochs):
        batches = iter(loader.iterate_batches(dataset, args.batch_size // shares, seed=args.seed + epoch,
                                              num_workers=LOADER_THREADS, process_index=share,
                                              process_count=shares))
        while True:
            t0 = time.perf_counter()
            batch = next(batches, None)
            if batch is None:
                break
            t_data = time.perf_counter()
            batch = {"text": torch.from_numpy(batch["text"]).long().to(device),
                     "image": torch.from_numpy(batch["image"]).to(device)}
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])  # the step's mean over the data ranks
            if is_root:
                print(json.dumps({"step": step, "epoch": epoch, "loss": loss,
                                  "grad_norm": float(metrics["grad_norm"]), "skipped": metrics["skipped"],
                                  "step_s": time.perf_counter() - t_data, "data_s": t_data - t0}), flush=True)
            if step % LOG_EVERY == 0:
                logger.log({"loss": loss, "epoch": epoch}, step=step)
            if args.save_every_n_steps and step and step % args.save_every_n_steps == 0:
                save()
            step += 1
        save()
    logger.finish()
    if is_root:
        print(json.dumps({"checkpoint": out_file, "global_step": step}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
