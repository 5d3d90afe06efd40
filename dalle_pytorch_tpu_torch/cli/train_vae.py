"""Train the discrete VAE image tokenizer (counterpart of `dalle_pytorch_tpu/cli/train_vae.py`).

    python -m dalle_pytorch_tpu_torch.cli.train_vae --image_folder DIR [--image_size 256] [--device cpu]
    python -m dalle_pytorch_tpu_torch.cli.train_vae --image_folder DIR --resume auto|PATH

The path: a folder of images (`data/loader.py` `ImageDataset`, PNG through
the port's own decoder, random resized crops) -> `models/vae.forward` (the
gumbel-softmax sample, straight-through and ReinMax under their flags, the
reconstruction loss and the weighted KL) -> backward -> Adam (optax's
`chain(scale_by_adam(), scale(-1))` times the learning rate, through
`optim/grouped.Adam`).  The learning rate and the gumbel temperature are
0-d tensors on the device, changed in place: the temperature anneals every
100 steps, `max(temp * exp(-anneal_rate * step), temp_min)`, and the
learning rate decays by `--lr_decay_rate` at each epoch's end.  Every 100
steps a record (loss, temperature, lr, codebook_used, epoch) goes to
`<name>.metrics.jsonl`, with grids of the originals and their soft and hard
reconstructions under `<name>.images/` and the codebook histogram
(`training/logging.py`).  `<name>.pt` is a v3 checkpoint that the JAX
package's `load_checkpoint` reads (its weights tree, `hparams` and
`version` meta), written before the first step (an unwritable output fails
before any compute), every `--save_every_n_steps` and at each epoch's end.
`--resume auto|PATH` restores the weights and hparams of the port's or the
JAX CLI's `vae.pt` (or of a torch-reference one, converted) and starts a
fresh optimizer, as the JAX CLI does.  Each
step prints one JSON record.  It runs on the card unless `--device cpu`.

The flags and defaults are the JAX CLI's, but for two whose JAX defaults
turn on machinery the port does not have: `--async_checkpoint` (0) and
`--prefetch_batches` (0); their JAX values, and every other flag whose
machinery waits (`--health_every`, `--inject_fault`,
`--fleet_inject_skew`), exit naming their ROADMAP.md item; `--fleet` is
taken and does nothing.  Telemetry is on by default, as in the JAX CLI
(`--telemetry DIR`, default `<output>.telemetry`; `--telemetry off`): the
loop's spans (`data_wait`, `dispatch`, `block`, `log`, `checkpoint`), the
tree ledger (a lower bound: no activation row), the headroom monitor
(`--hbm_headroom_frac`), the hang monitor (`--telemetry_heartbeat_s`) and
profiler captures (`--profile_on_alarm`, `--profile_steps A:B`, SIGUSR2).
An out-of-memory error writes `oom_report_*.txt` there and exits 77.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
import zipfile
from pathlib import Path
from typing import Optional, Tuple

import torch
from torch.func import functional_call

from dalle_pytorch_tpu_torch import weights
from dalle_pytorch_tpu_torch.checkpoint import load_checkpoint
from dalle_pytorch_tpu_torch.cli.common import refuse, start_backend
from dalle_pytorch_tpu_torch.cli.train_dalle import write_vae_checkpoint
from dalle_pytorch_tpu_torch.data import loader
from dalle_pytorch_tpu_torch.models import torch_port
from dalle_pytorch_tpu_torch.models import vae as vae_mod
from dalle_pytorch_tpu_torch.models.vae import DiscreteVAEConfig
from dalle_pytorch_tpu_torch.observability import memory as memory_mod
from dalle_pytorch_tpu_torch.observability import telemetry
from dalle_pytorch_tpu_torch.optim.grouped import Adam
from dalle_pytorch_tpu_torch.parallel import backend as backend_mod
from dalle_pytorch_tpu_torch.parallel.mesh import MeshConfig, make_mesh
from dalle_pytorch_tpu_torch.parallel.train_step import StepSettings, make_train_step
from dalle_pytorch_tpu_torch.training.logging import MetricLogger

LOG_EVERY = 100  # the annealing and logging cadence, in steps

# flag -> (its value that leaves the machinery off, the machinery, its ROADMAP.md Queue 1 item)
_WAITING = {
    "health_every": (0, "the in-graph health diagnostic step", 8),
    "inject_fault": (None, "the fault-injection harness", 8),
    "fleet_inject_skew": (0.0, "the straggler injection of fleet telemetry", 8),
    "async_checkpoint": (0, "the asynchronous checkpoint writer", 8),
    "prefetch_batches": (0, "the device prefetch thread", 10),
}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--image_folder", type=str, required=True)
    parser.add_argument("--image_size", type=int, default=128)
    parser.add_argument("--num_tokens", type=int, default=8192)
    parser.add_argument("--num_layers", type=int, default=3)
    parser.add_argument("--num_resnet_blocks", type=int, default=2)
    parser.add_argument("--smooth_l1_loss", action="store_true")
    parser.add_argument("--emb_dim", type=int, default=512)
    parser.add_argument("--hidden_dim", type=int, default=256)
    parser.add_argument("--kl_loss_weight", type=float, default=0.0)
    parser.add_argument("--transparent", action="store_true")
    parser.add_argument("--straight_through", action="store_true")
    parser.add_argument("--reinmax", action="store_true")
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--epochs", type=int, default=20)
    parser.add_argument("--learning_rate", type=float, default=1e-3)
    parser.add_argument("--lr_decay_rate", type=float, default=0.98)
    parser.add_argument("--starting_temp", type=float, default=1.0)
    parser.add_argument("--temp_min", type=float, default=0.5)
    parser.add_argument("--anneal_rate", type=float, default=1e-6)
    parser.add_argument("--num_images_save", type=int, default=4)
    parser.add_argument("--vae_output_file_name", type=str, default="vae")
    parser.add_argument("--save_every_n_steps", type=int, default=1000)
    parser.add_argument("--num_workers", type=int, default=4, help="decode/crop threads (0 = in the loop)")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    parser.add_argument("--wandb", action="store_true", help="log to Weights & Biases where wandb imports")
    parser.add_argument("--wandb_name", type=str, default="dalle_train_vae")
    parser.add_argument("--resume", type=str, default=None, metavar="auto|PATH",
                        help="'auto': <vae_output_file_name>.pt when it loads, else a fresh start; a path "
                             "resumes from that checkpoint.  Weights and hparams only: a fresh optimizer")
    parser.add_argument("--telemetry", type=str, default=None, metavar="DIR",
                        help="telemetry directory (spans JSONL, hang dumps, traces, OOM reports); default "
                             "<output>.telemetry; 'off' disables it")
    # the JAX defaults of these two turn machinery on that the port does not have
    parser.add_argument("--async_checkpoint", type=int, default=0,
                        help="0 (the port's default; the JAX CLI's is 1): saves are synchronous; the "
                             "background writer waits for Queue 1 item 8")
    parser.add_argument("--prefetch_batches", type=int, default=0,
                        help="0 (the port's default; the JAX CLI's is 2): no device prefetch thread; it waits "
                             "for Queue 1 item 10")
    parser.add_argument("--profile_steps", type=str, default=None, metavar="A:B",
                        help="capture a torch.profiler trace of steps [A, B) into <telemetry>/traces")
    parser.add_argument("--health_every", type=int, default=0, metavar="N", help="N > 0: Queue 1 item 8")
    parser.add_argument("--inject_fault", type=str, default=None, metavar="KIND@STEP", help="Queue 1 item 8")
    parser.add_argument("--fleet_inject_skew", type=float, default=0.0, metavar="SECONDS", help="Queue 1 item 8")
    parser.add_argument("--telemetry_heartbeat_s", type=float, default=900.0,
                        help="hang-monitor deadline in seconds (0 disables)")
    parser.add_argument("--telemetry_sync", type=int, default=1,
                        help="1: synchronise the card after each step (the block span); 0: never")
    parser.add_argument("--fleet", type=int, default=1,
                        help="taken and inert: the fleet aggregator waits for ROADMAP.md Queue 1 item 7")
    parser.add_argument("--profile_on_alarm", type=int, default=3, metavar="N",
                        help="capture a torch.profiler trace of the next N steps when an alarm fires (0 disables)")
    parser.add_argument("--hbm_headroom_frac", type=float, default=0.9, metavar="FRAC",
                        help="alarm when the allocator's bytes in use cross FRAC of the card (0 disables)")
    backend_mod.wrap_arg_parser(parser)
    return parser


def resolve_args(argv=None) -> argparse.Namespace:
    """Parse the flags and exit on those whose machinery waits."""
    args = build_parser().parse_args(argv)
    for flag, (off, machinery, item) in _WAITING.items():
        if getattr(args, flag) != off:
            raise refuse(f"--{flag} {getattr(args, flag)}: {machinery}", item)
    return args


def vae_config(args) -> DiscreteVAEConfig:
    return DiscreteVAEConfig(
        image_size=args.image_size, num_tokens=args.num_tokens, codebook_dim=args.emb_dim,
        num_layers=args.num_layers, num_resnet_blocks=args.num_resnet_blocks, hidden_dim=args.hidden_dim,
        channels=4 if args.transparent else 3, smooth_l1_loss=args.smooth_l1_loss, temperature=args.starting_temp,
        straight_through=args.straight_through, reinmax=args.reinmax, kl_div_loss_weight=args.kl_loss_weight,
    )


def vae_loss_fn(vae: vae_mod.DiscreteVAE):
    """loss_fn(params, batch, generator) for `make_train_step`: the VAE's
    training loss on batch["images"] at temperature batch["temp"], with
    `params` in place of its parameters; the gumbel draw is batch["uniform"]
    when the batch has one, else drawn from `generator`."""

    def loss_fn(params, batch, generator):
        return functional_call(vae, params, (batch["images"],),
                               {"generator": generator, "uniform": batch.get("uniform"), "temp": batch.get("temp"),
                                "return_loss": True})

    return loss_fn


def make_vae_step(vae: vae_mod.DiscreteVAE, lr: torch.Tensor, mesh=None):
    """(init_fn, step_fn) of the JAX CLI's `train_step`: the loss and its
    gradient, then Adam's direction times `lr` (a 0-d tensor the caller
    changes in place), no clipping and no guard (`parallel/train_step.py`).
    With `mesh` (every process on dp) the step is replicated data
    parallel, as the JAX CLI's."""
    return make_train_step(vae_loss_fn(vae), Adam(lr), StepSettings(skip_nonfinite=False), mesh=mesh)


def _resume(args, device) -> Tuple[Optional[vae_mod.DiscreteVAE], Optional[str]]:
    """The VAE of `--resume` (weights and config from the checkpoint) and its
    path, or (None, None) for a fresh start: `--resume auto` starts fresh
    when `<name>.pt` is missing or does not load; a named path that does
    not exists or load."""
    if args.resume is None:
        return None, None
    auto = args.resume == "auto"
    path = f"{args.vae_output_file_name}.pt" if auto else args.resume
    if not Path(path).is_file():
        if auto:
            print(f"[resume] --resume auto: no checkpoint at {path}; starting fresh", flush=True)
            return None, None
        raise SystemExit(f"--resume {path} does not exist")
    try:
        if torch_port.is_torch_checkpoint(path):  # a torch-reference vae.pt, converted
            params, cfg = torch_port.load_reference_vae_checkpoint(path)
            vae = weights.load_vae(params, cfg, device)
        else:
            trees, meta = load_checkpoint(path)
            cfg = DiscreteVAEConfig.from_dict(meta["hparams"])
            vae = weights.load_vae(trees["weights"], cfg, device)
    except (OSError, ValueError, KeyError, TypeError, zipfile.BadZipFile) as e:
        if not auto:
            raise SystemExit(f"--resume {path}: not a VAE checkpoint this port reads ({e!r})") from e
        print(f"[resume] --resume auto: {path} does not load ({e!r}); starting fresh", flush=True)
        return None, None
    print(f"[resume] resumed the VAE weights from {path} (hparams from the checkpoint; a fresh optimizer)",
          flush=True)
    return vae, path


def _log_cadence(logger: MetricLogger, vae, images, generator, temp_t, step, epoch, num_images_save,
                 record) -> None:
    """The records of the logging cadence after the step, in the JAX CLI's
    order: `record`, then the number of codebook entries the batch uses
    (`codebook_used`) and the epoch, the grids of the first `num_images_save` originals
    and their soft (gumbel) and hard (argmax codes) reconstructions, and
    the codebook histogram."""
    cfg = vae.cfg
    idx = vae_mod.get_codebook_indices(vae, images)
    used = int((torch.bincount(idx.reshape(-1), minlength=cfg.num_tokens) > 0).sum())
    logger.log({**record, "codebook_used": used, "epoch": epoch}, step=step)
    sample = images[: min(num_images_save, images.shape[0])]
    with torch.no_grad():
        soft = vae_mod.forward(vae, sample, generator, temp=temp_t)
    hard = vae_mod.decode_indices(vae, vae_mod.get_codebook_indices(vae, sample))
    logger.log_images({"original images": sample, "reconstructions": vae_mod.denormalize_images(cfg, soft),
                       "hard reconstructions": vae_mod.denormalize_images(cfg, hard)}, step=step)
    logger.log_histogram("codebook_indices", idx, step=step)


def main(argv=None) -> int:
    args = resolve_args(argv)
    be, device = start_backend(args)
    try:
        return _train(args, be, device)
    finally:
        be.shutdown()


def _train(args, be, device) -> int:
    # every process on dp: the JAX CLI's replicated data-parallel step
    mesh = make_mesh(MeshConfig(), device.type) if backend_mod.is_distributed else None
    is_root, shares = be.is_root_worker(), be.get_world_size()
    if args.batch_size % shares:
        raise SystemExit(f"--batch_size {args.batch_size} does not split over {shares} processes")
    torch.manual_seed(args.seed)
    vae, source = _resume(args, device)
    cfg = vae.cfg if vae is not None else vae_config(args)
    # a resumed run reads its images in the mode its checkpoint's VAE takes
    dataset = loader.ImageDataset(args.image_folder, cfg.image_size, transparent=cfg.channels == 4)
    if not len(dataset):
        raise SystemExit(f"no images found in {args.image_folder}")
    if vae is None:
        vae = vae_mod.init_discrete_vae(cfg, torch.Generator(device=device).manual_seed(args.seed), device)
    vae.train().requires_grad_(True)

    temp, lr = args.starting_temp, args.learning_rate
    temp_t = torch.tensor(temp, dtype=torch.float32, device=device)
    lr_t = torch.tensor(lr, dtype=torch.float32, device=device)
    init_fn, step_fn = make_vae_step(vae, lr_t, mesh)
    state = init_fn(dict(vae.named_parameters()))
    generator = torch.Generator(device=device).manual_seed(args.seed + 1)  # the gumbel draws
    logger = MetricLogger(run_name=args.vae_output_file_name, use_wandb=args.wandb,
                          wandb_kwargs={"name": args.wandb_name}, config=cfg.to_dict(), is_root=is_root)

    # the VAE has no priced activation geometry (convolutions): the tree
    # ledger, a LOWER bound that still names the dominant row in an OOM report
    mem_ledger = memory_mod.generic_memory_ledger(state.params, state.opt_state, device=device)
    run = telemetry.RunTelemetry.from_args(args, args.vae_output_file_name, mem_ledger, device, be.get_rank())
    where = {"phase": "train_step", "ledger": mem_ledger,
             "context": {"batch_size": args.batch_size, "image_size": cfg.image_size}}
    progress = {"step": 0}  # the loop's step, for the last flush
    try:
        with run.oom_exit(where):
            return _loop(args, be, device, vae, cfg, dataset, state, step_fn, generator, logger, run, temp, temp_t,
                         lr, lr_t, is_root, shares, source, progress)
    finally:
        run.flush(logger, step=progress["step"])
        run.close()
        logger.finish()


def _loop(args, be, device, vae, cfg, dataset, state, step_fn, generator, logger, run, temp, temp_t, lr,
          lr_t, is_root, shares, source, progress) -> int:
    out_file = f"{args.vae_output_file_name}.pt"

    def save():  # the parameters are replicated: the root writes its own
        with telemetry.span("checkpoint"):
            if is_root:
                write_vae_checkpoint(out_file, vae)
            be.local_barrier()

    save()  # an unwritable output fails before any compute
    if is_root:
        print(json.dumps({"config": cfg.to_dict(), "params": sum(p.numel() for p in state.params.values()),
                          "device": str(device), "batch_size": args.batch_size, "images": len(dataset),
                          "resumed_from": source}), flush=True)
    global_step = 0
    for epoch in range(args.epochs):
        t_epoch = time.time()
        batches = iter(loader.iterate_image_batches(dataset, args.batch_size // shares, seed=args.seed + epoch,
                                                    num_workers=args.num_workers, process_index=be.get_rank(),
                                                    process_count=shares))
        while True:
            run.begin(global_step)
            t0 = time.perf_counter()
            with telemetry.span("data_wait"):
                images = next(batches, None)
            if images is None:
                run.abort()
                break
            t_data = time.perf_counter()
            images = torch.from_numpy(images).to(device)
            with telemetry.span("dispatch"):
                state, metrics = step_fn(state, {"images": images, "temp": temp_t}, generator)
            run.block()
            with telemetry.span("log"):
                loss = float(metrics["loss"])  # the step's mean over the data ranks
                if is_root:
                    print(json.dumps({"step": global_step, "epoch": epoch, "loss": loss, "temperature": temp,
                                      "lr": lr, "step_s": time.perf_counter() - t_data, "data_s": t_data - t0}),
                          flush=True)
                if global_step % LOG_EVERY == 0:
                    temp = max(temp * math.exp(-args.anneal_rate * global_step), args.temp_min)
                    temp_t.fill_(temp)
                    # every rank draws, so that the gumbel generators stay in step
                    _log_cadence(logger, vae, images, generator, temp_t, global_step, epoch, args.num_images_save,
                                 {"loss": loss, "temperature": temp, "lr": lr})
                    run.flush(logger, step=global_step)
            if args.save_every_n_steps and global_step and global_step % args.save_every_n_steps == 0:
                save()
            run.end(global_step)
            global_step += 1
            progress["step"] = global_step
        lr *= args.lr_decay_rate
        lr_t.fill_(lr)
        save()
        logger.log({"epoch_time_s": time.time() - t_epoch, "epoch": epoch}, step=global_step)
    if is_root:
        print(json.dumps({"checkpoint": out_file, "global_step": global_step}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
